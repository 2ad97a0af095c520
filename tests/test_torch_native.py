"""The port's host codec (automerge_tpu_torch/native) against the JAX
package's native codec and the Python decoder, on the CPU.

Decoded batches must be identical field by field; the run walker must
equal `_detect_runs_numpy` of both packages bit for bit, unsharded and
sharded. A payload outside the codec's scope is declined and decoded by
the Python decoder; a failed build raises instead of falling back."""

import json
import os
import time

import numpy as np
import pytest

from automerge_tpu import native as jnative
from automerge_tpu.engine import TextChangeBatch as JBatch
from automerge_tpu.engine import runs as jruns
from automerge_tpu_torch import native
from automerge_tpu_torch.engine import DeviceTextDoc
from automerge_tpu_torch.engine import TextChangeBatch as TBatch
from automerge_tpu_torch.engine import runs as truns

from test_native_codec import typing_change

FIELDS = ("op_change", "op_kind", "op_target_actor", "op_target_ctr",
          "op_parent_actor", "op_parent_ctr", "op_value")
PLAN_FIELDS = ("hpos", "run_len", "head_slot", "rpos", "res_new_slot",
               "blob")


def assert_batches_equal(a, b):
    assert a.actors == b.actors
    assert a.actor_table == b.actor_table
    assert a.deps == b.deps
    assert a.messages == b.messages
    assert a.value_pool == b.value_pool
    np.testing.assert_array_equal(a.seqs, b.seqs)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def payloads():
    return {
        "typing": [typing_change("alice", 1, "hello world",
                                 message="hi\nthere"),
                   typing_change("bob", 1, "né±漢🎉", start=1,
                                 deps={"alice": 1}),
                   {"actor": "bob", "seq": 2, "deps": {}, "ops": [
                       {"action": "del", "obj": "t", "key": "alice:2"},
                       {"action": "ins", "obj": "t", "key": "bob:1",
                        "elem": 99},
                       {"action": "set", "obj": "t", "key": "bob:99",
                        "value": "é"}]}],
        "escapes": [{"actor": "aé", "seq": 1, "deps": {}, "ops": [
            {"action": "ins", "obj": "t", "key": "_head", "elem": 1},
            {"action": "set", "obj": "t", "key": "aé:1", "value": "🎉"}]}],
        "two_actors": [typing_change("alice", 1, "hi"),
                       typing_change("bob", 1, "yo", deps={"alice": 1})],
        "null_message": [dict(typing_change("alice", 1, "hi"),
                              message=None)],
        "counters": [{"actor": "c", "seq": 1, "deps": {}, "ops": [
            {"action": "ins", "obj": "t", "key": "_head", "elem": 1},
            {"action": "set", "obj": "t", "key": "c:1", "value": "x"},
            {"action": "inc", "obj": "t", "key": "c:1", "value": 3}]}],
    }


@pytest.fixture(scope="module")
def jax_codec():
    """The JAX package's codec library, loaded. It builds in place: a
    process of another test worker that loads while one builds finds a
    half-written library and marks it failed for good. So wait until the
    build settles and load again, a bounded number of times."""
    deadline = time.monotonic() + 240
    while True:
        lib = jnative._load()
        if lib is not None:
            return lib
        if time.monotonic() > deadline:
            pytest.fail("the JAX package's native codec did not load")
        # settled: the library and its flags stamp written, and the
        # library unchanged for 2 s (or 30 s passed: build it here)
        wait_until = min(deadline, time.monotonic() + 30)
        while time.monotonic() < wait_until:
            try:
                if (os.path.exists(jnative._FLAGS_STAMP) and time.time()
                        - os.path.getmtime(jnative._SO) > 2.0):
                    break
            except OSError:
                pass
            time.sleep(0.5)
        jnative._lib_failed = False


@pytest.mark.parametrize("indent", [None, 2])
@pytest.mark.parametrize("name", sorted(payloads()))
def test_decoder_matches_jax_native_and_python(name, indent, jax_codec):
    changes = payloads()[name]
    data = json.dumps(changes, indent=indent)
    mine = native.decode_text_changes(data, "t")
    theirs = jnative.decode_text_changes(data, "t")
    python = TBatch.from_changes(changes, "t")
    assert mine is not None and theirs is not None
    assert_batches_equal(mine, python)
    assert_batches_equal(mine, theirs)


def test_from_json_routes_native_and_counts():
    data = json.dumps(payloads()["typing"])
    native.reset_counts()
    batch = TBatch.from_json(data, "t")
    assert native.routes == {"native": 1, "python": 0}
    assert_batches_equal(batch, JBatch.from_json(data, "t"))
    doc = DeviceTextDoc("t", device="cpu")
    doc.apply_changes(json.dumps([typing_change("w", 1, "native!")]))
    assert doc.text() == "native!"
    assert native.routes["native"] == 2


def test_bulk_from_changes_routes_native_with_identical_batch(monkeypatch):
    text = "x" * (TBatch._NATIVE_MIN_OPS // 2 + 10)
    changes = [typing_change("alice", 1, text, message="bulk")]
    native.reset_counts()
    routed = TBatch.from_changes(changes, "t")
    assert native.routes == {"native": 1, "python": 0}
    monkeypatch.setattr(TBatch, "_NATIVE_MIN_OPS", 10**9)
    walked = TBatch.from_changes(changes, "t")
    assert native.routes == {"native": 1, "python": 1}
    assert_batches_equal(routed, walked)
    assert_batches_equal(routed, JBatch.from_changes(changes, "t"))


OUT_OF_SCOPE = {
    "rich_value": [{"actor": "a", "seq": 1, "deps": {}, "ops": [
        {"action": "ins", "obj": "t", "key": "_head", "elem": 1},
        {"action": "set", "obj": "t", "key": "a:1",
         "value": "multi-char"}]}],
    "newline_actor": [{"actor": "a\nb", "seq": 1, "deps": {}, "ops": []}],
    "numeric_message": [dict(typing_change("alice", 1, "hi"), message=42)],
    "big_elem": [{"actor": "a", "seq": 1, "deps": {}, "ops": [
        {"action": "ins", "obj": "t", "key": "_head", "elem": 2 ** 31},
        {"action": "set", "obj": "t", "key": f"a:{2 ** 31}",
         "value": "x"}]}],
}


@pytest.mark.parametrize("name", sorted(OUT_OF_SCOPE))
def test_out_of_scope_payload_falls_back_to_python(name):
    changes = OUT_OF_SCOPE[name]
    data = json.dumps(changes)
    assert native.decode_text_changes(data, "t") is None
    assert jnative.decode_text_changes(data, "t") is None
    native.reset_counts()
    try:
        want = JBatch.from_json(data, "t")
    except (ValueError, OverflowError) as e:   # Python decoder rejects it
        with pytest.raises(type(e)):
            TBatch.from_json(data, "t")
        return
    got = TBatch.from_json(data, "t")
    assert native.routes == {"native": 0, "python": 1}
    assert_batches_equal(got, want)


@pytest.mark.parametrize("key", ["nocolon", "a:", "a:12x"])
def test_malformed_elem_id_declined(key):
    changes = [{"actor": "a", "seq": 1, "deps": {}, "ops": [
        {"action": "del", "obj": "t", "key": key},
        {"action": "ins", "obj": "t", "key": "_head", "elem": 1}]}]
    assert native.decode_text_changes(json.dumps(changes), "t") is None


def test_bulk_malformed_change_still_raises():
    text = "x" * (TBatch._NATIVE_MIN_OPS // 2 + 10)
    bad = {k: v for k, v in typing_change("alice", 1, text).items()
           if k != "seq"}
    with pytest.raises(KeyError):
        TBatch.from_changes([bad], "t")


def random_ops(seed):
    """Seeded op columns: pairs, chained runs, bare inserts, dels, incs,
    pooled values (tests/test_native_codec.py's generator)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    kind = np.zeros(n, np.int8)
    ta = rng.integers(0, 4, n).astype(np.int32)
    tc = rng.integers(1, 50, n).astype(np.int32)
    pa = rng.integers(-1, 4, n).astype(np.int32)
    pc = rng.integers(0, 50, n).astype(np.int32)
    val = rng.integers(-3, 300, n).astype(np.int64)
    row = np.sort(rng.integers(0, 5, n)).astype(np.int32)
    i = 0
    while i < n - 1:
        if rng.random() < 0.5:
            kind[i], kind[i + 1] = 0, 1
            ta[i + 1], tc[i + 1], row[i + 1] = ta[i], tc[i], row[i]
            if rng.random() < 0.7 and i >= 2 and kind[i - 2] == 0:
                ta[i], tc[i] = ta[i - 2], tc[i - 2] + 1
                pa[i], pc[i], row[i] = ta[i - 2], tc[i - 2], row[i - 2]
                ta[i + 1], tc[i + 1], row[i + 1] = ta[i], tc[i], row[i]
            i += 2
        else:
            kind[i] = int(rng.integers(0, 4))
            i += 1
    return (kind, ta, tc, pa, pc, val, row), int(rng.integers(0, 100))


def assert_plans_equal(a, b):
    for f in ("n_ops", "n_ins", "blob_lt_128", "blob_lt_256"):
        assert getattr(a, f) == getattr(b, f), f
    for f in PLAN_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("seed", range(6))
def test_run_walker_matches_numpy_in_both_packages(seed):
    cols, base = random_ops(seed)
    native.reset_counts()
    mine = truns._detect_runs_single(*cols, base)
    assert native.walks["native"] == 1
    assert_plans_equal(mine, truns._detect_runs_numpy(*cols, base))
    assert_plans_equal(mine, jruns._detect_runs_numpy(*cols, base))
    assert_plans_equal(mine, jruns._detect_runs_single(*cols, base))


def merge_ops(seed, n_changes=50, run=20):
    """A merge-shaped batch with residual deletes spliced in."""
    import bench as B
    batch = B.merge_batch("t", n_changes, 2 * run, 1000, seed=seed)
    kind = batch.op_kind.copy()
    kind[21::97] = 2                            # KIND_DEL
    return (kind, batch.op_target_actor, batch.op_target_ctr,
            batch.op_parent_actor, batch.op_parent_ctr, batch.op_value,
            batch.op_change)


@pytest.mark.parametrize("workers", ["1", "3"])
def test_sharded_detection_matches_numpy(workers, monkeypatch):
    monkeypatch.setenv("AMTPU_PLAN_WORKERS", workers)
    monkeypatch.setattr(truns, "_SHARD_MIN_OPS", 64)
    monkeypatch.setattr(jruns, "_SHARD_MIN_OPS", 64)
    monkeypatch.setattr("automerge_tpu_torch.engine.pipeline._POOL", None)
    monkeypatch.setattr("automerge_tpu.engine.pipeline._POOL", None)
    cols = merge_ops(5)
    native.reset_counts()
    truns.detections["calls"] = 0
    mine = truns.detect_runs(*cols, 1000)
    assert truns.detections["calls"] == 1
    assert native.walks["native"] == (3 if workers == "3" else 1)
    assert_plans_equal(mine, truns._detect_runs_numpy(*cols, 1000))
    assert_plans_equal(mine, jruns.detect_runs(*cols, 1000))


def _empty_cols():
    return (np.empty(0, np.int8),) + tuple(
        np.empty(0, t) for t in (np.int32,) * 4 + (np.int64, np.int32))


@pytest.mark.parametrize("workers", ["1", "3"])
@pytest.mark.parametrize("seed", range(3))
def test_doc_axis_walk_matches_numpy_per_document(seed, workers,
                                                  monkeypatch):
    """`detect_runs_axis` over seeded documents (an empty one among them,
    bases of their own): one call, one walk unsharded, each document's
    cut equal to the numpy reference on it alone."""
    monkeypatch.setenv("AMTPU_PLAN_WORKERS", workers)
    monkeypatch.setattr(truns, "_SHARD_MIN_OPS", 64)
    monkeypatch.setattr("automerge_tpu_torch.engine.pipeline._POOL", None)
    docs = [random_ops(10 * seed + i) for i in range(5)]
    docs.insert(2, (_empty_cols(), 7))
    native.reset_counts()
    truns.detections["calls"] = 0
    plans = truns.detect_runs_axis([c for c, _ in docs],
                                   [b for _, b in docs]).cut()
    assert truns.detections["calls"] == 1
    assert (native.walks["native"] > 1) == (workers == "3")
    assert len(plans) == len(docs)
    for (cols, base), plan in zip(docs, plans):
        assert_plans_equal(plan, truns._detect_runs_numpy(*cols, base))
    assert truns.detect_runs_axis([], []).cut() == []
    assert truns.detections["calls"] == 2


@pytest.mark.parametrize("seed", range(2))
def test_parallel_walker_stitch_matches_numpy(seed, monkeypatch):
    """Past the walker's own thread fan-out threshold (2^19 ops per chunk),
    forced to three threads, with runs crossing chunk boundaries."""
    monkeypatch.setenv("AMTPU_DETECT_THREADS", "3")
    rng = np.random.default_rng(900 + seed)
    n = 1_100_000 + int(rng.integers(0, 7))
    kind = np.full(n, 1, np.int8)
    ta = np.zeros(n, np.int32)
    tc = np.zeros(n, np.int32)
    pa = np.zeros(n, np.int32)
    pc = np.zeros(n, np.int32)
    val = np.zeros(n, np.int64)
    row = np.zeros(n, np.int32)
    i, r, c = 0, 0, 1
    while i < n - 1:
        if rng.random() < 0.82:
            L = min(int(rng.integers(1, 120_000)), (n - 1 - i) // 2)
            if L <= 0:
                break
            idx = i + 2 * np.arange(L)
            kind[idx], kind[idx + 1] = 0, 1
            a_ = int(rng.integers(0, 5))
            ta[idx] = ta[idx + 1] = a_
            ctr = c + np.arange(L)
            tc[idx] = tc[idx + 1] = ctr
            pa[idx], pc[idx] = a_, ctr - 1
            pa[i], pc[i] = int(rng.integers(0, 5)), int(rng.integers(0, 50))
            val[idx + 1] = rng.integers(32, 300, L)
            row[idx] = row[idx + 1] = r
            c += L + 1
            i += 2 * L
        else:
            kind[i] = int(rng.integers(0, 4))
            ta[i], tc[i] = int(rng.integers(0, 5)), c
            c += 1
            i += 1
        r += 1
    cols = (kind, ta, tc, pa, pc, val, row)
    assert_plans_equal(truns._detect_runs_single(*cols, 37),
                       truns._detect_runs_numpy(*cols, 37))


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "codec.cpp"
    bad.write_text('extern "C" int amtpu_parse( {\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="failed") as e:
        native.load()
    assert "error" in str(e.value)
    # no silent numpy fallback on the engine path
    cols, base = random_ops(0)
    with pytest.raises(RuntimeError):
        truns._detect_runs_single(*cols, base)
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build(compiler="no-such-compiler")


def test_library_name_carries_source_and_flags_digest(tmp_path,
                                                      monkeypatch):
    src = tmp_path / "codec.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    monkeypatch.setattr(native, "SOURCE", src)
    a = native.library_path(["-O3"])
    assert a != native.library_path(["-O2"])
    src.write_bytes(src.read_bytes() + b"\n// edit\n")
    assert native.library_path(["-O3"]) != a
    assert a.parent == native.BUILD_DIR


# --- the DocSet's doc-axis pass -------------------------------------------------

def _axis_round(rng, index, n, nxt, n_actors=4):
    """One round's runs on a document of `n` elements whose index is
    `index`: 1-5 runs by random actors (fresh counters, sometimes
    key-contiguous with the actor's last run), each after the head, an
    element of the document or an element of an earlier run of the
    round. -> (staged reference index, per-run columns)."""
    K = int(rng.integers(1, 6))
    runs = {k: [] for k in ("actor", "ctr", "len", "slot", "pslot")}
    slot = n + 1
    for _ in range(K):
        a = int(rng.integers(0, n_actors))
        ctr = nxt[a] + int(rng.integers(0, 2))
        length = int(rng.integers(1, 5))
        nxt[a] = ctr + length
        head = slot - 1 < 1 or rng.random() < 0.2
        runs["pslot"].append(0 if head else int(rng.integers(1, slot)))
        for k, v in (("actor", a), ("ctr", ctr), ("len", length),
                     ("slot", slot)):
            runs[k].append(v)
        slot += length
    cols = {k: np.asarray(v, np.int64) for k, v in runs.items()}
    staged = index.merge(truns_pack(cols["actor"], cols["ctr"]),
                         cols["len"], cols["slot"])
    pa, pc = np.full(K, -1, np.int64), np.zeros(K, np.int64)
    inner = cols["pslot"] > 0
    if inner.any():
        pa[inner], pc[inner] = staged.slot_to_key(cols["pslot"][inner])
    cols["pa"], cols["pc"] = pa, pc
    return staged, cols


def truns_pack(actor, ctr):
    from automerge_tpu_torch.engine.host_index import pack_keys
    return pack_keys(np.asarray(actor, np.int64), np.asarray(ctr, np.int64))


def _axis_docs(seed, n_docs=6):
    """Seeded documents as the one-document code grows them: an index
    (`BatchRangeIndex.merge`) and a mirror (`SegmentMirror.apply_round`,
    None for one document) after 0-20 rounds, and one round to plan."""
    from automerge_tpu_torch.engine.host_index import BatchRangeIndex
    from automerge_tpu_torch.engine.segments import SegmentMirror
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n_docs):
        index, mirror, n, nxt = (BatchRangeIndex(), SegmentMirror.empty(),
                                 0, [1, 1, 1, 1])
        for _ in range(int(rng.integers(0, 21))):
            index, c = _axis_round(rng, index, n, nxt)
            after = n + int(c["len"].sum())
            mirror = mirror.apply_round(c["slot"], c["pslot"], c["ctr"],
                                        c["actor"], after, index.slot_to_key)
            n = after
        staged, c = _axis_round(rng, index, n, nxt)
        docs.append({"index": index, "mirror": None if i == 2 else mirror,
                     "n": n, "staged": staged, "cols": c,
                     "row_rank": rng.integers(0, 9, len(c["len"])),
                     "row_seq": rng.integers(1, 99, len(c["len"]))})
    return docs


def _axis_pass(docs, compact=12, relocate=False):
    """The native pass over `docs` (one change a run; the batch's actor
    table is the document's, rank for rank)."""
    i64, i32 = np.int64, np.int32

    def cat(parts, dt):
        return (np.concatenate(parts).astype(dt) if parts
                else np.empty(0, dt))
    c = [d["cols"] for d in docs]
    off = lambda sizes: np.concatenate(([0], np.cumsum(sizes))).astype(i64)
    tiers = [r for d in docs for r in d["index"]._runs]
    mirrors = [d["mirror"] for d in docs if d["mirror"] is not None]
    inputs = (
        off([len(x["len"]) for x in c]),
        cat([x["actor"] for x in c], i32), cat([x["ctr"] for x in c], i32),
        cat([x["pa"] for x in c], i32), cat([x["pc"] for x in c], i32),
        cat([np.arange(len(x["len"])) for x in c], i64),
        cat([x["len"] for x in c], i64), cat([x["slot"] for x in c], i64),
        off([4] * len(docs)), np.tile(np.arange(4, dtype=i64), len(docs)),
        off([len(x["len"]) for x in c]),
        cat([d["row_rank"] for d in docs], i32),
        cat([d["row_seq"] for d in docs], i32),
        off([len(d["index"]._runs) for d in docs]),
        np.asarray([len(r[0]) for r in tiers], i64),
        *(cat([r[k] for r in tiers], i64) for k in range(3)),
        np.asarray([-1 if d["mirror"] is None else len(d["mirror"].heads)
                    for d in docs], i64),
        *(cat([getattr(m, k) for m in mirrors], i64)
          for k in ("heads", "par", "hctr", "hactor")),
        np.asarray([d["n"] for d in docs], i64),
        np.asarray([int(x["len"].sum()) for x in c], i64),
        np.full(len(docs), relocate, np.uint8))
    return native.AxisPass(len(docs), compact, inputs)


@pytest.mark.parametrize("relocate", [False, True])
@pytest.mark.parametrize("compact", [12, 2])
@pytest.mark.parametrize("seed", range(4))
def test_axis_pass_matches_the_one_document_stages(seed, compact, relocate,
                                                   monkeypatch):
    """`native.AxisPass` against the one-document numpy code on seeded
    documents: its merge equals `BatchRangeIndex.merge` tier for tier
    (the doubling compaction and the tier lid), its lookup equals the
    staged index's exact probe, its mirror equals
    `SegmentMirror.apply_round`; with `relocate` every tier comes back
    as a copy."""
    from automerge_tpu_torch.engine.host_index import BatchRangeIndex
    from automerge_tpu_torch.engine.segments import SegmentMirror
    monkeypatch.setattr(BatchRangeIndex, "_COMPACT_TIERS", compact)
    docs = _axis_docs(seed)
    for d in docs:      # the reference under the lid in force
        c = d["cols"]
        d["staged"] = d["index"].merge(truns_pack(c["actor"], c["ctr"]),
                                       c["len"], c["slot"])
    p = _axis_pass(docs, compact, relocate)
    try:
        keep, new_off, new_len, actor, slab = p.merge()
        looked = p.lookup()
        m_len, mslab = p.mirror()
    finally:
        p.close()
    o = m_o = r0 = 0
    parent_slot, win_actor, win_seq, elem_base, n_breaks = looked
    for i, d in enumerate(docs):
        c, want = d["cols"], d["staged"]
        runs = d["index"]._runs[: keep[i]]
        assert not relocate or keep[i] == 0
        for k in range(new_off[i], new_off[i + 1]):
            runs += (tuple(row[o: o + new_len[k]] for row in slab),)
            o += new_len[k]
        assert len(runs) == len(want._runs)
        for got_run, want_run in zip(runs, want._runs):
            for x, y in zip(got_run, want_run):
                np.testing.assert_array_equal(x, y)
        K = len(c["len"])
        sl = slice(r0, r0 + K)
        r0 += K
        np.testing.assert_array_equal(actor[sl], c["actor"])
        head = c["pa"] < 0
        keys = truns_pack(np.where(head, 0, c["pa"]), c["pc"])
        slots, found = want.lookup(keys)
        assert (found | head).all()
        np.testing.assert_array_equal(parent_slot[sl],
                                      np.where(head, 0, slots))
        np.testing.assert_array_equal(parent_slot[sl], c["pslot"])
        np.testing.assert_array_equal(win_actor[sl], d["row_rank"])
        np.testing.assert_array_equal(win_seq[sl], d["row_seq"])
        np.testing.assert_array_equal(elem_base[sl],
                                      np.cumsum(c["len"]) - c["len"])
        assert n_breaks[i] == int((~head).sum())
        if d["mirror"] is None:
            assert m_len[i] == -1
            continue
        ref = d["mirror"].apply_round(
            c["slot"], c["pslot"], c["ctr"], c["actor"],
            d["n"] + int(c["len"].sum()), want.slot_to_key)
        got = SegmentMirror(*(row[m_o: m_o + m_len[i]] for row in mslab))
        m_o += m_len[i]
        for k in ("heads", "par", "hctr", "hactor"):
            np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                          err_msg=k)
    assert o == slab.shape[1] and m_o == mslab.shape[1]


@pytest.mark.parametrize("fault", ["duplicate", "unknown_parent",
                                   "mirror"])
def test_axis_pass_stops_where_the_one_document_code_raises(fault):
    """A planted overlap, an unknown parent, or a slot the index lacks
    (the mirror's slot -> key probe) in document 3: the stage the
    one-document code raises in returns None, naming document 3."""
    from automerge_tpu_torch.engine.host_index import (BatchRangeIndex,
                                                       DuplicateElemId)
    docs = _axis_docs(7)
    d = docs[3]
    c = d["cols"]
    if fault == "duplicate":
        first = d["index"].rows()
        c["actor"][0], c["ctr"][0] = first[0][0] >> 32, \
            first[0][0] & 0xFFFFFFFF
        with pytest.raises(DuplicateElemId):
            d["index"].merge(truns_pack(c["actor"], c["ctr"]), c["len"],
                             c["slot"])
    elif fault == "unknown_parent":
        c["pa"][0], c["pc"][0] = 1, 10 ** 6
    else:
        # a run after slot q - 1, where q continues a chain and the index
        # lacks q: the mirror's probe of q cannot resolve it
        q = min(set(range(2, d["n"] + 1)) - set(d["mirror"].heads.tolist()))
        starts, lens, slots = d["index"].rows()
        k = int(np.flatnonzero((slots <= q) & (q < slots + lens))[0])
        cut = q - slots[k]
        rows = [(starts[j], lens[j], slots[j]) for j in range(len(starts))
                if j != k]
        if cut:
            rows.append((starts[k], cut, slots[k]))
        if lens[k] - cut - 1:
            rows.append((starts[k] + cut + 1, lens[k] - cut - 1, q + 1))
        rows.sort()
        d["index"] = BatchRangeIndex.from_rows(*map(np.asarray, zip(*rows)))
        c["pslot"][0] = q - 1
        (c["pa"][0],), (c["pc"][0],) = d["index"].slot_to_key(
            np.asarray([q - 1]))
        staged = d["index"].merge(truns_pack(c["actor"], c["ctr"]),
                                  c["len"], c["slot"])
        with pytest.raises(KeyError):
            d["mirror"].apply_round(c["slot"], c["pslot"], c["ctr"],
                                    c["actor"], d["n"] + int(c["len"].sum()),
                                    staged.slot_to_key)
    p = _axis_pass(docs)
    try:
        stages = [p.merge, p.lookup, p.mirror]
        want = {"duplicate": 0, "unknown_parent": 1, "mirror": 2}[fault]
        for k, stage in enumerate(stages[: want + 1]):
            out = stage()
            assert (out is None) == (k == want), k
        assert p.STAGE_CODES[p.status] == fault and p.bad_doc == 3
    finally:
        p.close()


# --- the DocSet read's pass over the doc axis -----------------------------------

def _seg_mirror(rng, n_segs, siblings=0.0, breaks=0.0):
    """A seeded mirror of `n_segs` segments: sorted head slots after the
    virtual head, each head's parent an earlier slot, with share
    `siblings` at one shared parent slot (one parent segment, one attach
    offset) and share `breaks` at head - 1 (a chain break's parent);
    small counters and ranks, so sort keys tie often."""
    from automerge_tpu_torch.engine.segments import SegmentMirror
    heads = np.concatenate(([0], np.sort(rng.choice(
        np.arange(1, 8 * n_segs + 8), n_segs, replace=False))))
    par = np.zeros(n_segs + 1, np.int64)
    hub = int(rng.integers(0, heads[1])) if n_segs else 0
    for k in range(1, n_segs + 1):
        r = rng.random()
        if r < breaks and heads[k] > 1:
            par[k] = heads[k] - 1
        elif r < breaks + siblings:
            par[k] = min(hub, heads[k] - 1)
        else:
            par[k] = rng.integers(0, heads[k])
    hctr, hactor = rng.integers(1, 6, n_segs + 1), rng.integers(0, 4,
                                                               n_segs + 1)
    hctr[0] = hactor[0] = 0
    return SegmentMirror(heads.astype(np.int64), par,
                         hctr.astype(np.int64), hactor.astype(np.int64))


def _seg_rows(case, seed):
    """-> (mirrors, n_elems, S) for one case of the read pass's test."""
    from automerge_tpu_torch.engine.segments import SegmentMirror
    rng = np.random.default_rng(seed)
    sizes = {"random": rng.integers(0, 30, 40),
             "empty_and_one": rng.integers(0, 2, 24),
             "siblings": rng.integers(2, 40, 16),
             "chain_breaks": rng.integers(2, 40, 16),
             "full_bucket": np.append(rng.integers(0, 61, 12), 62),
             "n_elems": rng.integers(0, 20, 30),
             "long_rows": rng.integers(400, 480, 40)}[case]
    share = {"siblings": (0.9, 0.0), "chain_breaks": (0.0, 0.9)}.get(
        case, (0.2, 0.2))
    mirrors = [_seg_mirror(rng, int(n), *share) for n in sizes]
    if case == "empty_and_one":
        mirrors += [SegmentMirror.empty()] * 3
    tail = rng.integers(1, 6, len(mirrors))
    if case == "n_elems":
        tail = np.where(np.arange(len(mirrors)) % 2, tail,
                        rng.integers(2 ** 20, 2 ** 30, len(mirrors)))
    n_elems = [int(m.heads[-1] + t) if m.n_segs else 0
               for m, t in zip(mirrors, tail)]
    top = max(m.n_segs for m in mirrors) + 2
    return mirrors, n_elems, top if case == "full_bucket" else top + 7


def _segplan(mirrors, n_elems, S):
    keys = ("heads", "par", "hctr", "hactor")
    offsets = np.zeros((4, len(mirrors) + 1), np.int64)
    for row, k in zip(offsets, keys):
        row[1:] = np.cumsum([len(getattr(m, k)) for m in mirrors])
    return native.segplan_axis(
        offsets, *(np.concatenate([getattr(m, k) for m in mirrors])
                   for k in keys), n_elems, S)


@pytest.mark.parametrize("case", ["random", "empty_and_one", "siblings",
                                  "chain_breaks", "full_bucket", "n_elems",
                                  "long_rows"])
@pytest.mark.parametrize("seed", range(3))
def test_segplan_axis_matches_the_row_plans(case, seed):
    """`native.segplan_axis` against `SegmentMirror.plan(S, n_elems)`,
    `head_checksum()` and `aux_checksum()`, row for row, on seeded
    mirrors: empty and one-segment rows, many siblings at one parent and
    attach offset, chain-break heads, a row at n_segs + 2 == S, large
    and small `n_elems` in one call, rows of hundreds of segments."""
    mirrors, n_elems, S = _seg_rows(case, seed)
    plans, checks = _segplan(mirrors, n_elems, S)
    assert plans.shape == (len(mirrors), 4, S) and plans.dtype == np.int32
    for d, (m, n) in enumerate(zip(mirrors, n_elems)):
        np.testing.assert_array_equal(plans[d], m.plan(S, n), err_msg=d)
        assert checks[d].tolist() == [m.head_checksum(), m.aux_checksum()]
    if case == "full_bucket":
        assert mirrors[-1].n_segs + 2 == S


@pytest.mark.parametrize("fault", ["no_tree", "unsorted", "below_first_head",
                                   "falling_weights"])
@pytest.mark.parametrize("seed", range(3))
def test_segplan_axis_gives_the_rows_off_the_walk_the_empty_plan(fault, seed):
    """Rows no true mirror holds, among true ones: a parent at or past its
    own head, two segments swapped (unsorted heads, the checksums
    unchanged), a parent below the first head, or weights that do not
    rise along the walk (the last segment first among its siblings, with
    no or negative weight). The pass gives those rows the empty mirror's
    plan and checksums (n_segs 0, which the device's count of the row's
    segments refutes); every other row still equals its row plan."""
    from automerge_tpu_torch.engine.segments import SegmentMirror
    mirrors, n_elems, S = _seg_rows("random", seed)
    rng = np.random.default_rng(seed + 100)
    faulty = [d for d, m in enumerate(mirrors) if m.n_segs >= 2][::3]
    for d in faulty:
        m = mirrors[d].copy()
        k = int(rng.integers(1, m.n_segs))
        if fault == "no_tree":
            m.par[k] = m.heads[k] + rng.integers(0, 3)
        elif fault == "unsorted":
            for col in (m.heads, m.par, m.hctr, m.hactor):
                col[[k, k + 1]] = col[[k + 1, k]]
        elif fault == "below_first_head":
            m.par[k] = -1 - rng.integers(0, 3)
        else:
            m.par[-1], m.hctr[-1] = m.heads[1] - 1, 99
            n_elems[d] = int(m.heads[-1]) - 1 - int(rng.integers(0, 3))
        mirrors[d] = m
    plans, checks = _segplan(mirrors, n_elems, S)
    assert faulty
    empty = SegmentMirror.empty().plan(S, 0)
    for d, (m, n) in enumerate(zip(mirrors, n_elems)):
        if d in faulty:
            np.testing.assert_array_equal(plans[d], empty, err_msg=d)
            assert checks[d].tolist() == [0, 0]
        else:
            np.testing.assert_array_equal(plans[d], m.plan(S, n), err_msg=d)
            assert checks[d].tolist() == [m.head_checksum(),
                                          m.aux_checksum()]


@pytest.mark.parametrize("case", ["random", "long_rows"])
@pytest.mark.parametrize("fault", ["bucket", "unequal"])
def test_segplan_axis_raises_where_the_row_plan_raises(fault, case):
    """S below a row's n_segs + 2, or a row whose columns differ in
    length: `plan` raises on that row, and so does the pass, naming the
    first such row."""
    from automerge_tpu_torch.engine.segments import SegmentMirror
    mirrors, n_elems, S = _seg_rows(case, 5)
    big = max(range(len(mirrors)), key=lambda d: mirrors[d].n_segs)
    if fault == "unequal":
        big = len(mirrors) - 1 - big
    if fault == "bucket":
        S = mirrors[big].n_segs + 1
    else:
        m = mirrors[big]
        mirrors[big] = SegmentMirror(m.heads, m.par, m.hctr[:-1], m.hactor)
    with pytest.raises(ValueError):
        mirrors[big].plan(S, n_elems[big])
    with pytest.raises(ValueError, match=rf"row {big}\b"):
        _segplan(mirrors, n_elems, S)
