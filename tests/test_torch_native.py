"""The port's host codec (automerge_tpu_torch/native) against the JAX
package's native codec and the Python decoder, on the CPU.

Decoded batches must be identical field by field; the run walker must
equal `_detect_runs_numpy` of both packages bit for bit, unsharded and
sharded. A payload outside the codec's scope is declined and decoded by
the Python decoder; a failed build raises instead of falling back."""

import json

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


@pytest.mark.parametrize("indent", [None, 2])
@pytest.mark.parametrize("name", sorted(payloads()))
def test_decoder_matches_jax_native_and_python(name, indent):
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
    """`detect_runs_docs` over seeded documents (an empty one among them,
    bases of their own): one call, one walk unsharded, each document's
    cut equal to the numpy reference on it alone."""
    monkeypatch.setenv("AMTPU_PLAN_WORKERS", workers)
    monkeypatch.setattr(truns, "_SHARD_MIN_OPS", 64)
    monkeypatch.setattr("automerge_tpu_torch.engine.pipeline._POOL", None)
    docs = [random_ops(10 * seed + i) for i in range(5)]
    docs.insert(2, (_empty_cols(), 7))
    native.reset_counts()
    truns.detections["calls"] = 0
    plans = truns.detect_runs_docs([c for c, _ in docs],
                                   [b for _, b in docs])
    assert truns.detections["calls"] == 1
    assert (native.walks["native"] > 1) == (workers == "3")
    assert len(plans) == len(docs)
    for (cols, base), plan in zip(docs, plans):
        assert_plans_equal(plan, truns._detect_runs_numpy(*cols, base))
    assert truns.detect_runs_docs([], []) == []
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
