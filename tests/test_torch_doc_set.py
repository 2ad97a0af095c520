"""The port's DeviceTextDocSet (automerge_tpu_torch, device="cpu") against
the JAX package's DeviceTextDocSet.

The twins of tests/test_doc_set_engine.py (all but the mesh-sharded case:
the port has no mesh yet): the same change streams go through both sets,
and the texts, the stacked tables' live prefixes (slots 0..n_elems of
every stacked row — the dense expansion writes past the live region of
inactive rows), every row's meta (clock, actor table, counts, elemId
index, segment mirror) and the graduated documents must be equal, with
zero tolerance."""

import numpy as np
import pytest
import torch

from automerge_tpu.engine import DeviceTextDocSet as JSet
from automerge_tpu.engine import TextChangeBatch as JBatch
from automerge_tpu_torch import state
from automerge_tpu_torch.engine import DeviceTextDoc as TDoc
from automerge_tpu_torch.engine import DeviceTextDocSet as TSet
from automerge_tpu_torch.engine import TextChangeBatch as TBatch
from automerge_tpu_torch.engine import stacked as TS

from test_doc_set_engine import typing_change

KEYS = ("parent", "ctr", "actor", "value", "has_value", "win_actor",
        "win_seq", "win_counter", "chain")


def both(ids, capacity=1024):
    return JSet(ids, capacity=capacity), TSet(ids, capacity=capacity,
                                               device="cpu")


def feed(jds, tds, changes_by_obj: dict):
    """One apply_batches call on each set with the same changes."""
    jds.apply_batches({o: JBatch.from_changes(c, o)
                       for o, c in changes_by_obj.items()})
    tds.apply_batches({o: TBatch.from_changes(c, o)
                       for o, c in changes_by_obj.items()})


def assert_sets_equal(jds, tds):
    assert tds.texts() == jds.texts()
    assert tds._cap == jds._cap
    assert sorted(tds._overlay) == sorted(jds._overlay)
    jd, td = jds._ensure_dev(), tds._ensure_dev()
    for d in range(jds.n_docs):
        jm, tm = jds._meta[d], tds._meta[d]
        assert tm.n_elems == jm.n_elems
        if d in jds._overlay:
            continue
        assert tm.clock == jm.clock
        assert tm.actor_table == jm.actor_table
        assert tm.all_ascii == jm.all_ascii
        assert tm.all_deps == jm.all_deps
        assert tm.seg_bound == jm.seg_bound
        for a, b in zip(tm.index.rows(), jm.index.rows()):
            np.testing.assert_array_equal(a, b)
        assert (tm.mirror is None) == (jm.mirror is None)
        if jm.mirror is not None:
            for k in ("heads", "par", "hctr", "hactor"):
                np.testing.assert_array_equal(getattr(tm.mirror, k),
                                              getattr(jm.mirror, k))
        n = jm.n_elems + 1
        for k in KEYS:
            a, b = np.asarray(jd[k]), td[k].numpy()
            assert b.dtype == a.dtype, k
            np.testing.assert_array_equal(b[d, :n], a[d, :n], err_msg=k)
    for d, jdoc in jds._overlay.items():
        tdoc = tds._overlay[d]
        assert tdoc.text() == jdoc.text()
        assert tdoc.clock == jdoc.clock
        assert tdoc.conflicts == jdoc.conflicts
        n = jdoc.n_elems + 1
        for k in KEYS:
            np.testing.assert_array_equal(
                tdoc._ensure_dev()[k].numpy()[:n],
                np.asarray(jdoc._ensure_dev()[k])[:n], err_msg=k)


def test_bulk_build_matches_single_doc():
    ids = [f"d{i}" for i in range(5)]
    jds, tds = both(ids)
    changes = {obj: [typing_change(f"actor-{a}", 1, f"doc{i}text{a}",
                                   obj=obj) for a in range(3)]
               for i, obj in enumerate(ids)}
    feed(jds, tds, changes)
    texts = tds.texts()
    for obj in ids:
        assert texts[obj] == TDoc(obj, device="cpu").apply_changes(
            changes[obj]).text()
    assert_sets_equal(jds, tds)


def test_incremental_rounds_and_graduation():
    ids = ["a", "b"]
    jds, tds = both(ids)
    feed(jds, tds, {o: [typing_change("w", 1, "hello", obj=o)] for o in ids})
    assert tds.texts() == {"a": "hello", "b": "hello"}
    ch = {"actor": "w", "seq": 2, "deps": {}, "ops":
          [{"action": "del", "obj": "a", "key": "w:5"}]}
    feed(jds, tds, {"a": [ch]})
    assert tds.texts() == {"a": "hell", "b": "hello"}
    feed(jds, tds, {o: [typing_change(
        "w", 3 if o == "a" else 2, "!!", start_ctr=6,
        after="w:4" if o == "a" else "w:5", obj=o)] for o in ids})
    assert tds.texts() == {"a": "hell!!", "b": "hello!!"}
    assert_sets_equal(jds, tds)


def test_unicode_docset():
    jds, tds = both(["u"])
    feed(jds, tds, {"u": [typing_change("w", 1, "héllo", obj="u")]})
    assert tds.texts()["u"] == "héllo"
    assert_sets_equal(jds, tds)


def test_concurrent_actors_same_position():
    jds, tds = both(["x"])
    changes = [typing_change("aaa", 1, "123", obj="x"),
               typing_change("bbb", 1, "456", start_ctr=1, obj="x")]
    feed(jds, tds, {"x": changes})
    single = TDoc("x", device="cpu").apply_changes(changes)
    assert tds.texts()["x"] == single.text()
    assert_sets_equal(jds, tds)


def test_graduation_carries_causal_history():
    jds, tds = both(["g"])
    chA = typing_change("A", 1, "x", obj="g")
    chB = {"actor": "B", "seq": 1, "deps": {"A": 1}, "ops": [
        {"action": "ins", "obj": "g", "key": "A:1", "elem": 2},
        {"action": "set", "obj": "g", "key": "B:2", "value": "y"}]}
    feed(jds, tds, {"g": [chA]})
    feed(jds, tds, {"g": [chB]})
    ch0 = {"actor": "0", "seq": 1, "deps": {"B": 1}, "ops": [
        {"action": "set", "obj": "g", "key": "A:1", "value": "z"}]}
    feed(jds, tds, {"g": [ch0]})
    assert tds.texts()["g"] == "zy"
    assert tds.doc("g").conflicts_at(0) is None
    assert_sets_equal(jds, tds)


def test_duplicate_batch_is_noop_without_graduation():
    jds, tds = both(["dup"])
    ch = [typing_change("w", 1, "abc", obj="dup")]
    feed(jds, tds, {"dup": ch})
    feed(jds, tds, {"dup": ch})
    assert tds.texts()["dup"] == "abc"
    assert not tds._overlay
    assert_sets_equal(jds, tds)


def test_in_batch_duplicate_change_is_idempotent():
    jds, tds = both(["ib"])
    ch = typing_change("w", 1, "a", obj="ib")
    feed(jds, tds, {"ib": [ch, ch]})
    assert tds.texts()["ib"] == "a"
    assert_sets_equal(jds, tds)


def test_sequential_same_actor_batch_stays_fast():
    jds, tds = both(["sq"])
    feed(jds, tds, {"sq": [
        typing_change("w", 1, "ab", obj="sq"),
        typing_change("w", 2, "cd", start_ctr=3, after="w:2", obj="sq")]})
    assert tds.texts()["sq"] == "abcd"
    assert not tds._overlay
    assert_sets_equal(jds, tds)


def random_rounds(seed, ids, n_rounds=3):
    """tests/test_doc_set_engine.py's random docsets: per round and doc,
    1-3 concurrent typing actors over a shared causal frontier."""
    rng = np.random.default_rng(seed)
    ctr = {o: 1 for o in ids}
    rounds = []
    for rnd in range(n_rounds):
        batches = {}
        for o in ids:
            n_act = int(rng.integers(1, 4))
            changes = []
            for a in range(n_act):
                text = "".join(chr(97 + int(c))
                               for c in rng.integers(0, 26, 8))
                changes.append(typing_change(
                    f"w{a}", rnd + 1, text, start_ctr=ctr[o], obj=o,
                    deps={f"w{i}": rnd for i in range(n_act)} if rnd else {}))
            ctr[o] += 8
            batches[o] = changes
        rounds.append(batches)
    return rounds


@pytest.mark.parametrize("seed", range(3))
def test_random_docsets_match_jax(seed):
    ids = [f"r{i}" for i in range(4)]
    jds, tds = both(ids)
    for batches in random_rounds(seed, ids):
        feed(jds, tds, batches)
    assert_sets_equal(jds, tds)


def test_docset_mirrors_track_chain_bits():
    ids = ["m0", "m1"]
    jds, tds = both(ids)
    for rnd, start in ((1, 1), (2, 100)):
        feed(jds, tds, {o: [typing_change(
            f"w{a}", rnd, "abcd", start_ctr=start, obj=o,
            after=None if rnd == 1 else "w0:2",
            deps={} if rnd == 1 else {f"w{i}": 1 for i in range(2)})
            for a in range(2)] for o in ids})
    tds.texts()
    chain = tds._ensure_dev()["chain"].numpy()
    for d in range(len(ids)):
        meta = tds._meta[d]
        dev_heads = 1 + np.flatnonzero(~chain[d, 1: meta.n_elems + 1])
        np.testing.assert_array_equal(meta.mirror.heads[1:], dev_heads)
    assert_sets_equal(jds, tds)


def test_docset_corrupted_mirror_self_heals():
    from automerge_tpu_torch.engine.segments import SegmentMirror
    jds, tds = both(["h0", "h1"])
    feed(jds, tds, {o: [typing_change("w0", 1, "hello", obj=o)]
                    for o in jds.obj_ids})
    good = tds.texts()
    for ds, mirror_cls in ((tds, SegmentMirror), (jds, None)):
        m = ds._meta[1].mirror
        cls = mirror_cls or type(m)
        ds._meta[1].mirror = cls(
            np.append(m.heads, 3), np.append(m.par, 2),
            np.append(m.hctr, 99), np.append(m.hactor, 0))
        ds._meta[1].mirror.heads.sort()
        ds._codes_cache = None
    assert tds.texts() == good            # healed via self-contained program
    chain = tds._ensure_dev()["chain"].numpy()
    for d in range(2):
        meta = tds._meta[d]
        dev_heads = 1 + np.flatnonzero(~chain[d, 1: meta.n_elems + 1])
        np.testing.assert_array_equal(meta.mirror.heads[1:], dev_heads)
    tds._codes_cache = None
    jds._codes_cache = None
    assert tds.texts() == good            # planned again
    assert_sets_equal(jds, tds)


def test_graduated_group_takes_stacked_executor(monkeypatch):
    """Two docs needing the general path in one call graduate together and
    merge through ONE stacked apply; a third stays on the fast tier."""
    monkeypatch.setenv("AMTPU_STACKED_MIN_OPS", "1")
    ids = ["p", "q", "r"]
    jds, tds = both(ids)
    feed(jds, tds, {o: [typing_change("w", 1, "hello", obj=o)] for o in ids})
    TS.LAST_STATS.clear()
    feed(jds, tds, {
        "p": [{"actor": "w", "seq": 2, "deps": {}, "ops": [
            {"action": "del", "obj": "p", "key": "w:2"}]}],
        "q": [{"actor": "v", "seq": 1, "deps": {"w": 1}, "ops": [
            {"action": "set", "obj": "q", "key": "w:1", "value": "J"}]}],
        "r": [typing_change("w", 2, "!", start_ctr=6, after="w:5",
                            obj="r")]})
    assert TS.LAST_STATS and TS.LAST_STATS["text_docs"] == 2
    assert sorted(tds._overlay) == [0, 1]
    assert tds.texts() == {"p": "hllo", "q": "Jello", "r": "hello!"}
    assert_sets_equal(jds, tds)


def test_graduated_doc_owns_its_tables():
    """A graduated document's tables are copies of its row: writing them
    in place changes neither the stacked tables nor another row."""
    jds, tds = both(["a", "b"])
    feed(jds, tds, {o: [typing_change("w", 1, "abc", obj=o)]
                    for o in ("a", "b")})
    before = {k: v.clone() for k, v in tds._ensure_dev().items()}
    doc = tds.doc("a")
    for t in doc._ensure_dev().values():
        t.fill_(1)
    for k, v in tds._ensure_dev().items():
        assert torch.equal(v, before[k]), k


def test_load_jax_docset_state_and_continue():
    """A JAX DocSet's state (stacked tables, row meta, a graduated doc)
    carried into the port continues bit-exact under the same rounds."""
    ids = [f"s{i}" for i in range(3)]

    def rnd(r):
        deps = {f"w{a}": r - 1 for a in range(2)} if r > 1 else {}
        return {o: [typing_change(f"w{a}", r, f"{o}r{r}a{a}",
                                  start_ctr=16 * r + 8 * a, obj=o,
                                  after="w0:16" if r > 1 else None,
                                  deps=deps) for a in range(2)]
                for o in ids}
    jds = JSet(ids)
    for r in (1, 2):
        jds.apply_batches({o: JBatch.from_changes(c, o)
                           for o, c in rnd(r).items()})
    jds.apply_batches({"s0": JBatch.from_changes([{
        "actor": "w0", "seq": 3, "deps": {"w1": 2}, "ops": [
            {"action": "del", "obj": "s0", "key": "w0:17"}]}], "s0")})
    tds = state.load_doc_set_state(TSet(ids, device="cpu"),
                                   state.doc_set_state(jds))
    assert_sets_equal(jds, tds)
    last = rnd(3)
    last["s0"] = [typing_change("w1", 3, "zz", start_ctr=99, after="w0:16",
                                deps={"w0": 3}, obj="s0")]
    feed(jds, tds, last)
    assert_sets_equal(jds, tds)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSet(["x"])


# --- the fast tier's one run walk over the round's doc axis ------------------

MIXED = ["base0", "chain", "base1", "base2", "head", "resid", "notready",
         "redeliv", "partial", "actors"]


def mixed_rounds():
    """Two rounds over MIXED. The second: runs-only documents on bases of
    0, 2, 4 and 7 elements (the 4's run continues the 2's counters, as
    one run would across the documents' boundary), runs at the head of a non-empty list, a residual
    delete (graduates), a change one seq ahead of the clock (not ready), a
    redelivered batch (skipped), a partial duplicate (general), and a new
    actor sorting after a document's two (its own actor table)."""
    redeliv = typing_change("w", 1, "re", obj="redeliv")
    partial = typing_change("w", 1, "pa", obj="partial")
    first = {
        "base0": [typing_change("w", 1, "ab", obj="base0")],
        "chain": [typing_change("w", 1, "abcd", obj="chain")],
        "base1": [typing_change("w", 1, "abcdefg", obj="base1")],
        "head": [typing_change("w", 1, "xyz", obj="head")],
        "resid": [typing_change("w", 1, "hello", obj="resid")],
        "notready": [typing_change("w", 1, "q", obj="notready")],
        "redeliv": [redeliv],
        "partial": [partial],
        "actors": [typing_change("zeta", 1, "zz", obj="actors"),
                   typing_change("alpha", 1, "aa", obj="actors")]}
    resid = typing_change("w", 2, "lo", start_ctr=6, after="w:5",
                          obj="resid")
    resid["ops"].append({"action": "del", "obj": "resid", "key": "w:1"})
    second = {
        "base0": [typing_change("w", 2, "cd", start_ctr=3, after="w:2",
                                obj="base0")],
        "chain": [typing_change("w", 2, "ef", start_ctr=5, after="w:4",
                                obj="chain")],
        "base1": [typing_change("w", 2, "hi", start_ctr=8, after="w:7",
                                obj="base1")],
        "base2": [typing_change("v", 1, "new", obj="base2")],
        "head": [typing_change("x", 1, "HH", obj="head", deps={"w": 1})],
        "resid": [resid],
        "notready": [typing_change("w", 3, "zz", start_ctr=2, after="w:1",
                                   obj="notready")],
        "redeliv": [redeliv],
        "partial": [partial, typing_change("w", 2, "rt", start_ctr=3,
                                           after="w:2", obj="partial")],
        "actors": [typing_change("zz-late", 1, "mm", start_ctr=3,
                                 after="zeta:2", obj="actors",
                                 deps={"zeta": 1, "alpha": 1})]}
    return first, second


def spy_walks(monkeypatch):
    """Record every doc-axis walk of the set: (columns, bases, plans)."""
    from automerge_tpu_torch.engine import doc_set, runs
    walks = []

    def spy(columns, base_elems):
        walk = runs.detect_runs_axis(columns, base_elems)
        walks.append((columns, list(base_elems), walk.cut()))
        return walk
    monkeypatch.setattr(doc_set, "detect_runs_axis", spy)
    return walks


def assert_mirror_checksums_equal(jds, tds):
    for d in range(jds.n_docs):
        jm, tm = jds._meta[d].mirror, tds._meta[d].mirror
        if d in jds._overlay or jm is None:
            continue
        assert tm.head_checksum() == jm.head_checksum(), d
        assert tm.aux_checksum() == jm.aux_checksum(), d


def test_one_walk_cuts_equal_per_document_detection(monkeypatch):
    """Each document's cut of the round's one walk equals the numpy
    reference on that document alone, bit for bit; only the ready
    documents are walked; texts, graduations, index rows and mirrors
    equal the JAX package's DocSet after the same rounds."""
    from automerge_tpu_torch.engine.runs import _detect_runs_numpy
    from test_torch_native import assert_plans_equal
    walks = spy_walks(monkeypatch)
    jds, tds = both(MIXED)
    first, second = mixed_rounds()
    feed(jds, tds, first)
    bases = {o: tds._meta[tds._idx[o]].n_elems for o in MIXED}
    feed(jds, tds, second)
    assert len(walks) == 2
    for columns, base_elems, plans in walks:
        assert len(columns) == len(base_elems) == len(plans)
        for cols, base, plan in zip(columns, base_elems, plans):
            assert_plans_equal(plan, _detect_runs_numpy(*cols, base))
    columns, base_elems, plans = walks[1]
    walked = ["base0", "chain", "base1", "base2", "head", "resid", "actors"]
    assert base_elems == [bases[o] for o in walked] == [2, 4, 7, 0, 3, 5, 4]
    assert [p.n_ops for p in plans] == [
        len(TBatch.from_changes(second[o], o).op_kind) for o in walked]
    assert [p.n_runs for p in plans] == [1] * len(walked)
    assert len(plans[walked.index("resid")].rpos) == 1
    assert sorted(tds.obj_ids[d] for d in tds._overlay) == [
        "notready", "partial", "resid"]
    assert_sets_equal(jds, tds)
    assert_mirror_checksums_equal(jds, tds)


def test_sharded_walk_cuts_equal_the_unsharded(monkeypatch):
    """Past `_SHARD_MIN_OPS` the round's walk shards across the planner
    pool at change boundaries (document boundaries among them): the same
    per-document plans, and the same sets."""
    from automerge_tpu_torch import native
    from automerge_tpu_torch.engine import runs
    from test_torch_native import assert_plans_equal
    first, second = mixed_rounds()
    plain = spy_walks(monkeypatch)
    jds, tds = both(MIXED)
    for r in (first, second):
        feed(jds, tds, r)
    monkeypatch.setenv("AMTPU_PLAN_WORKERS", "3")
    monkeypatch.setattr(runs, "_SHARD_MIN_OPS", 8)
    monkeypatch.setattr("automerge_tpu_torch.engine.pipeline._POOL", None)
    sharded = spy_walks(monkeypatch)
    sds = TSet(MIXED, device="cpu")
    native.reset_counts()
    for r in (first, second):
        sds.apply_batches({o: TBatch.from_changes(c, o)
                           for o, c in r.items()})
    assert native.walks["native"] > len(sharded) == len(plain) == 2
    for (_, _, a), (_, _, b) in zip(plain, sharded):
        assert len(a) == len(b)
        for pa, pb in zip(a, b):
            assert_plans_equal(pb, pa)
    assert_sets_equal(jds, sds)
    assert_mirror_checksums_equal(jds, sds)


def _state(ds) -> list:
    """Every row's clock, index rows, mirror arrays and element count."""
    out = []
    for m in ds._meta:
        mirror = (None if m.mirror is None else
                  [getattr(m.mirror, k).copy()
                   for k in ("heads", "par", "hctr", "hactor")])
        out.append((dict(m.clock), [r.copy() for r in m.index.rows()],
                    mirror, m.n_elems))
    return out


def _assert_state_equal(a, b):
    for (ca, ia, ma, na), (cb, ib, mb, nb) in zip(a, b, strict=True):
        assert ca == cb and na == nb
        for x, y in zip(ia, ib, strict=True):
            np.testing.assert_array_equal(x, y)
        assert (ma is None) == (mb is None)
        for x, y in zip(ma or (), mb or (), strict=True):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fault", ["duplicate", "unknown_parent"])
def test_round_error_names_its_document_and_touches_no_state(fault):
    """A duplicate element ID, or an unknown parent, in document k of a
    round raises the JAX DocSet's message naming document k, and leaves
    every document's clock, index, mirror and element count as they
    were."""
    ids = [f"e{i}" for i in range(5)]
    k = 3
    jds, tds = both(ids)
    feed(jds, tds, {o: [typing_change("w", 1, "abc", obj=o)] for o in ids})
    rnd = {o: [typing_change("w", 2, "de", start_ctr=4, after="w:3", obj=o)]
           for o in ids}
    if fault == "duplicate":
        rnd[ids[k]] = [typing_change("w", 2, "de", start_ctr=2, after="w:3",
                                     obj=ids[k])]
        message = f"Duplicate list element ID w:2 in {ids[k]}"
    else:
        rnd[ids[k]] = [typing_change("w", 2, "de", start_ctr=4,
                                     after="w:99", obj=ids[k])]
        message = f"ins references unknown parent element in {ids[k]}"
    before = _state(tds)
    texts = tds.texts()
    for ds, B in ((jds, JBatch), (tds, TBatch)):
        with pytest.raises(ValueError) as err:
            ds.apply_batches({o: B.from_changes(c, o)
                              for o, c in rnd.items()})
        assert str(err.value) == message
    _assert_state_equal(_state(tds), before)
    assert not tds._overlay
    tds._codes_cache = None
    assert tds.texts() == texts


# --- the doc-axis pass ----------------------------------------------------------

def _round_plans(ds, batches):
    """The round as `_apply_batches` plans it, without committing: the
    doc-axis pass's plan (None: declined) and `_plan_fast` on each walked
    document alone ({doc: pack or None}, in walk order)."""
    from automerge_tpu_torch.engine import runs
    walked = []
    for o, b in batches.items():
        d = ds._idx[o]
        if d not in ds._overlay and ds._ready(d, b, b.seqs.tolist()) is True:
            walked.append((d, b))
    cols = [(b.op_kind, b.op_target_actor, b.op_target_ctr,
             b.op_parent_actor, b.op_parent_ctr, b.op_value, b.op_change)
            for _, b in walked]
    bases = [ds._meta[d].n_elems for d, _ in walked]
    fast = ds._plan_axis(walked, runs.detect_runs_axis(cols, bases))
    ref = {d: ds._plan_fast(d, b, plan) for (d, b), plan
           in zip(walked, runs.detect_runs_axis(cols, bases).cut())}
    return fast, ref


def assert_axis_plan_equal(fast, ref):
    """Every document the pass planned: its descriptors, blob, staged
    index (tier for tier, read-only), mirror, clock, closures, ascii flag
    and interning equal `_plan_fast`'s on it alone; the rest are the
    documents `_plan_fast` sends to the general path."""
    from automerge_tpu_torch.engine.doc_set import _FastRound
    assert fast.docs == [d for d, p in ref.items() if p is not None]
    r0 = b0 = 0
    for i, d in enumerate(fast.docs):
        p = ref[d]
        nr, npr = p["n_runs"], p["n_pairs"]
        assert (fast.n_runs[i], fast.n_pairs[i], fast.n_breaks[i]) == (
            nr, npr, p["n_breaks"])
        for k in _FastRound._RUN_KEYS:
            got, want = getattr(fast, k)[r0: r0 + nr], np.asarray(p[k])
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
        np.testing.assert_array_equal(fast.blob[b0: b0 + npr], p["blob"])
        assert fast.blob.dtype == p["blob"].dtype
        r0, b0 = r0 + nr, b0 + npr
        index, mirror, clock, deps, ascii_, actors = fast.staged[i]
        want = p["staged_index"]
        assert index.n_ranges == want.n_ranges
        assert len(index._runs) == len(want._runs)
        for got_run, want_run in zip(index._runs, want._runs):
            for x, y in zip(got_run, want_run, strict=True):
                assert x.dtype == y.dtype and not x.flags.writeable
                np.testing.assert_array_equal(x, y)
        for x, y in zip(index.rows(), want.rows(), strict=True):
            np.testing.assert_array_equal(x, y)
        assert (mirror is None) == (p["staged_mirror"] is None)
        for k in ("heads", "par", "hctr", "hactor"):
            if mirror is not None:
                x, y = getattr(mirror, k), getattr(p["staged_mirror"], k)
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y, err_msg=k)
        assert clock == p["staged_clock"]
        assert deps == p["staged_all_deps"]
        assert ascii_ == p["staged_ascii"]
        assert actors == p["staged_actors"]
    if fast.docs:
        assert r0 == len(fast.ctr0) and b0 == len(fast.blob)


AXIS_ACTORS = ("w0", "w1", "w2", "w3")


def axis_rounds(seed, ids, n_rounds=24):
    """Seeded rounds for the doc-axis pass. Round 0 interns every actor
    of AXIS_ACTORS in every document, each typing one run from the head.
    Later, per round and document, 1-3 distinct actors each send one
    change of one or two typing runs, every run after a random element
    of the earlier rounds or at the head; concurrent changes start at
    the same counter, past every counter before, so a run inserted
    inside a chain breaks it. Each change depends on the clock the round
    started from."""
    rng = np.random.default_rng(seed)
    elems = {o: [] for o in ids}
    top = {o: 0 for o in ids}
    seqs = {o: {} for o in ids}
    rounds = []
    for rnd in range(n_rounds):
        batches = {}
        for o in ids:
            clock = dict(seqs[o])
            authors = (AXIS_ACTORS if rnd == 0 else rng.choice(
                AXIS_ACTORS, size=int(rng.integers(1, 4)), replace=False))
            changes, minted, high = [], [], top[o]
            for actor in map(str, authors):
                ctr, ops = top[o], []
                for _ in range(1 if rnd == 0 else int(rng.integers(1, 3))):
                    k = int(rng.integers(0, len(elems[o]) + 1))
                    text = "".join(chr(97 + int(c)) for c in
                                   rng.integers(0, 26, int(rng.integers(1, 6))))
                    ops += typing_change(
                        actor, 1, text, start_ctr=ctr + 1, obj=o,
                        after=elems[o][k] if k < len(elems[o]) else None)["ops"]
                    minted += [f"{actor}:{ctr + 1 + j}" for j in
                               range(len(text))]
                    ctr += len(text)
                high = max(high, ctr)
                seq = seqs[o].get(actor, 0) + 1
                seqs[o][actor] = seq
                changes.append({"actor": actor, "seq": seq, "ops": ops,
                                "deps": {a: s for a, s in clock.items()
                                         if a != actor}})
            top[o] = high
            elems[o] += minted
            batches[o] = changes
        rounds.append(batches)
    return rounds


@pytest.mark.parametrize("seed", range(3))
def test_axis_pass_equals_per_document_planning(seed):
    """On MIXED's rounds and on seeded rounds (HEAD parents, several runs
    a document, chain breaks resolved through the staged index's slot
    map, a late actor that keeps the order and one that changes it, a
    redelivery, a row whose mirror is gone, documents of many tiers),
    the doc-axis pass plans every fast-tier document exactly as
    `_plan_fast` does on it alone, and the sets equal the JAX package's
    DocSet after the same rounds."""
    from automerge_tpu_torch.engine import doc_set
    doc_set.reset_axis_plans()
    jds, tds = both(MIXED)
    for rnd in mixed_rounds():
        fast, ref = _round_plans(tds, {o: TBatch.from_changes(c, o)
                                       for o, c in rnd.items()})
        assert_axis_plan_equal(fast, ref)
        feed(jds, tds, rnd)
    assert_sets_equal(jds, tds)

    ids = [f"x{i}" for i in range(6)]
    rounds = axis_rounds(seed, ids)
    rounds[8]["x3"].append(typing_change(
        "z-late", 1, "zz", start_ctr=500, obj="x3",
        deps={a: 1 for a in AXIS_ACTORS}))
    rounds[10]["x4"].append(typing_change(
        "a-late", 1, "aa", start_ctr=600, obj="x4",
        deps={a: 1 for a in AXIS_ACTORS}))
    rounds.insert(12, {"x2": rounds[11]["x2"]})    # a redelivery
    jds, tds = both(ids)
    breaks = 0
    for r, rnd in enumerate(rounds):
        if r == 6:
            tds._meta[1].mirror = None
        before = [None if m.mirror is None else m.mirror.n_segs
                  for m in tds._meta]
        fast, ref = _round_plans(tds, {o: TBatch.from_changes(c, o)
                                       for o, c in rnd.items()})
        assert_axis_plan_equal(fast, ref)
        if r == 10:
            assert tds._idx["x4"] not in fast.docs     # the order change
        if r == 12:
            assert not ref and not fast.docs           # skipped
        for i, d in enumerate(fast.docs):
            m = fast.staged[i][1]
            if m is not None and before[d] is not None:
                breaks += m.n_segs - before[d] > fast.n_runs[i]
        feed(jds, tds, rnd)
        if 6 <= r < 20:
            assert tds._meta[1].mirror is None
    assert breaks > 0
    assert sorted(tds.obj_ids[d] for d in tds._overlay) == ["x4"]
    tiers = [len(m.index._runs) for m in tds._meta]
    assert max(tiers) >= 3
    assert max(len(m.index._runs[0][0]) for m in tds._meta) >= 16
    assert doc_set.axis_plans["declined"] == 0
    assert doc_set.axis_plans["rounds"] == 2 * (2 + len(rounds) - 1)
    assert_sets_equal(jds, tds)
    assert_mirror_checksums_equal(jds, tds)


@pytest.mark.parametrize("first", ["duplicate", "unknown_parent"])
def test_axis_pass_declines_a_faulty_round_to_the_per_document_error(first):
    """Faults in documents 1 and 3 of a round (a duplicate element id,
    an unknown parent; each kind first in turn): the pass declines the
    round, the per-document planner raises the message `_plan_fast`
    gives on document 1 alone, and no document's state moves."""
    from automerge_tpu_torch.engine import doc_set, runs
    ids = [f"e{i}" for i in range(5)]
    tds = TSet(ids, device="cpu")
    tds.apply_batches({o: TBatch.from_changes(
        [typing_change("w", 1, "abc", obj=o)], o) for o in ids})
    faults = {
        "duplicate": lambda o: typing_change("w", 2, "de", start_ctr=2,
                                             after="w:3", obj=o),
        "unknown_parent": lambda o: typing_change("w", 2, "de", start_ctr=4,
                                                  after="w:99", obj=o)}
    second = next(k for k in faults if k != first)
    rnd = {o: [typing_change("w", 2, "de", start_ctr=4, after="w:3", obj=o)]
           for o in ids}
    rnd[ids[1]], rnd[ids[3]] = [faults[first](ids[1])], \
        [faults[second](ids[3])]
    batches = {o: TBatch.from_changes(c, o) for o, c in rnd.items()}
    b1 = batches[ids[1]]
    plan = runs.detect_runs_axis(
        [(b1.op_kind, b1.op_target_actor, b1.op_target_ctr,
          b1.op_parent_actor, b1.op_parent_ctr, b1.op_value, b1.op_change)],
        [tds._meta[1].n_elems]).cut()[0]
    with pytest.raises(ValueError) as alone:
        tds._plan_fast(1, b1, plan)
    before = _state(tds)
    doc_set.reset_axis_plans()
    with pytest.raises(ValueError) as err:
        tds.apply_batches(batches)
    assert str(err.value) == str(alone.value)
    assert ids[1] in str(err.value)
    assert doc_set.axis_plans == {"rounds": 0, "docs": 0, "declined": 1}
    _assert_state_equal(_state(tds), before)
    assert not tds._overlay


def test_axis_pass_declines_a_failed_mirror_to_the_degraded_row(caplog):
    """A row whose index lacks a slot its round's chain-break probe
    needs: the pass declines the round, the per-document planner logs
    its warning and degrades only that row's mirror to None; the round
    goes on, and the read serves every text as the JAX DocSet does."""
    from automerge_tpu_torch.engine import doc_set
    from automerge_tpu_torch.engine.host_index import BatchRangeIndex
    ids = ["f0", "f1", "f2"]
    jds, tds = both(ids)
    feed(jds, tds, {o: [typing_change("w", 1, "abcd", obj=o)] for o in ids})
    # f1's index without w:3 (slot 3): an insert after w:2 probes slot 3
    tds._meta[1].index = BatchRangeIndex.from_rows(
        [tds._meta[1].index.rows()[0][0], tds._meta[1].index.rows()[0][0]
         + 3], [2, 1], [1, 4])
    doc_set.reset_axis_plans()
    rnd = {o: [typing_change("x", 1, "xy", start_ctr=10, after="w:2",
                             obj=o, deps={"w": 1})] for o in ids}
    with caplog.at_level("WARNING"):
        tds.apply_batches({o: TBatch.from_changes(c, o)
                           for o, c in rnd.items()})
    assert doc_set.axis_plans["declined"] == 1
    assert "segment-mirror planning failed for f1" in caplog.text
    assert [m.mirror is None for m in tds._meta] == [False, True, False]
    jds.apply_batches({o: JBatch.from_changes(c, o) for o, c in rnd.items()})
    assert tds.texts() == jds.texts()


def _held(ds) -> int:
    """Bytes of the pass's slabs still alive."""
    return sum(r().nbytes for r in ds._slabs if r() is not None)


@pytest.mark.parametrize("slack", [0, None])
def test_axis_pass_moves_rows_a_round_left_behind(slack):
    """Rounds that leave documents behind one by one: each idle row
    keeps the slab of its last round alive, with the other rows' states
    of that round in it. With no slack the pass moves every row's state
    into its own slabs once they hold more than twice the rows' state, so
    the slabs stay bounded; with the default slack (far above this set)
    nothing moves and they pile up. Either way the sets equal the JAX
    package's DocSet."""
    ids = [f"s{i:02d}" for i in range(12)]
    jds, tds = both(ids)
    if slack is not None:
        tds._SLAB_SLACK = slack
    feed(jds, tds, {o: [typing_change("w", 1, "abcdef" * 4, obj=o)]
                    for o in ids})
    held = []
    for r in range(1, 12):
        feed(jds, tds, {o: [typing_change(
            "w", r + 1, "xy", start_ctr=23 + 2 * r, after=f"w:{r + 3}",
            obj=o)] for o in ids[r:]})
        held.append(_held(tds) / sum(tds._state_bytes))
    assert not tds._overlay
    if slack is None:
        assert held[-1] > 4
    else:
        assert max(held) < 4
    assert_sets_equal(jds, tds)
    assert_mirror_checksums_equal(jds, tds)


def test_texts_plans_every_row_in_one_read_pass(monkeypatch, caplog):
    """After a build and seeded append rounds: `texts()` equals the JAX
    package's DocSet after each round; the plans it hands the planned
    materialization equal the stacked per-row `SegmentMirror.plan`, at S
    = the largest mirror's n_segs + 2, bucketed; `axis_reads` counts one
    planned read a call. A planted divergent mirror (one row's `hctr`
    altered) takes the heal path: the row is rebuilt from its chain bits,
    the call is served by the self-contained program and counted under
    `self_contained`, and the next call is planned again. A planted
    mirror the pass cannot plan but whose checksums are the device's (two
    segments swapped) takes the heal path too: the pass gives it the
    empty mirror's plan, whose segment count the device refutes.
    A set with a graduated (overlay) row reads through the pass too, its
    row riding on the empty mirror's plan. The pass reads the round's
    mirror slab in place while every row's mirror is a view of it, and
    copies the rows' mirrors otherwise (the planted rows, the graduated
    row): the plans are the same either way."""
    from automerge_tpu_torch.engine import doc_set
    from automerge_tpu_torch.engine.segments import SegmentMirror
    from automerge_tpu_torch.ops import ingest
    handed = []
    planned_r = ingest.materialize_codes_planned_r

    def spy(*args, **kw):
        handed.append(args[7].cpu().numpy())
        return planned_r(*args, **kw)
    monkeypatch.setattr(ingest, "materialize_codes_planned_r", spy)

    def row_plans(ds, S):
        empty = SegmentMirror.empty()
        return np.stack([
            empty.plan(S, 0) if d in ds._overlay
            else ds._meta[d].mirror.plan(S, ds._meta[d].n_elems)
            for d in range(ds.n_docs)])

    ids = [f"t{i}" for i in range(6)]
    jds, tds = both(ids)
    doc_set.reset_axis_reads()
    rounds = axis_rounds(3, ids, n_rounds=8)
    for r, rnd in enumerate(rounds):
        feed(jds, tds, rnd)
        slab = tds._mirror_slab[0]()           # every row, in order
        assert all(m.mirror.hactor.base is slab for m in tds._meta)
        assert tds.texts() == jds.texts(), r
        S = handed[-1].shape[-1]
        assert S == ingest.bucket(
            max(m.mirror.n_segs for m in tds._meta) + 2, 64)
        np.testing.assert_array_equal(handed[-1], row_plans(tds, S))
    n = len(rounds)
    assert len(handed) == n
    assert max(m.mirror.n_segs for m in tds._meta) > 4
    assert doc_set.axis_reads == {"planned": n, "rows": n * len(ids),
                                  "self_contained": 0}

    good = tds.texts()
    m = tds._meta[2].mirror.copy()
    m.hctr[1] += 1
    tds._meta[2].mirror = m
    tds._codes_cache = None
    assert tds.texts() == good            # healed, self-contained
    assert "segment mirror diverged for doc-set rows [2]" in caplog.text
    assert len(handed) == n + 1
    assert doc_set.axis_reads == {"planned": n, "rows": (n + 1) * len(ids),
                                  "self_contained": 1}
    assert_sets_equal(jds, tds)           # the rebuilt mirror is the true one
    tds._codes_cache = None
    assert tds.texts() == good            # planned again
    assert len(handed) == n + 2
    assert doc_set.axis_reads["planned"] == n + 1
    assert doc_set.axis_reads["self_contained"] == 1

    m = tds._meta[3].mirror.copy()
    assert m.n_segs >= 2
    sums = (m.head_checksum(), m.aux_checksum())
    for col in (m.heads, m.par, m.hctr, m.hactor):
        col[[1, 2]] = col[[2, 1]]
    assert (m.head_checksum(), m.aux_checksum()) == sums
    tds._meta[3].mirror = m
    tds._codes_cache = None
    assert tds.texts() == good            # off the walk: healed
    assert "segment mirror diverged for doc-set rows [3]" in caplog.text
    assert (np.diff(tds._meta[3].mirror.heads) > 0).all()
    assert len(handed) == n + 3
    assert doc_set.axis_reads["planned"] == n + 1
    assert doc_set.axis_reads["self_contained"] == 2

    clock = dict(tds._meta[tds._idx["t4"]].clock)
    ch = {"actor": "w0", "seq": clock["w0"] + 1, "deps": clock, "ops":
          [{"action": "del", "obj": "t4", "key": "w0:1"}]}
    before = tds.texts()["t4"]
    feed(jds, tds, {"t4": [ch]})
    assert sorted(tds._overlay) == [tds._idx["t4"]]
    assert tds.texts() == jds.texts()
    assert len(tds.texts()["t4"]) == len(before) - 1
    np.testing.assert_array_equal(handed[-1],
                                  row_plans(tds, handed[-1].shape[-1]))
    assert doc_set.axis_reads["planned"] == n + 2
    assert doc_set.axis_reads["self_contained"] == 2
    assert_sets_equal(jds, tds)
