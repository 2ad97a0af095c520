"""The port's streaming ring (automerge_tpu_torch engine/pipeline.py) and
its in-place commits, on the CPU.

- The ring against the JAX package's ring and against serial
  `apply_batch`, over depth x donation: text, scalars, live table
  prefixes, conflicts and ring stats are equal (zero tolerance).
- Twins of tests/test_pipeline.py's ring-contract tests, run on the port:
  overlap, chained plans, generation checks, fallback and re-chain, the
  context-exit flush, the closed ring, the remap serial path.
- In-place rounds (the round programs' `store=`, `TableStore`) against
  the out-of-place rounds on every round shape, bit for bit, keeping the
  tables' storage when the capacity is unchanged; and the donation
  contract: a commit failing after its first in-place write loses the
  document, one failing before any write leaves it usable.
"""

import threading

import numpy as np
import pytest
import torch

import bench as B
from automerge_tpu.engine import DeviceTextDoc as JDoc
from automerge_tpu.engine import PipelinedIngestor as JRing
from automerge_tpu_torch.engine import DeviceTextDoc as TDoc
from automerge_tpu_torch.engine import PipelinedIngestor
from automerge_tpu_torch.engine import TextChangeBatch as TBatch
from automerge_tpu_torch.ops import fused_round as F
from automerge_tpu_torch.ops import ingest as I
from test_torch_soak_docs import threads_checked

KEYS = TDoc._TABLE_KEYS


@pytest.fixture(autouse=True)
def no_leaked_threads():
    """A test that leaves a new live thread behind fails, naming it."""
    with threads_checked():
        yield


def as_port(batch):
    return TBatch(**{k: getattr(batch, k)
                     for k in batch.__dataclass_fields__})


def fresh_doc(n=4000, cls=TDoc):
    d = cls("t") if cls is JDoc else cls("t", device="cpu")
    d.eager_materialize = True
    base = B.base_batch("t", n)
    d.apply_batch(base if cls is JDoc else as_port(base))
    d.text()
    return d


def halves(n=4000, k=3, port=True):
    out = [B.merge_batch("t", 40, 30, n, seed=s + 1, actor_prefix=f"p{s}")
           for s in range(k)]
    return [as_port(b) for b in out] if port else out


def extra_batch():
    return as_port(B.merge_batch("t", 5, 10, 4000, seed=9,
                                 actor_prefix="zz"))


def tables_np(doc):
    live = doc.n_elems + 1
    return {k: np.asarray(doc._ensure_dev()[k])[:live] for k in KEYS}


def assert_same_state(a, b):
    """Port doc `b` against doc `a` (either engine)."""
    assert b.text() == a.text()
    np.testing.assert_array_equal(np.asarray(b._scalars()),
                                  np.asarray(a._scalars()))
    assert b.n_elems == a.n_elems
    assert b.conflicts == a.conflicts
    assert b.clock == a.clock
    ta, tb = tables_np(a), tables_np(b)
    for k in KEYS:
        assert tb[k].dtype == ta[k].dtype, k
        np.testing.assert_array_equal(tb[k], ta[k], err_msg=k)


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_ring_matches_jax_ring_and_serial(depth, donate, monkeypatch):
    from automerge_tpu.ops import ingest as JI
    if donate:
        monkeypatch.setattr(JI, "_DONATION", True)   # force on the CPU
    jbatches = halves(k=5, port=False)
    tbatches = [as_port(b) for b in jbatches]
    serial = fresh_doc()
    for h in tbatches:
        serial.apply_batch(h)
    jdoc = fresh_doc(cls=JDoc)
    with JRing(jdoc, slots=depth, donate=donate) as ring:
        ring.run(jbatches)
        jstats = ring.stats
    tdoc = fresh_doc()
    with PipelinedIngestor(tdoc, slots=depth, donate=donate) as ring:
        assert tdoc.donate_buffers is donate
        ring.run(tbatches)
        tstats = ring.stats
    assert tdoc.donate_buffers is False               # restored on close
    assert tstats == jstats
    assert tstats["committed"] == 5 and tstats["fallbacks"] == 0
    assert tstats["per_commit_budget"]["dispatches_max"] <= 3
    assert tstats["per_commit_budget"]["syncs_max"] <= 1
    assert_same_state(jdoc, tdoc)
    assert_same_state(serial, tdoc)
    assert tdoc.dispatch_stats["last_commit"] == \
        jdoc.dispatch_stats["last_commit"]


# ------------------------------------------------------ ring contract twins

def test_prepare_overlaps_the_commit_before_it():
    """The worker plans batch k+1 while the caller commits batch k: the
    first commit waits until the next batch's prepare has finished on
    the worker thread."""
    hs = halves(k=3)
    doc = fresh_doc()
    prepared = []
    planned_next = threading.Event()
    prep, commit = doc.prepare_batch, doc.commit_prepared

    def prepare_batch(batch, after=None):
        plan = prep(batch, after=after)
        prepared.append(threading.current_thread().name)
        if len(prepared) == 2:
            planned_next.set()
        return plan

    def commit_prepared(plan):
        if not planned_next.is_set():
            assert planned_next.wait(30), "no prepare ran under the commit"
        return commit(plan)

    doc.prepare_batch = prepare_batch
    doc.commit_prepared = commit_prepared
    with PipelinedIngestor(doc, slots=2) as ring:
        ring.run(hs)
        st = ring.stats
    assert prepared[:2] == ["amtpu-pipeline"] * 2
    assert st["chained_prepares"] == 2
    control = fresh_doc()
    for h in hs:
        control.apply_batch(h)
    assert doc.text() == control.text()


def test_chained_prepare_matches_apply():
    hs = halves(k=2)
    direct = fresh_doc()
    direct.apply_batch(hs[0])
    direct.apply_batch(hs[1])
    doc = fresh_doc()
    p1 = doc.prepare_batch(hs[0])
    p2 = doc.prepare_batch(hs[1], after=p1)
    doc.commit_prepared(p1)
    doc.commit_prepared(p2)
    assert doc.text() == direct.text()
    assert doc.elem_ids() == direct.elem_ids()


def test_commit_severs_chain_and_staged_buffers():
    hs = halves(k=2)
    doc = fresh_doc()
    p1 = doc.prepare_batch(hs[0])
    p2 = doc.prepare_batch(hs[1], after=p1)
    doc.commit_prepared(p1)
    assert p1.rounds == [] and p1.after is None
    doc.commit_prepared(p2)
    assert p2.rounds == [] and p2.after is None


def test_chained_plan_requires_base_commit():
    hs = halves(k=2)
    doc = fresh_doc()
    p1 = doc.prepare_batch(hs[0])
    p2 = doc.prepare_batch(hs[1], after=p1)
    with pytest.raises(ValueError, match="re-prepare"):
        doc.commit_prepared(p2)
    doc.commit_prepared(p1)
    doc.commit_prepared(p2)


def test_generation_mismatch_aborts_chained_plan():
    hs = halves(k=2)
    doc = fresh_doc()
    p1 = doc.prepare_batch(hs[0])
    p2 = doc.prepare_batch(hs[1], after=p1)
    doc.commit_prepared(p1)
    doc.apply_batch(extra_batch())              # outside mutation
    with pytest.raises(ValueError, match="re-prepare"):
        doc.commit_prepared(p2)
    doc.commit_prepared(doc.prepare_batch(hs[1]))


def test_pipeline_recovers_from_outside_mutation():
    hs = halves(k=2)
    extra = extra_batch()
    doc = fresh_doc()
    with PipelinedIngestor(doc) as ring:
        ring.feed(hs[0])
        ring.commit_next()
        doc.apply_batch(extra)                  # outside the ring
        ring.feed(hs[1])
        ring.flush()
    control = fresh_doc()
    for h in (hs[0], extra, hs[1]):
        control.apply_batch(h)
    assert doc.text() == control.text()


def test_pipeline_rechains_after_fallback():
    hs = halves(k=5)
    extra = extra_batch()
    doc = fresh_doc()
    with PipelinedIngestor(doc) as ring:
        ring.feed(hs[0])
        ring.commit_next()
        doc.apply_batch(extra)                  # the one violation
        for h in hs[1:]:
            ring.feed(h)
            ring.commit_next()
        st = ring.stats
    control = fresh_doc()
    for h in [hs[0], extra] + hs[1:]:
        control.apply_batch(h)
    assert doc.text() == control.text()
    assert st["fallbacks"] <= 2, st


def test_gen_mismatch_abort_mid_ring():
    hs = halves(k=6)
    extra = extra_batch()
    doc = fresh_doc()
    with PipelinedIngestor(doc, slots=4) as ring:
        for h in hs[:4]:
            ring.feed(h)                        # ring full
        ring.commit_next()
        doc.apply_batch(extra)                  # under 3 pending plans
        for h in hs[4:]:
            ring.feed(h)
        ring.flush()
        st = ring.stats
    assert st["fallbacks"] >= 1, st
    control = fresh_doc()
    for h in hs[:1] + [extra] + hs[1:]:
        control.apply_batch(h)
    assert doc.text() == control.text()
    assert doc.elem_ids() == control.elem_ids()


def test_context_exit_flushes_fed_batches():
    """A clean exit commits fed batches; feeding past the slot bound
    drains instead of deadlocking (4 feeds into 2 slots)."""
    hs = halves(k=4)
    doc = fresh_doc()
    with PipelinedIngestor(doc, slots=2) as ring:
        for h in hs:
            ring.feed(h)
    control = fresh_doc()
    for h in hs:
        control.apply_batch(h)
    assert doc.text() == control.text()


def test_single_slot_pipeline_degrades_serial():
    hs = halves(k=3)
    doc = fresh_doc()
    with PipelinedIngestor(doc, slots=1) as ring:
        ring.run(hs)
    control = fresh_doc()
    for h in hs:
        control.apply_batch(h)
    assert doc.text() == control.text()


def test_closed_pipeline_rejects_feed():
    doc = fresh_doc()
    ring = PipelinedIngestor(doc)
    ring.feed(halves(k=1)[0])
    ring.flush()
    ring.close()
    with pytest.raises(RuntimeError, match="closed"):
        ring.feed(halves(k=1)[0])


def test_chained_prepare_refuses_remap():
    doc = fresh_doc()
    p1 = doc.prepare_batch(as_port(B.merge_batch("t", 4, 10, 4000, seed=1,
                                                 actor_prefix="m")))
    low = as_port(B.merge_batch("t", 4, 10, 4000, seed=2,
                                actor_prefix="aa"))
    with pytest.raises(ValueError, match="chain"):
        doc.prepare_batch(low, after=p1)
    doc.commit_prepared(p1)
    doc.apply_batch(low)


def test_ring_takes_remapping_batch_serially():
    """A batch whose actors sort before the table cannot chain: the ring
    prepares it on the caller thread after the commit before it."""
    hs = [as_port(B.merge_batch("t", 6, 10, 4000, seed=s,
                                actor_prefix=p))
          for s, p in ((1, "m"), (2, "aa"), (3, "n"))]
    doc = fresh_doc()
    with PipelinedIngestor(doc, slots=3, donate=True) as ring:
        ring.run(hs)
        st = ring.stats
    assert st["serial_prepares"] == 1 and st["fallbacks"] == 0, st
    control = fresh_doc()
    for h in hs:
        control.apply_batch(h)
    assert_same_state(control, doc)


def test_k_deep_ring_matches_serial():
    hs = halves(k=8)
    serial = fresh_doc()
    for h in hs:
        serial.apply_batch(h)
    doc = fresh_doc()
    with PipelinedIngestor(doc, slots=6) as ring:
        ring.run(hs)
        st = ring.stats
    assert_same_state(serial, doc)
    assert st["depth"] == 6 and st["committed"] == 8
    assert st["chained_prepares"] == 7, st
    assert st["serial_prepares"] == 0 and st["fallbacks"] == 0, st


def test_ring_spans_are_recorded():
    from automerge_tpu_torch import obs
    doc = fresh_doc()
    with obs.tracing():
        t0 = obs.now()
        with PipelinedIngestor(doc, slots=2) as ring:
            ring.run(halves(k=2))
        recs = obs.snapshot(since_ns=t0)
    assert obs.span_seconds(recs, "ring", "plan") > 0
    assert obs.span_seconds(recs, "ring", "commit") > 0


def test_background_prepare_failure_raises_pipeline_error():
    from automerge_tpu_torch.engine.pipeline import PipelineError
    doc = fresh_doc()

    def boom(batch, after=None):
        raise KeyError("planner fault")
    doc.prepare_batch = boom
    ring = PipelinedIngestor(doc)
    ring.feed(halves(k=1)[0])
    with pytest.raises(PipelineError) as e:
        ring.commit_next()
    assert isinstance(e.value.__cause__, KeyError)
    ring.close()


# ------------------------------------------------------- in-place rounds

def residual_changes():
    """Deletes, conflicting overwrites, two concurrent inserts after one
    element: the mixed round and the host slow path."""
    return [
        {"actor": "zdel", "seq": 1, "deps": {"base": 1}, "ops": [
            {"action": "del", "obj": "t", "key": f"base:{t}"}
            for t in (5, 6, 700)]},
        {"actor": "zset-0", "seq": 1, "deps": {"base": 1}, "ops": [
            {"action": "set", "obj": "t", "key": "base:42", "value": "P"}]},
        {"actor": "zset-1", "seq": 1, "deps": {"base": 1}, "ops": [
            {"action": "set", "obj": "t", "key": "base:42", "value": "Q"}]},
        {"actor": "zins-0", "seq": 1, "deps": {"base": 1}, "ops": [
            {"action": "ins", "obj": "t", "key": "base:9", "elem": 9000},
            {"action": "set", "obj": "t", "key": "zins-0:9000",
             "value": "X"}]},
        {"actor": "zins-1", "seq": 1, "deps": {"base": 1}, "ops": [
            {"action": "ins", "obj": "t", "key": "base:9", "elem": 9000}]},
    ]


def planned_round(doc, batch):
    """The first planned round of `batch` on `doc` (nothing committed)."""
    p = doc.prepare_batch(batch)
    return p.rounds[0][3]


def round_inputs(shape, grow):
    """(doc, exec plan) for one round shape. The base leaves its capacity
    bucket (4,096) room for a 40 x 30-op merge but not for a 40 x 60-op
    one, which grows the tables."""
    n = 3070
    doc = fresh_doc(n)
    merge = as_port(B.merge_batch("t", 40, 60 if grow else 30, n, seed=1,
                                  actor_prefix="p0"))
    if shape in ("commit", "commit_planned"):
        doc.prefer_planned = shape == "commit_planned"
        plan = planned_round(doc, merge)
        assert (plan.seg_plan is not None) == (shape == "commit_planned")
        return doc, plan
    doc.eager_materialize = False
    if shape == "mixed_dense":
        return doc, planned_round(doc, merge)
    batch = doc._decode_wire(residual_changes())
    return doc, planned_round(doc, batch)


def run_round(doc, plan, store):
    """Run the round's program out of place (store None) or in place."""
    tables = store.rows() if store else tuple(doc._dev.values())
    kw = dict(out_cap=plan.out_cap, store=store)
    if plan.dense and plan.n_runs and plan.n_res == 0 and \
            doc.eager_materialize:
        S = plan.seg_S or I.bucket(doc._seg_bound + plan.seg_inc + 2, 64)
        kw.update(S=S, as_u8=True, L=min(I.bucket(plan.n_elems_after + 2),
                                         plan.out_cap))
        if plan.seg_plan is not None:
            return F.fused_commit_round_planned(
                *tables, plan.desc, plan.blob, plan.seg_plan, **kw)
        return F.fused_commit_round(*tables, plan.desc, plan.blob, **kw)
    dd, db, dr, dc, dt = F.round_dummies(plan.out_cap, "cpu")
    return F.fused_mixed_round(
        *tables, plan.desc if plan.desc is not None else dd,
        plan.blob if plan.blob is not None else db,
        plan.res if plan.res is not None else dr, dc,
        plan.touch if plan.touch is not None else dt, **kw)


@pytest.mark.parametrize("shape,grow", [
    ("commit", False), ("commit", True), ("commit_planned", False),
    ("commit_planned", True), ("mixed_dense", False), ("mixed_dense", True),
    ("mixed_residual", False)])
def test_inplace_round_equals_out_of_place(shape, grow):
    doc, plan = round_inputs(shape, grow)
    want = run_round(doc, plan, None)
    cap = doc._cap if grow else plan.out_cap
    assert (cap < plan.out_cap) == grow
    store = I.TableStore(KEYS, TDoc._TABLE_FILLS,
                         {k: v.clone() for k, v in doc._dev.items()}, cap)
    ptrs = {k: v.data_ptr() for k, v in store.views.items()}
    got = run_round(doc, plan, store)
    assert len(got) == len(want)
    for k, g, w in zip(KEYS, got[:9], want[:9]):
        assert g.dtype == w.dtype and torch.equal(g, w), k
        assert g is store.views[k]
        assert (g.data_ptr() == ptrs[k]) == (not grow), k
    for g, w in zip(got[9:], want[9:]):
        assert torch.equal(g, w)
    assert store.writes >= 1


def test_inplace_register_writeback_equals_out_of_place():
    rng = np.random.default_rng(5)
    cap = 512
    tables = {"value": torch.from_numpy(rng.integers(0, 99, cap,
                                                     dtype=np.int32)),
              "has_value": torch.from_numpy(rng.random(cap) < 0.5),
              "win_actor": torch.from_numpy(rng.integers(-1, 5, cap,
                                                         dtype=np.int32)),
              "win_seq": torch.from_numpy(rng.integers(0, 9, cap,
                                                       dtype=np.int32)),
              "win_counter": torch.from_numpy(rng.random(cap) < 0.2)}
    wb = np.zeros((6, 128), np.int32)
    wb[0] = cap                                 # padding: dropped
    wb[0, :40] = rng.choice(cap, 40, replace=False)
    wb[1:, :40] = rng.integers(0, 2, (5, 40))
    wb = torch.from_numpy(wb)
    want = I.scatter_registers_packed(*tables.values(), wb)
    store = I.TableStore(I.REG_KEYS, I.REG_FILLS,
                         {k: v.clone() for k, v in tables.items()}, cap)
    ptrs = [store.views[k].data_ptr() for k in I.REG_KEYS]
    got = I.scatter_registers_packed(*store.rows(), wb, store=store)
    for g, w, p in zip(got, want, ptrs):
        assert torch.equal(g, w) and g.data_ptr() == p


def residual_stream(doc):
    """A merge, a residual round with conflicts (the slow path and its
    register writeback), then a second merge."""
    doc.apply_batch(halves(k=1)[0])
    doc.apply_changes(residual_changes())
    doc.apply_changes([{"actor": "zins-1", "seq": 2,
                        "deps": {"zins-1": 1}, "ops": [
                            {"action": "set", "obj": "t",
                             "key": "zins-1:9000", "value": "Y"}]}])
    doc.apply_batch(as_port(B.merge_batch("t", 30, 20, 4000, seed=7,
                                          actor_prefix="q")))


def test_inplace_doc_stream_equals_out_of_place_and_jax():
    jdoc = fresh_doc(cls=JDoc)
    plain = fresh_doc()
    inplace = fresh_doc()
    inplace.donate_buffers = True
    for d in (plain, inplace):
        residual_stream(d)
    jdoc.apply_batch(halves(k=1, port=False)[0])
    jdoc.apply_changes(residual_changes())
    jdoc.apply_changes([{"actor": "zins-1", "seq": 2,
                         "deps": {"zins-1": 1}, "ops": [
                             {"action": "set", "obj": "t",
                              "key": "zins-1:9000", "value": "Y"}]}])
    jdoc.apply_batch(B.merge_batch("t", 30, 20, 4000, seed=7,
                                   actor_prefix="q"))
    assert inplace.conflicts
    assert_same_state(plain, inplace)
    assert_same_state(jdoc, inplace)
    assert inplace._store is not None and inplace._store.holds(inplace._dev)
    assert inplace.dispatch_stats["dispatches"] == \
        plain.dispatch_stats["dispatches"]


def test_inplace_commit_keeps_table_storage():
    doc = fresh_doc()
    doc.donate_buffers = True
    # actor ids after 'base': interning appends, so no remap replaces
    # the actor columns out of place
    doc.apply_batch(as_port(B.merge_batch("t", 4, 10, 4000, seed=1,
                                          actor_prefix="q0")))
    ptrs = {k: v.data_ptr() for k, v in doc._dev.items()}
    cap = doc._cap
    doc.apply_batch(as_port(B.merge_batch("t", 4, 10, 4000, seed=2,
                                          actor_prefix="q1")))
    doc.apply_changes(residual_changes())       # mixed round + writeback
    assert doc._cap == cap
    assert {k: v.data_ptr() for k, v in doc._dev.items()} == ptrs
    control = fresh_doc()
    for b in (B.merge_batch("t", 4, 10, 4000, seed=1, actor_prefix="q0"),
              B.merge_batch("t", 4, 10, 4000, seed=2, actor_prefix="q1")):
        control.apply_batch(as_port(b))
    control.apply_changes(residual_changes())
    assert_same_state(control, doc)


def test_inplace_rows_are_aligned():
    store = I.TableStore(KEYS, TDoc._TABLE_FILLS,
                         TDoc("t", device="cpu")._ensure_dev(), 1100)
    for k, v in store.views.items():
        assert v.is_contiguous() and v.shape == (1100,)
        assert v.data_ptr() % 16 == 0, k


# --------------------------------------------------- donation contract

@pytest.mark.parametrize("donate", [False, True])
def test_failure_before_any_write_leaves_doc_usable(donate, monkeypatch):
    """multi_scan runs before the round's first scatter: a failure there
    leaves the tables and the host bookkeeping as they were, and the
    batch commits on a retry."""
    hs = halves(k=2)
    doc = fresh_doc()
    doc.donate_buffers = donate
    doc.apply_batch(hs[0])
    before = doc.text()
    calls = []

    def failing_scan(x):
        calls.append(1)
        raise RuntimeError("launch failed")
    with monkeypatch.context() as m:
        m.setattr(I, "multi_scan", failing_scan)
        plan = doc.prepare_batch(hs[1])
        with pytest.raises(RuntimeError, match="launch failed"):
            doc.commit_prepared(plan)
    assert calls and not doc._device_lost
    assert doc.text() == before
    doc.commit_prepared(doc.prepare_batch(hs[1]))
    control = fresh_doc()
    for h in hs:
        control.apply_batch(h)
    assert_same_state(control, doc)


def test_failure_after_first_inplace_write_loses_doc(monkeypatch):
    hs = halves(k=2)
    doc = fresh_doc()
    doc.donate_buffers = True
    doc.apply_batch(hs[0])

    def failing_materialize(*a, **k):
        raise RuntimeError("materialize failed")
    with monkeypatch.context() as m:
        m.setattr(F, "_materialize_core_planned_r", failing_materialize)
        plan = doc.prepare_batch(hs[1])
        with pytest.raises(RuntimeError, match="materialize failed"):
            doc.commit_prepared(plan)
    assert doc._device_lost
    for access in (doc.text, doc.__len__, doc.elem_ids,
                   lambda: doc.apply_batch(extra_batch())):
        with pytest.raises(RuntimeError, match="was lost"):
            access()


def test_out_of_place_failure_after_dispatch_keeps_doc(monkeypatch):
    """Without donation the live tables are never written: the same
    failure leaves the document usable."""
    hs = halves(k=2)
    doc = fresh_doc()
    doc.apply_batch(hs[0])

    def failing_materialize(*a, **k):
        raise RuntimeError("materialize failed")
    with monkeypatch.context() as m:
        m.setattr(F, "_materialize_core_planned_r", failing_materialize)
        with pytest.raises(RuntimeError, match="materialize failed"):
            doc.commit_prepared(doc.prepare_batch(hs[1]))
    assert not doc._device_lost
    doc.commit_prepared(doc.prepare_batch(hs[1]))
    control = fresh_doc()
    for h in hs:
        control.apply_batch(h)
    assert_same_state(control, doc)
