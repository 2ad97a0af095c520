"""The port's spans for the layers between the entry points and the
kernels: a checkpoint restore (`ckpt/*`), the apply path (`apply/*`),
the reads (`pull/*` under `pull/text`, `read/*` under `DeviceTextDocSet
.texts()`) and the DocSet fast tier (`docset/*`), on the CPU at small
sizes.

Each span lies inside its parent on the parent's thread, and siblings'
totals stay within the parent's. The DocSet's run detection is one
`plan/detect_runs` a call, over every document it walks, and its
planning one `plan/index_merge`, `docset/lookup` and `docset/mirror` a
call, over every document the doc-axis pass plans. Per-document spans
(the per-document planner's, where the pass declines a round) run under
`obs.aggregate_only()`: they count in the aggregates and write no
flight-recorder record, so a small ring does not wrap. With tracing off
no call site reads the clock.
"""

import json
import threading

import numpy as np
import pytest
import torch

from automerge_tpu_torch import obs
from portbench import drive
from portbench.families import docset_build, text_backlog
from test_torch_soak_docs import threads_checked

CPU = torch.device("cpu")
M = drive.program()
SEED = 2**31 + 17

BASE = {"base_len": 4000}
RESIDUAL = {"entry": "apply_batch", "batches": 1, "actors": 40,
            "pairs": 20, "deletes": 5, "bare_inserts": 5,
            "target": {"own_range": 100}}
POP = {"docs": 24, "doc_actors": 3, "doc_chars": 10}


@pytest.fixture(autouse=True)
def _tracing_off():
    with threads_checked():
        obs.disable()
        yield
        obs.disable()


@pytest.fixture(scope="module")
def backlog():
    """A base text's bundle and a residual-shaped batch on it (runs,
    deletes of the base, value-less inserts: the residual cell's
    shape)."""
    bl = text_backlog.backlog(BASE, RESIDUAL, SEED)
    doc = M.DeviceTextDoc("text", device=CPU)
    doc.apply_batch(text_backlog.base_batch(M, "text", bl.base_n))
    doc.text()
    return bl, M.ckpt.capture_engine(doc)


def _batch(bl):
    return text_backlog.backlog_batch(M, "text", bl, bl.batches[0])


def _records() -> list:
    """(name, start, end, thread) of the ring's spans."""
    return [(f"{r[2]}/{r[3]}", r[0], r[0] + r[1], r[4])
            for r in obs.snapshot() if r[1] >= 0]


def _inside(child, parent) -> bool:
    return (parent[1] <= child[1] and child[2] <= parent[2]
            and child[3] == parent[3])


def assert_nested(recs, parent: str, children) -> None:
    """Every `children` span lies inside a `parent` span on its thread,
    and within each parent span the children (siblings, disjoint) add up
    to at most the parent."""
    parents = [r for r in recs if r[0] == parent]
    assert parents, parent
    for name in children:
        kids = [r for r in recs if r[0] == name]
        assert kids, f"{name} not recorded"
        for k in kids:
            assert any(_inside(k, p) for p in parents), (name, parent)
    for p in parents:
        inner = [k for k in recs if k[0] in children and _inside(k, p)]
        assert sum(k[2] - k[1] for k in inner) <= p[2] - p[1]
        inner.sort(key=lambda k: k[1])
        for a, b in zip(inner, inner[1:]):
            assert a[2] <= b[1], (a, b)     # siblings do not overlap


def assert_totals_within(spans: dict, parent: str, children) -> None:
    """The aggregates: the children's totals at most the parent's."""
    total = sum(spans[c]["total_ns"] for c in children if c in spans)
    assert total <= spans[parent]["total_ns"], (parent, children)


# --- the scope ---------------------------------------------------------------

def test_aggregate_only_writes_no_record_yet_counts_every_span():
    seen = []

    def other_thread():
        obs.span("t", "other", obs.now())
        seen.append(True)

    with obs.tracing():
        obs.clear()
        with obs.aggregate_only():
            for _ in range(100):
                obs.span("t", "inner", obs.now())
            obs.event("t", "ev", n=3)
            th = threading.Thread(target=other_thread)
            th.start()
            th.join()
            with obs.aggregate_only():
                obs.span("t", "nested", obs.now())
            obs.span("t", "inner", obs.now())   # still in the outer scope
        obs.span("t", "outer", obs.now())
        snap = obs.metrics_snapshot()
        names = sorted(r[3] for r in obs.snapshot())
    assert seen
    assert names == ["other", "outer"]        # the scope is per thread
    assert snap["spans"]["t.inner"]["count"] == 101
    assert snap["spans"]["t.nested"]["count"] == 1
    assert snap["counters"]["t.ev"] == 3
    assert snap["emitted"] == snap["retained"] == 2


def test_write_trace_carries_the_origin_on_both_clocks(tmp_path):
    import time
    before = time.time_ns()
    with obs.tracing(capacity=64) as rec:
        after = time.time_ns()
        obs.span("t", "x", obs.now())
        path = obs.write_trace(str(tmp_path / "t.json"))
    with open(path) as fh:
        meta = json.load(fh)["otherData"]
    assert meta["origin_perf_counter_ns"] == rec.t0_ns
    assert meta["origin_unix_ns"] == rec.t0_unix_ns
    assert before <= rec.t0_unix_ns <= after


# --- checkpoint, apply path, pull --------------------------------------------

def test_restore_spans_nest_under_ckpt_restore(backlog):
    _, bundle = backlog
    with obs.tracing():
        obs.clear()
        M.ckpt.restore_engine(bundle, CPU)
        recs, spans = _records(), obs.metrics_snapshot()["spans"]
    direct = ("ckpt/decode", "ckpt/index", "ckpt/stage")
    assert_nested(recs, "ckpt/restore", direct)
    # the mirror rebuild runs while the staged copies are in flight
    assert_nested(recs, "ckpt/stage", ("ckpt/mirror",))
    assert spans["ckpt.restore"]["count"] == 1
    assert_totals_within(spans, "ckpt.restore",
                         [n.replace("/", ".") for n in direct])


APPLY_CHILDREN = ("plan/admission", "apply/intern", "apply/bookkeeping",
                  "apply/plan_round", "apply/execute", "apply/slow",
                  "apply/finish")


def test_residual_apply_batch_and_text_spans_nest(backlog):
    bl, bundle = backlog
    doc = M.ckpt.restore_engine(bundle, CPU)
    doc.eager_materialize = True
    batch = _batch(bl)
    with obs.tracing():
        obs.clear()
        doc.apply_batch(batch)
        text = doc.text()
        recs, spans = _records(), obs.metrics_snapshot()["spans"]
    assert len(text) == bl.base_n - bl.deletes * len(bl.batches[0].actors) \
        + bl.pairs * len(bl.batches[0].actors)
    assert_nested(recs, "apply/batch", APPLY_CHILDREN)
    assert_nested(recs, "apply/plan_round", ("plan/detect_runs",))
    assert_totals_within(spans, "apply.batch",
                         [n.replace("/", ".") for n in APPLY_CHILDREN])
    pull = ("pull/plan", "pull/wait", "pull/decode")
    assert_nested(recs, "pull/text", pull)
    assert_totals_within(spans, "pull.text",
                         [n.replace("/", ".") for n in pull])
    # no new span joins the categories the planning and commit metrics sum
    assert not [k for k in spans if k.startswith(("plan.", "commit."))
                and k not in ("plan.admission", "plan.detect_runs",
                              "plan.rank_resolve", "plan.index_merge")]


def test_incremental_pull_spans_nest(backlog):
    """A second text() after a round: one plan, two fetches."""
    _, bundle = backlog
    runs = {"entry": "ring", "batches": 2, "actors": 20, "pairs": 10,
            "deletes": 0, "bare_inserts": 0, "target": {"zipf": 1.2}}
    bl = text_backlog.backlog(BASE, runs, SEED)
    doc = M.ckpt.restore_engine(bundle, CPU)
    doc.apply_batch(text_backlog.backlog_batch(M, "text", bl, bl.batches[0]))
    doc.text()
    doc.apply_batch(text_backlog.backlog_batch(M, "text", bl, bl.batches[1]))
    with obs.tracing():
        obs.clear()
        doc.text()
        recs, spans = _records(), obs.metrics_snapshot()["spans"]
    assert doc.pull_stats["mode"] == "full"
    pull = ("pull/plan", "pull/wait", "pull/decode")
    assert_nested(recs, "pull/text", pull)
    assert spans["pull.plan"]["count"] == 1
    assert spans["pull.wait"]["count"] == 2     # scalars, codes
    assert_totals_within(spans, "pull.text",
                         [n.replace("/", ".") for n in pull])


def test_ring_commit_holds_the_execute_span(backlog):
    bl, bundle = backlog
    doc = M.ckpt.restore_engine(bundle, CPU)
    batch = _batch(bl)
    with obs.tracing():
        obs.clear()
        doc.commit_prepared(doc.prepare_batch(batch))
        recs = _records()
    assert_nested(recs, "commit/batch", ("apply/execute",))
    assert not [r for r in recs if r[0] == "apply/batch"]


# --- the DocSet ---------------------------------------------------------------

STAGES = ("docset.lookup", "docset.mirror")


def _docset(capacity=64):
    pop = docset_build.Population(POP, SEED)
    return pop, M.DeviceTextDocSet(pop.ids, capacity, device=CPU)


def _del_change(M, obj, pop, seq):
    """One change by actor-000 deleting its first char: not runs-only,
    so its document leaves the fast tier."""
    C = M.C
    return M.TB(
        obj_id=obj, actors=[pop.actors[0]], seqs=np.full(1, seq, np.int32),
        deps=[{}], messages=[None], op_change=np.zeros(1, np.int32),
        op_kind=np.array([C.KIND_DEL], np.int8),
        op_target_actor=np.zeros(1, np.int32),
        op_target_ctr=np.ones(1, np.int32),
        op_parent_actor=np.zeros(1, np.int32),
        op_parent_ctr=np.zeros(1, np.int32), op_value=np.zeros(1, np.int64),
        actor_table=list(pop.actors), value_pool=[])


def _walked_docs() -> list:
    """`n_docs` of each `plan/detect_runs` record: the documents a walk
    covered."""
    return [r[5]["n_docs"] for r in obs.snapshot()
            if r[2] == "plan" and r[3] == "detect_runs"]


def _axis_docs() -> list:
    """`n_axis` of each `docset/plan` record: the documents the
    doc-axis pass planned."""
    return [r[5]["n_axis"] for r in obs.snapshot()
            if r[2] == "docset" and r[3] == "plan"]


def test_docset_spans_nest_and_stage_spans_stay_out_of_the_ring():
    from automerge_tpu_torch.engine import doc_set
    pop, ds = _docset()
    doc_set.reset_axis_plans()
    with obs.tracing():
        obs.clear()
        ds.apply_batches(pop.batches(M))
        texts = ds.texts()
        recs, snap = _records(), obs.metrics_snapshot()
        axis = _axis_docs()
    assert set(texts) == set(pop.ids)
    spans = snap["spans"]
    assert_nested(recs, "docset/apply", ("docset/plan", "docset/stack",
                                         "docset/expand"))
    assert_nested(recs, "read/texts", ("read/plan", "read/wait",
                                       "read/check", "read/decode"))
    # the run detection: one walk a call over every document, in the ring
    assert_nested(recs, "docset/plan", ("plan/detect_runs",))
    assert spans["plan.detect_runs"]["count"] == 1
    assert _walked_docs() == [POP["docs"]]
    # the stages: one a call, over every document, by the doc-axis pass;
    # in the ring, inside the planning after the walk
    assert_nested(recs, "docset/plan", ("plan/detect_runs",) + tuple(
        k.replace(".", "/") for k in STAGES + ("plan.index_merge",)))
    for k in STAGES + ("plan.index_merge",):
        assert spans[k]["count"] == 1, k
    assert axis == [POP["docs"]]
    assert doc_set.axis_plans == {"rounds": 1, "docs": POP["docs"],
                                  "declined": 0}
    assert_totals_within(spans, "docset.plan", STAGES + (
        "plan.detect_runs", "plan.index_merge"))
    assert_totals_within(spans, "docset.apply", (
        "docset.plan", "docset.stack", "docset.expand"))
    assert spans["docset.plan"]["count"] == 1
    assert snap["emitted"] == snap["retained"] == len(obs.snapshot())
    # a round the pass declines: the per-document planner's stage spans,
    # one per document in the aggregates, none in the ring
    pop, ds = _docset()
    ds._plan_axis = lambda walked, walk: None
    with obs.tracing():
        obs.clear()
        ds.apply_batches(pop.batches(M))
        recs, spans = _records(), obs.metrics_snapshot()["spans"]
        axis = _axis_docs()
    for k in STAGES + ("plan.index_merge",):
        assert spans[k]["count"] == POP["docs"], k
        assert not [r for r in recs if r[0] == k.replace(".", "/")], k
    assert axis == [0]


def test_docset_read_spans_once_a_planned_call():
    """On the planned path each `texts()` call emits one `read/plan` (the
    doc-axis read pass, with its args: S and the rows planned) and one
    `read/check`."""
    from automerge_tpu_torch.engine import doc_set
    pop, ds = _docset()
    ds.apply_batches(pop.batches(M))
    doc_set.reset_axis_reads()
    with obs.tracing():
        obs.clear()
        for _ in range(3):
            ds._codes_cache = None
            ds.texts()
        recs, spans = obs.snapshot(), obs.metrics_snapshot()["spans"]
    assert_nested(_records(), "read/texts", ("read/plan", "read/check"))
    plan = [r[5] for r in recs if r[2] == "read" and r[3] == "plan"]
    assert plan == [{"S": 64, "n_rows": POP["docs"]}] * 3
    assert len([r for r in recs if r[2] == "read" and r[3] == "check"]) == 3
    assert spans["read.plan"]["count"] == spans["read.check"]["count"] == 3
    assert doc_set.axis_reads == {"planned": 3, "rows": 3 * POP["docs"],
                                  "self_contained": 0}


def test_docset_general_and_rebuild_spans():
    pop, ds = _docset()
    ds.apply_batches(pop.batches(M))
    ds.texts()
    with obs.tracing():
        obs.clear()
        ds.apply_batches({obj: _del_change(M, obj, pop, 2)
                          for obj in pop.ids[:2]})
        ds._meta[5].mirror = None         # a row whose mirror is lost
        ds.texts()
        recs = _records()
    assert_nested(recs, "docset/apply", ("docset/plan", "docset/general"))
    assert_nested(recs, "read/texts", ("read/rebuild", "read/wait",
                                       "read/decode"))
    # the graduated documents read through their own text()
    assert [r for r in recs if r[0] == "pull/text"]


def test_positions_read_records_no_pull_wait(backlog):
    """`pull/wait` is text()'s: the positions read fetches the same
    scalars outside `pull/text` and records no wait."""
    _, bundle = backlog
    doc = M.ckpt.restore_engine(bundle, CPU)
    with obs.tracing():
        obs.clear()
        order = doc.visible_order()
        before = obs.metrics_snapshot()["spans"]
        doc._mat = doc._scal = None
        doc.text()
        recs, after = _records(), obs.metrics_snapshot()["spans"]
    assert len(order) > 0
    assert "pull.wait" not in before
    assert after["pull.wait"]["count"] >= 2     # the scalars, the codes
    assert_nested(recs, "pull/text", ("pull/wait",))


def _expand_caps() -> list:
    return [r[5]["out_cap"] for r in obs.snapshot()
            if r[2] == "docset" and r[3] == "expand"]


def test_expand_span_shows_a_capacity_regrowth():
    """`docset/expand` carries the capacity the expansion wrote: above
    the set's capacity where the round regrew it, equal where it fit."""
    pop, ds = _docset(capacity=16)        # the build needs more
    with obs.tracing():
        obs.clear()
        ds.apply_batches(pop.batches(M))
        grown = _expand_caps()
    pop2, roomy = _docset(capacity=1024)
    with obs.tracing():
        obs.clear()
        roomy.apply_batches(pop2.batches(M))
        kept = _expand_caps()
    assert len(grown) == 1 and grown[0] > 16 and grown[0] == ds._cap
    assert kept == [1024]


def test_docset_rounds_do_not_wrap_a_small_ring():
    """A stripe of 64 records holds every per-call span of six calls:
    the run detection's one walk a round among them, and the doc-axis
    pass's three stage spans a round, each over every document."""
    from automerge_tpu_torch.engine import doc_set, runs
    from portbench.families import docset_rounds
    pop, ds = _docset()
    ds.apply_batches(pop.batches(M))
    gen = docset_rounds.AppendRounds(pop, {"writer": 0, "run": 4}, SEED)
    calls = []
    doc_set.reset_axis_plans()
    with obs.tracing(capacity=64):
        obs.clear()
        for r in range(3):
            before = runs.detections["calls"]
            ds.apply_batches(gen.batches(M, r))
            calls.append(runs.detections["calls"] - before)
            ds.texts()
        snap = obs.metrics_snapshot()
        walked = _walked_docs()
        axis = _axis_docs()
    assert snap["emitted"] == snap["retained"]
    assert snap["spans"]["docset.plan"]["count"] == 3
    assert calls == [1, 1, 1]
    assert snap["spans"]["plan.detect_runs"]["count"] == 3
    assert walked == [POP["docs"]] * 3
    for k in STAGES + ("plan.index_merge",):
        assert snap["spans"][k]["count"] == 3, k
    assert axis == [POP["docs"]] * 3
    assert doc_set.axis_plans == {"rounds": 3, "docs": 3 * POP["docs"],
                                  "declined": 0}


# --- the off path -------------------------------------------------------------

def test_off_path_reads_no_clock(backlog, monkeypatch):
    """With tracing off, no instrumented site calls `obs.now`: the
    restore, a residual apply_batch, text(), a prepared commit, and the
    DocSet's build, general round, heal and reads."""
    bl, bundle = backlog
    calls = []
    real = obs.now

    def counted():
        calls.append(1)
        return real()

    monkeypatch.setattr(obs, "now", counted)
    assert not obs.ENABLED
    doc = M.ckpt.restore_engine(bundle, CPU)
    doc.apply_batch(_batch(bl))
    doc.text()
    doc2 = M.ckpt.restore_engine(bundle, CPU)
    doc2.commit_prepared(doc2.prepare_batch(_batch(bl)))
    doc2.text()
    pop, ds = _docset(capacity=16)
    ds.apply_batches(pop.batches(M))
    ds.texts()
    ds.apply_batches({obj: _del_change(M, obj, pop, 2)
                      for obj in pop.ids[:2]})
    ds._meta[5].mirror = None
    ds.texts()
    assert calls == []
