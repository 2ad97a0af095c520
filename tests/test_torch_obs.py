"""The port's observability tier (automerge_tpu_torch/obs/) against the
JAX package's, on the CPU.

- Twins of tests/test_obs.py: the disabled fast path (measured and
  bounded against a cfg5-quick-shaped stream through the port's ring),
  ring wraparound, exact counters, concurrent writers, the ring's worker
  and caller spans, span-derived terms against perf_counter pairs, the
  serial profile of `chip_smoke.serial_stream`, Chrome-trace export and
  validation, the tracing scope, span aggregates, labeled sync
  durations; `obs.recorder()` is a callable, as in the JAX package.
- Twins of the ledger-level tests of tests/test_lineage.py, each run on
  both packages' `LineageLedger` with the same inputs and required to
  give the same chains and counters; the port's own hop sites (the
  frontend's `origin`, the stacked executor's `plan/stacked`) and the
  flow events they stitch into a trace. The tests that need `sync/`,
  `resilience/` or `service/` (the chaos soak, the DocSet flows, the
  service postmortem and scrape, the router hops) wait for those tiers.
- Twins of the non-XLA tests of tests/test_device_truth.py (footprint
  parity, the gauge feed, byte meters, prom families, counter tracks,
  `metrics_snapshot`, label coverage, the disabled and enabled bounds),
  and of its compile tests over the port's build/load events and launch
  registry (a load recorded once, steady state clean and violated, the
  per-route handles, the measured cost model).
"""

import os
import re
import threading
import time

import pytest
import torch

import bench as B
from automerge_tpu.obs import lineage as j_lineage
from automerge_tpu_torch import native, obs
from automerge_tpu_torch.engine import DeviceMapDoc, DeviceTextDoc, accounting
from automerge_tpu_torch.engine import PipelinedIngestor
from automerge_tpu_torch.engine import TextChangeBatch as TBatch
from automerge_tpu_torch.obs import device_truth as dt
from automerge_tpu_torch.obs import lineage, prom
from automerge_tpu_torch.obs.export import (TraceValidationError,
                                            to_chrome_trace,
                                            validate_chrome_trace)
from automerge_tpu_torch.obs.lineage import LineageLedger, sample_key
from automerge_tpu_torch.obs.recorder import FlightRecorder
from automerge_tpu_torch.ops import scan_kernels as S

PORT_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "automerge_tpu_torch")
LEDGERS = pytest.mark.parametrize("led_mod", [j_lineage, lineage],
                                  ids=["jax", "port"])


def as_port(batch):
    return TBatch(**{k: getattr(batch, k)
                     for k in batch.__dataclass_fields__})


@pytest.fixture(autouse=True)
def _flags_restored():
    """Every test starts and ends with tracing and lineage off, and the
    device-truth feed in its default ON state."""
    obs.disable()
    was_dt = dt.ENABLED
    dt.ENABLED = True
    yield
    obs.disable()
    dt.ENABLED = was_dt
    for mod in (lineage, j_lineage):
        mod.disable()
        mod.clear()


# --------------------------------------------------------------------------
# tests/test_obs.py twins
# --------------------------------------------------------------------------

QUICK = dict(base_n=20_000, n_batches=4, n_actors=200, ops=100)


def _quick_batches(prefix="ov"):
    return [as_port(B.merge_batch("obs-text", QUICK["n_actors"],
                                  QUICK["ops"], QUICK["base_n"], seed=50 + k,
                                  actor_prefix=f"{prefix}{k:02d}"))
            for k in range(QUICK["n_batches"])]


def _quick_doc():
    doc = DeviceTextDoc("obs-text", device="cpu")
    doc.eager_materialize = True
    doc.apply_batch(as_port(B.base_batch("obs-text", QUICK["base_n"])))
    doc.text()
    return doc


def _quick_stream(batches):
    doc = _quick_doc()
    t0 = time.perf_counter()
    with PipelinedIngestor(doc) as pipe:
        pipe.run(batches)
    doc._materialize(with_pos=False)
    doc._scalars()
    dt_s = time.perf_counter() - t0
    doc.text()
    return dt_s


def test_recorder_is_a_callable_like_the_jax_package():
    import automerge_tpu.obs as jobs
    assert callable(obs.recorder) and callable(jobs.recorder)
    with obs.tracing() as rec:
        assert obs.recorder() is rec and isinstance(rec, FlightRecorder)
        assert obs.telemetry() is not None and obs.enabled()
    assert not obs.enabled()


def test_disabled_overhead_within_noise_on_quick_stream():
    batches = _quick_batches()
    _quick_stream(batches)                       # warm-up
    disabled_s = min(_quick_stream(batches) for _ in range(3))
    with obs.tracing():
        rec = obs.recorder()
        rec.clear()
        _quick_stream(batches)
        n_records = rec.n_emitted
    assert n_records > 0
    assert not obs.ENABLED
    n_calls = 200_000
    t0 = time.perf_counter_ns()
    for _ in range(n_calls):
        t = obs.now() if obs.ENABLED else 0
        if obs.ENABLED:
            obs.span("x", "y", t)
    per_call_ns = (time.perf_counter_ns() - t0) / n_calls
    assert per_call_ns < 1_000, f"disabled emit path {per_call_ns:.0f}ns"
    worst_case_s = n_records * per_call_ns / 1e9
    assert worst_case_s <= 0.02 * disabled_s, (
        f"{n_records} emit sites x {per_call_ns:.0f}ns = "
        f"{worst_case_s * 1e3:.2f}ms vs stream {disabled_s * 1e3:.0f}ms")


def test_disabled_emit_is_strict_noop():
    with obs.tracing():
        pass                          # recorder now exists, flag off
    rec = obs.recorder()
    rec.clear()
    t = obs.now() if obs.ENABLED else 0
    if obs.ENABLED:
        obs.span("x", "y", t)
        obs.event("x", "z")
    assert rec.n_emitted == 0 and obs.snapshot() == []


def test_ring_wraparound_keeps_newest():
    rec = FlightRecorder(capacity=16, n_stripes=1)
    for i in range(100):
        rec.emit((i, 0, "c", "n", 0, {"i": i}))
    snap = rec.snapshot()
    assert len(snap) == 16
    assert [r[5]["i"] for r in snap] == list(range(84, 100))
    assert rec.n_emitted == 100 and rec.n_retained == 16


def test_counters_exact_across_wraparound():
    with obs.tracing(capacity=16):
        obs.clear()
        for _ in range(500):
            obs.event("chaos", "drop")
        snap = obs.metrics_snapshot()
    assert snap["counters"]["chaos.drop"] == 500
    assert snap["retained"] < snap["emitted"] == 500


def test_concurrent_writers_no_torn_records():
    n_threads, n_each = 12, 400
    with obs.tracing(capacity=n_threads * n_each):
        obs.clear()
        start = threading.Barrier(n_threads)

        def writer(w):
            start.wait()
            for i in range(n_each):
                t0 = obs.now()
                obs.span("t", f"w{w}", t0, args={"w": w, "i": i})

        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        snap = obs.snapshot()
    assert len(snap) == n_threads * n_each
    per_writer = {}
    for r in snap:
        assert len(r) == 6
        ts, dur, cat, name, tid, args = r
        assert cat == "t" and name == f"w{args['w']}"
        assert isinstance(ts, int) and dur >= 0
        per_writer.setdefault(args["w"], set()).add(args["i"])
    assert all(v == set(range(n_each)) for v in per_writer.values())


def test_ring_worker_and_caller_spans_are_consistent():
    batches = _quick_batches("rw")
    with obs.tracing():
        obs.clear()
        _quick_stream(batches)
        snap = obs.snapshot()
    plans = [r for r in snap if r[2] == "ring" and r[3] == "plan"]
    commits = [r for r in snap if r[2] == "ring" and r[3] == "commit"]
    assert len(plans) == len(batches)
    assert len(commits) == len(batches)
    assert sorted(r[5]["slot"] for r in commits) == list(range(len(batches)))
    assert len({r[4] for r in plans + commits}) >= 2


def test_span_terms_match_legacy_perf_counter():
    doc = _quick_doc()
    batch = as_port(B.merge_batch("obs-text", QUICK["n_actors"],
                                  QUICK["ops"], QUICK["base_n"], seed=7,
                                  actor_prefix="par"))
    with obs.tracing():
        obs.clear()
        t0 = time.perf_counter()
        plan = doc.prepare_batch(batch)
        legacy_prepare = time.perf_counter() - t0
        t0 = time.perf_counter()
        doc.commit_prepared(plan)
        legacy_commit = time.perf_counter() - t0
        doc._materialize(with_pos=False)
        doc._scalars()
        t0 = time.perf_counter()
        doc.text()
        legacy_pull = time.perf_counter() - t0
        recs = obs.snapshot()
    for legacy, derived, what in [
            (legacy_prepare, obs.span_seconds(recs, "plan", "prepare_batch"),
             "prepare"),
            (legacy_commit, obs.span_seconds(recs, "commit", "batch"),
             "commit"),
            (legacy_pull, obs.span_seconds(recs, "pull", "text"), "pull")]:
        assert derived > 0, what
        tol = max(0.02, 0.2 * legacy)
        assert abs(derived - legacy) <= tol, (
            f"{what}: span {derived:.4f}s vs legacy {legacy:.4f}s")


def test_serial_profile_is_span_derived():
    """chip_smoke's serial stream (the port's counterpart of bench.py's
    serial profile) reads its terms from the engine's spans."""
    import chip_smoke
    M = chip_smoke.port_modules()
    base_n = 4000
    batches = chip_smoke.ring_batches(M, base_n, 3, 40, 40)
    doc, rec = chip_smoke.serial_stream(torch, M, batches, base_n, "cpu")
    prof = rec["terms"]
    for term in ("prepare_s", "commit_s", "device_wait_s", "final_sync_s"):
        assert term in prof and prof[term] >= 0, prof
    assert prof["prepare_s"] > 0 and prof["commit_s"] > 0
    assert rec["n_vis"] == base_n + 3 * 40 * 20


def test_chrome_trace_export_and_validation():
    batches = _quick_batches("tr")
    with obs.tracing():
        obs.clear()
        with obs.span_ctx("bench", "stream", args={"rep": 0}):
            _quick_stream(batches)
        obs.event("chaos", "drop")
        snap = obs.snapshot()
        t0 = obs.recorder().t0_ns
    trace = to_chrome_trace(snap, t0_ns=t0)
    counts = validate_chrome_trace(trace, require_stream_nesting=True)
    assert counts["n_spans"] > 0 and counts["n_ring_spans"] > 0
    assert counts["n_streams"] >= 1 and counts["n_events"] >= 1
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X":
            assert ev["dur"] >= 0 and "cat" in ev and "ts" in ev


def test_trace_validation_rejects_empty_and_malformed():
    with pytest.raises(TraceValidationError):
        validate_chrome_trace({"traceEvents": []})
    with pytest.raises(TraceValidationError):
        validate_chrome_trace(
            {"traceEvents": [{"ph": "X", "name": "n", "cat": "c",
                              "ts": 0.0}]})      # missing dur
    bad = {"traceEvents": [
        {"ph": "X", "name": "plan", "cat": "ring", "ts": 5.0, "dur": 1.0,
         "pid": 1, "tid": 1}]}
    with pytest.raises(TraceValidationError):
        validate_chrome_trace(bad, require_stream_nesting=True)
    validate_chrome_trace(bad)        # without the bench contract: fine


def test_write_trace_round_trips_through_the_validator(tmp_path):
    with obs.tracing():
        obs.clear()
        with obs.span_ctx("bench", "region"):
            obs.event("ckpt", "capture")
        path = obs.write_trace(str(tmp_path / "t.json"))
    assert validate_chrome_trace(path)["n_spans"] >= 1


def test_tracing_scope_restores_outer_state():
    assert not obs.ENABLED
    with obs.tracing():
        assert obs.ENABLED
        with obs.tracing():
            assert obs.ENABLED
        assert obs.ENABLED
    assert not obs.ENABLED


def test_metrics_snapshot_span_aggregates():
    with obs.tracing():
        obs.clear()
        for _ in range(5):
            t0 = obs.now()
            time.sleep(0.001)
            obs.span("plan", "prepare_batch", t0)
        snap = obs.metrics_snapshot()
    agg = snap["spans"]["plan.prepare_batch"]
    assert agg["count"] == 5
    assert agg["total_ns"] >= 5 * 1_000_000
    assert agg["min_ns"] <= agg["max_ns"] <= agg["total_ns"]


def test_accounting_labeled_durations_ride_along():
    with obs.tracing():
        before = accounting.labeled_snapshot()["sync"]
        doc = DeviceTextDoc("lbl", device="cpu")
        doc.eager_materialize = True
        doc.apply_batch(as_port(B.base_batch("lbl", 2000)))
        doc.commit_prepared(doc.prepare_batch(
            as_port(B.merge_batch("lbl", 16, 20, 2000, seed=5))))
        after = accounting.labeled_snapshot()["sync"]
    d = after["stage_barrier"]["n"] - before.get(
        "stage_barrier", {"n": 0})["n"]
    assert d >= 1
    assert after["stage_barrier"]["ns"] > 0


# --------------------------------------------------------------------------
# tests/test_lineage.py twins (ledger level), on both packages
# --------------------------------------------------------------------------


@LEDGERS
def test_sampling_is_pure_function_of_identity(led_mod):
    import random
    keys = [(f"actor-{i % 7}", 1 + i // 7) for i in range(500)]
    a = led_mod.LineageLedger(rate=8)
    b = led_mod.LineageLedger(rate=8)
    sampled_a = {k for k in keys if a.sampled(*k)}
    shuffled = list(keys)
    random.Random(3).shuffle(shuffled)
    assert sampled_a == {k for k in shuffled if b.sampled(*k)}
    assert 0 < len(sampled_a) < len(keys)
    for k in list(sampled_a)[:10]:
        assert led_mod.sample_key(*k) % 8 == 0
    # the subset is the same in both packages
    assert sampled_a == {k for k in keys
                         if LineageLedger(rate=8).sampled(*k)}
    assert all(sample_key(*k) == j_lineage.sample_key(*k) for k in keys)


@LEDGERS
def test_rate_one_samples_everything(led_mod):
    led = led_mod.LineageLedger(rate=1)
    for i in range(50):
        assert led.sampled(f"a{i}", i + 1)


@LEDGERS
def test_unsampled_changes_never_enter_the_ledger(led_mod):
    led = led_mod.LineageLedger(rate=10**6)
    n = sum(led.record(f"a{i}", 1, "origin") for i in range(200))
    assert led.n_chains == n <= 1


def _hop_session(led):
    led.record("a", 1, "origin", site="a", t_ns=10)
    led.record("a", 1, "origin", site="a", t_ns=11)
    led.record("a", 1, "commit", site="B", t_ns=20)
    led.record("a", 1, "commit", site="B", t_ns=21)
    led.record("a", 1, "commit", site="C", t_ns=30)
    led.record("a", 1, "chan/send", site="ch", extra=5, t_ns=31)
    led.record("a", 1, "chan/retransmit", site="ch", extra=(5, 1), t_ns=32)
    led.record("a", 1, "chan/retransmit", site="ch", extra=(5, 2), t_ns=33)
    led.record("a", 1, "chan/retransmit", site="ch", extra=(5, 2), t_ns=34)
    return led


@LEDGERS
def test_hop_dedup_by_stage_site_extra(led_mod):
    led = led_mod.LineageLedger(rate=1)
    assert led.record("a", 1, "origin", site="a")
    assert not led.record("a", 1, "origin", site="a")      # dup drops
    assert led.record("a", 1, "commit", site="B")
    assert not led.record("a", 1, "commit", site="B")      # dup drops
    assert led.record("a", 1, "commit", site="C")          # new site
    c = led.chain("a", 1)
    assert [h[0] for h in c["hops"]] == ["origin", "commit", "commit"]
    assert led.stats["hops_deduped"] == 2
    assert led.visible_sites(c) == {"B", "C"}


@LEDGERS
def test_retransmit_attempts_are_distinct_hops_never_dup_chains(led_mod):
    led = led_mod.LineageLedger(rate=1)
    led.record("a", 1, "origin", site="a")
    led.record("a", 1, "chan/send", site="ch", extra=5)
    led.record("a", 1, "chan/retransmit", site="ch", extra=(5, 1))
    led.record("a", 1, "chan/retransmit", site="ch", extra=(5, 2))
    led.record("a", 1, "chan/retransmit", site="ch", extra=(5, 2))
    c = led.chain("a", 1)
    assert [h[0] for h in c["hops"]] == [
        "origin", "chan/send", "chan/retransmit", "chan/retransmit"]
    assert led.stats["chains_started"] == 1


def test_ledgers_of_both_packages_agree_exactly():
    """The same hop session on both ledgers: the same chains, counters,
    dwell aggregates and postmortem."""
    a = _hop_session(j_lineage.LineageLedger(rate=1))
    b = _hop_session(LineageLedger(rate=1))
    assert b.chains() == a.chains()
    assert b.stats == a.stats
    assert b.telemetry.span_aggregates() == a.telemetry.span_aggregates()
    assert b.stuck(k=4, at_ns=100) == a.stuck(k=4, at_ns=100)
    assert b.context_for([("a", 1)]) == a.context_for([("a", 1)])


@LEDGERS
def test_bounded_capacity_oldest_evicted_counters_exact(led_mod):
    led = led_mod.LineageLedger(rate=1, capacity=8)
    for i in range(20):
        led.record(f"a{i}", 1, "origin", site=f"a{i}")
        led.record(f"a{i}", 1, "commit", site="B")
    assert led.n_chains == 8
    assert led.stats["chains_started"] == 20
    assert led.stats["chains_evicted"] == 12
    assert led.stats["hops_recorded"] == 40
    assert {c["actor"] for c in led.chains()} == {
        f"a{i}" for i in range(12, 20)}


@LEDGERS
def test_max_hops_cap_counted(led_mod):
    led = led_mod.LineageLedger(rate=1, max_hops=4)
    for i in range(10):
        led.record("a", 1, "commit", site=f"s{i}")
    assert len(led.chain("a", 1)["hops"]) == 4
    assert led.stats["hops_dropped_cap"] == 6


@LEDGERS
def test_dwell_and_visibility_telemetry(led_mod):
    led = led_mod.LineageLedger(rate=1)
    t0 = 1_000_000
    led.record("a", 1, "origin", site="a", t_ns=t0)
    led.record("a", 1, "quar/park", site="B", t_ns=t0 + 1_000)
    led.record("a", 1, "quar/release", site="B", t_ns=t0 + 51_000)
    led.record("a", 1, "commit", site="B", t_ns=t0 + 60_000)
    agg = led.telemetry.span_aggregates()
    assert agg[("lineage", "dwell:quar/park")]["total_ns"] == 50_000
    assert agg[("lineage", "visibility")]["total_ns"] == 60_000
    assert led.max_dwell_ms("quar/park") == 0.05
    led.record("b", 1, "origin", site="b", t_ns=t0)
    led.record("b", 1, "commit", site="b", t_ns=t0 + 9_000)
    assert led.telemetry.span_aggregates()[
        ("lineage", "visibility")]["count"] == 1


@LEDGERS
def test_context_adoption_and_hostile_context_ignored(led_mod):
    led = led_mod.LineageLedger(rate=2)
    keys = [(f"k{i}", 1) for i in range(40)]
    in_subset = [k for k in keys if led.sampled(*k)]
    out_subset = [k for k in keys if not led.sampled(*k)]
    assert in_subset and out_subset
    ctx = [[a, s, 777, "origin-X"] for a, s in in_subset] + \
          [[a, s, 777, "evil"] for a, s in out_subset]
    led.adopt(ctx)
    assert led.n_chains == len(in_subset)
    assert led.stats["context_ignored"] == len(out_subset)
    c = led.chain(*in_subset[0])
    assert c["origin_ns"] == 777 and c["origin_site"] == "origin-X"


@LEDGERS
def test_adopt_clock_marks_covered_chains_visible(led_mod):
    led = led_mod.LineageLedger(rate=1)
    led.record("a", 1, "origin", site="a")
    led.record("a", 2, "origin", site="a")
    led.record("b", 5, "origin", site="b")
    led.adopt_clock({"a": 1, "b": 5}, site="joiner", doc="d")
    assert led.visible_sites(led.chain("a", 1)) == {"joiner"}
    assert led.visible_sites(led.chain("a", 2)) == set()
    assert led.visible_sites(led.chain("b", 5)) == {"joiner"}


def test_disabled_emit_path_is_one_flag_check():
    assert not lineage.ENABLED
    n = 200_000
    t0 = time.perf_counter_ns()
    acc = 0
    for _ in range(n):
        if lineage.ENABLED:       # the exact hop-site pattern
            acc += 1
    per_call = (time.perf_counter_ns() - t0) / n
    assert acc == 0
    assert per_call < 1_000, f"{per_call:.0f} ns per disabled check"


def test_change_keys_never_forces_a_frame_decode():
    from automerge_tpu_torch.engine import wire_format as wf
    ch = [{"actor": "a", "seq": 1, "deps": {},
           "ops": [{"action": "ins", "obj": "o", "key": "_head",
                    "elem": 1}]}]
    frame = wf.WireFrame(wf.encode_changes(ch), changes=ch)
    assert lineage.change_keys(frame) == [("a", 1)]
    cold = wf.WireFrame(frame.data)          # undecoded receiver frame
    assert lineage.change_keys(cold) == []
    assert cold._batch is None               # stayed undecoded
    assert lineage.payload_keys(
        {"docId": "d", "clock": {}, "changes": ch, "wire": frame}) \
        == [("a", 1), ("a", 1)]
    assert lineage.change_keys(cold.batch()) == [("a", 1)]


@LEDGERS
def test_prom_families_validate_clean(led_mod):
    led = led_mod.enable(rate=1, capacity=64)
    led.clear()
    led.record("a", 1, "origin", site="a", t_ns=1000)
    led.record("a", 1, "commit", site="B", t_ns=5_002_000)
    page = prom.expose(led.families("amtpu_lineage"))
    assert prom.validate_prom(page)["samples"] > 0
    assert "amtpu_lineage_span_seconds" in page
    assert "amtpu_lineage_visibility_ms" in page
    assert 'name="chains_started"' in page
    led_mod.disable()


@LEDGERS
def test_paired_dwell_survives_interleaved_hops(led_mod):
    led = led_mod.LineageLedger(rate=1)
    t0 = 1_000_000
    led.record("a", 1, "origin", site="a", t_ns=t0)
    led.record("a", 1, "quar/park", site="B", t_ns=t0 + 1_000)
    led.record("a", 1, "chan/retransmit", site="ch", extra=(1, 1),
               t_ns=t0 + 10_000)
    led.record("a", 1, "quar/release", site="B", t_ns=t0 + 51_000)
    agg = led.telemetry.span_aggregates()
    assert agg[("lineage", "dwell:quar/park")]["total_ns"] == 50_000
    assert ("lineage", "dwell:chan/retransmit") not in agg or \
        agg[("lineage", "dwell:chan/retransmit")]["max_ns"] <= 41_000


@LEDGERS
def test_late_origin_adoption_prepends_and_stays_complete(led_mod):
    led = led_mod.LineageLedger(rate=1)
    led.record("a", 1, "commit", site="B", doc="d", t_ns=5_000_000)
    assert led.telemetry.span_aggregates().get(
        ("lineage", "visibility")) is None
    led.adopt([["a", 1, 1_000_000, "origin-A"]])
    c = led.chain("a", 1)
    assert c["hops"][0][0] == "origin"
    assert c["origin_ns"] == 1_000_000
    vis = led.telemetry.span_aggregates()[("lineage", "visibility")]
    assert vis["count"] == 1 and vis["total_ns"] == 4_000_000
    assert led.stuck(k=4, at_ns=9_000_000)[0]["mid_flight"] is False
    led.adopt([["a", 1, 999, "evil-origin"]])
    assert led.chain("a", 1)["origin_ns"] == 1_000_000


def test_port_hop_sites_origin_and_stacked_plan():
    """The frontend's `origin` hop (one per local change, at the actor's
    site) and the stacked executor's `plan/stacked` hop, as in the JAX
    package; with tracing on they stitch into a validated flow."""
    import automerge_tpu as J
    import automerge_tpu_torch as T
    from automerge_tpu_torch.engine import stacked
    cpu = T.backend.backend_for("cpu")
    chains = {}
    for am, mod, o in ((J, j_lineage, "writer"),
                       (T, lineage, {"actorId": "writer", "backend": cpu})):
        led = mod.enable(rate=1, capacity=256)
        led.clear()
        d = am.change(am.init(o), lambda x: x.__setitem__("k", 1))
        d = am.change(d, lambda x: x.__setitem__("k", 2))
        chains[am] = [(c["actor"], c["seq"], [h[:2] for h in c["hops"]])
                      for c in led.chains()]
    assert chains[T] == chains[J] == [
        ("writer", 1, [("origin", "writer")]),
        ("writer", 2, [("origin", "writer")])]
    led = lineage.enable(rate=1, capacity=256)
    led.clear()
    old_min = os.environ.get("AMTPU_STACKED_MIN_OPS")
    os.environ["AMTPU_STACKED_MIN_OPS"] = "1"
    try:
        with obs.tracing():
            obs.clear()
            docs = [DeviceMapDoc(f"m{i}", device="cpu") for i in range(2)]
            items = [(doc, [{"actor": f"w{i}", "seq": 1, "deps": {},
                             "ops": [{"action": "set", "obj": doc.obj_id,
                                      "key": "k", "value": i}]}])
                     for i, doc in enumerate(docs)]
            lineage.hop("w0", 1, "origin", site="w0")
            assert stacked.apply_stacked(items)
            trace = to_chrome_trace(obs.snapshot(),
                                    t0_ns=obs.recorder().t0_ns)
    finally:
        if old_min is None:
            os.environ.pop("AMTPU_STACKED_MIN_OPS", None)
        else:
            os.environ["AMTPU_STACKED_MIN_OPS"] = old_min
    assert [h[0] for h in led.chain("w0", 1)["hops"]] == [
        "origin", "plan/stacked"]
    assert [h[0] for h in led.chain("w1", 1)["hops"]] == ["plan/stacked"]
    assert led.chain("w1", 1)["docs"] == set()   # plan hops name no site
    assert validate_chrome_trace(trace, require_flows=True)["n_flows"] >= 1


# --------------------------------------------------------------------------
# tests/test_device_truth.py twins
# --------------------------------------------------------------------------


def _storage_bytes(doc) -> int:
    st = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
          for t in doc._dev.values()}
    return sum(st.values())


def test_text_footprint_parity_with_live_buffers():
    doc = DeviceTextDoc("fp-text", device="cpu")
    doc.apply_batch(as_port(B.base_batch("fp-text", 2_000)))
    doc.text()
    fp = doc.device_footprint()
    assert fp["n_tables"] == 9
    assert fp["table_bytes"] == sum(t.numel() * t.element_size()
                                    for t in doc._dev.values())
    assert fp["storage_bytes"] == _storage_bytes(doc) >= fp["table_bytes"]
    assert fp["device_bytes"] >= fp["storage_bytes"]
    assert fp["host"]["index_ranges"] >= 1
    # in place, the tables are rows of the store's two buffers
    with PipelinedIngestor(doc, donate=True) as ring:
        ring.run([as_port(B.merge_batch("fp-text", 8, 10, 2_000, seed=1))])
    fp = doc.device_footprint()
    bufs = doc._store._bufs
    assert fp["storage_bytes"] == sum(b.untyped_storage().nbytes()
                                      for b in bufs) == _storage_bytes(doc)
    assert fp["storage_bytes"] > fp["table_bytes"]   # scratch column, pad
    doc._note_footprint()
    assert dt.REGISTRY.footprint()["gauges"]["doc:fp-text"] == \
        fp["device_bytes"]


def test_map_footprint_parity_and_gauge_feed():
    from automerge_tpu_torch.engine import MapChangeBatch
    dt.REGISTRY.clear_session()
    doc = DeviceMapDoc("fp-map", device="cpu")
    b = MapChangeBatch.from_changes([
        {"actor": "a", "seq": 1, "deps": {},
         "ops": [{"action": "set", "obj": "fp-map", "key": f"k{i}",
                  "value": i} for i in range(64)]}], "fp-map")
    doc.apply_batch(b)
    fp = doc.device_footprint()
    assert fp["n_tables"] == 5
    assert fp["storage_bytes"] == _storage_bytes(doc)
    g = dt.REGISTRY.footprint()
    assert g["gauges"].get("doc:fp-map") == fp["device_bytes"]
    assert g["peak_device_bytes"] >= fp["device_bytes"]


def test_byte_meters_move_and_are_exact_at_prepare():
    doc = DeviceTextDoc("meter-text", device="cpu")
    doc.apply_batch(as_port(B.base_batch("meter-text", 5_000)))
    doc.text()
    batch = as_port(B.merge_batch("meter-text", 100, 100, 5_000, seed=7))
    with accounting.track() as t:
        plan = doc.prepare_batch(batch)
        doc.commit_prepared(plan)
        doc.text()
    assert t.stats["h2d_bytes"] >= plan.n_staged_bytes > 0
    assert t.stats["d2h_bytes"] > 0
    assert doc.dispatch_stats["h2d_bytes"] > 0
    assert doc.dispatch_stats["d2h_bytes"] > 0


def test_footprint_feed_is_o1_and_build_samples_survive_commit_flood():
    dt.REGISTRY.clear_session()
    dt.record_build("t_lib", "build", 1_000, "libt_flood.so")
    n_build_samples = len(dt.REGISTRY._samples)
    assert n_build_samples >= 1
    for i in range(5000):
        dt.REGISTRY.note_footprint("doc", f"d{i % 7}", 100 + i)
    assert len(dt.REGISTRY._samples) == n_build_samples
    g = dt.REGISTRY.footprint()
    assert g["device_bytes_total"] == sum(
        v for key, v in g["gauges"].items() if key.startswith("doc:"))
    dt.REGISTRY.drop_footprint("doc", "d0")
    g2 = dt.REGISTRY.footprint()
    assert g2["device_bytes_total"] == sum(
        v for key, v in g2["gauges"].items() if key.startswith("doc:"))
    before = len(dt.REGISTRY._fp_samples)
    dt.REGISTRY.note_footprint("doc", "d1", g2["gauges"]["doc:d1"])
    assert len(dt.REGISTRY._fp_samples) == before


def test_dispatch_labels_name_the_kernels_their_programs_launch():
    assert dt.DISPATCH_LABEL_KERNELS["materialize"] == (
        "fused_segment_scans",)
    assert set(dt.DISPATCH_LABEL_KERNELS["fused_commit_round"]) == {
        "multi_scan", "fused_segment_scans"}
    assert dt.DISPATCH_LABEL_KERNELS["fused_commit_planned"] == (
        "multi_scan",)


def test_prom_families_validate_clean():
    dt.record_build("t_prom_lib", "load", 2_000, "libt_prom.so")
    dt.REGISTRY.note_footprint("doc", "prom-doc", 12345)
    S.multi_scan(torch.ones((2, 8), dtype=torch.int32))
    page = prom.expose(dt.families())
    assert prom.validate_prom(page)["samples"] > 0
    assert "amtpu_device_compiles_total" in page
    assert 'kernel="t_prom_lib"' in page
    assert 'amtpu_device_kernel_calls_total{kernel="multi_scan",' \
        'variant="plain"}' in page
    assert 'amtpu_device_footprint_bytes{key="prom-doc",kind="doc"} 12345' \
        in page


def test_counter_tracks_ride_the_trace_and_validate():
    with obs.tracing():
        obs.clear()
        t0 = obs.now()
        with obs.span_ctx("bench", "region"):
            dt.record_build("t_trace_lib", "load", 3_000, "libt_trace.so")
            dt.REGISTRY.note_footprint("doc", "trace-doc", 999)
        recs = obs.snapshot()
    trace = to_chrome_trace(recs, t0_ns=t0)
    assert validate_chrome_trace(trace)["n_counter_samples"] >= 2
    names = {ev["name"] for ev in trace["traceEvents"]
             if ev.get("ph") == "C"}
    assert "amtpu_device_compiles_total" in names
    assert "amtpu_device_device_bytes_total" in names


def test_counter_sample_schema_enforced():
    bad = {"traceEvents": [
        {"ph": "X", "name": "s", "cat": "c", "ts": 0, "dur": 1},
        {"ph": "C", "name": "ctr", "cat": "c", "ts": 0,
         "args": {"value": "not-a-number"}}]}
    with pytest.raises(TraceValidationError, match="counter"):
        validate_chrome_trace(bad)


def test_metrics_snapshot_carries_device_truth():
    doc = DeviceTextDoc("snap-text", device="cpu")
    doc.apply_batch(as_port(B.base_batch("snap-text", 300)))
    doc.apply_batch(as_port(B.merge_batch("snap-text", 4, 10, 300, seed=2)))
    snap = obs.metrics_snapshot()
    assert "device_truth" in snap
    s = snap["device_truth"]
    assert s["kernels"]["multi_scan/plain"]["calls"] >= 1
    assert s["compiles_total"] >= 1          # the codec's load at least
    assert any(k.startswith("native_codec/") for k in s["libraries"])
    assert s["footprint"]["gauges"]["doc:snap-text"] == \
        doc.device_footprint()["device_bytes"]
    assert {"h2d", "d2h"} <= set(s["staged_bytes"])


def test_library_load_recorded_once_then_steady(monkeypatch):
    """The codec's bind is one load event naming the library file; later
    loads are cache hits (no event) — the compile-event contract of the
    JAX package over the port's build/load events."""
    native.load()
    monkeypatch.setattr(native, "_LIB", None)
    snap = dt.REGISTRY.compile_snapshot()
    native.load()
    assert dt.REGISTRY.compiles_since(snap) == {("native_codec", "load"): 1}
    native.load()
    native.load()
    assert dt.REGISTRY.compiles_since(snap) == {("native_codec", "load"): 1}
    ev = [e for e in dt.REGISTRY.compile_events()
          if e["label"] == "native_codec"][-1]
    assert ev["sig"] == native.library_path().name and ev["wall_ns"] > 0
    rep = [r for r in dt.REGISTRY.recompile_report()
           if (r["label"], r["variant"]) == ("native_codec", "load")]
    assert rep and rep[0]["n_compiles"] >= 2
    assert rep[0]["signatures"][-1] == native.library_path().name


def test_steady_state_clean_and_violated(monkeypatch):
    doc = DeviceTextDoc("steady", device="cpu")
    doc.apply_batch(as_port(B.base_batch("steady", 1000)))
    doc.apply_batch(as_port(B.merge_batch("steady", 8, 10, 1000, seed=1,
                                          actor_prefix="w")))
    with dt.steady_state() as ss:
        for k in range(3):
            doc.apply_batch(as_port(B.merge_batch(
                "steady", 8, 10, 1000, seed=2 + k, actor_prefix=f"s{k}")))
    assert ss.recompiles == {}
    ss.assert_zero()
    monkeypatch.setattr(native, "_LIB", None)
    with dt.steady_state() as ss2:
        native.load()                     # a fresh bind INSIDE the region
    assert ss2.recompiles == {("native_codec", "load"): 1}
    with pytest.raises(AssertionError, match="native_codec"):
        ss2.assert_zero()


def test_disabled_flag_skips_the_feed():
    h = dt.REGISTRY.register("multi_scan", "plain")
    x = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    calls = h.calls
    dt.ENABLED = False
    y = S.multi_scan(x)
    assert h.calls == calls
    assert torch.equal(y, torch.cumsum(x, 1, dtype=torch.int32))
    dt.ENABLED = True
    S.multi_scan(x)
    assert h.calls == calls + 1


def test_routes_register_as_variants_with_measured_costs():
    """Each kernel registers a `cuda` and a `plain` handle; a plain call
    adds the bytes and operations of its shape, and the cost model, the
    attribution and the roofline read them."""
    ker = dt.REGISTRY.kernels()
    for name in ("multi_scan", "fused_segment_scans"):
        assert (name, "cuda") in ker and (name, "plain") in ker
    before = ker[("fused_segment_scans", "plain")]
    chain = torch.zeros((3, 64), dtype=torch.bool)
    S.fused_segment_scans(chain, chain.clone(),
                          torch.full((3,), 10, dtype=torch.int32))
    after = dt.REGISTRY.kernels()[("fused_segment_scans", "plain")]
    assert after["calls"] == before["calls"] + 1
    assert after["bytes"] - before["bytes"] == 14 * 3 * 64 + 4 * 3
    assert after["ops"] - before["ops"] == 3 * 3 * 64
    costs = dt.REGISTRY.kernel_costs()
    assert costs["fused_segment_scans"]["bytes_per_call"] > 0
    share = dt.attribute_device_time(
        {"materialize": 3, "fused_commit_planned": 1, "pack_rows": 2}, 1.0)
    assert abs(sum(share.values()) - 1.0) < 1e-5 and len(share) == 3
    roof = dt.roofline_seconds({"materialize": 2},
                               peak_flops=1e9, peak_bw=1e9)
    want = 2 * max(costs["fused_segment_scans"]["ops_per_call"],
                   costs["fused_segment_scans"]["bytes_per_call"]) / 1e9
    assert roof["seconds"] == round(want, 6)


def _per_call_ns(fn, x, n=1_000, rounds=5) -> float:
    best = None
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn(x)
        d = (time.perf_counter_ns() - t0) / n
        best = d if best is None else min(best, d)
    return best


def test_disabled_path_overhead_bound():
    x = torch.ones((2, 8), dtype=torch.int32)
    dt.ENABLED = False
    wrapped = _per_call_ns(S.multi_scan, x)
    raw = _per_call_ns(S.multi_scan_plain, x)
    assert wrapped - raw < 5_000, (wrapped, raw)


def test_enabled_probe_overhead_bound():
    x = torch.ones((2, 8), dtype=torch.int32)
    wrapped = _per_call_ns(S.multi_scan, x)
    raw = _per_call_ns(S.multi_scan_plain, x)
    assert wrapped - raw < 25_000, (wrapped, raw)


def _source_labels():
    """(dispatch_labels, sync_labels) present at call sites in the port's
    engine/ + ops/ source."""
    dispatch, sync = set(), set()
    for sub in ("engine", "ops"):
        root = os.path.join(PORT_ROOT, sub)
        for name in sorted(os.listdir(root)):
            if not name.endswith(".py"):
                continue
            src = open(os.path.join(root, name)).read()
            for m in re.finditer(
                    r'_count_dispatch\([^)]*label="([a-z_0-9]+)"', src):
                dispatch.add(m.group(1))
            for m in re.finditer(
                    r'_count_sync\([^)]*label="([a-z_0-9]+)"', src):
                sync.add(m.group(1))
            for m in re.finditer(
                    r'_count\(\s*stats\s*,\s*"([a-z_0-9]+)"', src):
                dispatch.add(m.group(1))
            for m in re.finditer(
                    r'_count_sync\(\s*stats\s*,\s*"([a-z_0-9]+)"', src):
                sync.add(m.group(1))
            # the stacked executor's fetch helper: _fetch(stats, "x", ...)
            for m in re.finditer(
                    r'_fetch\(\s*stats\s*,\s*"([a-z_0-9]+)"', src):
                sync.add(m.group(1))
    return dispatch, sync


def test_label_coverage_every_dispatch_label_registered():
    dispatch, sync = _source_labels()
    assert dispatch, "lint found no dispatch labels — regex rot"
    assert sync, "lint found no sync labels — regex rot"
    registered = dt.REGISTRY.registered_kernel_names()
    missing = {}
    for label in sorted(dispatch):
        kernels = dt.DISPATCH_LABEL_KERNELS.get(label)
        if kernels is None:
            missing[label] = "label not in DISPATCH_LABEL_KERNELS"
            continue
        unreg = [k for k in kernels if k not in registered]
        if unreg:
            missing[label] = f"kernels not registered: {unreg}"
    assert not missing, missing
    assert not sorted(sync - dt.SYNC_LABELS)


def test_label_map_has_no_stale_entries():
    dispatch, sync = _source_labels()
    assert not sorted(set(dt.DISPATCH_LABEL_KERNELS) - dispatch)
    assert not sorted(dt.SYNC_LABELS - sync)
