"""The port's lane workers (automerge_tpu_torch/shard/parallel.py)
against the JAX package's, on the CPU.

Every scenario runs through the JAX package on its 8 virtual CPU devices
and through the port with ``devices=[cpu]``, under the same
``AMTPU_PARALLEL_LANES`` setting. Tolerance is zero: the parallel and the
sequential path give the same bundle bytes, texts and per-lane counters
in each package, and the port's equal the JAX package's; so do the
executor's counters (submissions, completions, barriers, overlapped
rounds, pre-decoded batches).

- Twins of tests/test_parallel_mesh.py's flags, flag parity (1, 2 and 8
  lanes over seeds, `deliver_rounds`' pre-decode overlap, forced workers
  on one lane, migrations under workers), executor (ordering, drain on
  close, errors surfacing at the barrier after every lane quiesced, the
  overlap seam, barrier-wait telemetry and the ``amtpu_mesh_*`` families,
  a round-budget assert surfacing through the mesh) and residency under
  parallelism (the budget holds with workers on; a page-in thundering
  herd keeps the reservation ledger atomic).
- On the card (marked `cuda`): 8 threads on 8 streams launch
  `multi_scan` 200 times each and the launch counters read 1,600; a
  task's device work on its lane's stream is ordered after the
  submitting stream's and before the caller's next work.
"""

import random
import threading
from types import SimpleNamespace

import pytest
import torch

import automerge_tpu.shard as JSH
import automerge_tpu.shard.parallel as JPAR
import automerge_tpu_torch.shard as TSH
import automerge_tpu_torch.shard.parallel as TPAR
from automerge_tpu.engine import stacked as J_stacked
from automerge_tpu.obs import device_truth as J_dt
from automerge_tpu.obs.telemetry import Telemetry as JTelemetry
from automerge_tpu_torch.engine import stacked as T_stacked
from automerge_tpu_torch.obs import device_truth as T_dt
from automerge_tpu_torch.obs.telemetry import Telemetry as TTelemetry
from automerge_tpu_torch.ops import scan_kernels as S
from test_shard import chaotic_stream, map_change, text_change
from test_torch_soak_docs import threads_checked

CPU = torch.device("cpu")

J = SimpleNamespace(
    name="jax", shard=JSH, par=JPAR, stacked=J_stacked, dt=J_dt,
    Telemetry=JTelemetry,
    mesh=lambda **kw: JSH.ShardedDocSet(**kw),
    lane=lambda i, **kw: JSH.ShardLane(i, **kw))
T = SimpleNamespace(
    name="port", shard=TSH, par=TPAR, stacked=T_stacked, dt=T_dt,
    Telemetry=TTelemetry,
    mesh=lambda **kw: TSH.ShardedDocSet(devices=[CPU], **kw),
    lane=lambda i, **kw: TSH.ShardLane(i, device=CPU, **kw))


def same(run):
    want = run(J)
    got = run(T)
    assert got == want
    return got


@pytest.fixture(autouse=True)
def _small_gate(monkeypatch):
    monkeypatch.setenv("AMTPU_STACKED_MIN_OPS", "1")


@pytest.fixture(autouse=True)
def no_leaked_threads():
    """A test that leaves a new live thread behind fails, naming it."""
    with threads_checked():
        yield


# ---------------------------------------------------------------------------
# the flags
# ---------------------------------------------------------------------------


class TestFlags:
    def test_parallel_default_is_multi_lane_only(self, monkeypatch):
        monkeypatch.delenv("AMTPU_PARALLEL_LANES", raising=False)
        same(lambda P: [P.par.parallel_lanes_enabled(n)
                        for n in (1, 2, 8)])
        assert [TPAR.parallel_lanes_enabled(n) for n in (1, 2, 8)] == \
            [False, True, True]

    def test_parallel_overrides(self, monkeypatch):
        monkeypatch.setenv("AMTPU_PARALLEL_LANES", "0")
        assert same(lambda P: P.par.parallel_lanes_enabled(8)) is False
        monkeypatch.setenv("AMTPU_PARALLEL_LANES", "1")
        assert same(lambda P: P.par.parallel_lanes_enabled(1)) is True
        monkeypatch.setenv("AMTPU_PARALLEL_LANES", " 1 ")
        assert same(lambda P: P.par.parallel_lanes_enabled(1)) is True

    def test_tick_pipeline_follows_parallel_by_default(self, monkeypatch):
        monkeypatch.delenv("AMTPU_TICK_PIPELINE", raising=False)
        monkeypatch.delenv("AMTPU_PARALLEL_LANES", raising=False)
        assert same(lambda P: (P.par.tick_pipeline_enabled(2),
                               P.par.tick_pipeline_enabled(1))) == \
            (True, False)
        monkeypatch.setenv("AMTPU_PARALLEL_LANES", "0")
        assert same(lambda P: P.par.tick_pipeline_enabled(2)) is False

    def test_tick_pipeline_overrides_independently(self, monkeypatch):
        monkeypatch.setenv("AMTPU_PARALLEL_LANES", "1")
        monkeypatch.setenv("AMTPU_TICK_PIPELINE", "0")
        assert same(lambda P: P.par.tick_pipeline_enabled(8)) is False
        monkeypatch.setenv("AMTPU_PARALLEL_LANES", "0")
        monkeypatch.setenv("AMTPU_TICK_PIPELINE", "1")
        assert same(lambda P: P.par.tick_pipeline_enabled(1)) is True

    def test_default_counts_devices_not_lanes(self, monkeypatch):
        # the JAX package's 8 lanes sit on 8 devices and default to the
        # workers; the port's 8 lanes on one device default to the
        # sequential loop, and `AMTPU_PARALLEL_LANES=1` still forces them
        monkeypatch.delenv("AMTPU_PARALLEL_LANES", raising=False)
        jm, tm = J.mesh(n_shards=8, capacity=64), T.mesh(n_shards=8,
                                                         capacity=64)
        try:
            assert len({lane.device for lane in jm.lanes}) == 8
            assert jm.executor() is not None
            assert TPAR.lane_devices(tm.lanes) == 1
            assert tm.executor() is None
            monkeypatch.setenv("AMTPU_PARALLEL_LANES", "1")
            assert tm.executor() is not None
        finally:
            jm.close()
            tm.close()
        two = [SimpleNamespace(device=torch.device("cuda", i % 2))
               for i in range(8)]
        assert TPAR.lane_devices(two) == 2
        monkeypatch.delenv("AMTPU_PARALLEL_LANES")
        assert TPAR.parallel_lanes_enabled(TPAR.lane_devices(two))
        assert TPAR.tick_pipeline_enabled(TPAR.lane_devices(two))


# ---------------------------------------------------------------------------
# flag parity
# ---------------------------------------------------------------------------


def _run_mesh(P, seed, n_shards, flag, monkeypatch, rounds_api=False):
    monkeypatch.setenv("AMTPU_PARALLEL_LANES", flag)
    docs, rounds = chaotic_stream(seed)
    mesh = P.mesh(n_shards=n_shards, capacity=64)
    try:
        if rounds_api:
            mesh.deliver_rounds(rounds)
        else:
            for chunk in rounds:
                mesh.deliver_round(chunk)
        for d in docs:
            assert mesh.quarantined(d) == 0
        bundles = {d: mesh.capture(d) for d in docs}
        texts = mesh.texts()
        lane_stats = [dict(lane.stats) for lane in mesh.lanes]
        ex_stats = dict(mesh._executor.stats) \
            if mesh._executor is not None else None
    finally:
        mesh.close()
    return bundles, texts, lane_stats, ex_stats


class TestFlagParity:
    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("n_shards", [1, 2, 8])
    def test_parallel_matches_sequential_byte_identical(
            self, seed, n_shards, monkeypatch):
        """Parallel against sequential in the port, and both against the
        JAX package's parallel run: bundles, texts, lane counters and
        executor counters."""
        jpar = _run_mesh(J, seed, n_shards, "1", monkeypatch)
        seq = _run_mesh(T, seed, n_shards, "0", monkeypatch)
        par = _run_mesh(T, seed, n_shards, "1", monkeypatch)
        assert par[0] == seq[0], "bundle bytes diverged"
        assert par[1] == seq[1], "texts diverged"
        assert par[2] == seq[2], "lane stats diverged"
        assert seq[3] is None
        assert par[3] is not None and par[3]["errors"] == 0
        assert par[3]["submitted"] == par[3]["completed"] > 0
        assert par[3]["barriers"] > 0
        assert par == jpar

    def test_deliver_rounds_overlap_engages_and_stays_identical(
            self, monkeypatch):
        seq = _run_mesh(T, 3, 8, "0", monkeypatch)
        par = _run_mesh(T, 3, 8, "1", monkeypatch, rounds_api=True)
        assert par[0] == seq[0] and par[1] == seq[1] and par[2] == seq[2]
        assert par[3]["rounds_overlapped"] > 0
        assert par[3]["predecoded_batches"] > 0
        assert par == _run_mesh(J, 3, 8, "1", monkeypatch, rounds_api=True)

    def test_forced_parallel_on_one_lane(self, monkeypatch):
        seq = _run_mesh(T, 2, 1, "0", monkeypatch)
        par = _run_mesh(T, 2, 1, "1", monkeypatch)
        assert par[0] == seq[0] and par[1] == seq[1] and par[2] == seq[2]
        assert par[3]["submitted"] > 0
        assert par == _run_mesh(J, 2, 1, "1", monkeypatch)

    def test_migration_mid_stream_under_parallelism(self, monkeypatch):
        def run(P):
            docs, rounds = chaotic_stream(9, n_chunks=4)
            monkeypatch.setenv("AMTPU_PARALLEL_LANES", "0")
            ref = P.mesh(n_shards=1, capacity=64)
            for chunk in rounds:
                ref.deliver_round(chunk)
            monkeypatch.setenv("AMTPU_PARALLEL_LANES", "1")
            mesh = P.mesh(n_shards=8, capacity=64)
            try:
                moved = 0
                for i, chunk in enumerate(rounds):
                    mesh.deliver_round(chunk)
                    victim = docs[i % len(docs)]
                    if mesh.doc(victim) is not None:
                        dst = (mesh.placement.shard_of(victim) + 3) % 8
                        moved += mesh.migrate(victim, dst)
                assert moved >= 2
                assert mesh.texts() == ref.texts()
                caps = {d: mesh.capture(d) for d in docs}
                for d in docs:
                    assert caps[d] == ref.capture(d)
                return (moved, caps, [dict(lane.stats)
                                      for lane in mesh.lanes],
                        dict(mesh.stats), dict(mesh._executor.stats))
            finally:
                mesh.close()
        same(run)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


def _lanes(P, n):
    return [P.lane(i) for i in range(n)]


class TestExecutor:
    def test_results_in_submission_order(self):
        def run(P):
            with P.par.LaneExecutor(_lanes(P, 3)) as ex:
                tasks = [ex.submit(i, lambda v=i: v * 10) for i in range(3)]
                assert ex.barrier(tasks) == [0, 10, 20]
                assert ex.stats["completed"] == 3
                assert ex.stats["barriers"] == 1
                return dict(ex.stats)
        same(run)

    def test_per_lane_tasks_run_in_order(self):
        def run(P):
            seen = []
            with P.par.LaneExecutor(_lanes(P, 1)) as ex:
                tasks = [ex.submit(0, seen.append, k) for k in range(20)]
                ex.barrier(tasks)
            assert seen == list(range(20))
            return seen
        same(run)

    def test_close_is_idempotent_and_drains_pending(self):
        def run(P):
            done = []
            ex = P.par.LaneExecutor(_lanes(P, 2))
            for k in range(6):
                ex.submit(k % 2, done.append, k)
            ex.close()
            ex.close()
            assert sorted(done) == list(range(6))
            assert all(not w.is_alive() for w in ex._workers.values())
            with pytest.raises(RuntimeError):
                ex.submit(0, lambda: None)
            return sorted(done), ex.n_workers
        same(run)

    def test_error_reraises_after_all_lanes_quiesce(self):
        def run(P):
            other_done = threading.Event()

            def boom():
                raise AssertionError("round budget exceeded")

            def slow_ok():
                other_done.wait(timeout=5)
                return "ok"

            with P.par.LaneExecutor(_lanes(P, 2)) as ex:
                t0 = ex.submit(0, boom)
                t1 = ex.submit(1, slow_ok)
                other_done.set()
                with pytest.raises(AssertionError, match="round budget"):
                    ex.barrier([t0, t1])
                assert t1.done() and t1.result == "ok"
                assert ex.stats["errors"] == 1
                return dict(ex.stats)
        same(run)

    def test_while_waiting_runs_before_the_block(self):
        def run(P):
            order = []
            with P.par.LaneExecutor(_lanes(P, 1)) as ex:
                task = ex.submit(0, lambda: order.append("work"))
                ex.barrier([task],
                           while_waiting=lambda: order.append("over"))
            assert "over" in order
            return sorted(order)
        same(run)

    def test_barrier_wait_telemetry_and_families(self):
        def run(P):
            tel = P.Telemetry()
            with P.par.LaneExecutor(_lanes(P, 2), telemetry=tel) as ex:
                tasks = [ex.submit(i, lambda: None) for i in range(2)]
                ex.barrier(tasks)
                hists, aggs = tel.span_view()
                assert ("mesh", "barrier_wait") in hists
                assert aggs[("mesh", "barrier_wait")]["count"] == 1
                fams = ex.families()
                names = [f[0] for f in fams]
                for name in ("amtpu_mesh_workers", "amtpu_mesh_rounds_total",
                             "amtpu_mesh_rounds_overlapped_total",
                             "amtpu_mesh_barriers_total",
                             "amtpu_mesh_barrier_wait_seconds"):
                    assert name in names
                workers = dict(zip(names, fams))["amtpu_mesh_workers"]
                assert workers[3] == [({}, 2)]
                d = ex.describe()
                assert d["schema"] == "amtpu-mesh-exec-v1"
                assert len(d["workers"]) == 2
                # the histogram's samples are timings: compare its shape
                return ([f for f in fams
                         if f[0] != "amtpu_mesh_barrier_wait_seconds"],
                        [len(f[3]) for f in fams], d)
        same(run)

    def test_budget_assert_surfaces_through_the_mesh(self, monkeypatch):
        def run(P):
            monkeypatch.setenv("AMTPU_PARALLEL_LANES", "1")
            mesh = P.mesh(n_shards=2, capacity=64, doc_kind="map")
            try:
                def boom(st):
                    raise AssertionError("dispatch budget exceeded")
                with monkeypatch.context() as m:
                    m.setattr(P.stacked, "assert_round_budget", boom)
                    round_ = {f"bud-{i}": [map_change(
                        "a", 1, f"bud-{i}", [("k", i)])] for i in range(8)}
                    with pytest.raises(AssertionError,
                                       match="dispatch budget"):
                        mesh.deliver_round(round_)
                round2 = {f"ok-{i}": [map_change("a", 1, f"ok-{i}",
                                                 [("k", i)])]
                          for i in range(8)}
                assert mesh.deliver_round(round2) == 8
                return (dict(mesh._executor.stats),
                        [dict(lane.stats) for lane in mesh.lanes],
                        {d: mesh.doc(d).to_dict() for d in round2})
            finally:
                mesh.close()
        same(run)

    def test_worker_kernel_error_surfaces_at_the_barrier(self, monkeypatch):
        """A failure inside a lane's round (here the row-scan kernel's
        wrapper raising, as a failed launch does) is never swallowed: it
        re-raises on the deliver_round caller after every lane
        quiesced, and the mesh serves the next round."""
        from automerge_tpu_torch.ops import ingest as TI
        monkeypatch.setenv("AMTPU_PARALLEL_LANES", "1")
        mesh = T.mesh(n_shards=2, capacity=64)
        try:
            def failed_launch(x):
                raise RuntimeError("multi_scan: launch failed")
            round_ = {f"k-{i}": [text_change("a", 1, "xy", obj=f"k-{i}")]
                      for i in range(8)}
            with monkeypatch.context() as m:
                m.setattr(TI, "multi_scan", failed_launch)
                with pytest.raises(RuntimeError, match="launch failed"):
                    mesh.deliver_round(round_)
            assert mesh._executor.stats["errors"] == 1
            ok = {f"ok-{i}": [text_change("a", 1, "z", obj=f"ok-{i}")]
                  for i in range(8)}
            assert mesh.deliver_round(ok) == 16
            assert {d: mesh.texts()[d] for d in ok} == dict.fromkeys(ok, "z")
        finally:
            mesh.close()

    def test_mesh_describe_carries_executor(self, monkeypatch):
        def run(P):
            monkeypatch.setenv("AMTPU_PARALLEL_LANES", "1")
            mesh = P.mesh(n_shards=2, capacity=64)
            try:
                mesh.deliver_round({
                    "da": [text_change("a", 1, "x", obj="da")],
                    "db": [text_change("a", 1, "y", obj="db")]})
                d = mesh.describe()
                assert d["mesh_exec"]["schema"] == "amtpu-mesh-exec-v1"
                return d["mesh_exec"], d["stats"]
            finally:
                mesh.close()
        same(run)


# ---------------------------------------------------------------------------
# residency under parallelism
# ---------------------------------------------------------------------------


@pytest.fixture
def _fresh_gauges():
    for P in (J, T):
        P.dt.REGISTRY.clear_session()
    yield
    for P in (J, T):
        P.dt.REGISTRY.clear_session()


def _build(P, tmp_path, **kw):
    from test_torch_residency import build_mesh, prime
    spill = tmp_path / P.name
    spill.mkdir(exist_ok=True)
    mesh, res = build_mesh(P, n_shards=2, spill_dir=str(spill), budget=0,
                           **kw)
    prime(mesh, res)
    return mesh, res


class TestResidencyUnderParallelism:
    def test_population_10x_budget_peak_bounded_with_workers_on(
            self, monkeypatch, tmp_path, _fresh_gauges):
        def run(P):
            from test_torch_residency import res_state
            monkeypatch.setenv("AMTPU_PARALLEL_LANES", "1")
            P.dt.REGISTRY.clear_session()
            mesh, res = _build(P, tmp_path, cold_after=3)
            try:
                per_doc = res._est_bytes
                assert per_doc > 0
                budget = 3 * per_doc
                res.config.budget_bytes = budget
                n_docs, seqs = 30, {i: 0 for i in range(30)}
                rng = random.Random(20)
                trail = []
                for rnd in range(40):
                    deliveries = {}
                    for i in rng.sample(range(n_docs), 2):
                        seqs[i] += 1
                        a = f"a-doc{i}"
                        deliveries[f"doc{i}"] = [text_change(
                            a, seqs[i], "x", start_ctr=seqs[i],
                            obj=f"doc{i}",
                            after=(None if seqs[i] == 1
                                   else f"{a}:{seqs[i] - 1}"))]
                    mesh.deliver_round(deliveries)
                    fp = P.dt.REGISTRY.footprint()
                    assert fp["peak_device_bytes"] <= budget
                    trail.append(res.accounting()["hot"])
                m = res.metrics()
                assert m["budget_overruns"] == 0
                assert m["page_outs"] > 0 and m["page_ins"] > 0
                docs = sorted(f"doc{i}" for i in range(n_docs) if seqs[i])
                acct = res.accounting()
                assert sorted(acct["hot"] + acct["warm"] + acct["cold"]) \
                    == docs
                assert mesh._executor is not None \
                    and mesh._executor.stats["barriers"] > 0
                return (trail, res_state(P, mesh, res, docs),
                        dict(mesh._executor.stats),
                        {d: mesh.capture(d) for d in docs})
            finally:
                mesh.close()
        same(run)

    def test_reservation_ledger_survives_page_in_thundering_herd(
            self, monkeypatch, tmp_path, _fresh_gauges):
        """Concurrent page-ins land in whatever order the threads reach
        the lock, so each package is held to the invariants and the
        texts, and the two packages' populations and texts agree."""
        def run(P):
            monkeypatch.setenv("AMTPU_PARALLEL_LANES", "0")
            P.dt.REGISTRY.clear_session()
            mesh, res = _build(P, tmp_path)
            try:
                budget = 3 * res._est_bytes
                res.config.budget_bytes = budget
                n_docs = 8
                for i in range(n_docs):
                    mesh.deliver_round({f"h{i}": [text_change(
                        f"a{i}", 1, "z", obj=f"h{i}")]})
                for i in range(n_docs):
                    if res.tier_of(f"h{i}") == "hot":
                        res.demote(f"h{i}")
                start = threading.Barrier(n_docs)
                errors = []

                def herd(i):
                    try:
                        start.wait(timeout=10)
                        res.ensure_resident(f"h{i}")
                    except Exception as exc:   # noqa: BLE001
                        errors.append(exc)
                threads = [threading.Thread(target=herd, args=(i,))
                           for i in range(n_docs)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=30)
                assert not errors, errors
                fp = P.dt.REGISTRY.footprint()
                assert fp["peak_device_bytes"] <= budget
                acct = res.accounting()
                herd_docs = sorted(d for d in acct["hot"] + acct["warm"]
                                   + acct["cold"] if d.startswith("h"))
                assert herd_docs == [f"h{i}" for i in range(n_docs)]
                assert res.metrics()["budget_overruns"] == 0
                texts = {}
                for i in range(n_docs):
                    res.ensure_resident(f"h{i}")
                    lane = mesh.lane_of(f"h{i}")
                    with lane.device_ctx():
                        texts[f"h{i}"] = lane.docs[f"h{i}"].text()
                assert set(texts.values()) == {"z"}
                return herd_docs, texts, res._est_bytes
            finally:
                mesh.close()
        same(run)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_launch_counters_lose_nothing_under_threads(cuda_device):
    """8 threads, each on its own stream, launch `multi_scan` 200 times:
    the launch counter and the per-shape counter read 1,600, and every
    result equals the plain version."""
    x = torch.randint(0, 5, (12, 300), dtype=torch.int32,
                      device=cuda_device)
    want = S.multi_scan_plain(x.cpu())
    S.load()
    torch.cuda.synchronize()
    S.reset_launches()
    start = threading.Barrier(8)
    bad, errors = [], []

    def worker():
        try:
            stream = torch.cuda.Stream(cuda_device)
            start.wait(timeout=30)
            with torch.cuda.stream(stream):
                outs = [S.multi_scan(x) for _ in range(200)]
            stream.synchronize()
            bad.extend(o for o in outs if not torch.equal(o.cpu(), want))
        except Exception as exc:   # noqa: BLE001
            errors.append(exc)
    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert not bad
    assert S.launches["multi_scan"] == 1600
    assert S.launch_shapes["multi_scan"] == {(12, 300): 1600}


@pytest.mark.cuda
def test_executor_orders_lane_streams_around_the_caller(cuda_device):
    """A worker's kernels run on its lane's stream after the work the
    caller enqueued before submitting, and the caller's work after the
    barrier sees the lane's results — with no host synchronization in
    between."""
    lanes = [TSH.ShardLane(i, device=cuda_device) for i in range(4)]
    n = 1 << 22
    with TPAR.LaneExecutor(lanes) as ex:
        for rep in range(5):
            src = torch.full((n,), rep + 1, dtype=torch.int32,
                             device=cuda_device)
            outs = [None] * 4

            def task(i, src=src, outs=outs):
                assert torch.cuda.current_stream() == lanes[i].stream
                x = src.view(64, -1) * (i + 1)
                outs[i] = S.multi_scan(x)
                outs[i].record_stream(torch.cuda.current_stream())
            tasks = [ex.submit(i, task, i) for i in range(4)]
            ex.barrier(tasks)
            tails = torch.stack([o[:, -1] for o in outs])
            got = tails.cpu()
            row = n // 64
            for i in range(4):
                assert bool((got[i] == (rep + 1) * (i + 1) * row).all())
