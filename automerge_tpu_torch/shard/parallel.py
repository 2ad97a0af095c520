"""Parallel mesh execution: persistent per-lane worker threads
(INTERNALS §24).

Every structural win since the stacked executor is dispatch-count
accounting; this module converts them into wall-clock on a real mesh.
A :class:`LaneExecutor` owns ONE persistent daemon worker thread per
shard lane (the `PipelinedIngestor` thread/queue discipline, lifted
from per-doc to per-lane): the router fans a serving round out on the
caller thread, each touched lane's worker runs its stacked ingest
concurrently on the lane's device and CUDA stream (on one card, several
lanes are several streams: the workers' host planning overlaps and
their kernels may run side by side), and a round barrier precedes every
piece of commit-boundary work (quarantine drain to fixpoint, rebalancer
policy, residency ``after_round`` + the reservation-ledger clear) — so
the budget invariant and the migration pen semantics are untouched by
parallelism.

Stream ordering (the lane-boundary discipline of `shard/lane.py`): a
task records an event on the submitting thread's current stream and the
worker makes the lane's stream wait for it before running; the task
records an event on the lane's stream when it ends, and the barrier
makes the caller's current stream wait for every task's event before it
returns — so commit-boundary work on the caller's stream (quarantine
drain, captures, texts, residency demotes) never races a lane's
kernels, and the next round's lane work never races the caller's.

Safety argument (PAM's partition-parallel shape, PAPERS.md): placement
gives every doc exactly ONE owning lane, so concurrent lane ingests
never share doc state, and no lane program ever names another lane's
device or stream. Shared sinks on the worker path are all
concurrency-safe (telemetry: lock-striped; lineage ledger: locked;
byte/dispatch accounting: locked; device-truth registry: process-global
lock; the kernel launch counters of `ops/scan_kernels.py`: locked).
Everything else — the ``ShardedDocSet.stats`` dict, residency,
rebalance, placement — stays caller-thread-only, and per-lane ``ShardLane.stats`` increments ride a
per-task delta dict folded at the barrier (no lost updates, and budget
tests read race-free numbers).

Flags (read per call):

- ``AMTPU_PARALLEL_LANES`` — ``0`` forces the sequential loop (the
  parity comparator, kept verbatim in ``ShardedDocSet``), ``1`` forces
  workers on; unset defaults to ON when the mesh's lanes span more than
  one device. Lanes that are streams of one card run sequentially by
  default: their host work is Python under one interpreter lock, so
  workers cannot overlap it, and their kernels already overlap through
  the streams (PERF.md: on an H100 the workers ran shard-a 3-4x slower
  than the sequential loop).
- ``AMTPU_TICK_PIPELINE`` — the service-tick fan-out + frame pre-decode
  seam of the service tier; defaults to the lane-worker setting.

Acceptance is byte-identity: the parallel and sequential paths commit
through the SAME `ShardLane.ingest` / `apply_stacked` code, differing
only in which thread runs it, so capture bundles and texts cannot
diverge; the flag-matrix parity suite (tests/test_torch_lane_workers.py)
asserts exactly that on randomized chaotic streams.
"""

from __future__ import annotations

import os
import queue
import threading
import time

import torch

from .. import obs


def parallel_lanes_enabled(n_devices: int) -> bool:
    """Whether lane ingest rounds fan out to the worker pool.
    ``AMTPU_PARALLEL_LANES``: ``0`` off, ``1`` on, unset → on iff the
    mesh's lanes span more than one device, `n_devices` (lanes on one
    device have no host work to overlap; forcing ``1`` there stays
    correct and exercises the worker path)."""
    raw = os.environ.get("AMTPU_PARALLEL_LANES", "").strip()
    if raw == "0":
        return False
    if raw == "1":
        return True
    return n_devices > 1


def lane_devices(lanes) -> int:
    """The number of distinct devices `lanes` run on: the argument of
    `parallel_lanes_enabled` and `tick_pipeline_enabled`."""
    return len({lane.device for lane in lanes})


def tick_pipeline_enabled(n_devices: int) -> bool:
    """Whether ``SyncService.tick()`` fans grouped gate deliveries out
    per lane and pre-decodes the next tick's frames while device work
    drains. Defaults to the lane-worker setting so one flag drives the
    whole parallel tier; ``AMTPU_TICK_PIPELINE=0/1`` overrides."""
    raw = os.environ.get("AMTPU_TICK_PIPELINE", "").strip()
    if raw == "0":
        return False
    if raw == "1":
        return True
    return parallel_lanes_enabled(n_devices)


class _Task:
    """One unit of lane work: a future the round barrier waits on. On a
    card, `ready` is the submitting stream's event the lane waits for
    before the task and `finished` the lane stream's event the barrier
    waits for after it."""

    __slots__ = ("fn", "args", "kwargs", "lane_index", "result", "error",
                 "_done", "queued_while_busy", "ready", "finished")

    def __init__(self, lane_index, fn, args, kwargs):
        self.lane_index = lane_index
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.result = None
        self.error = None
        self._done = threading.Event()
        self.queued_while_busy = False
        self.ready = None
        self.finished = None

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self):
        self._done.wait()


_STOP = object()


class _LaneWorker(threading.Thread):
    """The persistent thread bound to one shard lane. Tasks run in
    submission order (a lane's rounds are causally ordered — the queue
    IS the per-lane pipeline); every task executes with the lane's
    device and stream current (the current stream is per thread), so
    staged tensors and kernel launches land on the lane's stream,
    exactly like the caller-thread path."""

    def __init__(self, lane, executor):
        super().__init__(name=f"amtpu-lane{lane.index}", daemon=True)
        self.lane = lane
        self.executor = executor
        self.tasks: "queue.SimpleQueue" = queue.SimpleQueue()
        self.busy = False          # caller-observed (GIL-atomic flag)
        self.rounds = 0
        # resolved ONCE (engine/pipeline.py, shared with the per-doc
        # ring): the hot loop builds no device objects per round
        from ..engine.pipeline import device_ctx_factory
        self._device_ctx = device_ctx_factory(lane.device, lane.stream)
        self.start()

    def run(self):
        while True:
            task = self.tasks.get()
            if task is _STOP:
                return
            self.busy = True
            _t0 = obs.now() if obs.ENABLED else 0
            stream = self.lane.stream
            try:
                with self._device_ctx():
                    if task.ready is not None:
                        stream.wait_event(task.ready)
                    try:
                        task.result = task.fn(*task.args, **task.kwargs)
                    finally:
                        if stream is not None:
                            task.finished = torch.cuda.Event()
                            task.finished.record(stream)
            except BaseException as exc:   # surfaced at the barrier
                task.error = exc
            finally:
                self.rounds += 1
                if obs.ENABLED:
                    obs.span("lane", "round", _t0, args={
                        "lane": self.lane.index,
                        "worker": self.name,
                        "error": task.error is not None})
                self.busy = False
                task._done.set()


class LaneExecutor:
    """The per-mesh worker pool: one persistent worker per lane,
    ``submit`` + ``barrier``, per-round overlap counters, and the
    ``amtpu_mesh_*`` exposition families."""

    def __init__(self, lanes, telemetry=None):
        self.telemetry = telemetry
        self.stats = {"submitted": 0, "completed": 0, "barriers": 0,
                      "rounds_overlapped": 0, "predecoded_batches": 0,
                      "errors": 0}
        self._closed = False
        self._workers = {lane.index: _LaneWorker(lane, self)
                         for lane in lanes}

    # -- dispatch -------------------------------------------------------

    def submit(self, lane_index: int, fn, *args, **kwargs) -> _Task:
        """Queue one unit of work on `lane_index`'s worker. Returns the
        task future the round barrier waits on. Tasks for one lane run
        in submission order; tasks for different lanes run
        concurrently."""
        if self._closed:
            raise RuntimeError("LaneExecutor is closed")
        w = self._workers[lane_index]
        task = _Task(lane_index, fn, args, kwargs)
        task.queued_while_busy = w.busy
        lane = w.lane
        if lane.stream is not None:
            # the lane's work must follow everything the submitting
            # thread enqueued before it (the worker waits on this event)
            task.ready = torch.cuda.Event()
            task.ready.record(torch.cuda.current_stream(lane.device))
        self.stats["submitted"] += 1
        w.tasks.put(task)
        return task

    def barrier(self, tasks, while_waiting=None) -> list:
        """The round barrier: wait for EVERY task (commit-boundary work
        must never observe a half-ingested round), then re-raise the
        first worker error on the caller thread — after all workers
        quiesced, so an assert in one lane cannot leave another lane's
        ingest racing the caller's unwind. `while_waiting` is the
        host/device overlap seam: pure host work (next-round decode)
        the caller runs before blocking. On a card the caller's current
        stream then waits for every task's lane stream, so the caller's
        next device work is ordered after the round."""
        if while_waiting is not None:
            while_waiting()
        t0 = time.perf_counter_ns()
        for task in tasks:
            task.wait()
        for task in tasks:
            if task.finished is not None:
                lane = self._workers[task.lane_index].lane
                torch.cuda.current_stream(lane.device).wait_event(
                    task.finished)
        wait_ns = time.perf_counter_ns() - t0
        self.stats["barriers"] += 1
        self.stats["completed"] += len(tasks)
        if self.telemetry is not None:
            # the barrier-wait histogram the amtpu_mesh_* families export:
            # how long the caller thread stalls on the slowest lane
            # (overlap work excluded — it ran before the block above)
            self.telemetry.observe_span("mesh", "barrier_wait", wait_ns)
        if obs.ENABLED:
            obs.span("mesh", "barrier_wait", t0, args={
                "tasks": len(tasks)}, t1_ns=t0 + wait_ns)
        for task in tasks:
            if task.error is not None:
                self.stats["errors"] += 1
                raise task.error
        return [task.result for task in tasks]

    # -- lifecycle ------------------------------------------------------

    @property
    def n_workers(self) -> int:
        return len(self._workers)

    def close(self):
        """Stop every worker (idempotent). Pending tasks drain first —
        the stop sentinel queues BEHIND them, so close at a commit
        boundary never abandons an in-flight round."""
        if self._closed:
            return
        self._closed = True
        for w in self._workers.values():
            w.tasks.put(_STOP)
        for w in self._workers.values():
            w.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- exposition -----------------------------------------------------

    def describe(self) -> dict:
        return {
            "schema": "amtpu-mesh-exec-v1",
            "workers": {i: {"alive": w.is_alive(), "rounds": w.rounds}
                        for i, w in sorted(self._workers.items())},
            "stats": dict(self.stats),
        }

    def families(self, prefix: str = "amtpu_mesh") -> list:
        """Prometheus exposition families (SyncService.scrape appends
        these next to the service families): worker count, per-worker
        round totals, rounds overlapped (host planning of round t+1
        under round t's device drain), and the barrier-wait
        histogram."""
        fams = [
            (f"{prefix}_workers", "gauge",
             "Persistent lane worker threads (one per shard lane; 0 "
             "when parallel execution is off).",
             [({}, sum(w.is_alive() for w in self._workers.values()))]),
            (f"{prefix}_rounds_total", "counter",
             "Lane ingest rounds executed per worker.",
             [({"lane": str(i)}, w.rounds)
              for i, w in sorted(self._workers.items())]),
            (f"{prefix}_rounds_overlapped_total", "counter",
             "Rounds whose next-round host planning (wire decode / "
             "columnar build) overlapped the in-flight device leg.",
             [({}, self.stats["rounds_overlapped"])]),
            (f"{prefix}_barriers_total", "counter",
             "Round barriers taken (one per fanned-out round).",
             [({}, self.stats["barriers"])]),
        ]
        if self.telemetry is not None:
            from ..obs.telemetry import N_BUCKETS, bucket_le_ns
            hists, aggs = self.telemetry.span_view()
            key = ("mesh", "barrier_wait")
            if key in hists:
                buckets = hists[key]
                agg = aggs.get(key, {"count": 0, "total_ns": 0})
                samples, cum = [], 0
                for i in range(N_BUCKETS + 1):
                    cum += buckets[i]
                    le = bucket_le_ns(i) / 1e9
                    samples.append((("_bucket", {
                        "le": "+Inf" if le == float("inf") else repr(le)}),
                        cum))
                samples.append((("_sum", {}), agg["total_ns"] / 1e9))
                samples.append((("_count", {}), agg["count"]))
                fams.append((
                    f"{prefix}_barrier_wait_seconds", "histogram",
                    "Caller-thread stall at the round barrier (time to "
                    "the slowest lane), log2 buckets fed at emit time.",
                    samples))
        return fams
