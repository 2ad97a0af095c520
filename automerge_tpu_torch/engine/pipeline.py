"""Host-side planning parallelism, host->device staging and the pipelined
ingestion ring.

Counterpart of `automerge_tpu/engine/pipeline.py`:

- `planner_pool()` — one small shared ThreadPoolExecutor. The heavy
  planning passes (the native run-detection walker, numpy column passes)
  release the GIL, so sharding one batch's planning across a few threads
  runs at real parallelism on multicore hosts (`AMTPU_PLAN_WORKERS=1`
  disables sharding).
- `stage_h2d()` — asynchronous host->device staging: the array is copied
  into pinned host memory and handed to the device with a non-blocking
  copy on the document's staging stream, so the transfer overlaps the
  remaining host planning AND the commits running on the compute stream.
  The caller keeps the pinned buffer referenced and owns the completion
  barrier (engine/base.py `prepare_batch`, which waits on the staging
  stream only).
- `PipelinedIngestor` — the K-deep in-flight batch ring: a worker thread
  prepares batch k+1 chained onto batch k's still-uncommitted plan
  (`prepare_batch(after=...)`) while the caller thread commits batch k
  and the card runs its kernels. `slots` PreparedBatch slots bound the
  speculation (default `AMTPU_PIPELINE_DEPTH`, 4). Every commit is
  generation-checked; a mismatch (the document mutated outside the ring)
  falls back to a fresh inline prepare instead of corrupting state.
  `stats` reports how the session ran (chained vs serial prepares,
  fallbacks, committed batches, the per-commit dispatch/sync budget).

Streams on a card: the caller's commits run on its current stream (the
compute stream); the worker's staging copies run on the document's
staging stream (`CausalDeviceDoc._stage_stream`), so a prepare never
waits for the commits ahead of it. Any other device work the worker does
(an unchained prepare's actor remap) runs on the compute stream, ordered
after every commit enqueued before it. At commit the compute stream waits
on the round's own staging event, and the staged tensors are handed to it
with `record_stream` (engine/text_doc.py `_execute_plan`), so the caching
allocator cannot give their memory to the next batch's copies while a
commit still reads it.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading

import numpy as np
import torch

from .. import obs

_POOL = None
_POOL_LOCK = threading.Lock()

# the dtypes a round plan stages (int32 matrices and scalars, uint8 blobs)
_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.bool_): torch.bool}


def plan_workers() -> int:
    """Worker count for sharded planning. 1 disables sharding."""
    try:
        w = int(os.environ.get("AMTPU_PLAN_WORKERS", "0"))
    except ValueError:
        w = 0
    if w <= 0:
        w = min(4, os.cpu_count() or 1)
    return max(1, w)


def pipeline_depth() -> int:
    """Default in-flight slot count of the batch ring (K). K-1 chained
    plans can run ahead of the commit front; 4 keeps planning, staging,
    commit and device execution all occupied without unbounded
    speculation (each slot pins its plan's staged device buffers until
    commit). AMTPU_PIPELINE_DEPTH overrides; 1 degrades to serial."""
    try:
        k = int(os.environ.get("AMTPU_PIPELINE_DEPTH", "0"))
    except ValueError:
        k = 0
    return k if k >= 1 else 4


def planner_pool():
    """The ONE shared planning pool (lazy; None when workers == 1)."""
    global _POOL
    if plan_workers() == 1:
        return None
    with _POOL_LOCK:
        if _POOL is None:
            from concurrent.futures import ThreadPoolExecutor
            _POOL = ThreadPoolExecutor(
                max_workers=plan_workers(),
                thread_name_prefix="amtpu-plan")
    return _POOL


def device_ctx_factory(device, stream=None):
    """A zero-arg context-manager factory pinning work to `device` (a
    ``torch.cuda.device`` context, plus ``torch.cuda.stream(stream)``
    when a stream is given), or a nullcontext factory for the CPU. The
    ring resolves it once, so its hot paths build no device objects per
    call."""
    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext

    def ctx():
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(device))
        if stream is not None:
            stack.enter_context(torch.cuda.stream(stream))
        return stack
    return ctx


def stage_h2d(arr: np.ndarray, device, stream) -> tuple:
    """Stage a host array onto `device` -> (device tensor, pinned host
    tensor or None). On a CUDA device the copy is non-blocking from pinned
    memory, enqueued on `stream` (the document's staging stream); the
    caller keeps the pinned tensor alive until its barrier. On the CPU
    (`stream` None) the result is a private copy and nothing is pinned."""
    device = torch.device(device)
    dtype = _TORCH_DTYPES[arr.dtype]
    if device.type == "cpu":
        return torch.from_numpy(np.array(arr, copy=True)), None
    pinned = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
    pinned.numpy()[...] = arr
    with torch.cuda.stream(stream):
        return pinned.to(device, non_blocking=True), pinned


class PipelineError(RuntimeError):
    """A background prepare failed; the original exception chains."""


_SERIAL = object()   # worker marker: batch not chainable, prepare inline


class PipelinedIngestor:
    """K-deep in-flight batch ring for one CausalDeviceDoc.

    Contract: while a pipeline session is open, the document is mutated
    ONLY through it. The worker thread prepares each fed batch chained
    onto the previous (still pending) plan's shadow state
    (`prepare_batch(after=...)`), so planning of batch k+1 overlaps both
    the caller's commit bookkeeping for batch k and the card's kernel
    execution; `slots` bounds the speculation depth (2 = double
    buffering; default AMTPU_PIPELINE_DEPTH, 4). Commits happen on the
    caller thread only and stay generation-checked: if the document moved
    under a pending plan (outside mutation, or a chained base that
    failed), the commit degrades to a fresh inline prepare+commit —
    semantics are always exactly apply_batch's.

    `donate=True` switches the document onto the in-place commit rounds
    for the session (`donate_buffers`, engine/base.py): each round writes
    into the live tables' storage, so device allocation stays flat across
    the ring instead of holding a new table set per commit. The flag is
    restored on close().

    Batches whose actor interning would reorder existing ranks cannot be
    planned against an uncommitted base (the remap would invalidate the
    base plan's staged columns); the worker marks those and the caller
    prepares them serially after the preceding commit. Wide merge loads
    intern fresh actors in lexicographic append position, so the chained
    path is the common case.

    The worker and the commits run on the document's device. The worker
    runs its non-staging device work on the stream that was current on
    the constructing thread (the compute stream), so it is ordered after
    the commits before it.
    """

    def __init__(self, doc, slots: int = None, donate: bool = False):
        self.doc = doc
        self.device = doc.device
        self._n_slots = max(1, pipeline_depth() if slots is None else slots)
        self._slots = threading.Semaphore(self._n_slots)
        self._in: "queue.Queue" = queue.Queue()
        self._out: "queue.Queue" = queue.Queue()
        self._n_fed = 0
        self._total_fed = 0
        self._cv = threading.Condition()
        self._n_committed = 0
        self._fallbacks = 0     # commits that degraded to a fresh prepare
        self._chained = 0       # background prepares chained onto a base
        self._serial = 0        # batches the caller had to prepare inline
        # running min/max of the per-commit device-interaction deltas
        # (doc.last_commit_stats): the ring's public budget surface
        self._budget = {"dispatches_min": None, "dispatches_max": 0,
                        "syncs_min": None, "syncs_max": 0}
        self._closing = False
        self._donate = donate
        self._donate_prior = getattr(doc, "donate_buffers", False)
        if donate:
            doc.donate_buffers = True
        # serializes prepare_batch calls between the worker and the
        # caller's degraded-path inline re-prepares (commit_next): two
        # concurrent UNCHAINED prepares could race actor interning
        self._prep_lock = threading.Lock()
        compute = (torch.cuda.current_stream(self.device)
                   if self.device.type == "cuda" else None)
        self._device_ctx = device_ctx_factory(self.device)
        self._worker_ctx = device_ctx_factory(self.device, compute)
        self._thread = threading.Thread(
            target=self._worker, name="amtpu-pipeline", daemon=True)
        self._started = False

    # -- context manager -------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # a clean exit commits everything still in flight — silently
        # dropping fed batches would violate the apply_batch-equivalence
        # contract; an exceptional exit just tears the worker down
        try:
            if exc_type is None:
                self.flush()
        finally:
            self.close()
        return False

    def close(self):
        """Terminal: a closed ingestor cannot be fed again (its worker
        thread is joined; start a new instance for a new session)."""
        with self._cv:
            self._closing = True
            self._cv.notify_all()       # unpark a quiescence wait
        if self._started:
            self._in.put(None)
            self._thread.join()
            self._started = False
        if self._donate:
            self.doc.donate_buffers = self._donate_prior

    @property
    def stats(self) -> dict:
        """How the session actually ran: ring depth, committed batches,
        chained vs caller-inline (serial) prepares, degraded-path
        fallbacks, and the per-commit dispatch/sync budget — so a ring
        that silently degraded to serial planning cannot pass as
        pipelined."""
        with self._cv:
            return {"depth": self._n_slots,
                    "committed": self._n_committed,
                    "chained_prepares": self._chained,
                    "fresh_prepares": (self._n_committed - self._chained
                                       - self._serial),
                    "serial_prepares": self._serial,
                    "fallbacks": self._fallbacks,
                    "per_commit_budget": dict(self._budget)}

    # -- feeding / committing --------------------------------------------
    def feed(self, batch):
        """Queue a batch for background planning. At the `slots` bound,
        feed COMMITS the oldest in-flight batch inline instead of
        blocking — commits happen on the caller thread only, so waiting
        on the semaphore with a full pipeline would deadlock (nobody
        else can drain it)."""
        if self._closing:
            raise RuntimeError("PipelinedIngestor is closed")
        if not self._started:
            self._thread.start()
            self._started = True
        while not self._slots.acquire(blocking=False):
            self.commit_next()
        self._in.put((self._total_fed, batch))
        self._total_fed += 1
        self._n_fed += 1

    def commit_next(self):
        """Commit the oldest fed batch (blocking on its prepare)."""
        if self._n_fed <= 0:
            raise RuntimeError("commit_next with no batch fed")
        self._n_fed -= 1
        k, batch, plan, err = self._out.get()
        _t0 = obs.now() if obs.ENABLED else 0
        serial = fallback = False
        try:
            if err is not None:
                raise PipelineError(
                    "background prepare failed") from err
            if plan is _SERIAL:
                serial = True
                with self._cv:
                    self._serial += 1
                with self._prep_lock, self._device_ctx():
                    plan = self.doc.prepare_batch(batch)
            try:
                with self._device_ctx():
                    self.doc.commit_prepared(plan)
            except ValueError:
                # generation mismatch: the document moved under the
                # pending plan — re-plan against live state and commit
                # (the documented degraded path, never silent corruption).
                # Bumping the fallback count makes the worker abandon the
                # now-dead chain base instead of chaining onto it forever.
                fallback = True
                if obs.ENABLED:
                    obs.event("ring", "fallback",
                              args={"doc": self.doc.obj_id, "slot": k})
                with self._cv:
                    self._fallbacks += 1
                with self._prep_lock, self._device_ctx():
                    plan = self.doc.prepare_batch(batch)
                with self._device_ctx():
                    self.doc.commit_prepared(plan)
        finally:
            with self._cv:
                self._n_committed += 1
                self._cv.notify_all()
            self._slots.release()
            if obs.ENABLED:
                obs.span("ring", "commit", _t0, args={
                    "doc": self.doc.obj_id, "slot": k,
                    "gen": self.doc._gen, "serial": serial,
                    "fallback": fallback})
        # reached on successful commits only: fold the committed batch's
        # device-interaction delta into the public budget surface
        st = getattr(self.doc, "last_commit_stats", None)
        if st:
            with self._cv:
                b = self._budget
                for key in ("dispatches", "syncs"):
                    b[key + "_max"] = max(b[key + "_max"], st[key])
                    b[key + "_min"] = (st[key] if b[key + "_min"] is None
                                       else min(b[key + "_min"], st[key]))

    def flush(self):
        """Commit every batch still in flight; returns the document."""
        while self._n_fed:
            self.commit_next()
        return self.doc

    def run(self, batches):
        """Pipeline a whole sequence: feed + commit with `slots` lag."""
        for b in batches:
            self.feed(b)
            # drain down to (slots - 1) speculative plans so the worker
            # keeps its lookahead while feed() can never block on an
            # exhausted semaphore (slots=1 degrades to a serial schedule)
            while self._n_fed >= self._n_slots:
                self.commit_next()
        return self.flush()

    # -- worker ----------------------------------------------------------
    def _worker(self):
        base = None       # the previous (possibly uncommitted) plan
        seen_fallbacks = 0
        while True:
            item = self._in.get()
            if item is None:
                return
            k, batch = item
            plan = err = None
            try:
                with self._cv:
                    if self._fallbacks != seen_fallbacks:
                        # a commit degraded to a fresh inline prepare:
                        # any pending chain base is dead (its
                        # committed_gen will never match) — drop it and
                        # re-enter via the quiescence path
                        seen_fallbacks = self._fallbacks
                        base = None
                if base is None:
                    # no pending plan to chain onto: a live-state prepare
                    # must not race a commit still mutating the document,
                    # so wait until every earlier batch has committed
                    with self._cv:
                        self._cv.wait_for(
                            lambda: self._n_committed >= k
                            or self._closing)
                    if self._closing and self._n_committed < k:
                        # abandoned session: hand the batch back serial
                        if obs.ENABLED:
                            obs.event("ring", "abort", args={
                                "doc": self.doc.obj_id, "slot": k})
                        self._out.put((k, batch, _SERIAL, None))
                        continue
                try:
                    _t0 = obs.now() if obs.ENABLED else 0
                    with self._prep_lock, self._worker_ctx():
                        plan = self.doc.prepare_batch(batch, after=base)
                    if obs.ENABLED:
                        obs.span("ring", "plan", _t0, args={
                            "doc": self.doc.obj_id, "slot": k,
                            "chained": base is not None})
                    if base is not None:
                        with self._cv:
                            self._chained += 1
                except ValueError:
                    # not chainable (actor remap / missing shadow):
                    # the caller prepares this one inline after the
                    # preceding commit lands
                    plan = _SERIAL
                    if obs.ENABLED:
                        obs.event("ring", "serial", args={
                            "doc": self.doc.obj_id, "slot": k})
            except BaseException as e:   # handed to the caller, re-raised
                err = e
                plan = None
            self._out.put((k, batch, plan, err))
            base = plan if plan not in (None, _SERIAL) else None
