"""Async checkpoint writer riding the two-phase ingestion seam.

``PipelinedIngestor`` (engine/pipeline.py) established the pattern: heavy
work overlaps device execution on a background thread, and every commit is
generation-checked so a racing mutation degrades to the safe serial path
instead of corrupting state. The checkpoint writer is the read-side twin:

- **Phase 1 (grab)** is a generation-stamped snapshot of an engine doc's
  mutable host state plus references to its device tables
  (:func:`~.engine_codec.grab` — microseconds, no d2h traffic). The
  worker retries it a bounded number of times when the doc's generation
  moves mid-grab (ingestion committed underneath it).
- **Phase 2 (encode)** — the d2h fetch, hashing, and bundle encoding —
  runs entirely on the worker thread, overlapping subsequent ingestion:
  rounds that run out of place never write a published table, so the
  captured state stays frozen no matter how far the doc advances. A doc
  with in-place tables (``donate_buffers``) refuses the deferred grab.

Streams on a card: the worker runs on the document's device
(`engine.pipeline.device_ctx_factory`) and on a stream of its own, so its
d2h copies never queue behind the ring's commits. ``capture_async``
names the caller's current stream (the one the commits run on) as the
producer: the grab records a CUDA event there, and the worker's stream
waits on that event before it reads the tables (engine_codec
``encode_grab``), tying the tables to its stream with ``record_stream``.
A backend-state capture on the worker replays its private fork on the
lineage's device, on the worker's stream.

If every grab attempt conflicts, the handle degrades to a **synchronous
capture**: ``result()`` performs the grab on the calling thread — the
caller invokes it at a commit boundary (after ``flush()``), where it owns
quiescence — and only the encode half still benefits from having been a
separate phase. ``stats`` counts how often each path ran.

Backend states (``DeviceBackendState`` / oracle ``BackendState``) need no
generation protocol at all: they are immutable views, and a state whose
core advanced restores consistency by forking its command-log prefix —
``capture_async`` just ships the whole capture to the worker.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from .. import obs
from . import bundle as _bundle
from .engine_codec import CaptureConflict, encode_grab, grab

_ENGINE_DOC_MANIFEST = {"engine": "engine-doc"}


def encode_engine_grab(g: dict) -> bytes:
    """A grab -> standalone engine-doc bundle bytes (deterministic)."""
    frag, arrays = encode_grab(g)
    return _bundle.encode({**_ENGINE_DOC_MANIFEST, "doc": frag,
                           "clock": frag["clock"]}, arrays)


class CheckpointHandle:
    """Future for one capture. ``result()`` blocks until the bundle is
    encoded; on grab-conflict exhaustion it performs the degraded
    synchronous grab on the calling thread."""

    def __init__(self, doc):
        self._doc = doc
        self._done = threading.Event()
        self._data = None
        self._error = None
        self._needs_sync = False

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float = None) -> bytes:
        if not self._done.wait(timeout):
            raise TimeoutError("checkpoint capture still in flight")
        if self._needs_sync:
            # degraded path: the caller owns quiescence here (commit
            # boundary), so a synchronous grab cannot conflict — and the
            # grab is encoded before any further (possibly donating)
            # commit can consume its buffers, hence inline=True
            _t0 = obs.now() if obs.ENABLED else 0
            self._data = encode_engine_grab(grab(self._doc, inline=True))
            if obs.ENABLED:
                obs.span("ckpt", "capture", _t0, args={
                    "mode": "sync_degraded", "bytes": len(self._data)})
            self._needs_sync = False
            self._error = None
        if self._error is not None:
            raise self._error
        return self._data


class AsyncCheckpointer:
    """Background checkpoint writer for engine docs and backend states.

    One worker thread, lazily started; captures queue FIFO. Contract for
    engine docs mirrors the ingestion pipeline's: the document is mutated
    by one thread (the pipeline caller), grabs race only against commits
    and are generation-checked with bounded retry, and ``result()`` is
    called at a commit boundary."""

    def __init__(self, max_grab_retries: int = 3):
        self._max_retries = max(1, max_grab_retries)
        self._lock = threading.Lock()
        self._thread = None
        self._queue = []
        self._wake = threading.Condition(self._lock)
        self._closing = False
        self._streams: dict = {}     # device -> the worker's stream
        self.stats = {"async_captures": 0, "grab_conflicts": 0,
                      "sync_fallbacks": 0, "snapshot_serves": 0}

    # -- lifecycle -------------------------------------------------------

    def _ensure_worker(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker, name="amtpu-ckpt", daemon=True)
            self._thread.start()

    def close(self):
        with self._wake:
            self._closing = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- captures --------------------------------------------------------

    def capture_async(self, target) -> CheckpointHandle:
        """Queue a capture of an engine doc or a backend state."""
        handle = CheckpointHandle(target)
        device = _device_of(target)
        producer = (torch.cuda.current_stream(device)
                    if device is not None and device.type == "cuda"
                    else None)
        with self._wake:
            if self._closing:
                raise RuntimeError("AsyncCheckpointer is closed")
            self._queue.append((target, handle, producer))
            self._ensure_worker()
            self._wake.notify_all()
        return handle

    @staticmethod
    def capture(target) -> bytes:
        """Synchronous capture (the identity comparator for the async
        path: same target, same bytes)."""
        if _is_engine_doc(target):
            # synchronous: grabbed refs are encoded before returning, so
            # a donation-enabled doc is safe here (inline contract)
            return encode_engine_grab(grab(target, inline=True))
        from .backend_codec import capture_state
        return capture_state(target)

    # -- worker ----------------------------------------------------------

    def _worker(self):
        while True:
            with self._wake:
                while not self._queue and not self._closing:
                    self._wake.wait()
                if not self._queue and self._closing:
                    return
                target, handle, producer = self._queue.pop(0)
            try:
                with self._device_ctx(_device_of(target)):
                    if _is_engine_doc(target):
                        self._capture_engine(target, handle, producer)
                    else:
                        # worker-side backend capture: never walk a live
                        # core another thread mutates — capture a private
                        # fork of the state's command-log prefix instead
                        from .backend_codec import capture_state
                        handle._data = capture_state(
                            target, assume_quiescent=False)
                        self.stats["async_captures"] += 1
            except BaseException as exc:   # surfaced via result()
                handle._error = exc
            finally:
                handle._done.set()

    def _device_ctx(self, device):
        """The worker's context for a capture on `device`: pinned to the
        device, on the worker's own stream there (a null context on the
        CPU or for an oracle state)."""
        if device is None or device.type != "cuda":
            return contextlib.nullcontext()
        from ..engine.pipeline import device_ctx_factory
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        return device_ctx_factory(device, stream)()

    def _capture_engine(self, doc, handle, producer=None):
        g = None
        _t0 = obs.now() if obs.ENABLED else 0
        for _ in range(self._max_retries):
            try:
                g = grab(doc, stream=producer)
                if g.get("mode") == "snapshot":
                    # zero-coordination read of the doc's cached
                    # commit-boundary state: a mutation (bulk index
                    # merge, stacked apply) was in flight, and instead
                    # of the old busy-wait/retry ladder the grab served
                    # the last consistent snapshot (INTERNALS §16.4)
                    self.stats["snapshot_serves"] += 1
                break
            except CaptureConflict:
                self.stats["grab_conflicts"] += 1
                if obs.ENABLED:
                    obs.event("ckpt", "grab_conflict",
                              args={"doc": doc.obj_id})
        if g is None:
            # ingestion never paused long enough: degrade to a
            # synchronous grab on the caller's thread at result() time
            self.stats["sync_fallbacks"] += 1
            handle._needs_sync = True
            if obs.ENABLED:
                obs.event("ckpt", "sync_fallback",
                          args={"doc": doc.obj_id})
            return
        handle._data = encode_engine_grab(g)
        self.stats["async_captures"] += 1
        if obs.ENABLED:
            obs.span("ckpt", "capture", _t0, args={
                "mode": "async", "doc": doc.obj_id,
                "bytes": len(handle._data)})


def _is_engine_doc(target) -> bool:
    from ..engine.base import CausalDeviceDoc
    return isinstance(target, CausalDeviceDoc)


def _device_of(target):
    """The torch device a capture target lives on (None for an oracle
    state)."""
    if _is_engine_doc(target):
        return target.device
    core = getattr(target, "_core", None)
    return None if core is None else core.device
