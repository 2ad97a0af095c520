"""Tracing tier of the PyTorch engine: a trimmed copy of
`automerge_tpu.obs` (spans and counters into a lock-striped
flight recorder, with rolling telemetry).

Contract for instrumented call sites (the hot-path discipline):

    from automerge_tpu_torch import obs
    ...
    t0 = obs.now() if obs.ENABLED else 0
    ... the work ...
    if obs.ENABLED:
        obs.span("plan", "prepare_batch", t0,
                 args={"doc": self.obj_id, "n_ops": batch.n_ops})

``obs.ENABLED`` is a module attribute: when tracing is off, the emit
path is one module-dict lookup and a falsy branch. Enable via
``AMTPU_TRACE=1``, `obs.enable()`, or the scoped ``with obs.tracing():``.
The device-truth and lineage tiers of the JAX package are not part of
this package.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

from .recorder import FlightRecorder, span_seconds  # noqa: F401
from .telemetry import Telemetry

#: THE fast-path gate, mutated only by enable()/disable().
ENABLED = False

_recorder: Optional[FlightRecorder] = None
_telemetry: Optional[Telemetry] = None

now = time.perf_counter_ns   # monotonic ns — the span clock


def enable(capacity: Optional[int] = None) -> FlightRecorder:
    """Turn tracing on (idempotent). The recorder is created on first
    enable and retained across disable(); pass `capacity` (records per
    stripe) to size a fresh one."""
    global ENABLED, _recorder, _telemetry
    if _recorder is None or capacity is not None:
        _recorder = FlightRecorder(capacity)
        _telemetry = Telemetry()
    elif _telemetry is None:
        _telemetry = Telemetry()
    ENABLED = True
    return _recorder


def disable():
    global ENABLED
    ENABLED = False


@contextmanager
def tracing(capacity: Optional[int] = None):
    """Scoped enable: tracing on inside the block, restored (not force-
    disabled) on exit. Yields the recorder."""
    was = ENABLED
    rec = enable(capacity)
    try:
        yield rec
    finally:
        if not was:
            disable()


def span(cat: str, name: str, t0_ns: int, args: Optional[dict] = None,
         t1_ns: Optional[int] = None):
    """Record a completed span started at `t0_ns` (from `obs.now()`).
    A zero `t0_ns` (tracing was off when the region started) is dropped."""
    rec = _recorder
    if rec is None or not t0_ns:
        return
    end = t1_ns if t1_ns is not None else time.perf_counter_ns()
    dur = max(0, end - t0_ns)
    rec.emit((t0_ns, dur, cat, name, threading.get_ident(), args))
    tel = _telemetry
    if tel is not None:
        tel.observe_span(cat, name, dur, ts_ns=t0_ns)


def counter(cat: str, name: str, n: int = 1):
    """Bump a counter without a ring record (exact totals, no ring
    pressure)."""
    rec = _recorder
    if rec is not None:
        rec.bump((cat, name), n)
        tel = _telemetry
        if tel is not None:
            tel.observe_count(cat, name, n)


def snapshot(since_ns: int = 0) -> list:
    """All retained records (see recorder.snapshot); [] when never
    enabled."""
    return [] if _recorder is None else _recorder.snapshot(since_ns)


if os.environ.get("AMTPU_TRACE", "0") not in ("", "0"):
    enable()
