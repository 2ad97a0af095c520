"""Tracing tier of the PyTorch engine: the port of `automerge_tpu.obs`
(spans and counters into a lock-striped flight recorder, with rolling
telemetry, Chrome-trace export, Prometheus exposition, the change-lineage
ledger and the device-truth registry).

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
Read with `obs.recorder()` (a function, as in the JAX package: it
shadows the `recorder` submodule), `obs.telemetry()`,
`obs.metrics_snapshot()` and `obs.write_trace(path)` (obs/export.py).
The lineage ledger (obs/lineage.py) and the device-truth registry
(obs/device_truth.py) are independent of the trace ring; the latter is
always on and its summary rides `metrics_snapshot()["device_truth"]`.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

from .recorder import (  # noqa: F401  (span_seconds: re-exported)
    EVENT_DUR, FlightRecorder, span_seconds, span_totals,
)
from .telemetry import Telemetry  # noqa: F401  (re-exported)

#: THE fast-path gate, mutated only by enable()/disable().
ENABLED = False

_recorder: Optional[FlightRecorder] = None
_telemetry: Optional[Telemetry] = None

now = time.perf_counter_ns   # monotonic ns — the span clock


def enabled() -> bool:
    return ENABLED


def recorder() -> Optional[FlightRecorder]:
    """The live FlightRecorder (None when tracing never enabled)."""
    return _recorder


def telemetry() -> Optional[Telemetry]:
    """The live rolling-telemetry store (None when tracing never
    enabled). Created and cleared in lockstep with the recorder; fed at
    emit time by span()/event()/counter(), so its aggregates stay exact
    across trace-ring wraparound."""
    return _telemetry


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


def event(cat: str, name: str, args: Optional[dict] = None, n: int = 1):
    """Record an instant event and bump its counter."""
    rec = _recorder
    if rec is None:
        return
    ts = time.perf_counter_ns()
    rec.emit((ts, EVENT_DUR, cat, name, threading.get_ident(), args))
    rec.bump((cat, name), n)
    tel = _telemetry
    if tel is not None:
        tel.observe_count(cat, name, n, ts_ns=ts)


@contextmanager
def span_ctx(cat: str, name: str, args: Optional[dict] = None):
    """Span context manager for call sites off the hot path (scripts,
    tests); hot paths use the explicit now()/span() pair behind the flag."""
    t0 = now() if ENABLED else 0
    try:
        yield
    finally:
        if ENABLED and t0:
            span(cat, name, t0, args)


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


def metrics_snapshot(since_ns: int = 0) -> dict:
    """Aggregate view of the session: exact counters (wrap-proof) plus
    per-(cat, name) span aggregates.

        {"counters": {"chaos.drop": 12, ...},
         "spans": {"plan.prepare_batch": {"count", "total_ns",
                                          "min_ns", "max_ns"}, ...},
         "emitted": <total records ever>, "retained": <in ring now>}

    Span aggregates come from the telemetry store (fed at emit time),
    so they stay EXACT after trace-ring wraparound. A `since_ns` query
    falls back to the retained ring records (windowed queries belong to
    `telemetry().windows()`); the ring view is also always available
    directly via `span_totals(snapshot())`.
    """
    if _recorder is None:
        out = {"counters": {}, "spans": {}, "emitted": 0, "retained": 0}
        _merge_device_truth(out)
        return out
    if since_ns == 0 and _telemetry is not None:
        spans = {f"{c}.{n}": dict(agg) for (c, n), agg
                 in sorted(_telemetry.span_aggregates().items())}
    else:
        spans = {f"{c}.{n}": agg for (c, n), agg
                 in sorted(span_totals(_recorder.snapshot(since_ns))
                           .items())}
    out = {
        "counters": {f"{c}.{n}": v
                     for (c, n), v in sorted(_recorder.counters().items())},
        "spans": spans,
        "emitted": _recorder.n_emitted,
        "retained": _recorder.n_retained,
    }
    _merge_device_truth(out)
    return out


def _merge_device_truth(out: dict):
    """Attach the always-on device-truth aggregates (library builds and
    loads, kernel launches, footprint gauges) when the session touched a
    device — independent of the trace ring, like the lineage ledger."""
    from . import device_truth
    if device_truth.REGISTRY.touched():
        out["device_truth"] = device_truth.summary()


def clear():
    if _recorder is not None:
        _recorder.clear()
    if _telemetry is not None:
        _telemetry.clear()


def write_trace(path: str, since_ns: int = 0) -> str:
    """Dump the retained records as Chrome trace-event JSON (Perfetto-
    loadable); returns `path`. See obs/export.py for the schema."""
    from .export import write_trace as _write
    return _write(path, snapshot(since_ns),
                  t0_ns=None if _recorder is None else _recorder.t0_ns)


# honor AMTPU_TRACE=1 at import: a run needs no code path to remember to
# call enable() before the first span
if os.environ.get("AMTPU_TRACE", "0") not in ("", "0"):
    enable()

# the change-lineage tier (its own module flag + AMTPU_LINEAGE_RATE env
# bootstrap); imported last so `obs` is fully initialized when lineage's
# emit path reaches back for the trace-ring flag
from . import lineage  # noqa: E402,F401

# the device-truth tier (its own always-on module flag): metrics_snapshot
# and write_trace reach into it, and the kernel wrappers feed it
from . import device_truth  # noqa: E402,F401
