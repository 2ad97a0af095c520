"""Lock-striped ring-buffer flight recorder — the storage tier of
`automerge_tpu_torch.obs`.

Design constraints (INTERNALS §11):

- **Bounded memory.** Records live in N_STRIPES independent ring buffers
  of `capacity` slots each; overflow overwrites the oldest record of the
  writer's stripe (the flight-recorder contract: the newest spans always
  survive). Worst-case footprint is ``n_stripes * capacity`` small
  tuples — ~tens of MB at the default 8 x 32768 even with per-record
  arg dicts.
- **No torn records.** A record is ONE tuple appended under its stripe's
  lock; readers only ever observe whole tuples. Stripes are selected by
  thread id, so the pipeline ring's worker thread and the caller thread
  write to different stripes and never contend on one lock in steady
  state (threads can hash-collide onto a stripe; the lock keeps that
  correct, just slower).
- **Snapshot without perturbing writers** (Jiffy's snapshot discipline,
  PAPERS.md): `snapshot()` copies each stripe's list under its lock —
  an O(capacity) slice copy, no global pause, writers blocked only for
  their own stripe's copy.
- **Counters survive wraparound.** Event/dispatch COUNTS aggregate in
  per-stripe dicts independent of the ring, so `metrics_snapshot()`
  totals are exact even after the ring dropped the oldest records.

This module is import-light on purpose (stdlib only): the engine imports
it on every process start, traced or not.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

# Record tuple layout (documented in INTERNALS §11; exported traces map it
# onto Chrome trace events):
#   (ts_ns, dur_ns, cat, name, tid, args)
# dur_ns >= 0  -> a completed span [ts_ns, ts_ns + dur_ns)
# dur_ns == -1 -> an instant event at ts_ns
# args: a small dict of payload fields (doc id, batch gen, counts...) or
# None. ts_ns is time.perf_counter_ns — monotonic within the process,
# comparable across threads.
EVENT_DUR = -1

TS, DUR, CAT, NAME, TID, ARGS = range(6)

#: Stripe count — a power of two so stripe selection is one mask op.
N_STRIPES = 8

#: Default ring capacity PER STRIPE (records). Override with
#: ``AMTPU_TRACE_CAPACITY`` (also per stripe) before `enable()`.
DEFAULT_CAPACITY = 32768


def default_capacity() -> int:
    try:
        cap = int(os.environ.get("AMTPU_TRACE_CAPACITY", "0"))
    except ValueError:
        cap = 0
    return cap if cap > 0 else DEFAULT_CAPACITY


class _Stripe:
    __slots__ = ("lock", "buf", "head", "counters")

    def __init__(self):
        self.lock = threading.Lock()
        self.buf: list = []      # ring storage (grows to capacity, then wraps)
        self.head = 0            # total records ever written to this stripe
        self.counters: dict = {}  # (cat, name) -> count (wrap-proof)


class FlightRecorder:
    """Bounded, lock-striped span/event store. One instance per enabled
    tracing session (module-level in `automerge_tpu_torch.obs`)."""

    def __init__(self, capacity: Optional[int] = None,
                 n_stripes: int = N_STRIPES):
        if n_stripes < 1 or n_stripes & (n_stripes - 1):
            raise ValueError("n_stripes must be a power of two")
        self.capacity = max(16, capacity if capacity is not None
                            else default_capacity())
        self._mask = n_stripes - 1
        self._stripes = [_Stripe() for _ in range(n_stripes)]
        self.t0_ns = time.perf_counter_ns()   # session origin (export base)

    # -- write side (hot; callers already checked the enable flag) -------

    def emit(self, rec: tuple):
        """Append one whole record tuple to the writer thread's stripe."""
        s = self._stripes[threading.get_ident() & self._mask]
        with s.lock:
            if len(s.buf) < self.capacity:
                s.buf.append(rec)
            else:
                s.buf[s.head % self.capacity] = rec
            s.head += 1

    def bump(self, key: tuple, n: int = 1):
        """Aggregate a counter (exact across ring wraparound)."""
        s = self._stripes[threading.get_ident() & self._mask]
        with s.lock:
            s.counters[key] = s.counters.get(key, 0) + n

    # -- read side (never blocks writers globally) ------------------------

    def snapshot(self, since_ns: int = 0) -> list:
        """All retained records (oldest-first by timestamp), optionally
        only those starting at/after `since_ns`. Each stripe is copied
        under its own lock; the merge runs outside any lock."""
        out: list = []
        for s in self._stripes:
            with s.lock:
                if len(s.buf) < self.capacity:
                    part = list(s.buf)
                else:
                    cut = s.head % self.capacity
                    part = s.buf[cut:] + s.buf[:cut]
            out.extend(part)
        if since_ns:
            out = [r for r in out if r[TS] >= since_ns]
        out.sort(key=lambda r: r[TS])
        return out

    def counters(self) -> dict:
        """Merged counter totals: {(cat, name): count}."""
        out: dict = {}
        for s in self._stripes:
            with s.lock:
                items = list(s.counters.items())
            for k, v in items:
                out[k] = out.get(k, 0) + v
        return out

    @property
    def n_emitted(self) -> int:
        """Total records ever written (>= retained when wrapped)."""
        return sum(s.head for s in self._stripes)

    @property
    def n_retained(self) -> int:
        return sum(min(s.head, self.capacity) for s in self._stripes)

    def clear(self):
        for s in self._stripes:
            with s.lock:
                s.buf = []
                s.head = 0
                s.counters = {}


def span_totals(records, cat: Optional[str] = None) -> dict:
    """Aggregate spans by (cat, name): {key: {"count", "total_ns",
    "min_ns", "max_ns"}}. Events (dur == -1) are excluded. `cat` filters
    to one category."""
    out: dict = {}
    for r in records:
        if r[DUR] < 0 or (cat is not None and r[CAT] != cat):
            continue
        key = (r[CAT], r[NAME])
        agg = out.get(key)
        if agg is None:
            out[key] = {"count": 1, "total_ns": r[DUR],
                        "min_ns": r[DUR], "max_ns": r[DUR]}
        else:
            agg["count"] += 1
            agg["total_ns"] += r[DUR]
            if r[DUR] < agg["min_ns"]:
                agg["min_ns"] = r[DUR]
            if r[DUR] > agg["max_ns"]:
                agg["max_ns"] = r[DUR]
    return out


def span_seconds(records, cat: str, name: Optional[str] = None) -> float:
    """Total seconds of all spans in `cat` (optionally one `name`) — the
    bench serial-profile derivation: a term is the SUM of the recorded
    spans of its category, never whatever elapsed between two hand-placed
    perf_counter calls (a misattribution class, made structural)."""
    total = 0
    for r in records:
        if (r[DUR] >= 0 and r[CAT] == cat
                and (name is None or r[NAME] == name)):
            total += r[DUR]
    return total / 1e9
