"""Bounded rolling time-series telemetry — the *continuous* tier of
`automerge_tpu_torch.obs` (INTERNALS §14).

The flight recorder (`obs/recorder.py`) answers "what just happened":
individual spans in a ring whose oldest records drop on wraparound. This
module answers "what has been happening": per-window aggregates fed AT
EMIT TIME, so their accuracy is independent of trace-ring retention —
the bug class this closes is `metrics_snapshot()` span histograms
silently going inexact once the ring wrapped.

Three stores, all bounded, all lock-striped by writer thread id (the
recorder's Jiffy discipline: snapshots copy each stripe under its own
lock, writers are never globally paused):

- **Exact aggregates.** Per-(cat, name) span `{count, total, min, max}`
  and counter totals, updated on every emit. These never decay.
- **Log-bucketed duration histograms.** Power-of-two buckets from ~1 µs
  to ~34 s (26 buckets + overflow) per span key — enough resolution for
  conservative p50/p99 bounds at a fixed, tiny footprint.
- **Rolling windows.** A fixed ring of `n_windows` per-window aggregate
  slots (counter deltas + span count/total per key), keyed by
  `ts // window_ns`. A window older than the ring simply rolls off —
  the time-series view is bounded regardless of process lifetime.

Memory bound: `stripes × (n_windows × live keys + histogram keys)`
small dicts. Keys come from the code-defined category taxonomy
(INTERNALS §11.3), not from peers, so the key population is bounded by
the instrumentation, never by traffic. Gauges are a single small
last-value-wins dict keyed (name, labels) under one lock — gauge
populations (e.g. per-tenant lag) are bounded by their caller (the
service drops a tenant's gauges with the tenant).

Stdlib-only on purpose, like the recorder: importable on every process
start, traced or not.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

#: Stripe count (power of two: stripe selection is one mask op).
N_STRIPES = 8

#: Histogram bucket layout: bucket i covers durations in
#: (2^(LOW+i-1), 2^(LOW+i)] ns, i.e. upper bounds 2^BUCKET_LOW ns (~1 µs)
#: through 2^(BUCKET_LOW+N_BUCKETS-1) ns (~34 s); index N_BUCKETS is the
#: +Inf overflow bucket.
BUCKET_LOW = 10
N_BUCKETS = 26

#: Default window width (1 s of perf_counter time) and ring depth — a
#: bit over two minutes of continuous series at the defaults.
DEFAULT_WINDOW_NS = 1_000_000_000
DEFAULT_N_WINDOWS = 128


def bucket_index(dur_ns: int) -> int:
    """Log2 bucket for a non-negative duration. Upper bounds are
    inclusive (Prometheus ``le`` semantics): a duration of exactly
    2^k ns lands in the ``le=2^k`` bucket, not the next one up."""
    if dur_ns <= 1:
        return 0
    return min(max((dur_ns - 1).bit_length() - BUCKET_LOW, 0), N_BUCKETS)


def bucket_le_ns(i: int) -> float:
    """Upper bound (ns) of bucket `i`; +inf for the overflow bucket."""
    return float("inf") if i >= N_BUCKETS else float(1 << (BUCKET_LOW + i))


class _Stripe:
    __slots__ = ("lock", "counts", "spans", "hist", "windows")

    def __init__(self, n_windows: int):
        self.lock = threading.Lock()
        self.counts: dict = {}    # key -> exact total
        self.spans: dict = {}     # key -> [count, total_ns, min_ns, max_ns]
        self.hist: dict = {}      # key -> list[int] of N_BUCKETS + 1
        # window ring: slot (wid % n_windows) -> [wid, counts, spans]
        self.windows: list = [None] * n_windows


class Telemetry:
    """Bounded rolling telemetry store. One instance lives beside the
    flight recorder in `automerge_tpu_torch.obs` (fed by span()/event()/
    counter() when tracing is enabled); the service tier owns a second,
    always-on instance for tick/lag series independent of tracing."""

    def __init__(self, window_ns: int = DEFAULT_WINDOW_NS,
                 n_windows: int = DEFAULT_N_WINDOWS,
                 n_stripes: int = N_STRIPES):
        if n_stripes < 1 or n_stripes & (n_stripes - 1):
            raise ValueError("n_stripes must be a power of two")
        if window_ns < 1 or n_windows < 1:
            raise ValueError("window_ns and n_windows must be >= 1")
        self.window_ns = window_ns
        self.n_windows = n_windows
        self._mask = n_stripes - 1
        self._stripes = [_Stripe(n_windows) for _ in range(n_stripes)]
        self._gauge_lock = threading.Lock()
        self._gauges: dict = {}   # (name, labels-tuple) -> value
        self.t0_ns = time.perf_counter_ns()

    # -- write side (hot when tracing is on) -----------------------------

    def _window(self, s: _Stripe, ts_ns: int) -> Optional[list]:
        wid = ts_ns // self.window_ns
        slot = wid % self.n_windows
        w = s.windows[slot]
        if w is None or w[0] != wid:
            if w is not None and w[0] > wid:
                # stale observation from before the ring's horizon (e.g.
                # a span longer than the whole ring): its window already
                # rolled off — drop it rather than clobber the live slot
                return None
            w = s.windows[slot] = [wid, {}, {}]   # roll: old window drops
        return w

    def observe_span(self, cat: str, name: str, dur_ns: int,
                     ts_ns: Optional[int] = None):
        """Fold one completed span into the exact aggregates, the log
        histogram, and the current window. Called at emit time — never
        derived from retained ring records."""
        if ts_ns is None:
            ts_ns = time.perf_counter_ns()
        key = (cat, name)
        s = self._stripes[threading.get_ident() & self._mask]
        with s.lock:
            agg = s.spans.get(key)
            if agg is None:
                s.spans[key] = [1, dur_ns, dur_ns, dur_ns]
            else:
                agg[0] += 1
                agg[1] += dur_ns
                if dur_ns < agg[2]:
                    agg[2] = dur_ns
                if dur_ns > agg[3]:
                    agg[3] = dur_ns
            h = s.hist.get(key)
            if h is None:
                h = s.hist[key] = [0] * (N_BUCKETS + 1)
            h[bucket_index(dur_ns)] += 1
            w = self._window(s, ts_ns)
            if w is not None:
                wagg = w[2].get(key)
                if wagg is None:
                    w[2][key] = [1, dur_ns]
                else:
                    wagg[0] += 1
                    wagg[1] += dur_ns

    def observe_count(self, cat: str, name: str, n: int = 1,
                      ts_ns: Optional[int] = None):
        """Bump a counter: exact total plus this window's delta."""
        if ts_ns is None:
            ts_ns = time.perf_counter_ns()
        key = (cat, name)
        s = self._stripes[threading.get_ident() & self._mask]
        with s.lock:
            s.counts[key] = s.counts.get(key, 0) + n
            w = self._window(s, ts_ns)
            if w is not None:
                w[1][key] = w[1].get(key, 0) + n

    def set_gauge(self, name: str, value, **labels):
        """Last-value-wins gauge (lag tables, occupancy levels)."""
        with self._gauge_lock:
            self._gauges[(name, tuple(sorted(labels.items())))] = value

    def drop_gauge(self, name: str, **labels):
        with self._gauge_lock:
            self._gauges.pop((name, tuple(sorted(labels.items()))), None)

    # -- read side (merges stripes; never blocks writers globally) -------

    def counters(self) -> dict:
        """Exact counter totals: {(cat, name): n} — independent of both
        the window ring and the trace ring."""
        out: dict = {}
        for s in self._stripes:
            with s.lock:
                items = list(s.counts.items())
            for k, v in items:
                out[k] = out.get(k, 0) + v
        return out

    def span_view(self) -> tuple:
        """Consistent ``(histograms, span_aggregates)`` pair: each
        stripe's hist and spans are copied under ONE lock acquisition,
        and every emit updates both under that same lock — so a span is
        either in both views or in neither. The histogram bucket total
        therefore always equals the aggregate count, the invariant a
        Prometheus histogram exposition (+Inf bucket == ``_count``)
        requires even while writers keep emitting."""
        hists: dict = {}
        aggs: dict = {}
        for s in self._stripes:
            with s.lock:
                h_items = [(k, list(v)) for k, v in s.hist.items()]
                a_items = [(k, list(v)) for k, v in s.spans.items()]
            for k, buckets in h_items:
                acc = hists.get(k)
                if acc is None:
                    hists[k] = buckets
                else:
                    for i, b in enumerate(buckets):
                        acc[i] += b
            for k, (n, tot, lo, hi) in a_items:
                agg = aggs.get(k)
                if agg is None:
                    aggs[k] = {"count": n, "total_ns": tot,
                               "min_ns": lo, "max_ns": hi}
                else:
                    agg["count"] += n
                    agg["total_ns"] += tot
                    agg["min_ns"] = min(agg["min_ns"], lo)
                    agg["max_ns"] = max(agg["max_ns"], hi)
        return hists, aggs

    def span_aggregates(self) -> dict:
        """Exact per-key span aggregates fed at emit time:
        {(cat, name): {"count", "total_ns", "min_ns", "max_ns"}}."""
        return self.span_view()[1]

    def histograms(self) -> dict:
        """Merged log-bucket counts: {(cat, name): [N_BUCKETS+1 ints]}."""
        return self.span_view()[0]

    def quantile_ns(self, cat: str, name: str, p: float) -> float:
        """Conservative quantile bound from the log histogram: the upper
        edge of the bucket holding the nearest-rank sample (the overflow
        bucket answers with the exact tracked max). 0.0 when the key has
        no samples."""
        key = (cat, name)
        hist = self.histograms().get(key)
        if not hist:
            return 0.0
        total = sum(hist)
        if total == 0:
            return 0.0
        rank = max(1, -(-int(p * total * 1000) // 1000))  # ceil, fp-safe
        rank = min(rank, total)
        seen = 0
        for i, n in enumerate(hist):
            seen += n
            if seen >= rank:
                if i >= N_BUCKETS:
                    agg = self.span_aggregates().get(key)
                    return float(agg["max_ns"]) if agg else float("inf")
                return bucket_le_ns(i)
        return bucket_le_ns(N_BUCKETS - 1)

    def windows(self) -> list:
        """The retained rolling windows, oldest first, stripes merged:
        [{"window": wid, "start_ns": wid*window_ns,
          "counters": {(cat, name): delta},
          "spans": {(cat, name): {"count", "total_ns"}}}]."""
        merged: dict = {}
        for s in self._stripes:
            with s.lock:
                parts = [(w[0], dict(w[1]),
                          {k: list(v) for k, v in w[2].items()})
                         for w in s.windows if w is not None]
            for wid, counts, spans in parts:
                m = merged.setdefault(wid, [{}, {}])
                for k, v in counts.items():
                    m[0][k] = m[0].get(k, 0) + v
                for k, (n, tot) in spans.items():
                    sp = m[1].get(k)
                    if sp is None:
                        m[1][k] = [n, tot]
                    else:
                        sp[0] += n
                        sp[1] += tot
        out = []
        # a slot that never got reused still holds its old window — drop
        # anything more than one ring span behind the newest, so the
        # returned series spans at most n_windows windows
        cutoff = (max(merged) - self.n_windows) if merged else 0
        for wid in sorted(merged):
            if wid <= cutoff:
                continue
            counts, spans = merged[wid]
            out.append({"window": wid, "start_ns": wid * self.window_ns,
                        "counters": counts,
                        "spans": {k: {"count": n, "total_ns": tot}
                                  for k, (n, tot) in spans.items()}})
        return out

    def series(self, cat: str, name: str, field: str = "counters") -> list:
        """One key's rolling series: [(start_ns, value)] per retained
        window — counter deltas (`field="counters"`) or span counts
        (`field="spans"`)."""
        key = (cat, name)
        out = []
        for w in self.windows():
            if field == "counters":
                if key in w["counters"]:
                    out.append((w["start_ns"], w["counters"][key]))
            else:
                if key in w["spans"]:
                    out.append((w["start_ns"], w["spans"][key]["count"]))
        return out

    def gauges(self) -> dict:
        """{(name, ((label, value), ...)): value} snapshot."""
        with self._gauge_lock:
            return dict(self._gauges)

    def clear(self):
        for s in self._stripes:
            with s.lock:
                s.counts = {}
                s.spans = {}
                s.hist = {}
                s.windows = [None] * self.n_windows
        with self._gauge_lock:
            self._gauges = {}
