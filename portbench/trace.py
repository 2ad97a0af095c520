"""The device trace of the traced run: torch.profiler's CUDA activity over
the window, read into what the per-layer metrics and the breakdown need.

Device times come from the profiler (kineto stamps them on the host's
wall clock); host spans are on `time.perf_counter_ns`, so the trace
measures the offset between the two clocks when it starts.
"""

from __future__ import annotations

import time

import numpy as np


def short_name(name: str) -> str:
    """A device operation's name without its return type, its argument
    list and "(anonymous namespace)::"."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = name.replace("(anonymous namespace)::", "")
    return name[5:] if name.startswith("void ") else name


class DeviceTrace:
    """Context manager: profiles the card's activity while it is open."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.events: list = []       # (name, start_ns, end_ns), perf clock

    def __enter__(self):
        tp = self.torch.profiler
        self.prof = tp.profile(activities=[tp.ProfilerActivity.CUDA])
        self.prof.__enter__()
        reads = []
        for _ in range(5):
            a = time.perf_counter_ns()
            w = time.time_ns()
            b = time.perf_counter_ns()
            reads.append(w - (a + b) // 2)
        self.offset = int(np.median(reads))   # wall clock - perf clock
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        cuda = self.torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != cuda or e.duration_ns() <= 0:
                continue
            t0 = e.start_ns() - self.offset
            self.events.append((e.name(), t0, t0 + e.duration_ns()))
        self.events.sort(key=lambda r: r[1])
        self.prof = None
        return False

    def summary(self, t0: int, t1: int, host_spans) -> "DeviceSummary":
        return DeviceSummary(self.events, t0, t1, host_spans)


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted, merged [start, end) intervals of an (n, 2) array."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.empty(len(iv), bool)
    new[0] = True
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], 1)


class DeviceSummary:
    """What the window's device operations say: busy time, time by
    operation, idle gaps by the host span they fell in."""

    def __init__(self, events, t0: int, t1: int, host_spans):
        self.t0, self.t1 = t0, t1
        self.window_s = (t1 - t0) / 1e9
        ev = [(n, max(a, t0), min(b, t1)) for n, a, b in events
              if b > t0 and a < t1]
        self.names = [short_name(n) for n, _, _ in ev]
        self.iv = np.array([(a, b) for _, a, b in ev],
                           np.int64).reshape(-1, 2)
        busy = _union(self.iv)
        self.busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9
        self._busy = busy
        self._host = list(host_spans)

    def op_seconds(self) -> dict:
        out: dict = {}
        for n, (a, b) in zip(self.names, self.iv):
            out[n] = out.get(n, 0) + int(b - a)
        return {n: ns / 1e9 for n, ns in out.items()}

    def kernel(self, fragment: str):
        """(calls, seconds) of the operations whose name holds
        `fragment`."""
        dur = [int(b - a) for n, (a, b) in zip(self.names, self.iv)
               if fragment in n]
        return len(dur), sum(dur) / 1e9

    def idle_by_span(self) -> dict:
        """Idle seconds of the window by the innermost host span that
        covered each gap's midpoint ("none" where no span did)."""
        b = self._busy
        starts = np.concatenate([[self.t0], b[:, 1]]) if len(b) else \
            np.array([self.t0])
        ends = np.concatenate([b[:, 0], [self.t1]]) if len(b) else \
            np.array([self.t1])
        keep = ends > starts
        starts, ends = starts[keep], ends[keep]
        mids = (starts + ends) // 2
        order = np.argsort(mids)
        mids_sorted = mids[order]
        label = np.full(len(mids), -1)
        width = np.full(len(mids), np.iinfo(np.int64).max)
        names: list = []
        for name, a, z in self._host:
            lo = np.searchsorted(mids_sorted, a)
            hi = np.searchsorted(mids_sorted, z)
            if hi <= lo:
                continue
            sel = order[lo:hi]
            w = z - a
            better = width[sel] > w
            if better.any():
                if not names or names[-1] != name:
                    names.append(name)
                label[sel[better]] = len(names) - 1
                width[sel[better]] = w
        out: dict = {}
        for lab, s, e in zip(label, starts, ends):
            key = names[lab] if lab >= 0 else "none"
            out[key] = out.get(key, 0) + int(e - s)
        return {k: v / 1e9 for k, v in out.items()}


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
