"""One run of one cell: set-up, the measured window (traced or not), the
metrics by their readers, and the comparison with the reference.

`run_cell` takes the device it is given and never looks for a card, so
the tests drive it on the CPU at small sizes; `run.py` is the entry that
looks for the card and checks what was loaded.
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import time

import numpy as np

from portbench import spec, trace

now = time.perf_counter_ns
TRACE_CAPACITY = 131072   # obs records a stripe in the traced run


class Reading:
    """What a metric's reader reads: the window's totals, its
    benchmark-side spans, the program's spans and counters, and (in the
    traced run) the device trace."""

    def __init__(self, cell, runner, setup_s: float, window_s: float):
        self.cell = cell
        self.setup_s = setup_s
        self.window_s = window_s
        self.n_ops = runner.n_ops
        self.spans = runner.spans
        self.ring_stats = getattr(runner, "ring_stats", [])
        self.obs_spans: dict = {}      # "cat.name" -> {"count", "total_ns"}
        self.launch_shapes: dict = {}  # kernel -> {shape: calls}
        self.device = None             # trace.DeviceSummary, traced run

    def seconds(self, name: str) -> np.ndarray:
        """Durations of the benchmark-side spans called `name`."""
        return np.array([(b - a) / 1e9 for n, a, b in self.spans
                         if n == name])

    def obs_seconds(self, *keys: str) -> float:
        return sum(self.obs_spans.get(k, {}).get("total_ns", 0)
                   for k in keys) / 1e9

    def ops_per_s(self) -> float:
        """Ops of every unit the window completed over its seconds."""
        return self.n_ops / self.window_s

    def idle_pct(self):
        """The share of the traced window in which no operation ran on
        the card."""
        if self.device is None or self.device.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.device.busy_s / self.device.window_s)


def _span_delta(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        b = before.get(k, {"count": 0, "total_ns": 0})
        n = v["count"] - b["count"]
        if n:
            out[k] = {"count": n, "total_ns": v["total_ns"] - b["total_ns"]}
    return out


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(M, torch, cell: spec.Cell, seed: int, seconds: float,
             traced: bool, device, t_start_ns: int) -> dict:
    """Set up, measure, compare. Returns the result line's object (its
    last key, "checks", holds each compared number with its limit)."""
    cuda = device.type == "cuda"
    runner = spec.family(cell.traffic["family"]).RUNNER(
        M, device, cell.config, cell.traffic, seed)
    runner.setup(seconds)
    gc.collect()
    gc.freeze()
    setup_s = (time.time_ns() - t_start_ns) / 1e9

    M.S.reset_launches()
    if traced:
        M.obs.enable(capacity=TRACE_CAPACITY)
        before = M.obs.metrics_snapshot()["spans"]
        with trace.DeviceTrace(torch) as dt:
            t0, t1 = runner.window(seconds)
        obs_spans = _span_delta(M.obs.metrics_snapshot()["spans"], before)
        obs_records = [(f"{r[2]}/{r[3]}", r[0], r[0] + r[1])
                       for r in M.obs.snapshot() if r[1] >= 0]
        M.obs.disable()
    else:
        t0, t1 = runner.window(seconds)
    shapes = {k: dict(v) for k, v in M.S.launch_shapes.items()}
    print(f"portbench: launches {dict(M.S.launches)} counters "
          f"{runner.counters}", file=sys.stderr)
    reading = Reading(cell, runner, setup_s, (t1 - t0) / 1e9)
    reading.launch_shapes = shapes
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    out_device = {"platform": "gpu" if cuda else device.type,
                  "kind": (torch.cuda.get_device_name(device) if cuda
                           else device.type),
                  "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        reading.obs_spans = obs_spans
        reading.device = dt.summary(t0, t1, runner.spans + obs_records)
        out_device["busy_s"] = reading.device.busy_s
        out_device["window_s"] = reading.device.window_s
        breakdown = {
            "device_ops": trace.top(reading.device.op_seconds()),
            "idle_gaps": trace.top(reading.device.idle_by_span())}
    if cuda:
        out_device["power_limit"] = power_limit()

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"])(reading)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the comparison runs after the window, on the host, with the
    # program's state freed
    runner.release()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, failed = runner.check()
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": runner.attempted, "failed": failed,
           "metrics": metrics, "device": out_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def check_lines(result: dict) -> list:
    return [f"check {k} {v['value']} limit {v['limit']}"
            for k, v in result["checks"].items()]


def set_cache_dirs(root) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own nvcc and g++ builds already live in its package
    directory)."""
    base = os.path.join(root, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
