"""On the card: the program's spans and the device trace share one clock.

The program stamps its spans with `time.perf_counter_ns`; torch.profiler
stamps device activity on the wall clock, and `trace.DeviceTrace` maps
it onto the span clock with one offset read when the trace opens. Over a
window as long as a benchmark run, each kernel, synchronised inside a
program span, has to map inside that span, to within 50 us, late in the
window as early. The test prints one `clock:` line: the offset the trace
read, the drift of `time.time_ns() - time.perf_counter_ns()` over the
window and, per half of the window, the quartiles of each product's
mapped start after its span's start (lead) and mapped end before its
span's end (tail). Needs a CUDA card. Its marker is `device_clock`, not
`cuda`, so the card run of the benchmark's tests (`-m cuda`) leaves it
out: in some windows the profiler's device stamps move against the host
clocks by more than the slack, and `trace.py` maps them with one offset
(PERF.md section 7). Run it alone:

    python3 -m pytest portbench/tests/test_portbench_clock.py -m device_clock -s
"""

import json
import time

import numpy as np
import pytest

from portbench import trace

WINDOW_S = 51.0       # the benchmark's run_seconds
SLACK_NS = 50_000
PERIOD_S = 0.02


def wall_minus_perf() -> int:
    """time.time_ns() - time.perf_counter_ns(), read between two reads
    of the span clock, the closest pair of five."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


@pytest.mark.device_clock
def test_kernels_map_inside_their_program_spans(cuda_torch):
    torch = cuda_torch
    from automerge_tpu_torch import obs
    dev = torch.device("cuda", 0)
    x = torch.rand(2048, 2048, device=dev)
    for _ in range(3):
        x @ x
    torch.cuda.synchronize(dev)
    obs.enable(capacity=8192)
    obs.clear()
    try:
        with trace.DeviceTrace(torch) as dt:
            d0 = wall_minus_perf()
            start = time.perf_counter()
            while time.perf_counter() - start < WINDOW_S:
                t0 = obs.now()
                x @ x
                torch.cuda.synchronize(dev)
                obs.span("clock", "kernel", t0)
                time.sleep(PERIOD_S)
            d1 = wall_minus_perf()
        spans = sorted((r[0], r[0] + r[1]) for r in obs.snapshot()
                       if r[2] == "clock")
    finally:
        obs.disable()
    assert obs.metrics_snapshot()["emitted"] == len(spans)
    kernels = sorted((a, b) for _, a, b in dt.events)  # the products alone
    assert len(kernels) == len(spans) > 0.5 * WINDOW_S / PERIOD_S, (
        len(kernels), len(spans))
    # the k-th product ran inside the k-th span: how far its mapped start
    # lies after the span's start, and its mapped end before the span's end
    lead = np.array([a - s0 for (a, _), (s0, _) in zip(kernels, spans)])
    tail = np.array([s1 - b for (_, b), (_, s1) in zip(kernels, spans)])
    half = len(spans) // 2

    def quartiles_us(v):
        return [round(float(q) / 1e3, 1) for q in
                np.percentile(v, [0, 25, 50, 75, 100])]

    record = {
        "window_s": WINDOW_S, "spans": len(spans), "kernels": len(kernels),
        "offset_ns": dt.offset, "drift_ns": d1 - d0,
        "lead_us_first_half": quartiles_us(lead[:half]),
        "lead_us_second_half": quartiles_us(lead[half:]),
        "tail_us_first_half": quartiles_us(tail[:half]),
        "tail_us_second_half": quartiles_us(tail[half:]),
        "outside": int(((lead < -SLACK_NS) | (tail < -SLACK_NS)).sum())}
    print("clock:", json.dumps(record))
    assert record["outside"] == 0, record
