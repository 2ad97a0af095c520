"""The yardstick's arithmetic, frozen here so that no change to the
program can move it: the card's peaks and the bytes and operations a
kernel call needs, from its shape.

Peaks of one H100 SXM (NVIDIA's data sheet, dense rates; a card set
below its 700 W limit runs slower, and the run reports the limit beside
the share): 3.35 TB/s from HBM3, 67 TFLOP/s outside the tensor cores,
a 50 MiB L2. The data sheet gives no L2 bandwidth, so the L2 rate here
is an empirical ceiling, as an empirical roofline takes it: the highest
rate, from the median kernel time of 300 back-to-back calls, at which
`torch.add(x, 1, out=y)` or `y.copy_(x)` moved int32 buffers of 4 to 48
MiB (read and write counted) held in L2, by the profiler's kernel times,
on an NVIDIA H100 80GB HBM3 at 700 W.

The byte counts are those of chip_smoke.py's `_ms_bound`: each input
byte read once and each output byte written once. A call whose input
and output together fit in the L2 is held to the L2 rate (its input was
as a rule written just before, and is read from there); a larger call
to the HBM rate.
"""

from __future__ import annotations

import sys

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, data sheet
L2_BYTES = 50 * 2 ** 20        # H100 SXM L2 (cudaDeviceProp.l2CacheSize)
L2_BYTES_PER_S = 5.24e12        # empirical ceiling, see above
INT_OPS_PER_S = 67e12          # non-tensor fp32 rate, taken for int32 adds


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    bandwidth of the memory they live in and operations over the
    arithmetic rate."""
    rate = L2_BYTES_PER_S if n_bytes <= L2_BYTES else HBM_BYTES_PER_S
    return max(n_bytes / rate, n_ops / INT_OPS_PER_S)


def multi_scan_bound_s(shape) -> float:
    """`multi_scan` over int32 (K, N): reads and writes 4 bytes an
    element, one add an element."""
    K, N = shape
    return bound_s(2 * K * N * 4, K * N)


def multi_scan_share_pct(r):
    """multi_scan's share of its roofline in a traced window: the least
    time its calls need, from the shapes the program counted, over the
    device time of its kernels in the trace. None when no call ran or
    the trace holds no such kernel. Where the trace holds fewer kernels
    than calls (the profiler can lose events), the bound is scaled by
    the share it holds."""
    shapes = r.launch_shapes.get("multi_scan", {})
    calls = sum(shapes.values())
    if r.device is None or not calls:
        return None
    n_k, secs = r.device.kernel("ms_scan")
    if not n_k or secs <= 0:
        return None
    bound = sum(multi_scan_bound_s(sh) * n for sh, n in shapes.items())
    print(f"portbench: multi_scan calls {shapes}, {n_k} ms_scan kernels "
          f"{secs!r} s, bound {bound!r} s", file=sys.stderr)
    if n_k != calls:
        print(f"portbench: {n_k} ms_scan kernels in the trace for {calls} "
              f"multi_scan calls", file=sys.stderr)
        bound *= n_k / calls
    return 100.0 * bound / secs
