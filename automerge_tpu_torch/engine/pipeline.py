"""Host-side planning parallelism and host->device staging.

Counterpart of the planner pool and `stage_h2d` of
`automerge_tpu/engine/pipeline.py`:

- `planner_pool()` — one small shared ThreadPoolExecutor. The heavy
  planning passes (numpy column passes) release the GIL, so sharding one
  batch's planning across a few threads runs at real parallelism on
  multicore hosts (`AMTPU_PLAN_WORKERS=1` disables sharding).
- `stage_h2d()` — asynchronous host->device staging: the array is copied
  into pinned host memory and handed to the device with a non-blocking
  copy on the current stream, so the transfer overlaps the remaining
  host planning. The caller keeps the pinned buffer referenced and owns
  the completion barrier (engine/base.py `prepare_batch`).

The pipelined ingestion ring (`PipelinedIngestor`) is not part of this
package yet.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

_POOL = None
_POOL_LOCK = threading.Lock()

# the dtypes a round plan stages (int32 matrices and scalars, uint8 blobs)
_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.uint8): torch.uint8}


def plan_workers() -> int:
    """Worker count for sharded planning. 1 disables sharding."""
    try:
        w = int(os.environ.get("AMTPU_PLAN_WORKERS", "0"))
    except ValueError:
        w = 0
    if w <= 0:
        w = min(4, os.cpu_count() or 1)
    return max(1, w)


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


def stage_h2d(arr: np.ndarray, device) -> tuple:
    """Stage a host array onto `device` -> (device tensor, pinned host
    tensor or None). On a CUDA device the copy is non-blocking from pinned
    memory; the caller keeps the pinned tensor alive until its barrier.
    On the CPU the result is a private copy and nothing is pinned."""
    device = torch.device(device)
    dtype = _TORCH_DTYPES[arr.dtype]
    if device.type == "cpu":
        return torch.from_numpy(np.array(arr, copy=True)), None
    pinned = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
    pinned.numpy()[...] = arr
    return pinned.to(device, non_blocking=True), pinned
