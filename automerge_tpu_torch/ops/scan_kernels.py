"""Prefix-scan kernels of the text engine: CUDA for Hopper, plain PyTorch
beside them.

Counterpart of `automerge_tpu/ops/scan_pallas.py`:

- `multi_scan(x)` replaces `multi_scan` (`_multi_scan_kernel`,
  scan_pallas.py:170-215): row-wise inclusive prefix sum of an int32
  (K, N) matrix. The fused round expansion (ops/fused_round.py) scans its
  six boundary-delta channels through it.
- `fused_segment_scans(chain, has_value, n_elems, base)` replaces
  `fused_segment_scans` (`_fused_kernel`, scan_pallas.py:76-167): the
  segment ranks, segment heads and visible counts of the self-contained
  materialization (ops/ingest.py `_materialize_core`) in one pass.

Both kernels live in `csrc/scan.cu` (its header says what bounds them on
an H100 and how the three-launch reduce-then-scan design replaces the TPU
kernels' in-order grid carry). The library is built with `nvcc` at first
use into `csrc/build/` and bound through ctypes.

Dispatch is by the tensor's device: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises. Each wrapper adds one to
`launches[name]` where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = _CSRC / "scan.cu"
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: launches per kernel since the last `reset_launches()`
launches = {"multi_scan": 0, "fused_segment_scans": 0}

_LIB = None
_LOCK = threading.Lock()
_I32_MAX = 2**31 - 1


def reset_launches():
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "automerge_tpu_torch need the CUDA toolkit")


def library_path() -> Path:
    """Where the library of the current source is (or will be) built: the
    file name carries a digest of the source, so an edit rebuilds."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libamt_scan_{tag}.so"


def build() -> float:
    """Compile `csrc/scan.cu` if its library is missing; returns the
    seconds spent (0.0 when it was already built). Raises on failure."""
    so = library_path()
    if so.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
            f"{proc.stderr}")
    os.replace(tmp, so)
    return time.perf_counter() - t0


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.amt_scan_chunk.argtypes = []
            lib.amt_scan_chunk.restype = ci
            lib.amt_multi_scan.argtypes = [vp, vp, vp, ci, ci, vp]
            lib.amt_multi_scan.restype = ci
            lib.amt_fused_segment_scans.argtypes = [
                vp, vp, ci, vp, ci, vp, vp, vp, vp, vp]
            lib.amt_fused_segment_scans.restype = ci
            _LIB = lib
    return _LIB


def _check_cuda(name: str, t: torch.Tensor, dtype, ndim: int):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.numel() > _I32_MAX:
        raise ValueError(f"{name}: {t.numel()} elements exceed int32")


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} "
                           f"({torch.cuda.get_device_name()})")


# ---------------------------------------------------------------- multi_scan

def multi_scan_plain(x: torch.Tensor) -> torch.Tensor:
    """Row-wise inclusive int32 prefix sum — the plain version."""
    return torch.cumsum(x, 1, dtype=torch.int32)


def multi_scan(x: torch.Tensor) -> torch.Tensor:
    """Row-wise inclusive prefix sum of an int32 (K, N) matrix; any N."""
    if x.device.type == "cpu":
        return multi_scan_plain(x)
    _check_cuda("multi_scan", x, torch.int32, 2)
    K, N = x.shape
    out = torch.empty_like(x)
    if K == 0 or N == 0:
        return out
    with torch.cuda.device(x.device):
        lib = _lib()
        nblk = -(-N // lib.amt_scan_chunk())
        scratch = torch.empty((K, nblk), dtype=torch.int32, device=x.device)
        rc = lib.amt_multi_scan(
            x.data_ptr(), out.data_ptr(), scratch.data_ptr(), K, N,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "multi_scan")
    launches["multi_scan"] += 1
    return out


# ------------------------------------------------------- fused_segment_scans

def fused_segment_scans_plain(chain: torch.Tensor, has_value: torch.Tensor,
                              n_elems, base: int = 0):
    """(rank_incl, seg_head, cumvis) — the plain version.

    rank_incl[i] = segment starts at slots <= i; seg_head[i] = the latest
    segment-start slot <= i (0 before the first); cumvis[i] = visible
    elements at slots <= i. Slot numbers are global: `base + i`."""
    C = chain.shape[0]
    flat = torch.arange(C, dtype=torch.int32, device=chain.device) + base
    is_elem = (flat >= 1) & (flat <= n_elems)
    seg_start = is_elem & ~chain
    vis = is_elem & has_value
    rank = torch.cumsum(seg_start.to(torch.int32), 0, dtype=torch.int32)
    cand = torch.where(seg_start, flat, 0)
    head = torch.cummax(cand, 0).values
    cumvis = torch.cumsum(vis.to(torch.int32), 0, dtype=torch.int32)
    return rank, head, cumvis


def fused_segment_scans(chain: torch.Tensor, has_value: torch.Tensor,
                        n_elems, base: int = 0):
    """-> (rank_incl, seg_head, cumvis), int32[C] each.

    `n_elems` is an int or an int32 scalar tensor on the same device; the
    kernel reads it on the device, so a count computed there needs no
    host sync."""
    if chain.device.type == "cpu":
        return fused_segment_scans_plain(chain, has_value, n_elems, base)
    _check_cuda("fused_segment_scans chain", chain, torch.bool, 1)
    _check_cuda("fused_segment_scans has_value", has_value, torch.bool, 1)
    C = chain.shape[0]
    if has_value.shape[0] != C:
        raise ValueError("fused_segment_scans: chain and has_value differ "
                         f"in length ({C} vs {has_value.shape[0]})")
    if not torch.is_tensor(n_elems):
        # a fill on the device: a pageable h2d copy would sync the stream
        n_elems = torch.full((), int(n_elems), dtype=torch.int32,
                             device=chain.device)
    if (n_elems.device != chain.device or n_elems.dtype != torch.int32
            or n_elems.numel() != 1):
        raise ValueError("fused_segment_scans: n_elems must be one int32 "
                         f"on {chain.device}")
    n_elems = n_elems.contiguous()
    rank = torch.empty(C, dtype=torch.int32, device=chain.device)
    head = torch.empty_like(rank)
    cumvis = torch.empty_like(rank)
    if C == 0:
        return rank, head, cumvis
    with torch.cuda.device(chain.device):
        lib = _lib()
        nblk = -(-C // lib.amt_scan_chunk())
        scratch = torch.empty((3, nblk), dtype=torch.int32,
                              device=chain.device)
        rc = lib.amt_fused_segment_scans(
            chain.data_ptr(), has_value.data_ptr(), C, n_elems.data_ptr(),
            int(base), scratch.data_ptr(), rank.data_ptr(), head.data_ptr(),
            cumvis.data_ptr(),
            torch.cuda.current_stream(chain.device).cuda_stream)
    _raise_on(rc, "fused_segment_scans")
    launches["fused_segment_scans"] += 1
    return rank, head, cumvis
