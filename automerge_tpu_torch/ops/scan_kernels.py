"""Prefix-scan kernels of the text engine: CUDA for Hopper, plain PyTorch
beside them.

Counterpart of `automerge_tpu/ops/scan_pallas.py`:

- `multi_scan(x)` replaces `multi_scan` (`_multi_scan_kernel`,
  scan_pallas.py:170-215, `pallas_call` at :204): row-wise inclusive prefix
  sum of an int32 (K, N) matrix. The fused round expansion
  (ops/fused_round.py) scans its six boundary-delta channels through it.
- `fused_segment_scans(chain, has_value, n_elems, base)` replaces
  `fused_segment_scans` (`_fused_kernel`, scan_pallas.py:76-167,
  `pallas_call` at :142): the segment ranks, segment heads and visible
  counts of the self-contained materialization (ops/ingest.py
  `_materialize_core_r`) in one pass. Given (D, C) rows and one count per
  row, it scans every row on its own in the same single launch: the
  DocSet's materialization over its stacked documents (the JAX package
  vmaps the one-column kernel there).

Both kernels live in `csrc/scan.cu`. Each call is one single-pass launch
(a chained scan with decoupled look-back over ticketed tiles, 16-byte
loads and stores) after a memset of its scratch; the source note says what
bounds them on an H100 (bytes: 302 MB and 88 MB at the merge shapes) and
why the tile sizes are what they are. The library is built with `nvcc` at
first use into `csrc/build/` and bound through ctypes.

Dispatch is by the tensor's device: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises. Each wrapper adds one to
`launches[name]` where it launches its kernel, and nowhere else, and one
to `launch_shapes[name][shape]` for the shape it launched at. Both routes
also feed the device-truth registry (obs/device_truth.py: the ``cuda``
and ``plain`` handles, with the bytes and operations of the call), and
the library's build and load are its build/load events.
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

from ..obs import device_truth as _dt

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = _CSRC / "scan.cu"
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: 64-bit status words per tile in the look-back scratch (csrc/scan.cu)
MS_STATUS_WORDS = 1
FS_STATUS_WORDS = 6

#: launches per kernel since the last `reset_launches()`
launches = {"multi_scan": 0, "fused_segment_scans": 0}
#: launches per kernel and input shape since the last `reset_launches()`
launch_shapes = {"multi_scan": {}, "fused_segment_scans": {}}

_LIB = None
_LOCK = threading.Lock()
_I32_MAX = 2**31 - 1

#: device-truth handles: (kernel, route) -> KernelHandle
_DT = {(k, v): _dt.register(k, v)
       for k in launches for v in ("cuda", "plain")}


def reset_launches():
    for k in launches:
        launches[k] = 0
        launch_shapes[k].clear()


def _note_shape(name: str, shape: tuple):
    by_shape = launch_shapes[name]
    by_shape[shape] = by_shape.get(shape, 0) + 1


def n_tiles(length: int, tile: int) -> int:
    return -(-length // tile)


def scratch_words(tiles: int, words_per_tile: int) -> int:
    """int64 words of a look-back scratch: one ticket counter, then the
    status words of every tile."""
    return 1 + tiles * words_per_tile


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
    """Where the library of the current source is or will be built: the
    file name carries a digest of the source, so an edit rebuilds."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libamt_scan_{digest}.so"


def build() -> float:
    """Compile `csrc/scan.cu` if its library is missing; returns the
    seconds spent (0.0 when it was already built). Raises on failure.
    ptxas's register and shared-memory report goes to `<library>.log`."""
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
    so.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, so)
    secs = time.perf_counter() - t0
    _dt.record_build("scan_kernels", "build", int(secs * 1e9), so.name)
    return secs


def bind(path) -> ctypes.CDLL:
    """The library at `path`, with the argument types of its entry points."""
    lib = ctypes.CDLL(str(path))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.amt_multi_scan_tile, lib.amt_fused_scan_tile):
        fn.argtypes = []
        fn.restype = ci
    lib.amt_multi_scan.argtypes = [vp, vp, vp, cll, ci, ci, vp]
    lib.amt_multi_scan.restype = ci
    lib.amt_fused_segment_scans.argtypes = [
        vp, vp, ci, ci, vp, ci, ci, vp, cll, vp, vp, vp, vp]
    lib.amt_fused_segment_scans.restype = ci
    return lib


def load() -> ctypes.CDLL:
    """The bound library of `csrc/scan.cu` (built first if needed)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            t0 = time.perf_counter_ns()
            _LIB = bind(library_path())
            _dt.record_build("scan_kernels", "load",
                             time.perf_counter_ns() - t0,
                             library_path().name)
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


def _scratch(tiles: int, words_per_tile: int, device) -> torch.Tensor:
    return torch.empty(scratch_words(tiles, words_per_tile),
                       dtype=torch.int64, device=device)


# ---------------------------------------------------------------- multi_scan

def multi_scan_plain(x: torch.Tensor) -> torch.Tensor:
    """Row-wise inclusive int32 prefix sum — the plain version."""
    return torch.cumsum(x, 1, dtype=torch.int32)


def _ms_cost(x: torch.Tensor) -> tuple:
    # reads and writes 4 bytes per element; one add per element
    return 8 * x.numel(), x.numel()


def _fs_cost(chain: torch.Tensor) -> tuple:
    # reads chain + has (1 B each) and one n_elems per row, writes three
    # int32 columns; three scans' adds per slot
    rows = chain.shape[0] if chain.dim() == 2 else 1
    return 14 * chain.numel() + 4 * rows, 3 * chain.numel()


def multi_scan(x: torch.Tensor) -> torch.Tensor:
    """Row-wise inclusive prefix sum of an int32 (K, N) matrix; any N."""
    if x.device.type == "cpu":
        if _dt.ENABLED:
            _DT["multi_scan", "plain"].note(*_ms_cost(x))
        return multi_scan_plain(x)
    _check_cuda("multi_scan", x, torch.int32, 2)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    K, N = x.shape
    lib = load()
    with torch.cuda.device(x.device):
        scratch = _scratch(K * n_tiles(N, lib.amt_multi_scan_tile()),
                           MS_STATUS_WORDS, x.device)
        rc = lib.amt_multi_scan(
            x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            scratch.numel() * 8, K, N,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "multi_scan")
    launches["multi_scan"] += 1
    _note_shape("multi_scan", tuple(x.shape))
    if _dt.ENABLED:
        _DT["multi_scan", "cuda"].note(*_ms_cost(x))
    return out


# ------------------------------------------------------- fused_segment_scans

def fused_segment_scans_plain(chain: torch.Tensor, has_value: torch.Tensor,
                              n_elems, base: int = 0):
    """(rank_incl, seg_head, cumvis) — the plain version.

    rank_incl[i] = segment starts at slots <= i; seg_head[i] = the latest
    segment-start slot <= i (0 before the first); cumvis[i] = visible
    elements at slots <= i. Slot numbers are global: `base + i`. On (D, C)
    rows each row is scanned on its own, with its own count n_elems[d]."""
    C = chain.shape[-1]
    flat = torch.arange(C, dtype=torch.int32, device=chain.device) + base
    if chain.dim() == 2:
        n_elems = _row_counts(n_elems, chain)[:, None]
    is_elem = (flat >= 1) & (flat <= n_elems)
    seg_start = is_elem & ~chain
    vis = is_elem & has_value
    rank = torch.cumsum(seg_start.to(torch.int32), -1, dtype=torch.int32)
    cand = torch.where(seg_start, flat, 0)
    head = torch.cummax(cand, -1).values
    cumvis = torch.cumsum(vis.to(torch.int32), -1, dtype=torch.int32)
    return rank, head, cumvis


def _row_counts(n_elems, chain: torch.Tensor) -> torch.Tensor:
    """Check the per-row element counts of a (D, C) call: an int32 (D,)
    tensor on the rows' device."""
    if (not torch.is_tensor(n_elems) or n_elems.device != chain.device
            or n_elems.dtype != torch.int32
            or tuple(n_elems.shape) != (chain.shape[0],)):
        raise ValueError("fused_segment_scans: per-row n_elems must be "
                         f"int32 ({chain.shape[0]},) on {chain.device}")
    return n_elems


def fused_segment_scans(chain: torch.Tensor, has_value: torch.Tensor,
                        n_elems, base: int = 0):
    """-> (rank_incl, seg_head, cumvis), int32, shaped like `chain`.

    One column of C slots, or (D, C) rows each scanned on its own (the
    per-document form of the DocSet's materialization): `n_elems` is then
    one count per row, an int32 (D,) tensor on the rows' device. For one
    column it is an int or an int32 scalar tensor on the same device. The
    kernel reads the counts on the device, so counts computed there need
    no host sync."""
    if chain.device.type == "cpu":
        if _dt.ENABLED:
            _DT["fused_segment_scans", "plain"].note(*_fs_cost(chain))
        return fused_segment_scans_plain(chain, has_value, n_elems, base)
    rows = chain.dim() == 2
    _check_cuda("fused_segment_scans chain", chain, torch.bool,
                2 if rows else 1)
    _check_cuda("fused_segment_scans has_value", has_value, torch.bool,
                2 if rows else 1)
    if has_value.shape != chain.shape:
        raise ValueError("fused_segment_scans: chain and has_value differ "
                         f"in shape ({tuple(chain.shape)} vs "
                         f"{tuple(has_value.shape)})")
    if rows:
        n_elems = _row_counts(n_elems, chain)
    else:
        if not torch.is_tensor(n_elems):
            # a fill on the device: a pageable h2d copy would sync the
            # stream
            n_elems = torch.full((), int(n_elems), dtype=torch.int32,
                                 device=chain.device)
        if (n_elems.device != chain.device or n_elems.dtype != torch.int32
                or n_elems.numel() != 1):
            raise ValueError("fused_segment_scans: n_elems must be one "
                             f"int32 on {chain.device}")
    n_elems = n_elems.contiguous()
    D, C = (chain.shape if rows else (1, chain.shape[0]))
    rank = torch.empty(chain.shape, dtype=torch.int32, device=chain.device)
    head = torch.empty_like(rank)
    cumvis = torch.empty_like(rank)
    if rank.numel() == 0:
        return rank, head, cumvis
    lib = load()
    with torch.cuda.device(chain.device):
        scratch = _scratch(D * n_tiles(C, lib.amt_fused_scan_tile()),
                           FS_STATUS_WORDS, chain.device)
        rc = lib.amt_fused_segment_scans(
            chain.data_ptr(), has_value.data_ptr(), D, C,
            n_elems.data_ptr(), 1 if rows else 0, int(base),
            scratch.data_ptr(), scratch.numel() * 8,
            rank.data_ptr(), head.data_ptr(), cumvis.data_ptr(),
            torch.cuda.current_stream(chain.device).cuda_stream)
    _raise_on(rc, "fused_segment_scans")
    launches["fused_segment_scans"] += 1
    _note_shape("fused_segment_scans", tuple(chain.shape))
    if _dt.ENABLED:
        _DT["fused_segment_scans", "cuda"].note(*_fs_cost(chain))
    return rank, head, cumvis
