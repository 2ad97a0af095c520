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

- `sharded_fused_scans(mesh, chain, has_value, n_elems)` replaces
  `sharded_fused_scans` (scan_pallas.py:218-266; no `pallas_call` of its
  own: per-shard `fused_segment_scans` under `shard_map` plus one
  `all_gather` of the shards' totals): the same three scans over a column
  (or (D, C) rows) cut into element shards on a mesh
  (parallel/mesh.py), as reduce, exchange, then scan. `fs_totals` (a
  kernel of its own, one launch a shard) reduces each shard to its
  (rank, head, vis) totals, the mesh's `all_gather` gives every shard all
  of them, and `fused_segment_scans_carry` (the `fs_scan` kernel with a
  carry-in, one launch a shard) scans the shard starting from the
  earlier shards' totals. The bound is one pass over the whole column,
  14 bytes a slot (0.0263 ms at C = 6,291,456 on an H100); the pair reads
  the bool columns twice, 16 bytes a slot. An axis of one shard runs the
  unsharded kernel and exchanges nothing.

The kernels live in `csrc/scan.cu`; its head note says what bounds them
on an H100 (bytes: 302 MB and 88 MB at the merge shapes; launches at
short rows) and why the tile sizes are what they are. Both kernel
families take one of three forms by row length, chosen here by
`ms_geometry` and `fs_geometry`: a warp a row up to 1,024 columns or
slots, a block a row up to a tile (8,192), a single-pass chained scan
with decoupled look-back over ticketed tiles beyond. Every call of every
wrapper is ONE kernel launch and no other device operation: an int count
goes to the kernel by value, and the look-back form's scratch persists,
one buffer per (device, stream, family) in `ScratchCache` (zeroed once
when allocated; the kernels reset its ticket and counters and advance its
epoch themselves, so CUDA graph replays stay right; `multi_scan` and the
segment scans tag their status words differently and so keep separate
buffers). The library is built with `nvcc` at first use into
`csrc/build/` and bound through ctypes.

Dispatch is by the tensor's device: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises. Each wrapper adds one to
`launches[name]` where it launches its kernel, and nowhere else, and one
to `launch_shapes[name][shape]` for the shape it launched at, both under
one lock: the shard tier's lane workers launch from several threads at
once (shard/parallel.py), and an unlocked ``+=`` can lose a count. Both routes
also feed the device-truth registry (obs/device_truth.py: the ``cuda``
and ``plain`` handles, with the bytes and operations of the call), and
the library's build and load are its build/load events.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

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
#: the three forms of both kernel families (csrc/scan.cu), by row length
FORMS = ("warp", "block", "lookback")

#: launches per kernel since the last `reset_launches()`; the carry-in
#: launches of `fs_scan` that the sharded form makes count under
#: "sharded_fused_scans"
launches = {"multi_scan": 0, "fused_segment_scans": 0, "fs_totals": 0,
            "sharded_fused_scans": 0}
#: launches per kernel and input shape since the last `reset_launches()`
launch_shapes = {k: {} for k in launches}

_LIB = None
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()    # the launch counters above
_I32_MAX = 2**31 - 1

#: device-truth handles: (kernel, route) -> KernelHandle
_DT = {(k, v): _dt.register(k, v)
       for k in launches for v in ("cuda", "plain")}


def reset_launches():
    with _COUNT_LOCK:
        for k in launches:
            launches[k] = 0
            launch_shapes[k].clear()


def _count_launch(name: str, shape: tuple):
    """One launch of `name` at `shape`: both counters, under one lock."""
    with _COUNT_LOCK:
        launches[name] += 1
        by_shape = launch_shapes[name]
        by_shape[shape] = by_shape.get(shape, 0) + 1


def n_tiles(length: int, tile: int) -> int:
    return -(-length // tile)


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
    lib.amt_multi_scan.argtypes = [vp, vp, ci, ci, ci, vp, ci, cll, vp]
    lib.amt_multi_scan.restype = ci
    for fn in (lib.amt_ms_warp_row, lib.amt_fs_warp_row):
        fn.argtypes = []
        fn.restype = ci
    for fn in (lib.amt_ms_form, lib.amt_fs_form):
        fn.argtypes = [ci]
        fn.restype = ci
    lib.amt_fused_segment_scans.argtypes = [
        vp, vp, ci, ci, vp, ci, cll, ci, vp, ci, ci, vp, ci, cll, vp, vp, vp,
        vp]
    lib.amt_fused_segment_scans.restype = ci
    lib.amt_fs_totals.argtypes = [
        vp, vp, ci, ci, vp, ci, cll, ci, ci, vp, ci, cll, vp, vp]
    lib.amt_fs_totals.restype = ci
    # the form constants (ms_geometry's and fs_geometry's tile and
    # warp_row), read once: a variant build may change them
    lib.ms_consts = (lib.amt_multi_scan_tile(), lib.amt_ms_warp_row())
    lib.fs_consts = (lib.amt_fused_scan_tile(), lib.amt_fs_warp_row())
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


def _check_kernel_input(name: str, t: torch.Tensor, dtype, ndim: int):
    """A tensor a kernel takes; one test on the way through,
    `_check_cuda` names what is wrong."""
    if (not t.is_cuda or t.dtype != dtype or t.dim() != ndim
            or not t.is_contiguous() or t.numel() > _I32_MAX):
        _check_cuda(name, t, dtype, ndim)


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} "
                           f"({torch.cuda.get_device_name()})")


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


MS_TILE = 8192          # kMsTile: the longest block-form row, a tile
MS_WARP_ROW = 1024      # kMsWarpRow: the longest warp-form row


class ScanLaunch(NamedTuple):
    """One scan launch: its form (an index into FORMS) and the persistent
    scratch it needs (row counters and 64-bit words; 0 and 0 for none)."""
    form: int
    counters: int
    words: int


@functools.lru_cache(maxsize=4096)
def ms_geometry(rows: int, n: int, tile: int = MS_TILE,
                warp_row: int = MS_WARP_ROW) -> ScanLaunch:
    """The `ms_scan` launch over `rows` rows of n columns (both >= 1): a
    warp a row up to `warp_row` columns, a block a row up to `tile`, else
    ceil(n / tile) tiles a row with the look-back (one status word a
    tile). The entry point refuses any other form; the wrapper passes the
    loaded library's constants."""
    if rows < 1 or n < 1:
        raise ValueError(f"no multi_scan launch over ({rows}, {n})")
    if n <= warp_row:
        return ScanLaunch(0, 0, 0)
    if n <= tile:
        return ScanLaunch(1, 0, 0)
    return ScanLaunch(2, 0, MS_STATUS_WORDS * rows * n_tiles(n, tile))


def multi_scan(x: torch.Tensor) -> torch.Tensor:
    """Row-wise inclusive prefix sum of an int32 (K, N) matrix; any N.
    One `ms_scan` launch on a CUDA tensor, in the form `ms_geometry`
    gives for N, and no other device operation."""
    if x.device.type == "cpu":
        if _dt.ENABLED:
            _DT["multi_scan", "plain"].note(*_ms_cost(x))
        return multi_scan_plain(x)
    _check_kernel_input("multi_scan", x, torch.int32, 2)
    out = torch.empty_like(x)
    K, N = x.shape
    if K == 0 or N == 0:
        return out
    lib = _LIB or load()
    dev = x.device
    geo = ms_geometry(K, N, *lib.ms_consts)
    stream = _stream_handle(dev)
    _, counters, words, sc = _scratch_entry("multi_scan", dev, stream, geo)
    rc = _call(dev, lib.amt_multi_scan, x.data_ptr(), out.data_ptr(), K, N,
               geo.form, sc, counters, words, stream)
    _raise_on(rc, "multi_scan")
    _count_launch("multi_scan", (K, N))
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


FS_TILE = 8192          # kFsTile: the longest block-form row, a tile
FS_WARP_ROW = 1024      # kFsWarpRow: the longest warp-form row
HEADER_WORDS = 2        # kHeaderWords: a look-back scratch's header


@functools.lru_cache(maxsize=4096)
def fs_geometry(kernel: str, rows: int, n: int, tile: int = FS_TILE,
                warp_row: int = FS_WARP_ROW) -> ScanLaunch:
    """The launch of `kernel` ("fs_scan" or "fs_totals") over `rows` rows
    of n slots (n >= 1): a warp a row up to `warp_row` slots, a block a
    row up to `tile`, else ceil(n / tile) tiles a row with the look-back
    (fs_scan: 6 status words a tile) or per-tile partials folded by the
    row's last block (fs_totals: 3 words a tile and a counter a row). The
    entry points refuse any other form; the wrappers pass the loaded
    library's constants."""
    if kernel not in ("fs_scan", "fs_totals") or rows < 1 or n < 1:
        raise ValueError(f"no segment-scan launch of {kernel} over "
                         f"({rows}, {n})")
    if n <= warp_row:
        return ScanLaunch(0, 0, 0)
    if n <= tile:
        return ScanLaunch(1, 0, 0)
    tiles = rows * n_tiles(n, tile)
    if kernel == "fs_scan":
        return ScanLaunch(2, 0, FS_STATUS_WORDS * tiles)
    return ScanLaunch(2, rows, 3 * tiles)


def fs_scratch_words(counters: int, words: int) -> int:
    """int64 words of a look-back scratch holding `counters` u32 row
    counters and `words` status words, after the header (the layout of
    both kernel families)."""
    return HEADER_WORDS + -(-counters // 2) + words


def _pow2(x: int) -> int:
    return 0 if x <= 0 else 1 << (x - 1).bit_length()


def _zeroed_words(n: int, device) -> torch.Tensor:
    # on the device's current stream: the stream whose launches use it
    return torch.zeros(n, dtype=torch.int64, device=device)


class ScratchCache:
    """The look-back form's persistent scratch: one buffer per key
    ((device, stream, kernel family) in the wrappers), zeroed once when it
    is allocated (`alloc(n_words, device)`, on that stream), grown to the
    next power of two of what a launch needs, never shared between two
    streams or two families. The kernels keep the buffer's state (ticket,
    counters, epoch) right from one launch to the next on the device, so
    a launch does no memset and a replayed CUDA graph stays right.
    Growing keeps the outgrown buffer (`retired`): a graph captured with
    it may still replay its pointer. Growing inside a capture raises (its
    allocation and zeroing would land in the graph): launch once on the
    capturing stream before capture."""

    def __init__(self, alloc=None, capturing=None):
        self._alloc = alloc or _zeroed_words
        self._capturing = capturing or torch.cuda.is_current_stream_capturing
        self._lock = threading.Lock()
        #: key -> (buffer, counters, words, ptr)
        self.buffers = {}
        self.retired = []

    def get(self, key, device, counters: int, words: int) -> tuple:
        with self._lock:
            have = self.buffers.get(key)
            if have is not None and have[1] >= counters and have[2] >= words:
                return have
            if self._capturing():
                raise RuntimeError(
                    "scan kernels: the scratch of this stream must be "
                    "sized before a CUDA graph captures it (launch once on "
                    "the capturing stream first)")
            if have is not None:
                counters = max(counters, have[1])
                words = max(words, have[2])
                self.retired.append(have[0])
            counters, words = _pow2(counters), _pow2(words)
            buf = self._alloc(fs_scratch_words(counters, words), device)
            entry = (buf, counters, words, buf.data_ptr())
            self.buffers[key] = entry
            return entry


_SCRATCH = ScratchCache()
_NO_SCRATCH = (None, 0, 0, None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream_handle(device) -> int:
    """The raw handle of `device`'s current stream."""
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream




def _fs_columns(name: str, chain, has_value) -> bool:
    """Check the CUDA columns of the segment-scan kernels; True for rows."""
    rows = chain.dim() == 2
    _check_kernel_input(f"{name} chain", chain, torch.bool, 2 if rows else 1)
    _check_kernel_input(f"{name} has_value", has_value, torch.bool,
                        2 if rows else 1)
    if has_value.shape != chain.shape:
        raise ValueError(f"{name}: chain and has_value differ "
                         f"in shape ({tuple(chain.shape)} vs "
                         f"{tuple(has_value.shape)})")
    if has_value.device != chain.device:
        raise ValueError(f"{name}: chain and has_value lie on "
                         f"{chain.device} and {has_value.device}")
    return rows


def _fs_counts(name: str, chain, n_elems, rows: bool) -> tuple:
    """The element counts as the kernels read them: (pointer, stride,
    immediate). An int goes by value (stride -1); a scalar tensor is read
    on the device (stride 0), per-row counts at their own stride."""
    if rows:
        n_elems = _row_counts(n_elems, chain)
        return n_elems.data_ptr(), n_elems.stride(0), 0
    if not torch.is_tensor(n_elems):
        return None, -1, int(n_elems)
    if (n_elems.device != chain.device or n_elems.dtype != torch.int32
            or n_elems.numel() != 1):
        raise ValueError(f"{name}: n_elems must be one int32 on "
                         f"{chain.device}")
    return n_elems.data_ptr(), 0, 0


def _scratch_entry(family: str, dev, stream: int, geo: ScanLaunch) -> tuple:
    """The scratch entry (buffer, counters, words, pointer) of one launch
    of `family` ("multi_scan", or "fs" for `fs_scan` and `fs_totals`) on
    `stream`: its persistent buffer in the look-back form, none else."""
    if geo.counters or geo.words:
        return _SCRATCH.get((dev.index, stream, family), dev, geo.counters,
                            geo.words)
    return _NO_SCRATCH


def _scratch_for(kernel: str, dev, D: int, C: int, lib):
    """(launch geometry, scratch entry, stream handle) of one segment-scan
    launch."""
    geo = fs_geometry(kernel, D, C, *lib.fs_consts)
    stream = _stream_handle(dev)
    return geo, _scratch_entry("fs", dev, stream, geo), stream


def _call(dev, fn, *args) -> int:
    """fn(*args) with `dev` the current device (entered only when it is
    not already)."""
    if dev.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def _fs_launch(name: str, chain, has_value, n_elems, base: int, carry,
               shard: int):
    """One `fs_scan` launch (with a carry-in when `carry` is given),
    counted under `name`: one kernel on the stream, nothing else."""
    rows = _fs_columns(name, chain, has_value)
    D, C = (chain.shape if rows else (1, chain.shape[0]))
    ne_ptr, ne_stride, ne_imm = _fs_counts(name, chain, n_elems, rows)
    dev = chain.device
    carry_ptr = None
    if carry is not None:
        _check_cuda(f"{name} carry", carry, torch.int32, carry.dim())
        if carry.device != dev or carry.numel() < 3 * D * shard:
            raise ValueError(f"{name}: carry must hold the int32 totals "
                             f"of {shard} earlier shards of {D} rows on "
                             f"{dev}")
        carry_ptr = carry.data_ptr()
    rank = torch.empty(chain.shape, dtype=torch.int32, device=dev)
    head = torch.empty_like(rank)
    cumvis = torch.empty_like(rank)
    if D == 0 or C == 0:
        return rank, head, cumvis
    lib = _LIB or load()
    geo, (_, counters, words, sc), stream = _scratch_for("fs_scan", dev, D,
                                                         C, lib)
    rc = _call(dev, lib.amt_fused_segment_scans, chain.data_ptr(),
               has_value.data_ptr(), D, C, ne_ptr, ne_stride, ne_imm,
               int(base), carry_ptr, int(shard), geo.form, sc, counters,
               words, rank.data_ptr(), head.data_ptr(), cumvis.data_ptr(),
               stream)
    _raise_on(rc, name)
    _count_launch(name, tuple(chain.shape))
    if _dt.ENABLED:
        _DT[name, "cuda"].note(*_fs_cost(chain))
    return rank, head, cumvis


def fused_segment_scans(chain: torch.Tensor, has_value: torch.Tensor,
                        n_elems, base: int = 0):
    """-> (rank_incl, seg_head, cumvis), int32, shaped like `chain`.

    One column of C slots, or (D, C) rows each scanned on its own (the
    per-document form of the DocSet's materialization): `n_elems` is then
    one count per row, an int32 (D,) tensor on the rows' device. For one
    column it is an int (passed to the kernel by value) or an int32 scalar
    tensor on the same device (read there, so counts computed on the
    device need no host sync)."""
    if chain.device.type == "cpu":
        if _dt.ENABLED:
            _DT["fused_segment_scans", "plain"].note(*_fs_cost(chain))
        return fused_segment_scans_plain(chain, has_value, n_elems, base)
    return _fs_launch("fused_segment_scans", chain, has_value, n_elems,
                      base, None, 0)


# ------------------------------------------------------- sharded form

def _carry_in(carry: torch.Tensor, shard: int, rows: bool):
    """(rank, head, vis) offsets of the shards before `shard` from the
    (n_shards, [D,] 3) gathered totals: sums and a max, 0 for none."""
    if shard == 0:
        rank = head = vis = carry.new_zeros(carry.shape[1:-1])
    else:
        pre = carry[:shard]
        rank = pre[..., 0].sum(0, dtype=torch.int32)
        head = pre[..., 1].amax(0)
        vis = pre[..., 2].sum(0, dtype=torch.int32)
    if rows:
        return rank[:, None], head[:, None], vis[:, None]
    return rank, head, vis


def fs_totals_plain(chain: torch.Tensor, has_value: torch.Tensor, n_elems,
                    base: int = 0) -> torch.Tensor:
    """The plain version of `fs_totals`: int32 (3,) for a column, (D, 3)
    for rows = (segment starts, latest segment-start slot or 0, visible
    count) over the live slots (global slot base + i in [1, n_elems])."""
    C = chain.shape[-1]
    flat = torch.arange(C, dtype=torch.int32, device=chain.device) + base
    if chain.dim() == 2:
        n_elems = _row_counts(n_elems, chain)[:, None]
    is_elem = (flat >= 1) & (flat <= n_elems)
    seg_start = is_elem & ~chain
    cand = torch.where(seg_start, flat, 0)
    return torch.stack([
        seg_start.sum(-1, dtype=torch.int32),
        cand.amax(-1) if C else cand.sum(-1, dtype=torch.int32),
        (is_elem & has_value).sum(-1, dtype=torch.int32)], -1)


def fs_totals(chain: torch.Tensor, has_value: torch.Tensor, n_elems,
              base: int = 0) -> torch.Tensor:
    """One shard's totals for the carry exchange of the sharded segment
    scans: int32 (3,) for a column, (D, 3) for rows; counts as for
    `fused_segment_scans`. One `fs_totals` launch on a CUDA tensor, which
    writes every total (no memset)."""
    if chain.device.type == "cpu":
        if _dt.ENABLED:
            _DT["fs_totals", "plain"].note(*_totals_cost(chain))
        return fs_totals_plain(chain, has_value, n_elems, base)
    rows = _fs_columns("fs_totals", chain, has_value)
    D, C = (chain.shape if rows else (1, chain.shape[0]))
    ne_ptr, ne_stride, ne_imm = _fs_counts("fs_totals", chain, n_elems, rows)
    dev = chain.device
    out = torch.empty((D, 3) if rows else (3,), dtype=torch.int32,
                      device=dev)
    if C == 0 or D == 0:
        return out.zero_()
    lib = _LIB or load()
    geo, (_, counters, words, sc), stream = _scratch_for("fs_totals", dev,
                                                         D, C, lib)
    rc = _call(dev, lib.amt_fs_totals, chain.data_ptr(),
               has_value.data_ptr(), D, C, ne_ptr, ne_stride, ne_imm,
               int(base), geo.form, sc, counters, words, out.data_ptr(),
               stream)
    _raise_on(rc, "fs_totals")
    _count_launch("fs_totals", tuple(chain.shape))
    if _dt.ENABLED:
        _DT["fs_totals", "cuda"].note(*_totals_cost(chain))
    return out


def _totals_cost(chain: torch.Tensor) -> tuple:
    # reads chain + has (1 B each) and a count per row, writes 3 int32 a
    # row; two adds and a max a slot
    rows = chain.shape[0] if chain.dim() == 2 else 1
    return 2 * chain.numel() + 16 * rows, 3 * chain.numel()


def fused_segment_scans_carry_plain(chain, has_value, n_elems, base: int,
                                    carry: torch.Tensor, shard: int):
    """The plain version of `fused_segment_scans_carry`: the shard's own
    scans, then the earlier shards' rank and vis sums added and their
    heads maxed in (scan_pallas.py:251-258)."""
    rank, head, cumvis = fused_segment_scans_plain(chain, has_value,
                                                   n_elems, base)
    r0, h0, v0 = _carry_in(carry, shard, chain.dim() == 2)
    return rank + r0, torch.maximum(head, h0), cumvis + v0


def fused_segment_scans_carry(chain: torch.Tensor, has_value: torch.Tensor,
                              n_elems, base: int, carry: torch.Tensor,
                              shard: int):
    """Shard `shard` of a sharded column's segment scans: the scans of its
    slots (global slots from `base`) starting from the combined totals of
    shards 0 .. shard - 1 in `carry`, the (n_shards, [D,] 3) int32 output
    of `fs_totals` gathered from every shard. One `fs_scan` launch with a
    carry-in on a CUDA tensor, counted under "sharded_fused_scans"."""
    if chain.device.type == "cpu":
        if _dt.ENABLED:
            _DT["sharded_fused_scans", "plain"].note(*_fs_cost(chain))
        return fused_segment_scans_carry_plain(chain, has_value, n_elems,
                                               base, carry, shard)
    return _fs_launch("sharded_fused_scans", chain, has_value, n_elems,
                      base, carry.contiguous(), shard)


def sharded_fused_scans_plain(chain: torch.Tensor, has_value: torch.Tensor,
                              n_elems, n_shards: int):
    """The plain version of `sharded_fused_scans` on whole tensors: each
    of `n_shards` element shards scanned by `fused_segment_scans_plain` at
    its base idx * C // n_shards, then every shard's totals shared and
    its offsets applied in torch ops. Returns the whole (rank, head,
    cumvis), shaped like `chain`."""
    C = chain.shape[-1]
    if C % n_shards:
        raise ValueError(f"capacity {C} must divide over {n_shards} shards")
    w = C // n_shards
    parts = [fused_segment_scans_plain(chain[..., i * w:(i + 1) * w],
                                       has_value[..., i * w:(i + 1) * w],
                                       n_elems, i * w)
             for i in range(n_shards)]
    totals = torch.stack([torch.stack([r[..., -1], h[..., -1], v[..., -1]],
                                      -1) for r, h, v in parts])
    out = []
    for i, (r, h, v) in enumerate(parts):
        r0, h0, v0 = _carry_in(totals, i, chain.dim() == 2)
        out.append((r + r0, torch.maximum(h, h0), v + v0))
    return tuple(torch.cat([o[k] for o in out], -1) for k in range(3))


def sharded_fused_scans(mesh, chain, has_value, n_elems, *,
                        axis: str = "elem"):
    """`fused_segment_scans` over an element-sharded table
    (scan_pallas.py:218-266) -> a (rank_incl, seg_head, cumvis) triple of
    `ShardedArray`s laid out as `chain`.

    `chain` / `has_value` are whole tensors (a column, sharded over
    `axis`; (D, C) rows, sharded over ("doc", axis)) or `ShardedArray`s
    already on the mesh. `n_elems` is an int or int32 scalar tensor for a
    column, an int32 (D,) tensor or ("doc",) `ShardedArray` for rows.
    Each line of shards along `axis` runs one `fs_totals` launch a shard,
    ONE `all_gather` of the (n_shards, [D,] 3) totals, and one carry-in
    `fs_scan` launch a shard; no host sync."""
    from ..parallel import mesh as pm
    if not isinstance(chain, pm.ShardedArray):
        spec = (axis,) if chain.dim() == 1 else ("doc", axis)
        chain = pm.shard(mesh, chain, spec)
        has_value = pm.shard(mesh, has_value, spec)
    rows = chain.ndim == 2
    if torch.is_tensor(n_elems):
        n_elems = pm.shard(mesh, n_elems, (chain.spec[0],) if rows else ())
    n = mesh.shape[axis]
    C = chain.shape[-1]
    if C % n:
        raise ValueError(f"capacity {C} must divide over {n} shards")
    w = C // n
    a = mesh.axis_names.index(axis)

    def count(coord):
        if isinstance(n_elems, pm.ShardedArray):
            return n_elems.blocks[coord]
        return n_elems

    if n == 1:
        return pm.map_shards(
            lambda coord, c, h: fused_segment_scans(c, h, count(coord)),
            chain, has_value, out=chain.spec)
    totals = pm.map_shards(
        lambda coord, c, h: fs_totals(c, h, count(coord), coord[a] * w),
        chain, has_value, out=chain.spec)
    carry = pm.all_gather(totals, axis)
    return pm.map_shards(
        lambda coord, c, h, t: fused_segment_scans_carry(
            c, h, count(coord), coord[a] * w, t, coord[a]),
        chain, has_value, carry, out=chain.spec)
