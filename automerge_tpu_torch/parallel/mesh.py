"""Multi-device execution: document-parallel and element-parallel sharding.

Counterpart of `automerge_tpu/parallel/mesh.py`. The JAX package expresses
a DocSet's and a long document's work as SPMD over a `jax.sharding.Mesh`
and lets XLA insert the collectives. PyTorch has no partitioner, so the
port's mesh is single-controller and explicit:

- `Mesh` is a (doc, elem) grid of `torch.device`s, driven from one
  process. Entries may repeat: eight *virtual shards* of one device (the
  CPU for the tests, one card for `chip_smoke.py`) run the same code a
  grid of eight cards would, as the JAX package's tests run on eight
  virtual CPU devices.
- `ShardedArray` is a global tensor held as one block per mesh
  coordinate, cut along the dims its partition spec names (a spec entry
  per dim: "doc", "elem" or None for a dim every coordinate holds whole).
- Every byte that moves between shards goes through the exchange
  functions below (`shard`, `unshard`, `all_gather`, `gather`, `scatter`,
  `reduce_scatter`). Each counts its calls in `calls` and the bytes it
  copied between shards in `moved_bytes`, plain integers like
  `ops.scan_kernels.launches`; `map_shards` (the counterpart of
  `shard_map`) runs a function on every coordinate's blocks and moves
  nothing. Bytes count what a grid of distinct devices would move, also
  where virtual shards share one device.

What runs on it:

- **doc axis (data parallel)**: a DocSet's documents stack into (doc,
  elem) tables; each doc group's programs run on its own device with no
  exchange (shard/audit.py counts that for the commit path).
- **elem axis (sequence parallel)**: one document's columns are cut into
  element shards. The prefix scans exchange their carries
  (`ops.scan_kernels.sharded_fused_scans`: one tiny all_gather), the
  planned materialization's segment lookups reduce S-sized partials, and
  its codes scatter reduces each shard's partial row
  (`sharded_planned_materialize`). Programs that need whole rows (the
  linearization of `sharded_merge_step`, the DocSet's run expansion)
  gather a doc group's element blocks onto the group's first device and
  scatter their outputs back.
"""

from __future__ import annotations

import itertools
import threading

import numpy as np
import torch

from ..ops.ingest import (I32, HASH_K2, HASH_K3, HASH_K4, _as_i32, _cumsum,
                          _mix32, _mul32, _prev_r, _set_drop_r, _take_r)
from ..ops.linearize import _rga_linearize_r

AXES = ("doc", "elem")
_M32 = 0xFFFFFFFF


# ------------------------------------------------------------------- mesh

def _concrete(d) -> torch.device:
    """`d` as a tensor made there reports its device: a bare "cuda" names
    the current card. (Left bare, it compares unequal to its own blocks'
    devices, and every exchange copies blocks a coordinate already
    holds.)"""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A (doc, elem) grid of devices; `shape` maps each axis name to its
    size, as `jax.sharding.Mesh.shape` does."""

    axis_names = AXES

    def __init__(self, grid):
        rows = [[_concrete(d) for d in row] for row in grid]
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh is a non-empty rectangular device grid")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, d in enumerate(row):
                self.devices[i, j] = d
        self.shape = {"doc": len(rows), "elem": len(rows[0])}
        self._streams: dict = {}

    @property
    def size(self) -> int:
        return self.devices.size

    def coords(self) -> list:
        """Every (doc, elem) coordinate, row-major."""
        return list(itertools.product(range(self.shape["doc"]),
                                      range(self.shape["elem"])))

    def device(self, coord) -> torch.device:
        return self.devices[tuple(coord)]

    def stream(self, coord):
        """The CUDA stream `map_shards` runs coordinate `coord`'s work on:
        one of its own where its card holds other coordinates too
        (virtual shards), so that they run side by side as shards on
        cards of their own would; None (the caller's stream) otherwise
        and off a card."""
        dev = self.device(coord)
        if dev.type != "cuda" or sum(d == dev for d in self.devices.flat) < 2:
            return None
        s = self._streams.get(tuple(coord))
        if s is None:
            s = self._streams[tuple(coord)] = torch.cuda.Stream(dev)
        return s

    def __repr__(self):
        return (f"Mesh(doc={self.shape['doc']}, elem={self.shape['elem']}, "
                f"devices={sorted({str(d) for d in self.devices.flat})})")


def cuda_devices() -> list:
    """The process's CUDA cards; raises without one (a mesh never falls
    back to the CPU: pass ``devices=`` for that)."""
    if not torch.cuda.is_available():
        raise RuntimeError("automerge_tpu_torch.parallel: no CUDA device is "
                           "available; pass devices= (e.g. [torch.device("
                           "'cpu')] * 8) for a mesh of virtual CPU shards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, doc_axis: int | None = None, *,
              devices=None) -> Mesh:
    """A (doc, elem) mesh over the process's CUDA cards, or over
    `devices` (which may repeat a device: virtual shards). `doc_axis`
    defaults to the balanced factorization of the JAX package: the
    largest divisor of n that is <= sqrt(n), so the elem axis is
    exercised whenever n > 1."""
    devices = cuda_devices() if devices is None else [
        torch.device(d) for d in devices]
    if n_devices:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} shards asked of {len(devices)} "
                             "devices")
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if doc_axis is None:
        doc_axis = max(d for d in range(1, int(n ** 0.5) + 1) if n % d == 0)
    if n % doc_axis:
        raise ValueError(f"doc_axis {doc_axis} does not divide {n} devices")
    e = n // doc_axis
    return Mesh([devices[i * e:(i + 1) * e] for i in range(doc_axis)])


# ---------------------------------------------------------- sharded arrays

def _norm_spec(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"partition spec {spec} has more entries than the "
                         f"{ndim} dims of its array")
    for ax in spec:
        if ax is not None and ax not in AXES:
            raise ValueError(f"unknown mesh axis {ax!r}")
    return spec + (None,) * (ndim - len(spec))


def _block_index(mesh: Mesh, spec: tuple, shape, coord) -> tuple:
    """The slices of the global array that `coord`'s block holds."""
    idx = []
    for dim, ax in enumerate(spec):
        if ax is None:
            idx.append(slice(None))
            continue
        k = mesh.shape[ax]
        if shape[dim] % k:
            raise ValueError(f"dim {dim} ({shape[dim]}) does not divide over "
                             f"the {ax} axis ({k})")
        w = shape[dim] // k
        i = coord[AXES.index(ax)]
        idx.append(slice(i * w, (i + 1) * w))
    return tuple(idx)


def _block_key(spec: tuple, coord) -> tuple:
    """Coordinates whose blocks hold the same slice share a key."""
    return tuple(coord[AXES.index(ax)] for ax in spec if ax is not None)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _copy_to(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of `t` on `device`."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


class ShardedArray:
    """A global tensor of `shape` held as one block per mesh coordinate,
    laid out by `spec`. Replicas on one device may share a block."""

    def __init__(self, mesh: Mesh, spec, blocks: dict, shape):
        self.mesh = mesh
        self.shape = tuple(shape)
        self.spec = _norm_spec(spec, len(self.shape))
        self.blocks = blocks
        if set(blocks) != set(mesh.coords()):
            raise ValueError("a sharded array holds one block per mesh "
                             "coordinate")

    @classmethod
    def from_blocks(cls, mesh: Mesh, spec, blocks: dict) -> "ShardedArray":
        """The array whose coordinates hold `blocks` (its shape follows
        from theirs and the spec)."""
        b = blocks[(0, 0)]
        spec = _norm_spec(spec, b.dim())
        shape = [n * (mesh.shape[ax] if ax else 1)
                 for n, ax in zip(b.shape, spec)]
        return cls(mesh, spec, blocks, shape)

    @classmethod
    def full(cls, mesh: Mesh, shape, spec, fill, dtype) -> "ShardedArray":
        """A constant array made in place on every coordinate's device
        (nothing moves between shards)."""
        spec = _norm_spec(spec, len(shape))
        made, blocks = {}, {}
        for coord in mesh.coords():
            dev = mesh.device(coord)
            key = (_block_key(spec, coord), str(dev))
            if key not in made:
                bshape = [len(range(*s.indices(n))) for s, n in zip(
                    _block_index(mesh, spec, shape, coord), shape)]
                made[key] = torch.full(bshape, fill, dtype=dtype, device=dev)
            blocks[coord] = made[key]
        return cls(mesh, spec, blocks, shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self):
        return self.blocks[(0, 0)].dtype

    @property
    def n_shards(self) -> int:
        """Mesh coordinates holding a block (`len(x.sharding.device_set)`
        of a JAX array on a mesh of distinct devices)."""
        return len(self.blocks)

    def shard_shape(self) -> tuple:
        return tuple(self.blocks[(0, 0)].shape)

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on `device` (default: the first coordinate's),
        through `unshard`."""
        return unshard(self, device)

    def __array__(self, dtype=None, copy=None):
        out = unshard(self, "cpu").numpy()
        return out if dtype is None else out.astype(dtype)

    def __repr__(self):
        return (f"ShardedArray(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, shards={self.n_shards})")


# --------------------------------------------------------------- exchange

#: calls of each exchange function since the last `reset_counts()`
calls = {"shard": 0, "unshard": 0, "all_gather": 0, "gather": 0,
         "scatter": 0, "reduce_scatter": 0}
#: bytes each exchange function copied between shards (or, for `shard`
#: and `unshard`, into and out of the mesh) since the last reset
moved_bytes = dict.fromkeys(calls, 0)
_COUNT_LOCK = threading.Lock()


def reset_counts():
    with _COUNT_LOCK:
        for k in calls:
            calls[k] = 0
            moved_bytes[k] = 0


def _count(name: str, nbytes: int):
    with _COUNT_LOCK:
        calls[name] += 1
        moved_bytes[name] += int(nbytes)


def _line(coord, a: int, i: int) -> tuple:
    """`coord` with its index along mesh axis number `a` set to i."""
    c = list(coord)
    c[a] = i
    return tuple(c)


def shard(mesh: Mesh, x, spec) -> ShardedArray:
    """Cut a whole tensor (or numpy array) into the mesh's blocks, each
    copied to its coordinate's device (replicas on one device share
    one copy)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    elif not torch.is_tensor(x):
        x = torch.as_tensor(x)
    spec = _norm_spec(spec, x.dim())
    made, blocks, nbytes = {}, {}, 0
    for coord in mesh.coords():
        dev = mesh.device(coord)
        key = (_block_key(spec, coord), str(dev))
        if key not in made:
            made[key] = _copy_to(x[_block_index(mesh, spec, x.shape, coord)],
                                 dev)
            nbytes += _nbytes(made[key])
        blocks[coord] = made[key]
    _count("shard", nbytes)
    return ShardedArray(mesh, spec, blocks, x.shape)


def unshard(x: ShardedArray, device=None) -> torch.Tensor:
    """The whole array on one device (default: the first coordinate's)."""
    mesh = x.mesh
    device = mesh.device((0, 0)) if device is None else torch.device(device)
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    seen, nbytes = set(), 0
    for coord, b in x.blocks.items():
        key = _block_key(x.spec, coord)
        if key in seen:
            continue
        seen.add(key)
        out[_block_index(mesh, x.spec, x.shape, coord)] = b
        nbytes += _nbytes(b)
    _count("unshard", nbytes)
    return out


def all_gather(x: ShardedArray, axis: str, *, tiled: bool = False
               ) -> ShardedArray:
    """Every coordinate receives the blocks of all coordinates along
    `axis` (its line), stacked on a new leading dim (`jax.lax.all_gather`)
    or, `tiled`, concatenated along the dim sharded over `axis`."""
    mesh = x.mesh
    a, n = AXES.index(axis), mesh.shape[axis]
    blocks, nbytes = {}, 0
    for coord in mesh.coords():
        dev = mesh.device(coord)
        parts = []
        for i in range(n):
            b = x.blocks[_line(coord, a, i)]
            if i != coord[a]:
                nbytes += _nbytes(b)
            parts.append(b if b.device == dev else _copy_to(b, dev))
        if tiled:
            blocks[coord] = torch.cat(parts, x.spec.index(axis))
        else:
            blocks[coord] = torch.stack(parts)
    spec = tuple(None if s == axis else s for s in x.spec)
    _count("all_gather", nbytes)
    return ShardedArray.from_blocks(mesh, spec if tiled else (None,) + spec,
                                    blocks)


def _leaders(mesh: Mesh, a: int, lines) -> list:
    leads = [c for c in mesh.coords() if c[a] == 0]
    return leads if lines is None else [tuple(c) for c in lines]


def gather(x: ShardedArray, axis: str, *, lines=None, index=None) -> dict:
    """Each line of coordinates along `axis` sends its blocks to the
    line's first coordinate (its leader), concatenated along the dim
    sharded over `axis`: {leader coordinate: tensor on its device}.
    `lines` restricts to some leaders; `index` (a slice or a list) picks
    rows of dim 0 of every block first."""
    mesh = x.mesh
    a, n = AXES.index(axis), mesh.shape[axis]
    d = x.spec.index(axis)
    out, nbytes = {}, 0
    for lead in _leaders(mesh, a, lines):
        dev = mesh.device(lead)
        parts = []
        for i in range(n):
            b = x.blocks[_line(lead, a, i)]
            if index is not None:
                b = b[index]
            if i:
                nbytes += _nbytes(b)
            parts.append(b if b.device == dev else _copy_to(b, dev))
        out[lead] = torch.cat(parts, d) if n > 1 else parts[0]
    _count("gather", nbytes)
    return out


def scatter(mesh: Mesh, parts: dict, axis: str, spec) -> ShardedArray:
    """The inverse of `gather`: each leader's tensor is cut along the dim
    that `spec` shards over `axis` and its pieces copied to the line's
    coordinates (every coordinate gets the whole tensor when `spec` does
    not name `axis`). `parts` covers every line's leader."""
    a, n = AXES.index(axis), mesh.shape[axis]
    blocks, nbytes = {}, 0
    spec0 = None
    for lead, t in parts.items():
        spec0 = _norm_spec(spec, t.dim())
        d = spec0.index(axis) if axis in spec0 else None
        for i in range(n):
            c = _line(lead, a, i)
            piece = t if d is None else t.narrow(d, i * (t.shape[d] // n),
                                                 t.shape[d] // n)
            blocks[c] = _copy_to(piece, mesh.device(c))
            if i:
                nbytes += _nbytes(piece)
    _count("scatter", nbytes)
    return ShardedArray.from_blocks(mesh, spec0, blocks)


def reduce_scatter(x: ShardedArray, axis: str, dim: int) -> ShardedArray:
    """Each coordinate holds a whole-length partial along `dim`; it
    receives the sum over its line of every partial's piece it owns
    (dim `dim` becomes sharded over `axis`)."""
    mesh = x.mesh
    a, n = AXES.index(axis), mesh.shape[axis]
    if x.spec[dim] is not None:
        raise ValueError(f"reduce_scatter: dim {dim} is already sharded")
    w = x.blocks[(0, 0)].shape[dim] // n
    blocks, nbytes = {}, 0
    for coord in mesh.coords():
        dev = mesh.device(coord)
        acc = None
        for i in range(n):
            piece = x.blocks[_line(coord, a, i)].narrow(dim, coord[a] * w, w)
            if i != coord[a]:
                nbytes += _nbytes(piece)
            piece = piece if piece.device == dev else _copy_to(piece, dev)
            acc = piece.clone() if acc is None else acc.add_(piece)
        blocks[coord] = acc
    spec = tuple(axis if k == dim else s for k, s in enumerate(x.spec))
    _count("reduce_scatter", nbytes)
    return ShardedArray.from_blocks(mesh, spec, blocks)


def map_shards(fn, *args, out):
    """`shard_map`: fn(coord, *blocks) on every mesh coordinate, where a
    `ShardedArray` argument passes its coordinate's block and any other
    argument passes as it is. `out` is the partition spec of the result,
    or a list of specs for a tuple of results (one spec given for a tuple
    applies to each). Moves nothing between shards.

    On a card each coordinate's work runs on its own stream
    (`Mesh.stream`), forked from and joined back to the caller's current
    stream: every coordinate starts after the caller's earlier work, and
    the caller's later work waits for every coordinate. (So a block a
    coordinate allocates and the caller frees is reused by that stream
    only after its next fork, past every use the caller issued.)"""
    mesh = next(a.mesh for a in args if isinstance(a, ShardedArray))
    res, joins = {}, []
    for c in mesh.coords():
        blocks = [a.blocks[c] if isinstance(a, ShardedArray) else a
                  for a in args]
        side = mesh.stream(c)
        if side is None:
            res[c] = fn(c, *blocks)
            continue
        cur = torch.cuda.current_stream(side.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            res[c] = fn(c, *blocks)
        joins.append((cur, side))
    for cur, side in joins:
        cur.wait_stream(side)
    first = res[(0, 0)]
    if not isinstance(first, tuple):
        return ShardedArray.from_blocks(mesh, out, res)
    specs = out if isinstance(out, list) else [out] * len(first)
    return tuple(ShardedArray.from_blocks(mesh, specs[k],
                                          {c: r[k] for c, r in res.items()})
                 for k in range(len(first)))


# ----------------------------------------------------- the merge step

def _merge_step_r(parent, ctr, actor, valid, visible, values):
    """`merge_step` of (D, n) rows, each on its own."""
    D, n = parent.shape
    pos = _rga_linearize_r(parent, ctr, actor, valid)
    idx = torch.arange(n, dtype=I32, device=parent.device)
    vis = visible & valid & (idx != 0)
    # rank among visible elements, by position (prefix scan over pos order)
    slot = (pos + 1).clamp(0, n + 1).long()
    by_pos = torch.zeros((D, n + 2), dtype=I32, device=parent.device)
    by_pos.scatter_add_(1, slot, vis.to(I32))
    cum = _cumsum(by_pos, 1)
    vis_rank = cum.gather(1, slot) - by_pos.gather(1, slot)
    out = _set_drop_r(
        torch.full((D, n), -1, dtype=values.dtype, device=values.device),
        torch.where(vis, vis_rank, n - 1),
        torch.where(vis, values, torch.full((), -1, dtype=values.dtype,
                                            device=values.device)))
    return pos, out, cum[:, n + 1]


def _tensors(tables, device):
    from ..engine.base import resolve_device
    out = []
    for t in tables:
        if not torch.is_tensor(t):
            t = torch.from_numpy(np.ascontiguousarray(t)).to(
                resolve_device(device))
        out.append(t)
    return out


def merge_step(parent, ctr, actor, valid, visible, values, *, device=None):
    """Single-document merge step: linearize + visible compaction.

    Returns (pos, out_values, n_visible): element positions in RGA order,
    the visible values scattered into list order (padded tail = -1), and
    the visible count. numpy inputs go to `device` (the card unless the
    caller asks for the CPU); tensors stay where they are."""
    t = _tensors((parent, ctr, actor, valid, visible, values), device)
    pos, out, n_vis = _merge_step_r(*(x[None] for x in t))
    return pos[0], out[0], n_vis[0]


def batched_merge_step(parent, ctr, actor, valid, visible, values, *,
                       device=None):
    """`merge_step` over a leading doc axis, written out (the JAX package
    vmaps it): (D, n) tables -> (pos, out_values) (D, n) and n_visible
    (D,)."""
    return _merge_step_r(*_tensors(
        (parent, ctr, actor, valid, visible, values), device))


def sharded_merge_step(mesh: Mesh, parent, ctr, actor, valid, visible,
                       values):
    """DocSet-scale merge: (docs, elements) tables sharded over the mesh.

    Documents shard over the `doc` axis (data parallel); the element axis
    shards over `elem`. The linearization needs whole rows, so each doc
    group's element blocks gather onto the group's first device, the
    group merges there, and the outputs scatter back as (doc, elem)
    shards. Returns sharded (pos, out_values, n_visible)."""
    spec = ("doc", "elem")
    args = [x if isinstance(x, ShardedArray) else shard(mesh, x, spec)
            for x in (parent, ctr, actor, valid, visible, values)]
    rows = [gather(x, "elem") for x in args]
    outs = {lead: _merge_step_r(*(r[lead] for r in rows)) for lead in rows[0]}
    pos = scatter(mesh, {k: o[0] for k, o in outs.items()}, "elem", spec)
    out = scatter(mesh, {k: o[1] for k, o in outs.items()}, "elem", spec)
    n_vis = scatter(mesh, {k: o[2] for k, o in outs.items()}, "elem",
                    ("doc",))
    return pos, out, n_vis


# ------------------------------------- elem-sharded planned materialization

def sharded_planned_materialize_r(mesh: Mesh, cols,
                                  n_elems: ShardedArray,
                                  segplan: ShardedArray, S: int,
                                  as_u8: bool):
    """`ops.ingest._materialize_core_planned_r` (codes only) of (D, C)
    rows whose columns are element-sharded ShardedArrays (spec (r,
    "elem"), r = "doc" or None), `n_elems` (r,), `segplan` (r, None,
    None). Returns (codes (r, "elem"), scalars (D, 5) replicated over
    elem).

    The visible prefix sum and the chain-bit segment count come from
    `sharded_fused_scans`. The S-sized lookups of `_seg_visibility_r`
    (cumvis and vis at each segment's head, cumvis at its last slot) and
    the plan-consistency hashes are partials that each shard fills for
    the slots it holds; one `all_gather` of the int64 (D, 2S + 4)
    partials and a sum give every shard the whole. Each shard then
    expands the per-segment bases over its own slots (the bases of heads
    before it are its carry) and scatters its visible codes into a
    whole-row partial; one `reduce_scatter` over elem sums those into
    the codes' element blocks (each position has one writer)."""
    from ..ops.scan_kernels import sharded_fused_scans
    parent, ctr, actor, value, has_value, chain = cols
    n = mesh.shape["elem"]
    C = value.shape[1]
    w = C // n
    r = value.spec[0]
    rank, _head, cumvis = sharded_fused_scans(mesh, chain, has_value, n_elems)

    def segs(plan, ne, dev):
        sidx = torch.arange(S, dtype=I32, device=dev)
        n_segs = plan[:, 3, 0]
        live = (sidx >= 1) & (sidx <= n_segs[:, None])
        heads_raw = plan[:, 0]
        heads = heads_raw.clamp(0, C - 1)
        nxt = torch.where(
            (sidx + 1 <= n_segs[:, None]) & (sidx + 1 < S),
            _take_r(heads_raw, (sidx + 1).clamp(0, S - 1)[None]),
            ne[:, None] + 1)
        return sidx, n_segs, live, heads, (nxt - 1).clamp(0, C - 1)

    def local(coord, p, c, a, h, ch, ne, plan, cv, rk):
        dev = h.device
        base = coord[1] * w
        gidx = torch.arange(w, dtype=I32, device=dev) + base
        is_elem = (gidx >= 1) & (gidx <= ne[:, None])
        vis = (h & is_elem).to(I32)
        _s, _n, _l, heads, last = segs(plan, ne, dev)

        def look(col, slots):
            loc = slots - base
            inside = (loc >= 0) & (loc < w)
            return torch.where(inside, _take_r(col, loc), 0)
        head_pre = look(cv, heads) - look(vis, heads)
        seg_start = is_elem & ~ch
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        g64 = gidx.to(torch.int64)
        head_h = torch.where(seg_start, _mix32(gidx), zero).sum(1)
        u = lambda t: t.to(torch.int64) & _M32  # noqa: E731
        aux_key = (_mul32(u(p), HASH_K2) + _mul32(u(c), HASH_K3)
                   + _mul32(u(a), HASH_K4))
        aux_h = torch.where(seg_start, _mix32(aux_key + g64), zero).sum(1)
        tail = coord[1] == n - 1          # the shard holding slot C - 1
        n_vis = cv[:, -1] if tail else torch.zeros_like(cv[:, -1])
        n_dev = rk[:, -1] if tail else torch.zeros_like(rk[:, -1])
        return torch.cat([head_pre.to(torch.int64),
                          look(cv, last).to(torch.int64),
                          torch.stack([n_vis.to(torch.int64),
                                       n_dev.to(torch.int64), head_h,
                                       aux_h], 1)], 1)

    part = map_shards(local, parent, ctr, actor, has_value, chain, n_elems,
                      segplan, cumvis, rank, out=(r, "elem"))
    whole = all_gather(part, "elem")

    def finish(coord, v, h, ne, plan, cv, tot):
        dev = h.device
        base = coord[1] * w
        tot = tot.sum(0)
        head_pre = tot[:, :S].to(I32)
        cv_last = tot[:, S:2 * S].to(I32)
        n_vis, n_dev, head_h, aux_h = tot[:, 2 * S:].unbind(1)
        sidx, n_segs, live, heads, _last = segs(plan, ne, dev)
        gidx = torch.arange(w, dtype=I32, device=dev) + base
        vis = h & (gidx >= 1) & (gidx <= ne[:, None])
        seg_vis = torch.where(live, cv_last - head_pre, 0)
        perm = plan[:, 1]
        sv_perm = _take_r(seg_vis, perm)
        rank_base = _set_drop_r(torch.zeros_like(seg_vis), perm,
                                _cumsum(sv_perm, 1) - sv_perm)
        seg_base = rank_base - head_pre
        # the S -> slot expansion of seg_base over this shard's slots:
        # deltas at its own live heads, plus the heads before it as carry
        d = torch.where(sidx == 1, seg_base, seg_base - _prev_r(seg_base))
        loc = heads - base
        mine = live & (loc >= 0) & (loc < w)
        deltas = _set_drop_r(torch.zeros(h.shape, dtype=I32, device=dev),
                             torch.where(mine, loc, w), d)
        carry = torch.where(live & (heads < base), d, 0).sum(1, dtype=I32)
        vis_rank = _cumsum(deltas, 1) + carry[:, None] + cv - vis.to(I32)
        tgt = torch.where(vis, vis_rank, C)
        D = h.shape[0]
        if as_u8:
            codes = _set_drop_r(torch.zeros((D, C), dtype=torch.uint8,
                                            device=dev), tgt,
                                v.to(torch.uint8))
        else:   # + 1 so that a position nobody writes sums to 0 (then -1)
            codes = _set_drop_r(torch.zeros((D, C), dtype=I32, device=dev),
                                tgt, v + 1)
        scalars = torch.stack([n_vis.to(I32), n_segs, n_dev.to(I32),
                               _as_i32(head_h), _as_i32(aux_h)], 1)
        return codes, scalars

    partial, scalars = map_shards(finish, value, has_value, n_elems,
                                  segplan, cumvis, whole,
                                  out=[(r, None), (r, None)])
    codes = reduce_scatter(partial, "elem", 1)
    if not as_u8:
        codes = map_shards(lambda _c, b: b.sub_(1), codes, out=codes.spec)
    return codes, scalars


def sharded_planned_materialize(mesh: Mesh, parent, ctr, actor, value,
                                has_value, chain, n_elems, segplan, *,
                                S: int, as_u8: bool = False):
    """One huge document's codes-only materialization with the element
    axis sharded over the mesh and the segment structure HOST-PLANNED
    (engine/segments.py): no sort and no pointer doubling on the device,
    so the elem axis pays only the prefix-scan carries, S-sized
    partials, and the codes scatter's reduce (`sharded_planned_materialize_r`
    says what moves). The (4, S) segplan is tiny and replicated. Columns are whole
    (C,) tensors or ("elem",) ShardedArrays. Returns codes sharded over
    elem and the replicated 5 scalars ([n_vis, n_segs, n_segs_dev,
    head_hash, aux_hash])."""
    def rows(x):
        if not isinstance(x, ShardedArray):
            x = shard(mesh, x, ("elem",))
        return map_shards(lambda _c, b: b[None], x, out=(None, "elem"))
    cols = [rows(x) for x in (parent, ctr, actor, value, has_value, chain)]
    if not torch.is_tensor(n_elems):
        n_elems = torch.tensor(int(n_elems), dtype=I32)
    n_el = shard(mesh, n_elems.reshape(1).to(I32), (None,))
    plan = shard(mesh, torch.as_tensor(segplan).to(I32)[None], (None,))
    codes, scalars = sharded_planned_materialize_r(mesh, cols, n_el, plan,
                                                   S, as_u8)
    codes = map_shards(lambda _c, b: b[0], codes, out=("elem",))
    scalars = map_shards(lambda _c, b: b[0], scalars, out=(None,))
    return codes, scalars


def example_doc_tables(n_docs: int, cap: int, seed: int = 0):
    """Synthesize a batch of random padded RGA document tables (head at
    slot 0); numpy only, the JAX package's generator."""
    rng = np.random.default_rng(seed)
    parent = np.zeros((n_docs, cap), np.int32)
    ctr = np.zeros((n_docs, cap), np.int32)
    actor = np.zeros((n_docs, cap), np.int32)
    valid = np.zeros((n_docs, cap), bool)
    visible = np.zeros((n_docs, cap), bool)
    values = np.zeros((n_docs, cap), np.int32)
    valid[:, 0] = True
    for d in range(n_docs):
        n = int(rng.integers(1, cap - 1))
        for i in range(1, n + 1):
            parent[d, i] = int(rng.integers(0, i))  # after any earlier elem
            ctr[d, i] = i
            actor[d, i] = int(rng.integers(0, 4))
            valid[d, i] = True
            visible[d, i] = bool(rng.random() < 0.8)
            values[d, i] = 97 + int(rng.integers(0, 26))
    return parent, ctr, actor, valid, visible, values
