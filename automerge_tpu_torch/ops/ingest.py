"""Device-side batch ingestion for the columnar engines, in PyTorch.

Counterpart of the text- and map-engine subset of
`automerge_tpu/ops/ingest.py`: run expansion (through
ops/fused_round.py), residual placement with the LWW register fast path,
chain breaks, the chain-condensed materialization (self-contained and
host-planned), the map round, the register writeback, the DocSet's dense
expansion and the stacking helpers of the multi-document tier. Every
function is a plain function on tensors, on the device its inputs live
on; shapes and `bucket()` sizes are the JAX package's, so the two produce
identical tables.

**Row forms.** Every program is written once, over a leading doc axis:
its operands are (D, ...) stacks, one row per document (the `*_r`
functions). The stacked documents (engine/stacked.py, engine/doc_set.py)
run them on their stacks, where the JAX package `vmap`s its one-document
programs (a kernel bound through ctypes cannot be vmapped). A
one-document program (`materialize_codes`, `apply_map_round`, ...) is its
row form at D = 1 (`_row` in, `_one` out).

**In-place rounds** (the port's form of the JAX package's `*_donated`
twins). The functions here run out of place by default. Given a
`TableStore` (one document, D = 1), the commit-path scatters
(`_scatter_rows_9_r`, `_register_fast_path_r`, `break_chains_r`,
`scatter_registers_packed_r`) write the round's rows into the store's
buffers instead, which are the live tables' storage: a round at an
unchanged capacity allocates no table set, and a round that grows the
capacity allocates one, once. The document selects them with
`donate_buffers` (engine/base.py), and a round that raises after its
first in-place write leaves no valid table state (`TableStore.writes`
tells the two cases apart).

Semantics that differ between JAX and PyTorch are made explicit here
rather than inherited:

- `.at[i].set(v, mode="drop")` drops indices outside the array (and wraps
  negatives). `_set_drop_r` / `_set_drop_rows_r` reproduce it without a
  host sync: dropped indices are redirected to a scratch column past each
  row's end, which is cut off. A row's scratch is its own: flattened to
  D * n without it, row d's sentinel n would land on row d + 1's slot 0.
- a JAX gather clamps an out-of-range index; `_take_r` does so explicitly.
- uint32 hashing wraps; torch has no uint32 shift on the CPU, so the
  hashes run in int64 with explicit 32-bit masks (`_mix32`).
- every int32 prefix sum passes `dtype=torch.int32` (torch would widen).
- `lax.sort(..., num_keys=k)` becomes successive stable sorts along each
  row (`_lexsort_r`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._common import KIND_DEL, KIND_INC, KIND_INS, KIND_SET  # noqa: F401
from .scan_kernels import fused_segment_scans, multi_scan

I32 = torch.int32


def bucket(n: int, minimum: int = 256) -> int:
    """Half-octave size buckets (2^k and 3·2^(k-1)): <=25% padding waste."""
    cap = minimum
    while cap < n:
        cap = cap * 3 // 2 if (cap & (cap - 1)) == 0 else (cap // 3) * 4
    return cap


# Packed-descriptor row layout of the (9, R) run descriptor matrix; the
# META row carries the round's scalars ([n_run_elems, base_slot, n_runs]).
DESC_HEAD_SLOT, DESC_PARENT_SLOT, DESC_CTR0, DESC_ACTOR, DESC_WIN_ACTOR, \
    DESC_WIN_SEQ, DESC_ELEM_BASE, DESC_HAS_VALUE, DESC_META = range(9)
META_N_ELEMS, META_BASE_SLOT, META_N_RUNS = range(3)

# Residual-op packed layout: one (8, M) int32 matrix.
RES_KIND, RES_SLOT, RES_NEW_SLOT, RES_CTR, RES_ACTOR, RES_VALUE, \
    RES_WIN_ACTOR, RES_WIN_SEQ = range(8)

# Row layout of the packed (D, 5, M) stacked map-op upload.
MOP_KIND, MOP_SLOT, MOP_VALUE, MOP_WIN_ACTOR, MOP_WIN_SEQ = range(5)

# Packed-writeback row layout for scatter_registers_packed: one (6, S).
WB_SLOT, WB_VALUE, WB_HAS, WB_WIN_ACTOR, WB_WIN_SEQ, WB_WIN_COUNTER = \
    range(6)


# ----------------------------------------------------------------- helpers

def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device)


def _row(*ts) -> tuple:
    """One document's operands as one-row stacks (a row form's D = 1)."""
    return tuple(t[None] for t in ts)


def _one(out, store=None, keys=()) -> tuple:
    """Row 0 of each of a row form's D = 1 results. With a `store`, the
    leading `keys` results are the store's own views: the engine knows
    in-place tables by identity (`TableStore.holds`)."""
    out = tuple(t[0] for t in out)
    if store is not None:
        out = tuple(store.views[k] for k in keys) + out[len(keys):]
    return out


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`a[idx]` with JAX gather semantics: negative indices wrap once,
    then every index clamps into range."""
    n = a.shape[0]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return a[idx]


def _take_r(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-wise `a[idx]` with JAX gather semantics (negatives wrap once,
    then every index clamps into its row); a (1, M) `idx` serves every
    row."""
    n = a.shape[1]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return a.gather(1, idx.expand(a.shape[0], -1))


def _drop_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX `mode="drop"` scatter indices for a length-`n` axis: negatives
    inside [-n, 0) wrap, everything else outside [0, n) maps to `n` — a
    scratch position past the end that the caller cuts off again."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _flat_rows(idx: torch.Tensor, stride: int) -> torch.Tensor:
    """(D, M) in-row indices -> flat (D * M,) indices into a (D, stride)
    buffer."""
    D = idx.shape[0]
    if D > 1:
        idx = idx + torch.arange(D, dtype=torch.int64,
                                 device=idx.device)[:, None] * stride
    return idx.reshape(-1)


def _set_drop_r(dst: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """Row-wise `dst.at[idx].set(vals, mode="drop")` of a (D, n, ...)
    `dst` with (D, M) `idx`, out of place (a scalar `vals` broadcasts).

    Instead of a mask, which would need a host sync to compact, dropped
    indices write to a scratch column appended to each row and cut off
    again; only they may collide, so live writes stay deterministic."""
    D, n = dst.shape[:2]
    trail = tuple(dst.shape[2:])
    out = torch.cat([dst, dst.new_zeros((D, 1) + trail)], 1)
    if torch.is_tensor(vals):
        vals = vals.to(dst.dtype).reshape((-1,) + trail)
    else:
        # a fill on the device: a pageable h2d copy would sync the stream
        vals = dst.new_full((), vals)
    out.view((-1,) + trail).index_put_(
        (_flat_rows(_drop_index(idx, n), n + 1),), vals)
    return out[:, :n]


def _set_drop(dst: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """`dst.at[idx].set(vals, mode="drop")` along dim 0: `_set_drop_r` of
    one row."""
    return _set_drop_r(dst[None], idx[None],
                       vals[None] if torch.is_tensor(vals) else vals)[0]


def _prev_r(a: torch.Tensor) -> torch.Tensor:
    """[0, a[:, 0], ..., a[:, -2]] per row."""
    return torch.cat([a.new_zeros((a.shape[0], 1)), a[:, :-1]], 1)


def _ext_r(a: torch.Tensor, fill, out_cap: int) -> torch.Tensor:
    """(D, C) rows extended to (D, out_cap) with their padding fill."""
    D, C = a.shape
    if C >= out_cap:
        return a
    return torch.cat([a, a.new_full((D, out_cap - C), fill)], 1)


def _lexsort_r(keys) -> torch.Tensor:
    """Row-wise stable ascending order over (D, n) `keys` (most
    significant first), as int64 (D, n) orders — the `lax.sort(...,
    num_keys=len(keys))` permutation of each row: successive stable sorts
    from the least significant key."""
    D, n = keys[0].shape
    order = torch.arange(n, device=keys[0].device).expand(D, n)
    for k in reversed(keys):
        order = order.gather(
            1, torch.sort(k.gather(1, order), dim=1, stable=True).indices)
    return order


def _cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cumsum(x, dim, dtype=I32)


# ------------------------------------------------------- table scatters

#: the text engine's 9 element tables and their padding fills (bool fill:
#: a bool table), in the row order every commit-path program uses
TEXT_TABLE_KEYS = ("parent", "ctr", "actor", "value", "has_value",
                   "win_actor", "win_seq", "win_counter", "chain")
TEXT_TABLE_FILLS = (0, 0, 0, 0, False, -1, 0, False, False)
#: the 5 register tables (every engine has them)
REG_KEYS = ("value", "has_value", "win_actor", "win_seq", "win_counter")
REG_FILLS = (0, False, -1, 0, False)


class TableStore:
    """A document's tables packed for in-place rounds.

    The int32 tables are the rows of one (K, W) int32 buffer and the bool
    tables the rows of one (B, W) bool buffer, with W = cap + 1 rounded up
    to a multiple of 16 so that every row starts 16-byte aligned. Column
    `cap` is the scratch where dropped scatter indices land
    (`_drop_index`), so a scatter writes straight into the storage; the
    tables are the rows' [:cap] views (`views`). Only `grow` allocates;
    `writes` counts the in-place scatters, so a failed round can tell
    whether it touched the live tables."""

    def __init__(self, keys, fills, tables: dict, cap: int):
        self.keys = tuple(keys)
        self.fills = dict(zip(self.keys, fills))
        bools = [k for k in self.keys if isinstance(self.fills[k], bool)]
        ints = [k for k in self.keys if k not in bools]
        #: key -> (buffer: 0 int32 / 1 bool, row)
        self._row = {k: (0, r) for r, k in enumerate(ints)}
        self._row.update({k: (1, r) for r, k in enumerate(bools)})
        self._n_rows = (len(ints), len(bools))
        self.writes = 0
        self._alloc(cap, tables)

    def _alloc(self, cap: int, tables: dict):
        width = -(-(cap + 1) // 16) * 16
        dev = tables[self.keys[0]].device
        bufs = (torch.empty((self._n_rows[0], width), dtype=I32, device=dev),
                torch.empty((self._n_rows[1], width), dtype=torch.bool,
                            device=dev))
        for k, (b, r) in self._row.items():
            t = tables[k]
            bufs[b][r, :t.shape[0]] = t
            bufs[b][r, t.shape[0]:] = self.fills[k]
        self.cap = cap
        self._bufs = bufs
        self.views = {k: bufs[b][r, :cap] for k, (b, r) in self._row.items()}

    def rows(self) -> tuple:
        """The table views in key order."""
        return tuple(self.views[k] for k in self.keys)

    def holds(self, tables: dict) -> bool:
        """Whether `tables` are exactly this store's views."""
        return all(tables.get(k) is v for k, v in self.views.items())

    def grow(self, cap: int):
        """Reallocate at a larger capacity (one copy; padding filled)."""
        if cap > self.cap:
            self._alloc(cap, self.views)

    def put(self, keys, idx: torch.Tensor, updates):
        """`table.at[idx].set(update, mode="drop")` for each key, in place:
        one column scatter per buffer over the rows the keys name (an
        update may be a Python scalar, broadcast along idx). The keys of
        one buffer must name contiguous rows, as TEXT_TABLE_KEYS, REG_KEYS
        and ("chain",) do in both layouts."""
        di = _drop_index(idx, self.cap)
        M = di.shape[0]
        groups = ([], [])
        for k, u in zip(keys, updates):
            b, r = self._row[k]
            dtype = torch.bool if b else I32
            groups[b].append((r, u.to(dtype) if torch.is_tensor(u) else
                              torch.full((M,), u, dtype=dtype,
                                         device=di.device)))
        for b, group in enumerate(groups):
            if not group:
                continue
            group.sort(key=lambda g: g[0])
            lo, hi = group[0][0], group[-1][0] + 1
            assert hi - lo == len(group), "rows of one put must be contiguous"
            self._bufs[b][lo:hi, di] = torch.stack([v for _, v in group])
        self.writes += 1

    def put_row(self, keys, idx: torch.Tensor, updates):
        """`put` of a row form's one-row (1, M) indices and updates."""
        self.put(keys, idx[0],
                 tuple(u[0] if torch.is_tensor(u) else u for u in updates))


def table_versions(tables) -> tuple:
    """The write counters of `tables`: torch bumps a tensor's `_version`
    on every in-place write to its storage, and views share their
    base's counter, so a `TableStore.put` into a store's buffer bumps
    every table view of that buffer."""
    return tuple(t._version for t in tables)


def buffers_consumed(tables, versions) -> bool:
    """True iff an in-place round wrote into any of `tables` since their
    `table_versions` were read — the port's form of the JAX package's
    `buffers_consumed` (there a donated call deletes the buffer; here
    an in-place round overwrites it and the tensor stays alive)."""
    return any(t._version != v for t, v in zip(tables, versions))


def _set_drop_rows_r(rows, fills, idx, updates, n: int) -> torch.Tensor:
    """Write K aligned (D, C) tables at (D, M) `idx` as ONE scatter into a
    (K, D, n + 1) int32 buffer: table r is `rows[r]` padded with
    `fills[r]` to n, and each row's out-of-range `idx` drops into its
    scratch column n. Returns the (K, D, n) view; every row of it is
    contiguous, so no transpose copy is needed."""
    D, C = rows[0].shape
    buf = torch.empty((len(rows), D, n + 1), dtype=I32,
                      device=rows[0].device)
    for r, (t, fill) in enumerate(zip(rows, fills)):
        buf[r, :, :C] = t
        buf[r, :, C:] = fill
    buf.view(len(rows), -1)[:, _flat_rows(_drop_index(idx, n), n + 1)] = \
        torch.stack([u.to(I32).reshape(-1) for u in updates])
    return buf[:, :, :n]


def _scatter_rows_9_r(tables, idx, updates, out_cap: int, store=None):
    """Write the 9 element tables at (D, M) `idx` as ONE scatter (shared
    index rows; out-of-range `idx` drops), the tables first extended to
    `out_cap` with their padding fills. Row order: TEXT_TABLE_KEYS; bool
    tables ride as int32. With a `store` (D = 1) the rows land in its
    buffers (one scatter per dtype) and its views come back."""
    if store is not None:
        store.grow(out_cap)
        store.put_row(TEXT_TABLE_KEYS, idx, updates)
        return _row(*store.rows())
    out = _set_drop_rows_r(tables, TEXT_TABLE_FILLS, idx, updates,
                           max(tables[0].shape[1], out_cap))
    return (out[0], out[1], out[2], out[3], out[4].bool(), out[5], out[6],
            out[7].bool(), out[8].bool())


def _unpack_desc_r(desc):
    """The run rows of a (D, 9, R) descriptor stack."""
    return (desc[:, DESC_HEAD_SLOT], desc[:, DESC_PARENT_SLOT],
            desc[:, DESC_CTR0], desc[:, DESC_ACTOR], desc[:, DESC_WIN_ACTOR],
            desc[:, DESC_WIN_SEQ], desc[:, DESC_ELEM_BASE],
            desc[:, DESC_HAS_VALUE].bool())


def break_chains_r(chain, parent, ctr, actor, p_slots, h_ctr, h_actor,
                   store=None):
    """Clear the chain bit of slot p+1 for every touched parent p whose
    new child Lamport-exceeds (ctr, actor) of p+1 (breaks are sticky):
    (D, T) touched parents per row. With a `store` (D = 1), in place."""
    C = chain.shape[1]
    q = (p_slots + 1).clamp(0, C - 1).long()
    cq = ctr.gather(1, q)
    aq = actor.gather(1, q)
    brk = (p_slots >= 1) & ((h_ctr > cq) | ((h_ctr == cq) & (h_actor > aq)))
    tgt = torch.where(brk, q, C)
    if store is not None:
        store.put_row(("chain",), tgt, (False,))
        return store.views["chain"][None]
    return _set_drop_r(chain, tgt, False)


def _register_fast_path_r(value_n, has_n, wa_n, ws_n, wc_n, kind, is_assign,
                          op_slot, op_value, op_win_actor, op_win_seq,
                          conflict_slots, out_cap, store=None):
    """Shared LWW register resolution, (D, M) ops against (D, out_cap)
    registers: a single plain inline set in this round targeting an empty
    register or the op's own actor's earlier write is written here;
    everything else is flagged `slow` for the host. With a `store` (D = 1,
    capacity `out_cap`) the writes land in place.

    Returns the updated registers plus the packed (D, 7, M) `slow_info`
    [slow, tslot, reg_value, reg_has, reg_win_actor, reg_win_seq,
    reg_win_counter]."""
    D = kind.shape[0]
    dev = kind.device
    tslot = torch.where(is_assign, op_slot, out_cap)
    tclip = tslot.clamp(0, out_cap - 1).long()
    counts = torch.zeros((D, out_cap + 1), dtype=I32, device=dev)
    counts.view(-1).index_add_(
        0, _flat_rows(tslot.clamp(0, out_cap).long(), out_cap + 1),
        is_assign.to(I32).reshape(-1))
    cmask = torch.zeros((D, out_cap + 1), dtype=torch.bool, device=dev)
    cmask.view(-1)[_flat_rows(conflict_slots.clamp(0, out_cap).long(),
                              out_cap + 1)] = True
    g_h, g_wa = has_n.gather(1, tclip), wa_n.gather(1, tclip)
    empty = ~g_h & (g_wa < 0)
    self_over = (~wc_n.gather(1, tclip) & (g_wa == op_win_actor)
                 & (ws_n.gather(1, tclip) < op_win_seq))
    fast = (is_assign & (kind == KIND_SET)
            & (counts.gather(1, tclip) == 1) & (empty | self_over)
            & ~cmask.gather(1, tclip) & (op_value >= 0))
    f_idx = torch.where(fast, tslot, out_cap)
    ones = torch.ones_like(f_idx)
    upd = (op_value, ones, op_win_actor, op_win_seq, torch.zeros_like(ones))
    if store is not None:
        store.put_row(REG_KEYS, f_idx, upd)
        value_n, has_n, wa_n, ws_n, wc_n = (store.views[k][None]
                                            for k in REG_KEYS)
    else:
        regs = _set_drop_rows_r((value_n, has_n, wa_n, ws_n, wc_n), (0,) * 5,
                                f_idx, upd, value_n.shape[1])
        value_n, has_n, wa_n, ws_n, wc_n = (regs[0], regs[1].bool(), regs[2],
                                            regs[3], regs[4].bool())
    slow = is_assign & ~fast
    slow_info = torch.stack([
        slow.to(I32), tslot,
        value_n.gather(1, tclip), has_n.gather(1, tclip).to(I32),
        wa_n.gather(1, tclip), ws_n.gather(1, tclip),
        wc_n.gather(1, tclip).to(I32)], 1)
    return value_n, has_n, wa_n, ws_n, wc_n, slow_info


def _apply_residual_packed_r(parent, ctr, actor, value, has_value,
                             win_actor, win_seq, win_counter, chain, res,
                             conflict_slots, *, out_cap: int, store=None):
    """Place irregular inserts and run the LWW register fast path: (D, 8,
    M) residual ops (row layout: RES_*; padding rows: kind=-1,
    slots=out_cap), (D, K) conflict slots. Returns the 9 tables + the
    (D, 7, M) slow_info. With a `store` (D = 1), in place."""
    kind = res[:, RES_KIND]
    is_ins = kind == KIND_INS
    is_assign = (kind == KIND_SET) | (kind == KIND_DEL) | (kind == KIND_INC)
    op_slot = res[:, RES_SLOT]
    zeros = torch.zeros_like(op_slot)
    tables = _scatter_rows_9_r(
        (parent, ctr, actor, value, has_value, win_actor, win_seq,
         win_counter, chain),
        torch.where(is_ins, res[:, RES_NEW_SLOT], out_cap),
        (op_slot, res[:, RES_CTR], res[:, RES_ACTOR], zeros, zeros,
         torch.full_like(zeros, -1), zeros, zeros, zeros),
        out_cap, store)
    regs = _register_fast_path_r(
        *tables[3:8], kind, is_assign, op_slot, res[:, RES_VALUE],
        res[:, RES_WIN_ACTOR], res[:, RES_WIN_SEQ], conflict_slots, out_cap,
        store)
    return tables[:3] + regs[:5] + (tables[8], regs[5])


def _map_round_r(regs, kind, slot, value, win_actor, win_seq,
                 conflict_slots, out_cap: int):
    kind = kind.to(I32)
    is_assign = (kind == KIND_SET) | (kind == KIND_DEL) | (kind == KIND_INC)
    regs = [_ext_r(t, f, out_cap) for t, f in zip(regs, REG_FILLS)]
    return _register_fast_path_r(*regs, kind, is_assign, slot, value,
                                 win_actor, win_seq, conflict_slots, out_cap)


def apply_map_round(value, has_value, win_actor, win_seq, win_counter,
                    op_kind, op_slot, op_value, op_win_actor, op_win_seq,
                    conflict_slots, *, out_cap: int):
    """One causally-ready round of map ops (set/del/inc on interned keys):
    the residual round without inserts. Key registers are dense slots; the
    LWW fast path takes single uncontended inline-int sets, and dels,
    incs, pooled values, multi-writer rounds and occupied registers land
    in the `slow` mask for the host (padding: kind=-1, slot=out_cap).
    Returns the 5 registers + the (7, M) slow_info."""
    return _one(_map_round_r(
        _row(value, has_value, win_actor, win_seq, win_counter),
        *_row(op_kind, op_slot, op_value, op_win_actor, op_win_seq,
              conflict_slots), out_cap))


def apply_map_round_r(value, has_value, win_actor, win_seq, win_counter,
                      ops, conflict_slots, *, out_cap: int):
    """`apply_map_round` over the doc axis: one round of every stacked
    map document. `ops` is the packed (D, 5, M) int32 op matrix (MOP_*
    rows; padding kind=-1, slot=out_cap), `conflict_slots` (D, K).
    Returns the 5 stacked registers + the (D, 7, M) slow_info."""
    return _map_round_r(
        (value, has_value, win_actor, win_seq, win_counter),
        ops[:, MOP_KIND], ops[:, MOP_SLOT], ops[:, MOP_VALUE],
        ops[:, MOP_WIN_ACTOR], ops[:, MOP_WIN_SEQ], conflict_slots, out_cap)


# ---------------------------------------------------------- materialize

def _linearize_segments_r(parent, attach_off, ctr, actor, weight, valid):
    """Condensed-tree linearization of (D, n) trees, each row on its own:
    per-parent children ordered by descending (attach, ctr, actor),
    successor chain by pointer doubling, weighted list ranking. Returns
    each segment's start position."""
    D, n = parent.shape
    dev = parent.device
    steps = max(1, math.ceil(math.log2(max(2, n))))
    idx = torch.arange(n, dtype=I32, device=dev)
    is_seg = valid & (idx != 0)
    big = n + 1

    sort_parent = torch.where(is_seg, parent, big)
    order = _lexsort_r([sort_parent, torch.where(is_seg, -attach_off, big),
                        torch.where(is_seg, -ctr, big),
                        torch.where(is_seg, -actor, big)])
    p_s = sort_parent.gather(1, order)
    idx_s = order.to(I32)
    in_group = p_s < big
    false1 = torch.zeros((D, 1), dtype=torch.bool, device=dev)
    same_next = torch.cat([(p_s[:, 1:] == p_s[:, :-1]) & in_group[:, 1:],
                           false1], 1)
    next_in_sorted = torch.cat([idx_s[:, 1:], idx_s.new_full((D, 1), -1)], 1)
    next_sib = torch.full((D, n), -1, dtype=I32, device=dev).scatter_(
        1, order, torch.where(same_next, next_in_sorted, -1))
    group_start = torch.cat([~false1, p_s[:, 1:] != p_s[:, :-1]], 1) \
        & in_group
    first_child = _set_drop_r(
        torch.full((D, n), -1, dtype=I32, device=dev),
        torch.where(group_start, p_s, big - 1),
        torch.where(group_start, idx_s, -1))

    has_next = next_sib >= 0
    anc = torch.where(has_next | (idx == 0), idx,
                      torch.where(is_seg, parent, 0)).long()
    for _ in range(steps):
        anc = anc.gather(1, anc)
    succ = torch.where(first_child >= 0, first_child, _take_r(next_sib, anc))
    nxt = torch.where(succ >= 0, succ, n)
    nxt = torch.where(is_seg | (idx == 0), nxt, idx)
    nxt = torch.cat([nxt, nxt.new_full((D, 1), n)], 1).long()
    dist = torch.where(is_seg, weight, 0).to(I32)
    dist = torch.cat([dist, dist.new_zeros((D, 1))], 1)
    for _ in range(steps + 1):
        dist, nxt = dist + dist.gather(1, nxt), nxt.gather(1, nxt)
    start = dist[:, :1] - dist[:, :n]
    return torch.where(is_seg, start,
                       torch.where(idx == 0, 0, big)).to(I32)


def _expand_S_r(table, sidx, live_seg, heads, C: int):
    """(D, S) segment table -> per-segment deltas at the heads' slots
    ((D, C), prefix-summed by the caller): slots of segment k read
    table[k]."""
    d = torch.where(sidx == 1, table, table - _prev_r(table))
    return _set_drop_r(torch.zeros((table.shape[0], C), dtype=table.dtype,
                                   device=table.device),
                       torch.where(live_seg, heads, C), d)


def _codes_r(value, vis, vis_rank, C: int, as_u8: bool):
    tgt = torch.where(vis, vis_rank, C)
    D = value.shape[0]
    if as_u8:
        # known-7-bit documents scatter 1-byte codes: 4x fewer bytes each way
        return _set_drop_r(torch.zeros((D, C), dtype=torch.uint8,
                                       device=value.device),
                           tgt, value.to(torch.uint8))
    return _set_drop_r(torch.full((D, C), -1, dtype=value.dtype,
                                  device=value.device), tgt, value)


def _per_row(n_elems):
    """Element counts broadcasting over (D, C): a (D,) tensor as a
    column; a scalar (one document) as it is."""
    if torch.is_tensor(n_elems) and n_elems.dim() == 1:
        return n_elems[:, None]
    return n_elems


def _segment_scans(chain, has_value, n_elems):
    """`fused_segment_scans` of (D, C) rows: (D,) counts take the kernel's
    row form, a scalar count (one document) its 1-D form."""
    if torch.is_tensor(n_elems) and n_elems.dim() == 1:
        return fused_segment_scans(chain, has_value, n_elems)
    return _row(*fused_segment_scans(chain[0], has_value[0], n_elems))


def _seg_visibility_r(vis, cumvis, heads_raw, n_segs, ne, S: int):
    """(sidx, heads, next_head, live_seg, head_pre, seg_vis) of (D, S)
    segment tables: `n_segs` (D,), `ne` the per-row element counts
    (`_per_row`)."""
    C = vis.shape[1]
    sidx = torch.arange(S, dtype=I32, device=vis.device)
    live_seg = (sidx >= 1) & (sidx <= n_segs[:, None])
    heads = heads_raw.clamp(0, C - 1)
    next_head = torch.where(
        (sidx + 1 <= n_segs[:, None]) & (sidx + 1 < S),
        _take_r(heads_raw, (sidx + 1).clamp(0, S - 1)[None]), ne + 1)
    head_pre = _take_r(cumvis, heads) - _take_r(vis, heads).to(I32)
    last = (next_head - 1).clamp(0, C - 1)
    seg_vis = torch.where(live_seg, _take_r(cumvis, last) - head_pre, 0)
    return sidx, heads, next_head, live_seg, head_pre, seg_vis


def _place(value, vis, is_elem, cumvis, seg_base, starts, sidx, live_seg,
           heads, with_pos: bool, as_u8: bool):
    """Element placement from the per-segment bases: the codes, and the
    positions when `with_pos` (the S->slot expansions prefix-summed in
    one pass)."""
    C = value.shape[1]
    if with_pos:
        exp = _cumsum(torch.stack(
            [_expand_S_r(t, sidx, live_seg, heads, C)
             for t in (seg_base, starts, heads)], 1), 2)
        sb_exp, starts_exp, seg_head_exp = exp[:, 0], exp[:, 1], exp[:, 2]
    else:
        sb_exp = _cumsum(_expand_S_r(seg_base, sidx, live_seg, heads, C), 1)
    vis_rank = sb_exp + cumvis - vis.to(I32)
    codes = _codes_r(value, vis, vis_rank, C, as_u8)
    if not with_pos:
        return codes, None
    idx = torch.arange(C, dtype=I32, device=value.device)
    pos = torch.where(is_elem, starts_exp + (idx - seg_head_exp),
                      torch.where(idx == 0, -1, C + 1).to(I32))
    return codes, pos


def _materialize_core_r(parent, ctr, actor, value, has_value, chain,
                        n_elems, S, with_pos, as_u8, scans=None):
    """RGA positions + visible compaction of (D, C) tables from the
    maintained chain bits, each row on its own.

    Segments (maximal chain runs, contiguous in slot space) compact into S
    nodes, the condensed tree linearizes in O(S log S), and element
    position = segment start + offset. The segment ranks and the visible
    prefix sum of every row come from ONE `fused_segment_scans` launch
    (the JAX package ran a (2, C) cumsum here and kept the Pallas kernel
    for other callers). `scans` = (rank_incl, cumvis) computed already (an
    element-sharded caller scans its shards in place: parallel/mesh.py)
    skips that launch. Returns (codes, scalars (D, 2) = [n_vis, n_segs])
    or, `with_pos`, (pos, codes, scalars)."""
    D, C = parent.shape
    ne = _per_row(n_elems)
    idx = torch.arange(C, dtype=I32, device=parent.device)
    is_elem = (idx >= 1) & (idx <= ne)
    vis = has_value & is_elem
    if scans is None:
        rank_incl, _seg_head, cumvis = _segment_scans(chain, has_value,
                                                      n_elems)
    else:
        rank_incl, cumvis = scans
    n_segs = rank_incl[:, -1]
    sidx = torch.arange(S, dtype=I32, device=parent.device)
    heads_raw = torch.searchsorted(rank_incl, sidx.expand(D, S).contiguous(),
                                   right=False, out_int32=True)
    valid = sidx <= n_segs[:, None]
    sidx, heads, next_head, live_seg, head_pre, seg_vis = _seg_visibility_r(
        vis, cumvis, heads_raw, n_segs, ne, S)
    p_slot = _take_r(parent, heads)
    node_parent = _take_r(rank_incl, p_slot)
    attach = p_slot - _take_r(heads, node_parent.clamp(0, S - 1))
    weight = torch.where(live_seg, next_head - heads, 0)
    starts = _linearize_segments_r(node_parent, attach, _take_r(ctr, heads),
                                   _take_r(actor, heads), weight, valid)
    perm = torch.sort(torch.where(live_seg, starts, C + 2), dim=1,
                      stable=True).indices
    sv_perm = seg_vis.gather(1, perm)
    rank_base = torch.zeros((D, S), dtype=I32, device=parent.device)
    rank_base.scatter_(1, perm, _cumsum(sv_perm, 1) - sv_perm)
    codes, pos = _place(value, vis, is_elem, cumvis, rank_base - head_pre,
                        starts, sidx, live_seg, heads, with_pos, as_u8)
    scalars = torch.stack([cumvis[:, C - 1], n_segs], 1)
    return (pos, codes, scalars) if with_pos else (codes, scalars)


# Odd 32-bit mixing constants for the plan-consistency hashes (see
# `_materialize_core_planned_r`). engine/segments.SegmentMirror
# {head_checksum, aux_checksum} run `mix32_np`, the numpy twin of `_mix32`.
HASH_K1 = np.uint32(2654435761)   # 0x9E3779B1
HASH_K2 = np.uint32(2246822519)   # 0x85EBCA77
HASH_K3 = np.uint32(3266489917)   # 0xC2B2AE3D
HASH_K4 = np.uint32(668265263)    # 0x27D4EB2F

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, k) -> torch.Tensor:
    """(a * k) mod 2^32 for int64 `a` in [0, 2^32): split into 16-bit
    halves of `k` so no intermediate leaves the int64 range."""
    k = int(k)
    lo, hi = k & 0xFFFF, k >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3-fmix-style nonlinear 32-bit mix; returns int64 holding the
    uint32 result (the device twin of `mix32_np`)."""
    x = x.to(torch.int64) & _M32
    x = _mul32(x, HASH_K1)
    x = x ^ (x >> 15)
    x = _mul32(x, HASH_K2)
    x = x ^ (x >> 13)
    return x


def _as_i32(u: torch.Tensor) -> torch.Tensor:
    """uint32 value held in int64 -> the int32 with the same bits."""
    u = u & _M32
    return torch.where(u >= 2**31, u - 2**32, u).to(I32)


def mix32_np(x: np.ndarray) -> np.ndarray:
    """Host twin of `_mix32` — the uint32 pipeline in numpy."""
    x = x.astype(np.uint32) * HASH_K1
    x = x ^ (x >> np.uint32(15))
    x = x * HASH_K2
    x = x ^ (x >> np.uint32(13))
    return x


def _materialize_core_planned_r(parent, ctr, actor, value, has_value, chain,
                                n_elems, segplan, S, with_pos, as_u8):
    """Materialization of (D, C) tables with HOST-PLANNED segment
    structure.

    `segplan` is the (D, 4, S) int32 stack of engine/segments
    SegmentMirror.plan(): [head slots, position->segment permutation,
    segment starts, meta(n_segs)]. What remains on the device is the
    visibility prefix sum, the S->slot expansion sum and the codes
    scatter, plus the plan-consistency scalars: the segment count and two
    nonlinear hashes re-derived from the REAL chain bits, which the engine
    checks against the mirror at its scalar sync. Returns (codes, scalars
    (D, 5) = [n_vis, n_segs, n_segs from the chain bits, head hash, aux
    hash]) or, `with_pos`, (pos, codes, scalars)."""
    D, C = value.shape
    ne = _per_row(n_elems)
    idx = torch.arange(C, dtype=I32, device=value.device)
    is_elem = (idx >= 1) & (idx <= ne)
    vis = has_value & is_elem
    cumvis = _cumsum(vis.to(I32), 1)
    n_segs = segplan[:, 3, 0]
    sidx, heads, _next, live_seg, head_pre, seg_vis = _seg_visibility_r(
        vis, cumvis, segplan[:, 0], n_segs, ne, S)
    perm = segplan[:, 1]
    sv_perm = _take_r(seg_vis, perm)
    rank_base = _set_drop_r(torch.zeros((D, S), dtype=I32,
                                        device=value.device),
                            perm, _cumsum(sv_perm, 1) - sv_perm)
    codes, pos = _place(value, vis, is_elem, cumvis, rank_base - head_pre,
                        segplan[:, 2], sidx, live_seg, heads, with_pos,
                        as_u8)

    seg_start = is_elem & ~chain
    zero = torch.zeros((), dtype=torch.int64, device=value.device)
    head_hash = _as_i32(torch.where(seg_start, _mix32(idx), zero).sum(1))
    u = lambda t: t.to(torch.int64) & _M32  # noqa: E731
    aux_key = (_mul32(u(parent), HASH_K2) + _mul32(u(ctr), HASH_K3)
               + _mul32(u(actor), HASH_K4))
    aux_hash = _as_i32(torch.where(
        seg_start, _mix32(aux_key + idx.to(torch.int64)), zero).sum(1))
    scalars = torch.stack([cumvis[:, C - 1], n_segs,
                           seg_start.sum(1, dtype=I32), head_hash,
                           aux_hash], 1)
    return (pos, codes, scalars) if with_pos else (codes, scalars)


def _slice_live(cols, L):
    """Restrict the element columns to the live-window bucket `L` (along
    their last dim): table capacity can exceed the live prefix by up to
    50%, and every pass of the materialization scales with operand
    length."""
    if L is None or L >= cols[0].shape[-1]:
        return cols
    return tuple(c[..., :L] for c in cols)


def materialize_text_planned(parent, ctr, actor, value, has_value, chain,
                             n_elems, segplan, *, S: int, as_u8: bool = False,
                             L: int = None):
    """(pos, codes, scalars) with host-planned segment structure."""
    cols = _slice_live((parent, ctr, actor, value, has_value, chain), L)
    return _one(_materialize_core_planned_r(
        *_row(*cols), n_elems, segplan[None], S, True, as_u8))


def materialize_codes_planned(parent, ctr, actor, value, has_value, chain,
                              n_elems, segplan, *, S: int,
                              as_u8: bool = False, L: int = None):
    """(codes, scalars) with host-planned segment structure."""
    cols = _slice_live((parent, ctr, actor, value, has_value, chain), L)
    return _one(_materialize_core_planned_r(
        *_row(*cols), n_elems, segplan[None], S, False, as_u8))


def materialize_text(parent, ctr, actor, value, has_value, chain, n_elems,
                     *, S: int, as_u8: bool = False, L: int = None):
    """Full materialization: (pos, codes, [n_vis, n_segs]). `pos` includes
    tombstones (head = -1, padding > n); `codes` is the visible values in
    list order (uint8 when `as_u8`)."""
    cols = _slice_live((parent, ctr, actor, value, has_value, chain), L)
    return _one(_materialize_core_r(*_row(*cols), n_elems, S, True, as_u8))


def materialize_codes(parent, ctr, actor, value, has_value, chain, n_elems,
                      *, S: int, as_u8: bool = False, L: int = None):
    """Codes-only materialization for `text()`."""
    cols = _slice_live((parent, ctr, actor, value, has_value, chain), L)
    return _one(_materialize_core_r(*_row(*cols), n_elems, S, False, as_u8))


def materialize_codes_r(parent, ctr, actor, value, has_value, chain,
                        n_elems, *, S: int, as_u8: bool = False):
    """`materialize_codes` over the doc axis: (D, C) tables, (D,) counts
    on the device; the segment scans of every row are ONE row-form
    `fused_segment_scans` launch on (D, C). Returns (codes (D, C),
    scalars (D, 2))."""
    return _materialize_core_r(parent, ctr, actor, value, has_value, chain,
                               n_elems, S, False, as_u8)


def materialize_codes_planned_r(parent, ctr, actor, value, has_value, chain,
                                n_elems, segplan, *, S: int,
                                as_u8: bool = False):
    """`materialize_codes_planned` over the doc axis: (D, 4, S) segment
    plans. Returns (codes (D, C), scalars (D, 5))."""
    return _materialize_core_planned_r(parent, ctr, actor, value, has_value,
                                       chain, n_elems, segplan, S, False,
                                       as_u8)


# ------------------------------------------------------ host interplay

def remap_actors(actor, win_actor, remap, n_elems):
    """Re-rank actor ids after interning breaks lexicographic rank order."""
    C = actor.shape[0]
    idx = _arange(C, actor)
    live = (idx >= 1) & (idx <= n_elems)
    hi = remap.shape[0] - 1
    actor_n = torch.where(live, remap[actor.clamp(0, hi).long()], actor)
    return actor_n, remap_ranks(win_actor, remap)


def remap_ranks(win_actor, remap):
    """Re-rank the winner-actor column after an interning order change."""
    hi = remap.shape[0] - 1
    return torch.where(win_actor >= 0, remap[win_actor.clamp(0, hi).long()],
                       win_actor)


def pack_rows(*arrays):
    """Stack same-length tables into one int32 matrix: the host mirror
    fetch is a single device->host transfer."""
    return torch.stack([a.to(I32) for a in arrays])


def scatter_registers(value, has_value, win_actor, win_seq, win_counter,
                      slots, v, h, wa, ws, wc):
    """Write back host-resolved registers, one column per argument
    (out-of-range slots drop) — the per-column comparator of
    `scatter_registers_packed`."""
    return (_set_drop(value, slots, v), _set_drop(has_value, slots, h),
            _set_drop(win_actor, slots, wa), _set_drop(win_seq, slots, ws),
            _set_drop(win_counter, slots, wc))


def scatter_registers_packed_r(value, has_value, win_actor, win_seq,
                               win_counter, wb, store=None):
    """Host-resolved register writeback over the doc axis: every
    document's resolved rows as one (D, 6, S) int32 matrix (row layout:
    WB_*; padding rows carry an out-of-range slot and drop). With a
    `store` (D = 1, whose views are the registers passed), in place."""
    upd = (wb[:, WB_VALUE], wb[:, WB_HAS], wb[:, WB_WIN_ACTOR],
           wb[:, WB_WIN_SEQ], wb[:, WB_WIN_COUNTER])
    if store is not None:
        store.put_row(REG_KEYS, wb[:, WB_SLOT], upd)
        return tuple(store.views[k][None] for k in REG_KEYS)
    regs = _set_drop_rows_r((value, has_value, win_actor, win_seq,
                             win_counter), (0,) * 5, wb[:, WB_SLOT], upd,
                            value.shape[1])
    return (regs[0], regs[1].bool(), regs[2], regs[3], regs[4].bool())


def scatter_registers_packed(value, has_value, win_actor, win_seq,
                             win_counter, wb, store=None):
    """`scatter_registers` with the resolved rows packed as one (6, S)
    int32 matrix: `scatter_registers_packed_r` of one document."""
    return _one(scatter_registers_packed_r(
        *_row(value, has_value, win_actor, win_seq, win_counter, wb),
        store=store), store, REG_KEYS)


# ------------------------------------------------------- run expansion

def _expand_columns_r(run_ctr0, run_actor, run_win_actor, run_win_seq,
                      run_elem_base, run_has_value, N: int, extra=None):
    """The boundary-delta prefix sum of the run expansion over the doc
    axis: ONE `multi_scan` launch on (D * K, N). Channels: ctr (+1 per
    element), [`extra` (D, R) deltas stepping +1 per element,] actor,
    win_actor, win_seq, has_value. Returns (D, K, N) int32.

    Every per-element column is piecewise affine over runs (constant or +1
    per element), so the columns come from boundary deltas at each run's
    first element and one shared prefix sum — no per-element gathers. A
    run's first element takes its delta in place of the step; live run
    starts are distinct, so that is one add of (delta - step) per column.
    Padding runs (elem_base == N) add zero at a clamped column instead."""
    D, R = run_ctr0.shape
    dev = run_ctr0.device
    run_len_prev = run_elem_base - _prev_r(run_elem_base)
    first = torch.arange(R, dtype=I32, device=dev) == 0
    wa_v = torch.where(run_has_value, run_win_actor, -1)
    ws_v = torch.where(run_has_value, run_win_seq, 0)
    has_v = run_has_value.to(I32)

    def step1(v):       # +1-per-element column: reset at each run start
        return torch.where(first, v, v - (_prev_r(v) + run_len_prev - 1))

    def const(v):       # piecewise-constant column
        return torch.where(first, v, v - _prev_r(v))
    chans = [step1(run_ctr0)] + ([step1(extra)] if extra is not None
                                 else [])
    chans += [const(run_actor), const(wa_v), const(ws_v), const(has_v)]
    K = len(chans)
    step = (torch.arange(K, device=dev) < K - 4).to(I32)
    deltas = step[None, :, None].expand(D, K, N).contiguous()
    upd = torch.stack(chans, 1) - step[None, :, None]
    upd = torch.where((run_elem_base < N)[:, None, :], upd, 0)
    deltas.scatter_add_(
        2, run_elem_base.clamp(0, N - 1).long()[:, None, :].expand(D, K, R),
        upd)
    return multi_scan(deltas.view(D * K, N)).view(D, K, N)


def expand_runs_dense_r(parent, ctr, actor, value, has_value, win_actor,
                        win_seq, win_counter, chain,
                        run_parent_slot, run_ctr0, run_actor,
                        run_win_actor, run_win_seq, run_elem_base,
                        run_has_value, blob, n_run_elems, base_slot, *,
                        out_cap: int):
    """`expand_runs_dense` over the doc axis (the DocSet's fast tier):
    every row writes its padded run window [base_slot, base_slot + N) —
    inactive rows too, past their live region, as under the JAX
    package's vmap — with the (5, N) boundary-delta prefix sum of every
    row as ONE `multi_scan` launch on (D * 5, N). Run descriptors are
    (D, R), `blob` (D, N), `n_run_elems`/`base_slot` (D,)."""
    D, N = blob.shape
    dev = blob.device
    cols = _expand_columns_r(run_ctr0, run_actor, run_win_actor,
                             run_win_seq, run_elem_base, run_has_value, N)
    j = torch.arange(N, dtype=I32, device=dev)
    live = j < n_run_elems[:, None]
    is_start = _set_drop_r(torch.zeros((D, N), dtype=torch.bool, device=dev),
                           run_elem_base, True)
    parent_col = _set_drop_r((base_slot[:, None] - 1) + j, run_elem_base,
                             run_parent_slot)
    has_col = (cols[:, 4] > 0) & live
    # dynamic_update_slice clamps its start so the window fits
    start = base_slot.clamp(0, max(out_cap - N, 0))
    return _scatter_rows_9_r(
        (parent, ctr, actor, value, has_value, win_actor, win_seq,
         win_counter, chain), start[:, None] + j,
        (parent_col, cols[:, 0], cols[:, 1], blob.to(I32), has_col,
         torch.where(has_col, cols[:, 2], -1),
         torch.where(has_col, cols[:, 3], 0),
         torch.zeros((D, N), dtype=I32, device=dev), live & ~is_start),
        out_cap)


# --- stacking documents ----------------------------------------------------

def _stack_padded(tables, fills, out_cap: int) -> tuple:
    """Per-document table tuples -> one (D, out_cap) tensor per column,
    each document's column extended with its padding fill."""
    def ext(t, fill):
        n = t.shape[0]
        return t if n >= out_cap else torch.cat([t, t.new_full(
            (out_cap - n,), fill)])
    return tuple(torch.stack([ext(doc[k], fills[k]) for doc in tables])
                 for k in range(len(fills)))


def _remap_r(ranks, remaps):
    """Re-rank (D, C) actor ranks through per-row (D, L) remaps (clamped
    gather; the caller masks which slots take it)."""
    hi = remaps.shape[1] - 1
    return remaps.gather(1, ranks.clamp(0, hi).long())


def stack_register_tables(tables, remaps, *, out_cap: int) -> tuple:
    """Per-document register 5-tuples -> stacked (D, out_cap) columns,
    each row's pending actor-rank remap ((D, L) int32, identity rows for
    unaffected documents) folded into the gather."""
    value, has_value, win_actor, win_seq, win_counter = _stack_padded(
        tables, REG_FILLS, out_cap)
    win_actor = torch.where(win_actor >= 0, _remap_r(win_actor, remaps),
                            win_actor)
    return value, has_value, win_actor, win_seq, win_counter


def stack_element_tables(tables, remaps, n_elems, *, out_cap: int) -> tuple:
    """Per-document element 9-tuples -> stacked (D, out_cap) columns with
    each row's pending remap folded in (`remap_actors` per row: live
    slots 1..n_elems[d] re-rank `actor`, every slot a non-negative
    `win_actor`)."""
    (parent, ctr, actor, value, has_value, win_actor, win_seq, win_counter,
     chain) = _stack_padded(tables, TEXT_TABLE_FILLS, out_cap)
    idx = torch.arange(out_cap, dtype=I32, device=parent.device)
    live = (idx >= 1) & (idx <= n_elems[:, None])
    actor = torch.where(live, _remap_r(actor, remaps), actor)
    win_actor = torch.where(win_actor >= 0, _remap_r(win_actor, remaps),
                            win_actor)
    return (parent, ctr, actor, value, has_value, win_actor, win_seq,
            win_counter, chain)


def stacked_pack_rows(*tables) -> torch.Tensor:
    """Stacked (D, w) columns -> one (D, K, w) int32 matrix: ONE d2h
    fetch re-seeds every stacked document's host mirror."""
    return torch.stack([t.to(I32) for t in tables], 1)


def unstack_rows(cols) -> list:
    """Stacked (D, cap) columns -> per-document table tuples, each table a
    buffer of its own: the documents share no storage with the stacked
    columns or with each other, so a later in-place write to one document
    — through a `TableStore`, or to the stacked columns — can reach no
    other, a document's storages hold exactly its tables (its
    ``device_footprint`` counts no other document's bytes), and releasing
    a document frees its tables whatever the others do. The copies of a
    dtype are one batched op: `torch._foreach_add` of a zero of the
    column's kind (the identity, dtype kept) allocates every output
    itself, and on a card copies in multi-tensor launches of about a
    hundred rows each, not one launch or one Python call per row."""
    D = cols[0].shape[0]
    by_dtype: dict = {}
    for k, c in enumerate(cols):
        by_dtype.setdefault(c.dtype, []).append(k)
    per_key = [None] * len(cols)
    for dtype, keys in by_dtype.items():
        own = torch._foreach_add(
            [row for k in keys for row in cols[k].unbind(0)],
            False if dtype == torch.bool else 0)
        for i, k in enumerate(keys):
            per_key[k] = own[i * D:(i + 1) * D]
    return list(zip(*per_key))
