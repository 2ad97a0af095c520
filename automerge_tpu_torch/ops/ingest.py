"""Device-side batch ingestion for the columnar engines, in PyTorch.

Counterpart of the text- and map-engine subset of
`automerge_tpu/ops/ingest.py`: run expansion (through
ops/fused_round.py), residual placement with the LWW register fast path,
chain breaks, the chain-condensed materialization (self-contained and
host-planned), the map round, and the register writeback. Every function
is a plain function on tensors, on the device its inputs live on; shapes
and `bucket()` sizes are the JAX package's, so the two produce identical
tables.

**In-place rounds** (the port's form of the JAX package's `*_donated`
twins). The functions here run out of place by default. Given a
`TableStore`, the commit-path scatters (`_scatter_rows_9`,
`_register_fast_path`, `_break_chains_core`, `scatter_registers_packed`)
write the round's rows into the store's buffers instead, which are the
live tables' storage: a round at an unchanged capacity allocates no
table set, and a round that grows the capacity allocates one, once.
The document selects them with `donate_buffers` (engine/base.py), and a
round that raises after its first in-place write leaves no valid table
state (`TableStore.writes` tells the two cases apart).

Semantics that differ between JAX and PyTorch are made explicit here
rather than inherited:

- `.at[i].set(v, mode="drop")` drops indices outside the array (and wraps
  negatives). `_set_drop` / `_set_drop_rows` reproduce it without a host
  sync: dropped indices are redirected to one scratch row (column) past
  the end, which is cut off.
- a JAX gather clamps an out-of-range index; `_take` does so explicitly.
- uint32 hashing wraps; torch has no uint32 shift on the CPU, so the
  hashes run in int64 with explicit 32-bit masks (`_mix32`).
- every int32 prefix sum passes `dtype=torch.int32` (torch would widen).
- `lax.sort(..., num_keys=k)` becomes successive stable sorts (`_lexsort`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._common import KIND_DEL, KIND_INC, KIND_INS, KIND_SET  # noqa: F401
from .scan_kernels import fused_segment_scans

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

# Row layout of the packed (D, 5, M) stacked map-op upload (the stacked
# executor is not part of this package; the layout is shared format).
MOP_KIND, MOP_SLOT, MOP_VALUE, MOP_WIN_ACTOR, MOP_WIN_SEQ = range(5)

# Packed-writeback row layout for scatter_registers_packed: one (6, S).
WB_SLOT, WB_VALUE, WB_HAS, WB_WIN_ACTOR, WB_WIN_SEQ, WB_WIN_COUNTER = \
    range(6)


# ----------------------------------------------------------------- helpers

def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`a[idx]` with JAX gather semantics: negative indices wrap once,
    then every index clamps into range."""
    n = a.shape[0]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return a[idx]


def _drop_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX `mode="drop"` scatter indices for a length-`n` axis: negatives
    inside [-n, 0) wrap, everything else outside [0, n) maps to `n` — a
    scratch position past the end that the caller cuts off again."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _set_drop(dst: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """`dst.at[idx].set(vals, mode="drop")` along dim 0, out of place.

    Instead of a mask, which would need a host sync to compact, dropped
    rows write to one scratch row appended past the end and cut off
    again; only they may collide, so live writes stay deterministic."""
    n = dst.shape[0]
    out = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    if not torch.is_tensor(vals):
        # a fill on the device: a pageable h2d copy would sync the stream
        vals = dst.new_full((), vals)
    out.index_put_((_drop_index(idx, n),), vals.to(dst.dtype))
    return out[:n]


def _prev(a: torch.Tensor) -> torch.Tensor:
    """[0, a[0], ..., a[-2]]"""
    return torch.cat([a.new_zeros(1), a[:-1]])


def _lexsort(keys) -> torch.Tensor:
    """Stable ascending order over `keys` (most significant first) — the
    `lax.sort(..., num_keys=len(keys))` permutation."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
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


def _set_drop_rows(rows, fills, idx, updates, n: int) -> torch.Tensor:
    """Write K aligned rows at `idx` as ONE column scatter into a
    (K, n + 1) int32 buffer: row r is `rows[r]` padded with `fills[r]` to
    length n, and out-of-range `idx` drops into the scratch column n.
    Returns the (K, n) view; each of its rows is contiguous, so no
    transpose copy is needed."""
    C = rows[0].shape[0]
    buf = torch.empty((len(rows), n + 1), dtype=I32, device=rows[0].device)
    for r, (t, fill) in enumerate(zip(rows, fills)):
        buf[r, :C] = t
        buf[r, C:] = fill
    buf[:, _drop_index(idx, n)] = torch.stack([u.to(I32) for u in updates])
    return buf[:, :n]


def _scatter_rows_9(tables, idx, updates, out_cap: int, store=None):
    """Write 9 aligned element-table rows at `idx` as ONE scatter (shared
    index vector; out-of-range `idx` drops), the tables first extended to
    `out_cap` with their padding fills. Row order: TEXT_TABLE_KEYS; bool
    rows ride as int32. With a `store` the rows land in its buffers (one
    scatter per dtype) and its views come back."""
    if store is not None:
        store.grow(out_cap)
        store.put(TEXT_TABLE_KEYS, idx, updates)
        return store.rows()
    out = _set_drop_rows(tables, (0, 0, 0, 0, 0, -1, 0, 0, 0), idx, updates,
                         max(tables[0].shape[0], out_cap))
    return (out[0], out[1], out[2], out[3], out[4].bool(), out[5], out[6],
            out[7].bool(), out[8].bool())


def _unpack_desc(desc):
    return (desc[DESC_HEAD_SLOT], desc[DESC_PARENT_SLOT], desc[DESC_CTR0],
            desc[DESC_ACTOR], desc[DESC_WIN_ACTOR], desc[DESC_WIN_SEQ],
            desc[DESC_ELEM_BASE], desc[DESC_HAS_VALUE].bool())


def _break_chains_core(chain, parent, ctr, actor, p_slots, h_ctr, h_actor,
                       store=None):
    """Clear the chain bit of slot p+1 for every touched parent p whose new
    child Lamport-exceeds (ctr, actor) of p+1 (breaks are sticky). With a
    `store`, in place."""
    C = chain.shape[0]
    q = (p_slots + 1).clamp(0, C - 1)
    cq = ctr[q.long()]
    aq = actor[q.long()]
    brk = (p_slots >= 1) & ((h_ctr > cq) | ((h_ctr == cq) & (h_actor > aq)))
    tgt = torch.where(brk, q, C)
    if store is not None:
        store.put(("chain",), tgt, (False,))
        return store.views["chain"]
    return _set_drop(chain, tgt, False)


def _break_chains_packed(chain, parent, ctr, actor, touch, store=None):
    """`_break_chains_core` with the (p_slot, ctr, actor) touch rows packed
    as one (3, T) int32 matrix."""
    return _break_chains_core(chain, parent, ctr, actor,
                              touch[0], touch[1], touch[2], store)


def _register_fast_path(value_n, has_n, wa_n, ws_n, wc_n, kind, is_assign,
                        op_slot, op_value, op_win_actor, op_win_seq,
                        conflict_slots, out_cap, store=None):
    """Shared LWW register resolution: a single plain inline set in this
    round targeting an empty register or the op's own actor's earlier
    write is written here; everything else is flagged `slow` for the host.
    With a `store` (of capacity `out_cap`) the writes land in place.

    Returns the updated registers plus the packed (7, M) `slow_info`
    [slow, tslot, reg_value, reg_has, reg_win_actor, reg_win_seq,
    reg_win_counter]."""
    tslot = torch.where(is_assign, op_slot, out_cap)
    tclip = tslot.clamp(0, out_cap - 1).long()
    counts = torch.zeros(out_cap + 1, dtype=I32, device=value_n.device)
    counts.index_add_(0, tslot.clamp(0, out_cap).long(), is_assign.to(I32))
    cmask = torch.zeros(out_cap + 1, dtype=torch.bool, device=value_n.device)
    cmask[conflict_slots.clamp(0, out_cap).long()] = True
    empty = ~has_n[tclip] & (wa_n[tclip] < 0)
    self_over = (~wc_n[tclip] & (wa_n[tclip] == op_win_actor)
                 & (ws_n[tclip] < op_win_seq))
    fast = (is_assign & (kind == KIND_SET)
            & (counts[tclip] == 1) & (empty | self_over)
            & ~cmask[tclip] & (op_value >= 0))
    f_idx = torch.where(fast, tslot, out_cap)
    M = f_idx.shape[0]
    ones = torch.ones(M, dtype=I32, device=value_n.device)
    upd = (op_value, ones, op_win_actor, op_win_seq, torch.zeros_like(ones))
    if store is not None:
        store.put(REG_KEYS, f_idx, upd)
        value_n, has_n, wa_n, ws_n, wc_n = (store.views[k] for k in REG_KEYS)
    else:
        regs = _set_drop_rows((value_n, has_n, wa_n, ws_n, wc_n), (0,) * 5,
                              f_idx, upd, value_n.shape[0])
        value_n, has_n, wa_n, ws_n, wc_n = (
            regs[0], regs[1].bool(), regs[2], regs[3], regs[4].bool())

    slow = is_assign & ~fast
    slow_info = torch.stack([
        slow.to(I32), tslot,
        value_n[tclip], has_n[tclip].to(I32),
        wa_n[tclip], ws_n[tclip], wc_n[tclip].to(I32)])
    return value_n, has_n, wa_n, ws_n, wc_n, slow_info


def apply_residual(parent, ctr, actor, value, has_value, win_actor, win_seq,
                   win_counter, chain, op_kind, op_slot, op_new_slot, op_ctr,
                   op_actor, op_value, op_win_actor, op_win_seq,
                   conflict_slots, *, out_cap: int, store=None):
    """Place irregular inserts and run the LWW register fast path (padding
    rows: kind=-1, slots=out_cap). Returns the 9 tables + (7, M)
    slow_info. With a `store`, in place."""
    M = op_kind.shape[0]
    kind = op_kind.to(I32)
    is_ins = kind == KIND_INS
    is_assign = (kind == KIND_SET) | (kind == KIND_DEL) | (kind == KIND_INC)

    ins_idx = torch.where(is_ins, op_new_slot, out_cap)
    zeros = torch.zeros(M, dtype=I32, device=op_kind.device)
    (parent_n, ctr_n, actor_n, value_n, has_n, wa_n, ws_n, wc_n,
     chain_n) = _scatter_rows_9(
        (parent, ctr, actor, value, has_value, win_actor, win_seq,
         win_counter, chain),
        ins_idx,
        (op_slot, op_ctr, op_actor, zeros, zeros,
         torch.full_like(zeros, -1), zeros, zeros, zeros),
        out_cap, store)

    (value_n, has_n, wa_n, ws_n, wc_n, slow_info) = _register_fast_path(
        value_n, has_n, wa_n, ws_n, wc_n, kind, is_assign, op_slot,
        op_value, op_win_actor, op_win_seq, conflict_slots, out_cap, store)
    return (parent_n, ctr_n, actor_n, value_n, has_n, wa_n, ws_n, wc_n,
            chain_n, slow_info)


def _apply_residual_packed(parent, ctr, actor, value, has_value, win_actor,
                           win_seq, win_counter, chain, res, conflict_slots,
                           *, out_cap: int, store=None):
    """`apply_residual` taking the residual op columns as one packed
    (8, M) int32 matrix (row layout: RES_*)."""
    return apply_residual(
        parent, ctr, actor, value, has_value, win_actor, win_seq,
        win_counter, chain,
        res[RES_KIND], res[RES_SLOT], res[RES_NEW_SLOT],
        res[RES_CTR], res[RES_ACTOR], res[RES_VALUE], res[RES_WIN_ACTOR],
        res[RES_WIN_SEQ], conflict_slots, out_cap=out_cap, store=store)


def _ext(a: torch.Tensor, fill, out_cap: int) -> torch.Tensor:
    """`a` extended to `out_cap` with its padding fill."""
    C = a.shape[0]
    if C >= out_cap:
        return a
    return torch.cat([a, a.new_full((out_cap - C,), fill)])


def apply_map_round(value, has_value, win_actor, win_seq, win_counter,
                    op_kind, op_slot, op_value, op_win_actor, op_win_seq,
                    conflict_slots, *, out_cap: int):
    """One causally-ready round of map ops (set/del/inc on interned keys):
    `apply_residual` without inserts. Key registers are dense slots; the
    LWW fast path takes single uncontended inline-int sets, and dels,
    incs, pooled values, multi-writer rounds and occupied registers land
    in the `slow` mask for the host (padding: kind=-1, slot=out_cap).
    Returns the 5 registers + the (7, M) slow_info."""
    kind = op_kind.to(I32)
    is_assign = (kind == KIND_SET) | (kind == KIND_DEL) | (kind == KIND_INC)
    regs = [_ext(t, f, out_cap) for t, f in zip(
        (value, has_value, win_actor, win_seq, win_counter), REG_FILLS)]
    return _register_fast_path(
        *regs, kind, is_assign, op_slot, op_value, op_win_actor, op_win_seq,
        conflict_slots, out_cap)


# ---------------------------------------------------------- materialize

def _linearize_segments(parent, attach_off, ctr, actor, weight, valid):
    """Condensed-tree linearization: per-parent children ordered by
    descending (attach, ctr, actor), successor chain by pointer doubling,
    weighted list ranking. Returns each segment's start position."""
    n = parent.shape[0]
    steps = max(1, math.ceil(math.log2(max(2, n))))
    idx = _arange(n, parent)
    is_seg = valid & (idx != 0)
    big = n + 1

    sort_parent = torch.where(is_seg, parent, big)
    neg_off = torch.where(is_seg, -attach_off, big)
    neg_ctr = torch.where(is_seg, -ctr, big)
    neg_actor = torch.where(is_seg, -actor, big)
    order = _lexsort([sort_parent, neg_off, neg_ctr, neg_actor])
    p_s = sort_parent[order]
    idx_s = order.to(I32)

    in_group = p_s < big
    false1 = torch.zeros(1, dtype=torch.bool, device=parent.device)
    same_next = torch.cat([(p_s[1:] == p_s[:-1]) & in_group[1:], false1])
    next_in_sorted = torch.cat([idx_s[1:], idx_s.new_full((1,), -1)])
    next_sib = torch.full((n,), -1, dtype=I32, device=parent.device)
    next_sib[order] = torch.where(same_next, next_in_sorted, -1)

    group_start = torch.cat([~false1, p_s[1:] != p_s[:-1]]) & in_group
    first_child = _set_drop(
        torch.full((n,), -1, dtype=I32, device=parent.device),
        torch.where(group_start, p_s, big - 1),
        torch.where(group_start, idx_s, -1))

    has_next = next_sib >= 0
    safe_parent = torch.where(is_seg, parent, 0)
    anc = torch.where(has_next | (idx == 0), idx, safe_parent).long()
    for _ in range(steps):
        anc = anc[anc]

    succ = torch.where(first_child >= 0, first_child, next_sib[anc])

    nxt = torch.where(succ >= 0, succ, n)
    nxt = torch.where(is_seg | (idx == 0), nxt, idx)
    nxt = torch.cat([nxt, nxt.new_full((1,), n)]).long()
    dist = torch.where(is_seg, weight, 0).to(I32)
    dist = torch.cat([dist, dist.new_zeros(1)])
    for _ in range(steps + 1):
        dist, nxt = dist + dist[nxt], nxt[nxt]
    start = dist[0] - dist[:n]
    return torch.where(is_seg, start, torch.where(idx == 0, 0, big)).to(I32)


def _expand_S(table, sidx, live_seg, heads, C: int):
    """S-space table -> per-segment deltas at the heads' slots (C-sized,
    prefix-summed by the caller): slots of segment k read table[k]."""
    d = torch.where(sidx == 1, table, table - _prev(table))
    tgt = torch.where(live_seg, heads, C)
    return _set_drop(torch.zeros(C, dtype=table.dtype, device=table.device),
                     tgt, d)


def _codes(value, vis, vis_rank, C: int, as_u8: bool):
    tgt = torch.where(vis, vis_rank, C)
    if as_u8:
        # known-7-bit documents scatter 1-byte codes: 4x fewer bytes each way
        return _set_drop(torch.zeros(C, dtype=torch.uint8,
                                     device=value.device),
                         tgt, value.to(torch.uint8))
    return _set_drop(torch.full((C,), -1, dtype=value.dtype,
                                device=value.device), tgt, value)


def _materialize_core(parent, ctr, actor, value, has_value, chain, n_elems,
                      S, with_pos, as_u8):
    """RGA positions + visible compaction from the maintained chain bits.

    Segments (maximal chain runs, contiguous in slot space) compact into S
    nodes, the condensed tree linearizes in O(S log S), and element
    position = segment start + offset. The segment ranks and the visible
    prefix sum come from ONE `fused_segment_scans` pass (the JAX package
    ran a (2, C) cumsum here and kept the Pallas kernel for other
    callers)."""
    C = parent.shape[0]
    idx = _arange(C, parent)
    is_elem = (idx >= 1) & (idx <= n_elems)
    vis = has_value & is_elem
    rank_incl, _seg_head, cumvis = fused_segment_scans(chain, has_value,
                                                       n_elems)
    n_segs = rank_incl[-1]

    sidx = _arange(S, parent)
    heads = torch.searchsorted(rank_incl, sidx, right=False,
                               out_int32=True).clamp(0, C - 1)

    valid = sidx <= n_segs
    live_seg = valid & (sidx >= 1)
    next_head = torch.where((sidx + 1 <= n_segs) & (sidx + 1 < S),
                            _take(heads, (sidx + 1).clamp(0, S - 1)),
                            n_elems + 1)

    p_slot = _take(parent, heads)
    node_parent = _take(rank_incl, p_slot)
    attach = p_slot - _take(heads, node_parent.clamp(0, S - 1))
    nctr = _take(ctr, heads)
    nactor = _take(actor, heads)
    weight = torch.where(live_seg, next_head - heads, 0)
    starts = _linearize_segments(node_parent, attach, nctr, nactor, weight,
                                 valid)

    n_vis = cumvis[C - 1]
    head_pre = _take(cumvis, heads) - _take(vis, heads).to(I32)
    last = (next_head - 1).clamp(0, C - 1)
    seg_vis = torch.where(live_seg, _take(cumvis, last) - head_pre, 0)

    order_key = torch.where(live_seg, starts, C + 2)
    perm = torch.sort(order_key, stable=True).indices
    sv_perm = seg_vis[perm]
    base_perm = _cumsum(sv_perm) - sv_perm          # exclusive, by pos
    rank_base = torch.zeros(S, dtype=I32, device=parent.device)
    rank_base[perm] = base_perm
    seg_base = rank_base - head_pre

    if with_pos:
        d3 = torch.stack([_expand_S(seg_base, sidx, live_seg, heads, C),
                          _expand_S(starts, sidx, live_seg, heads, C),
                          _expand_S(heads, sidx, live_seg, heads, C)])
        exp = _cumsum(d3, 1)
        sb_exp, starts_exp, seg_head_exp = exp[0], exp[1], exp[2]
    else:
        sb_exp = _cumsum(_expand_S(seg_base, sidx, live_seg, heads, C))
    vis_rank = sb_exp + cumvis - vis.to(I32)

    codes = _codes(value, vis, vis_rank, C, as_u8)
    scalars = torch.stack([n_vis, n_segs])
    if with_pos:
        pos = torch.where(is_elem, starts_exp + (idx - seg_head_exp),
                          torch.where(idx == 0, -1, C + 1).to(I32))
        return pos, codes, scalars
    return codes, scalars


# Odd 32-bit mixing constants for the plan-consistency hashes (see
# `_materialize_core_planned`). engine/segments.SegmentMirror
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


def _materialize_core_planned(parent, ctr, actor, value, has_value, chain,
                              n_elems, segplan, S, with_pos, as_u8):
    """Materialization with HOST-PLANNED segment structure.

    `segplan` is the (4, S) int32 matrix of engine/segments
    SegmentMirror.plan(): [head slots, position->segment permutation,
    segment starts, meta(n_segs)]. What remains on the device is the
    visibility prefix sum, the S->slot expansion sum and the codes
    scatter, plus the plan-consistency scalars: the segment count and two
    nonlinear hashes re-derived from the REAL chain bits, which the engine
    checks against the mirror at its scalar sync."""
    C = value.shape[0]
    idx = _arange(C, value)
    is_elem = (idx >= 1) & (idx <= n_elems)
    vis = has_value & is_elem
    cumvis = _cumsum(vis.to(I32))
    n_vis = cumvis[C - 1]

    heads_raw = segplan[0]
    heads = heads_raw.clamp(0, C - 1)
    perm = segplan[1].long()
    n_segs = segplan[3, 0]
    sidx = _arange(S, value)
    live_seg = (sidx >= 1) & (sidx <= n_segs)

    next_head = torch.where((sidx + 1 <= n_segs) & (sidx + 1 < S),
                            _take(heads_raw, (sidx + 1).clamp(0, S - 1)),
                            n_elems + 1)
    head_pre = _take(cumvis, heads) - _take(vis, heads).to(I32)
    last = (next_head - 1).clamp(0, C - 1)
    seg_vis = torch.where(live_seg, _take(cumvis, last) - head_pre, 0)

    sv_perm = _take(seg_vis, perm)
    base_perm = _cumsum(sv_perm) - sv_perm
    rank_base = _set_drop(torch.zeros(S, dtype=I32, device=value.device),
                          perm, base_perm)
    seg_base = rank_base - head_pre

    if with_pos:
        starts = segplan[2]
        d3 = torch.stack([_expand_S(seg_base, sidx, live_seg, heads, C),
                          _expand_S(starts, sidx, live_seg, heads, C),
                          _expand_S(heads, sidx, live_seg, heads, C)])
        exp = _cumsum(d3, 1)
        sb_exp, starts_exp, seg_head_exp = exp[0], exp[1], exp[2]
    else:
        sb_exp = _cumsum(_expand_S(seg_base, sidx, live_seg, heads, C))
    vis_rank = sb_exp + cumvis - vis.to(I32)
    codes = _codes(value, vis, vis_rank, C, as_u8)

    seg_start = is_elem & ~chain
    n_segs_dev = seg_start.sum(dtype=I32)
    zero = torch.zeros((), dtype=torch.int64, device=value.device)
    head_hash_dev = _as_i32(torch.where(seg_start, _mix32(idx), zero).sum())
    u = lambda t: t.to(torch.int64) & _M32  # noqa: E731
    aux_key = (_mul32(u(parent), HASH_K2) + _mul32(u(ctr), HASH_K3)
               + _mul32(u(actor), HASH_K4))
    aux_hash_dev = _as_i32(torch.where(
        seg_start, _mix32(aux_key + idx.to(torch.int64)), zero).sum())
    scalars = torch.stack([n_vis, n_segs, n_segs_dev, head_hash_dev,
                           aux_hash_dev])

    if with_pos:
        pos = torch.where(is_elem, starts_exp + (idx - seg_head_exp),
                          torch.where(idx == 0, -1, C + 1).to(I32))
        return pos, codes, scalars
    return codes, scalars


def _slice_live(cols, L):
    """Restrict the element columns to the live-window bucket `L`: table
    capacity can exceed the live prefix by up to 50%, and every pass of
    the materialization scales with operand length."""
    if L is None or L >= cols[0].shape[0]:
        return cols
    return tuple(c[:L] for c in cols)


def materialize_text_planned(parent, ctr, actor, value, has_value, chain,
                             n_elems, segplan, *, S: int, as_u8: bool = False,
                             L: int = None):
    """(pos, codes, scalars) with host-planned segment structure."""
    cols = _slice_live((parent, ctr, actor, value, has_value, chain), L)
    return _materialize_core_planned(*cols, n_elems, segplan, S,
                                     with_pos=True, as_u8=as_u8)


def materialize_codes_planned(parent, ctr, actor, value, has_value, chain,
                              n_elems, segplan, *, S: int,
                              as_u8: bool = False, L: int = None):
    """(codes, scalars) with host-planned segment structure."""
    cols = _slice_live((parent, ctr, actor, value, has_value, chain), L)
    return _materialize_core_planned(*cols, n_elems, segplan, S,
                                     with_pos=False, as_u8=as_u8)


def materialize_text(parent, ctr, actor, value, has_value, chain, n_elems,
                     *, S: int, as_u8: bool = False, L: int = None):
    """Full materialization: (pos, codes, [n_vis, n_segs]). `pos` includes
    tombstones (head = -1, padding > n); `codes` is the visible values in
    list order (uint8 when `as_u8`)."""
    cols = _slice_live((parent, ctr, actor, value, has_value, chain), L)
    return _materialize_core(*cols, n_elems, S, with_pos=True, as_u8=as_u8)


def materialize_codes(parent, ctr, actor, value, has_value, chain, n_elems,
                      *, S: int, as_u8: bool = False, L: int = None):
    """Codes-only materialization for `text()`."""
    cols = _slice_live((parent, ctr, actor, value, has_value, chain), L)
    return _materialize_core(*cols, n_elems, S, with_pos=False, as_u8=as_u8)


def segment_visible_counts(has_value, n_elems, segplan, *, S: int,
                           L: int = None):
    """Per-segment VISIBLE character counts (S-sized) — the dirty-span
    feed of the incremental text pull; `segplan` is the mirror's plan."""
    hv = _slice_live((has_value,), L)[0]
    C = hv.shape[0]
    idx = _arange(C, hv)
    vis = hv & (idx >= 1) & (idx <= n_elems)
    cumvis = _cumsum(vis.to(I32))
    heads_raw = segplan[0]
    n_segs = segplan[3, 0]
    sidx = _arange(S, hv)
    live_seg = (sidx >= 1) & (sidx <= n_segs)
    heads = heads_raw.clamp(0, C - 1)
    next_head = torch.where((sidx + 1 <= n_segs) & (sidx + 1 < S),
                            _take(heads_raw, (sidx + 1).clamp(0, S - 1)),
                            n_elems + 1)
    head_pre = _take(cumvis, heads) - _take(vis, heads).to(I32)
    last = (next_head - 1).clamp(0, C - 1)
    return torch.where(live_seg, _take(cumvis, last) - head_pre, 0)


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


def scatter_registers_packed(value, has_value, win_actor, win_seq,
                             win_counter, wb, store=None):
    """`scatter_registers` with the resolved rows packed as one (6, S)
    int32 matrix (row layout: WB_*; padding rows carry an OOB slot). With
    a `store` (whose views are the registers passed), in place."""
    slots = wb[WB_SLOT]
    if store is not None:
        store.put(REG_KEYS, slots,
                  (wb[WB_VALUE], wb[WB_HAS], wb[WB_WIN_ACTOR],
                   wb[WB_WIN_SEQ], wb[WB_WIN_COUNTER]))
        return tuple(store.views[k] for k in REG_KEYS)
    return (_set_drop(value, slots, wb[WB_VALUE]),
            _set_drop(has_value, slots, wb[WB_HAS].bool()),
            _set_drop(win_actor, slots, wb[WB_WIN_ACTOR]),
            _set_drop(win_seq, slots, wb[WB_WIN_SEQ]),
            _set_drop(win_counter, slots, wb[WB_WIN_COUNTER].bool()))
