"""Fused round programs of the solo text document, in PyTorch.

Counterpart of the solo tier of `automerge_tpu/ops/fused_round.py`:

- `fused_mixed_round` — one causal round of any shape: expansion,
  residual placement + register fast path, chain breaks. Absent phases
  ride padding-convention no-ops (`round_dummies`), so every round shape
  runs the same code.
- `fused_commit_round` / `fused_commit_round_planned` — the dense merge
  round end to end: expansion plus the codes-only materialization
  (self-contained, or with the host-planned segment structure).

Given `store=` (a `TableStore`, ops/ingest.py, whose views are the tables
passed), each program writes the round into the live tables' storage: the
port's form of the JAX package's `*_donated` twins (fused_round.py:179,
:206, :231 there). The results equal the out-of-place forms' bit for bit.

The expansion's (6, N) boundary-delta prefix sum runs through the
`multi_scan` kernel (ops/scan_kernels.py) on a CUDA tensor and its plain
version on a CPU tensor; there is no other switch.
"""

from __future__ import annotations

import numpy as np
import torch

from .ingest import (
    DESC_ELEM_BASE, DESC_META, META_BASE_SLOT, META_N_ELEMS, META_N_RUNS,
    RES_KIND, RES_NEW_SLOT, RES_SLOT, I32,
    _apply_residual_packed, _break_chains_core, _break_chains_packed,
    _materialize_core, _materialize_core_planned, _prev, _scatter_rows_9,
    _set_drop, _slice_live, _unpack_desc,
)
from .scan_kernels import multi_scan


def _meta(desc, k: int):
    """META-row scalar `k` of a (9, R) descriptor, with the JAX gather's
    clamp: the one-column dummy descriptor reads column 0 (a zero)."""
    return desc[DESC_META, min(k, desc.shape[1] - 1)]


def _fused_expand(tables, desc, blob, *, out_cap: int, store=None):
    """Run expansion with the (6, N) column prefix sum on `multi_scan`,
    plus the run-head chain breaks applied from the descriptor (idempotent
    for sparse plans — their touch matrices carry the same triples). With
    a `store`, the rows are written in place.

    Every per-element column is piecewise affine over runs (constant or +1
    per element), so the columns come from boundary deltas at each run's
    first element and one shared prefix sum — no per-element gathers."""
    (run_head_slot, run_parent_slot, run_ctr0, run_actor, run_win_actor,
     run_win_seq, run_elem_base, run_has_value) = _unpack_desc(desc)
    n_run_elems = _meta(desc, META_N_ELEMS)
    R = run_head_slot.shape[0]
    N = blob.shape[0]
    dev = desc.device

    run_len_prev = run_elem_base - _prev(run_elem_base)
    first = torch.arange(R, dtype=I32, device=dev) == 0
    d_ctr = torch.where(first, run_ctr0,
                        run_ctr0 - (_prev(run_ctr0) + run_len_prev - 1))
    d_slot = torch.where(first, run_head_slot,
                         run_head_slot
                         - (_prev(run_head_slot) + run_len_prev - 1))
    wa_v = torch.where(run_has_value, run_win_actor, -1)
    ws_v = torch.where(run_has_value, run_win_seq, 0)
    has_v = run_has_value.to(I32)
    d_actor = torch.where(first, run_actor, run_actor - _prev(run_actor))
    d_wa = torch.where(first, wa_v, wa_v - _prev(wa_v))
    d_ws = torch.where(first, ws_v, ws_v - _prev(ws_v))
    d_has = torch.where(first, has_v, has_v - _prev(has_v))

    # (6, N), the layout multi_scan reads: channels 0/1 (ctr, slot) step
    # +1 per element, the rest are piecewise constant. A run's first
    # element takes its delta in place of the step; live run starts are
    # distinct, so that is one add of (delta - step) per column. Padding
    # runs (elem_base == N) add zero at a clamped column instead.
    step = (torch.arange(6, device=dev) < 2).to(I32)   # [1, 1, 0, 0, 0, 0]
    deltas = step[:, None].expand(6, N).contiguous()
    upd = torch.stack([d_ctr, d_slot, d_actor, d_wa, d_ws, d_has]) \
        - step[:, None]
    upd = torch.where(run_elem_base < N, upd, 0)
    deltas.index_add_(1, run_elem_base.clamp(0, N - 1), upd)
    cols = multi_scan(deltas)
    ctr_col, slot_col = cols[0], cols[1]

    j = torch.arange(N, dtype=I32, device=dev)
    live = j < n_run_elems
    is_start = _set_drop(torch.zeros(N, dtype=torch.bool, device=dev),
                         run_elem_base, True)
    tgt = torch.where(live, slot_col, out_cap)   # sentinel drops padding
    parent_col = _set_drop(slot_col - 1, run_elem_base, run_parent_slot)
    has_col = (cols[5] > 0) & live

    tables = _scatter_rows_9(
        tables, tgt,
        (parent_col, ctr_col, cols[2], blob.to(I32), has_col,
         torch.where(has_col, cols[3], -1), torch.where(has_col, cols[4], 0),
         torch.zeros(N, dtype=I32, device=dev), live & ~is_start),
        out_cap, store)

    n_runs = _meta(desc, META_N_RUNS)
    live_r = torch.arange(R, dtype=I32, device=dev) < n_runs
    chain_n = _break_chains_core(
        tables[8], tables[0], tables[1], tables[2],
        torch.where(live_r, run_parent_slot, 0),
        torch.where(live_r, run_ctr0, -1),
        torch.where(live_r, run_actor, -1), store)
    return tables[:8] + (chain_n,)


def fused_mixed_round(parent, ctr, actor, value, has_value, win_actor,
                      win_seq, win_counter, chain, desc, blob, res,
                      conflict_slots, touch, *, out_cap: int, store=None):
    """One round of any shape: every phase runs unconditionally over
    padding-convention no-ops. Returns the 9 tables + the (7, M)
    slow_info (callers skip its fetch when the round staged no
    residuals)."""
    tables = (parent, ctr, actor, value, has_value, win_actor, win_seq,
              win_counter, chain)
    tables = _fused_expand(tables, desc, blob, out_cap=out_cap, store=store)
    out = _apply_residual_packed(*tables, res, conflict_slots,
                                 out_cap=out_cap, store=store)
    tables, slow_info = out[:9], out[9]
    tables = tables[:8] + (_break_chains_packed(
        tables[8], tables[0], tables[1], tables[2], touch, store),)
    return tables + (slow_info,)


def _commit_n_elems(desc):
    """The post-round element count, on the device: base_slot +
    n_run_elems - 1 from the descriptor's META row (no host upload)."""
    return _meta(desc, META_BASE_SLOT) + _meta(desc, META_N_ELEMS) - 1


def _commit_round(tables, desc, blob, segplan, out_cap, S, as_u8, L, store):
    tables = _fused_expand(tables, desc, blob, out_cap=out_cap, store=store)
    cols = _slice_live((tables[0], tables[1], tables[2], tables[3],
                        tables[4], tables[8]), L)
    if segplan is None:
        codes, scalars = _materialize_core(
            *cols, _commit_n_elems(desc), S, with_pos=False, as_u8=as_u8)
    else:
        codes, scalars = _materialize_core_planned(
            *cols, _commit_n_elems(desc), segplan, S, with_pos=False,
            as_u8=as_u8)
    return tables + (codes, scalars)


def fused_commit_round(parent, ctr, actor, value, has_value, win_actor,
                       win_seq, win_counter, chain, desc, blob, *,
                       out_cap: int, S: int, as_u8: bool, L: int,
                       store=None):
    """The dense merge round end to end: expansion + the self-contained
    codes-only materialization. Returns the 9 tables + (codes, scalars)."""
    return _commit_round((parent, ctr, actor, value, has_value, win_actor,
                          win_seq, win_counter, chain), desc, blob, None,
                         out_cap, S, as_u8, L, store)


def fused_commit_round_planned(parent, ctr, actor, value, has_value,
                               win_actor, win_seq, win_counter, chain, desc,
                               blob, segplan, *, out_cap: int, S: int,
                               as_u8: bool, L: int, store=None):
    """`fused_commit_round` with the materialization's segment structure
    staged from the host plan (no device sort, no pointer doubling)."""
    return _commit_round((parent, ctr, actor, value, has_value, win_actor,
                          win_seq, win_counter, chain), desc, blob, segplan,
                         out_cap, S, as_u8, L, store)


_DUMMIES: dict = {}


def round_dummies(out_cap: int, device):
    """Cached no-op operands for the phases a solo round did not stage:
    (desc, blob, res, conflict_slots, touch). Each follows the padding
    convention its phase treats as absent — a runless descriptor with
    the elem_base sentinel, kind=-1/slot=out_cap residual rows, an
    all-out_cap conflict vector, p_slot=0 touch rows."""
    device = torch.device(device)
    key = (out_cap, str(device))
    d = _DUMMIES.get(key)
    if d is None:
        desc = np.zeros((9, 1), np.int32)
        desc[DESC_ELEM_BASE, 0] = 1       # == blob length: padding sentinel
        res = np.zeros((8, 1), np.int32)
        res[RES_KIND] = -1
        res[RES_SLOT] = out_cap
        res[RES_NEW_SLOT] = out_cap
        d = (torch.from_numpy(desc).to(device),
             torch.zeros(1, dtype=I32, device=device),
             torch.from_numpy(res).to(device),
             torch.full((1,), out_cap, dtype=I32, device=device),
             torch.zeros((3, 1), dtype=I32, device=device))
        _DUMMIES[key] = d
    return d
