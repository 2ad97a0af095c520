"""Fused round programs of the text and map documents, in PyTorch.

Counterpart of `automerge_tpu/ops/fused_round.py`:

- `fused_mixed_round` — one causal round of any shape: expansion,
  residual placement + register fast path, chain breaks. Absent phases
  ride padding-convention no-ops (`round_dummies`), so every round shape
  runs the same code; it is the one-document case of the stacked text
  lane's program.
- `fused_commit_round` / `fused_commit_round_planned` — the dense merge
  round end to end: expansion plus the codes-only materialization
  (self-contained, or with the host-planned segment structure).
- `fused_stacked_round` — one causal round of EVERY stacked document
  (engine/stacked.py), both lanes in one program: the map documents'
  `apply_map_round` and the text documents' mixed round over the doc
  axis (the JAX package vmaps the one-document programs; a ctypes kernel
  cannot be vmapped, so every program here is written over the doc axis
  and one document is its D = 1 case). The text lane's expansion scans
  all its documents' six channels with ONE `multi_scan` launch on
  (D * 6, N). `fused_scatter_registers` writes both lanes' host-resolved
  slow registers back.

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
    RES_KIND, RES_NEW_SLOT, RES_SLOT, I32, TEXT_TABLE_KEYS,
    _apply_residual_packed_r, _expand_columns_r, _materialize_core_planned_r,
    _materialize_core_r, _one, _row, _scatter_rows_9_r, _set_drop_r,
    _slice_live, _unpack_desc_r, apply_map_round_r, break_chains_r,
    scatter_registers_packed_r,
)


def _meta(desc, k: int):
    """META-row scalar `k` of a (9, R) descriptor, with the JAX gather's
    clamp: the one-column dummy descriptor reads column 0 (a zero)."""
    return desc[DESC_META, min(k, desc.shape[1] - 1)]


def _fused_expand_r(tables, desc, blob, *, out_cap: int, store=None):
    """Run expansion over the doc axis — (D, 9, R) descriptors, (D, N)
    blobs, (D, C) tables — plus the run-head chain breaks applied from the
    descriptor (idempotent for sparse plans: their touch matrices carry
    the same triples). The six boundary-delta channels of every row (ctr
    and slot step +1 per element; actor, win_actor, win_seq, has_value
    are piecewise constant) are ONE `multi_scan` launch on (D * 6, N);
    padding rows (a runless descriptor) write nothing. With a `store`
    (D = 1), the rows are written in place."""
    (run_head_slot, run_parent_slot, run_ctr0, run_actor, run_win_actor,
     run_win_seq, run_elem_base, run_has_value) = _unpack_desc_r(desc)
    D, R = run_head_slot.shape
    N = blob.shape[1]
    dev = desc.device
    meta = desc[:, DESC_META]
    n_run_elems = meta[:, min(META_N_ELEMS, R - 1)]
    cols = _expand_columns_r(run_ctr0, run_actor, run_win_actor,
                             run_win_seq, run_elem_base, run_has_value, N,
                             extra=run_head_slot)
    slot_col = cols[:, 1]
    j = torch.arange(N, dtype=I32, device=dev)
    live = j < n_run_elems[:, None]
    is_start = _set_drop_r(torch.zeros((D, N), dtype=torch.bool, device=dev),
                           run_elem_base, True)
    tgt = torch.where(live, slot_col, out_cap)   # sentinel drops padding
    parent_col = _set_drop_r(slot_col - 1, run_elem_base, run_parent_slot)
    has_col = (cols[:, 5] > 0) & live
    tables = _scatter_rows_9_r(
        tables, tgt,
        (parent_col, cols[:, 0], cols[:, 2], blob.to(I32), has_col,
         torch.where(has_col, cols[:, 3], -1),
         torch.where(has_col, cols[:, 4], 0),
         torch.zeros((D, N), dtype=I32, device=dev), live & ~is_start),
        out_cap, store)
    live_r = (torch.arange(R, dtype=I32, device=dev)
              < meta[:, min(META_N_RUNS, R - 1)][:, None])
    chain_n = break_chains_r(
        tables[8], tables[0], tables[1], tables[2],
        torch.where(live_r, run_parent_slot, 0),
        torch.where(live_r, run_ctr0, -1),
        torch.where(live_r, run_actor, -1), store)
    return tables[:8] + (chain_n,)


def _fused_mixed_core_r(parent, ctr, actor, value, has_value, win_actor,
                        win_seq, win_counter, chain, desc, blob, res,
                        conflict_slots, touch, *, out_cap: int, store=None):
    """The mixed round over the doc axis (stacked (D, ...) operands):
    expansion, residual placement + register fast path, chain breaks.
    Returns the 9 tables + the (D, 7, M) slow_info."""
    tables = _fused_expand_r((parent, ctr, actor, value, has_value,
                              win_actor, win_seq, win_counter, chain),
                             desc, blob, out_cap=out_cap, store=store)
    out = _apply_residual_packed_r(*tables, res, conflict_slots,
                                   out_cap=out_cap, store=store)
    tables, slow_info = out[:9], out[9]
    chain_n = break_chains_r(tables[8], tables[0], tables[1], tables[2],
                             touch[:, 0], touch[:, 1], touch[:, 2], store)
    return tables[:8] + (chain_n, slow_info)


def fused_mixed_round(parent, ctr, actor, value, has_value, win_actor,
                      win_seq, win_counter, chain, desc, blob, res,
                      conflict_slots, touch, *, out_cap: int, store=None):
    """One round of any shape of one document: every phase runs
    unconditionally over padding-convention no-ops. Returns the 9 tables +
    the (7, M) slow_info (callers skip its fetch when the round staged no
    residuals)."""
    return _one(_fused_mixed_core_r(
        *_row(parent, ctr, actor, value, has_value, win_actor, win_seq,
              win_counter, chain, desc, blob, res, conflict_slots, touch),
        out_cap=out_cap, store=store), store, TEXT_TABLE_KEYS)


def _commit_n_elems(desc):
    """The post-round element count, on the device: base_slot +
    n_run_elems - 1 from the descriptor's META row (no host upload)."""
    return _meta(desc, META_BASE_SLOT) + _meta(desc, META_N_ELEMS) - 1


def _commit_round(tables, desc, blob, segplan, out_cap, S, as_u8, L, store):
    tables = _fused_expand_r(_row(*tables), desc[None], blob[None],
                             out_cap=out_cap, store=store)
    cols = _slice_live((tables[0], tables[1], tables[2], tables[3],
                        tables[4], tables[8]), L)
    if segplan is None:
        mat = _materialize_core_r(*cols, _commit_n_elems(desc), S,
                                  with_pos=False, as_u8=as_u8)
    else:
        mat = _materialize_core_planned_r(
            *cols, _commit_n_elems(desc), segplan[None], S, with_pos=False,
            as_u8=as_u8)
    return _one(tables + mat, store, TEXT_TABLE_KEYS)


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


def fused_stacked_round(m_value, m_has, m_wa, m_ws, m_wc, m_ops, m_conflict,
                        parent, ctr, actor, value, has_value, win_actor,
                        win_seq, win_counter, chain, desc, blob, res,
                        t_conflict, touch, *, map_cap: int, text_cap: int,
                        with_map: bool, with_text: bool):
    """One causal round of every stacked document, both lanes. Map lane:
    5 stacked register tables + (D, 5, M) ops + (D, K) conflict slots;
    text lane: 9 stacked element tables + (D, 9, R) desc, (D, N) blob,
    (D, 8, M) residuals, (D, K) conflict slots, (D, 3, T) touches. An
    absent lane's operands are `_absent` placeholders. Returns the map
    lane's 5 tables + (D, 7, M) slow_info when `with_map`, then the text
    lane's 9 tables + (D, 7, M) slow_info when `with_text`."""
    out = ()
    if with_map:
        out += apply_map_round_r(m_value, m_has, m_wa, m_ws, m_wc, m_ops,
                                 m_conflict, out_cap=map_cap)
    if with_text:
        out += _fused_mixed_core_r(parent, ctr, actor, value, has_value,
                                   win_actor, win_seq, win_counter, chain,
                                   desc, blob, res, t_conflict, touch,
                                   out_cap=text_cap)
    return out


def fused_scatter_registers(m_value, m_has, m_wa, m_ws, m_wc, m_wb,
                            t_value, t_has, t_wa, t_ws, t_wc, t_wb, *,
                            with_map: bool, with_text: bool):
    """Both lanes' host-resolved slow-register writebacks, (D, 6, S) each,
    as one program. Returns the map lane's 5 registers when `with_map`,
    then the text lane's 5 when `with_text`."""
    out = ()
    if with_map:
        out += scatter_registers_packed_r(m_value, m_has, m_wa, m_ws, m_wc,
                                          m_wb)
    if with_text:
        out += scatter_registers_packed_r(t_value, t_has, t_wa, t_ws, t_wc,
                                          t_wb)
    return out


_ABSENT: dict = {}


def _absent(device):
    """The shared placeholder for a dead lane's operands of
    `fused_stacked_round` / `fused_scatter_registers` (one cached (1, 1)
    int32 per device; the lane's flag keeps it unread)."""
    device = torch.device(device)
    t = _ABSENT.get(str(device))
    if t is None:
        t = _ABSENT[str(device)] = torch.zeros((1, 1), dtype=I32,
                                               device=device)
    return t


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
