"""RGA linearization helpers, in PyTorch.

Counterpart of `pad_capacity`, `rga_linearize`, `stacked_linearize` and
`rga_linearize_segments` of `automerge_tpu/ops/linearize.py`: the
element-wise RGA linearization (sibling sort, pointer doubling for the
successor chain, list ranking) of one document or of stacked (D, n) rows,
and the same over a condensed tree of chain segments.
"""

from __future__ import annotations

import math

import torch

from .ingest import I32, _lexsort_r, _row, _set_drop_r, _take_r

HEAD = 0  # index 0 is the virtual head of the list


def _doubling_steps(n: int) -> int:
    return max(1, math.ceil(math.log2(max(2, n))))


def pad_capacity(n: int, minimum: int = 16) -> int:
    """Bucket a live size to the next power of two."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def rga_linearize(parent, ctr, actor, valid):
    """RGA list positions for a padded element table: `_rga_linearize_r`
    of one document.

    Index 0 is the virtual head; real elements live at 1..n-1 (padding has
    valid=False). Siblings order by descending Lamport (ctr, actor rank)
    at each insertion point. Returns pos[i], the 0-based position of
    element i in the list (tombstones included); pos[HEAD] == -1 and
    padding sorts past every live element."""
    return _rga_linearize_r(*_row(parent, ctr, actor, valid))[0]


def stacked_linearize(parent, ctr, actor, n_elems):
    """`rga_linearize` over the doc axis: every stacked document's RGA
    positions from its (D, w) element tables in one program; `n_elems` is
    the (D,) live count (slots 1..n_elems[d] valid). The stacked executor
    (engine/stacked.py `_finalize`) ships the result inside its one
    packed mirror fetch."""
    idx = torch.arange(parent.shape[1], dtype=I32, device=parent.device)
    return _rga_linearize_r(parent, ctr, actor, idx <= n_elems[:, None])


def _rga_linearize_r(parent, ctr, actor, valid):
    """`rga_linearize` of (D, n) rows, each on its own: sibling sort,
    pointer doubling for the successor chain, list ranking, every gather
    and scatter row-wise."""
    D, n = parent.shape
    dev = parent.device
    steps = _doubling_steps(n)
    idx = torch.arange(n, dtype=I32, device=dev)

    is_elem = valid & (idx != HEAD)
    big = n + 1

    sort_parent = torch.where(is_elem, parent, big)
    neg_ctr = torch.where(is_elem, -ctr, big)
    neg_actor = torch.where(is_elem, -actor, big)
    order = _lexsort_r([sort_parent, neg_ctr, neg_actor])
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
    safe_parent = torch.where(is_elem, parent, HEAD)
    anc = torch.where(has_next | (idx == HEAD), idx, safe_parent)
    for _ in range(steps):
        anc = _take_r(anc, anc)

    succ = torch.where(first_child >= 0, first_child, _take_r(next_sib, anc))

    end = n   # virtual end-of-list sentinel
    nxt = torch.where(succ >= 0, succ, end)
    nxt = torch.where(is_elem | (idx == HEAD), nxt, idx)   # padding: self-loop
    nxt = torch.cat([nxt, nxt.new_full((D, 1), end)], 1)
    dist = torch.where(is_elem | (idx == HEAD), 1, 0).to(I32)
    dist = torch.cat([dist, dist.new_zeros((D, 1))], 1)
    for _ in range(steps + 1):
        dist, nxt = dist + _take_r(dist, nxt), _take_r(nxt, nxt)

    # dist[i] = #chain nodes from i (inclusive) to end; head is position -1
    pos = dist[:, :1] - dist[:, :n] - 1
    return torch.where(is_elem, pos,
                       torch.where(idx == HEAD, -1, big)).to(I32)


def rga_linearize_segments(parent, attach_off, ctr, actor, weight, valid):
    """Linearize a *condensed* RGA tree of chain segments: each node is a
    typing run (a chain whose every element is its parent's maximal
    child), so an element's position is its segment's start plus its
    offset in the segment.

    `parent[i]` is the segment whose element this segment's head was
    inserted after, `attach_off` that element's offset in the parent
    segment, `ctr`/`actor` the head's Lamport key, `weight` the segment's
    length; index 0 is the virtual head and padding has valid=False.
    Children order by (-attach_off, -ctr, -actor). Returns start[i], the
    0-based position of segment i's first element (0 for the head,
    n + 1 for padding). No engine path calls it; it runs on whatever
    device its tensors are on."""
    return _rga_linearize_segments_r(
        *_row(parent, attach_off, ctr, actor, weight, valid))[0]


def _rga_linearize_segments_r(parent, attach_off, ctr, actor, weight,
                              valid):
    """`rga_linearize_segments` of (D, n) rows, each on its own: the 4-key
    sibling sort, the successor chain by pointer doubling and a weighted
    list ranking."""
    D, n = parent.shape
    dev = parent.device
    steps = _doubling_steps(n)
    idx = torch.arange(n, dtype=I32, device=dev)

    is_seg = valid & (idx != HEAD)
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
    safe_parent = torch.where(is_seg, parent, HEAD)
    anc = torch.where(has_next | (idx == HEAD), idx, safe_parent)
    for _ in range(steps):
        anc = _take_r(anc, anc)

    succ = torch.where(first_child >= 0, first_child, _take_r(next_sib, anc))

    end = n   # virtual end-of-list sentinel
    nxt = torch.where(succ >= 0, succ, end)
    nxt = torch.where(is_seg | (idx == HEAD), nxt, idx)   # padding: self-loop
    nxt = torch.cat([nxt, nxt.new_full((D, 1), end)], 1)
    dist = torch.where(is_seg, weight, 0).to(I32)
    dist = torch.cat([dist, dist.new_zeros((D, 1))], 1)
    for _ in range(steps + 1):
        dist, nxt = dist + _take_r(dist, nxt), _take_r(nxt, nxt)

    # dist[i] = total weight from segment i (inclusive) to the end
    start = dist[:, :1] - dist[:, :n]
    return torch.where(is_seg, start,
                       torch.where(idx == HEAD, 0, big)).to(I32)
