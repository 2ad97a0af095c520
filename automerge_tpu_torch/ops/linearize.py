"""RGA linearization helpers, in PyTorch.

Counterpart of `gather_spans`, `pad_capacity` and `rga_linearize` of
`automerge_tpu/ops/linearize.py`: the element-wise RGA linearization
(sibling sort, pointer doubling for the successor chain, list ranking)
and the span gather of the incremental text pull.
"""

from __future__ import annotations

import math

import torch

from .ingest import I32, _lexsort, _set_drop, _take

HEAD = 0  # index 0 is the virtual head of the list


def gather_spans(codes, spans, *, P: int):
    """Gather [start, start+len) spans of `codes` into ONE dense buffer of
    bucketed length `P` — the device half of the incremental text pull.

    `spans` is a packed (2, D) int32 matrix [starts, lens] (padding rows:
    len 0). Output element j belongs to the span whose cumulative-length
    interval contains j (zero-length padding collapses to duplicate
    ends, which a right-side search skips); positions past the live
    total return 0."""
    starts, lens = spans[0], spans[1]
    D = starts.shape[0]
    ends = torch.cumsum(lens, 0, dtype=I32)
    total = ends[D - 1]
    begins = ends - lens
    j = torch.arange(P, dtype=I32, device=codes.device)
    span_of = torch.searchsorted(ends, j, right=True,
                                 out_int32=True).clamp(0, D - 1)
    pos = _take(starts, span_of) + (j - _take(begins, span_of))
    C = codes.shape[0]
    pos = torch.where(j < total, pos, 0).clamp(0, C - 1)
    out = codes[pos.long()]
    return torch.where(j < total, out, torch.zeros((), dtype=codes.dtype,
                                                   device=codes.device))


def _doubling_steps(n: int) -> int:
    return max(1, math.ceil(math.log2(max(2, n))))


def pad_capacity(n: int, minimum: int = 16) -> int:
    """Bucket a live size to the next power of two."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def rga_linearize(parent, ctr, actor, valid):
    """RGA list positions for a padded element table.

    Index 0 is the virtual head; real elements live at 1..n-1 (padding has
    valid=False). Siblings order by descending Lamport (ctr, actor rank)
    at each insertion point. Returns pos[i], the 0-based position of
    element i in the list (tombstones included); pos[HEAD] == -1 and
    padding sorts past every live element."""
    n = parent.shape[0]
    steps = _doubling_steps(n)
    idx = torch.arange(n, dtype=I32, device=parent.device)

    is_elem = valid & (idx != HEAD)
    big = n + 1

    sort_parent = torch.where(is_elem, parent, big)
    neg_ctr = torch.where(is_elem, -ctr, big)
    neg_actor = torch.where(is_elem, -actor, big)
    order = _lexsort([sort_parent, neg_ctr, neg_actor])
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
    safe_parent = torch.where(is_elem, parent, HEAD)
    anc = torch.where(has_next | (idx == HEAD), idx, safe_parent)
    for _ in range(steps):
        anc = _take(anc, anc)

    succ = torch.where(first_child >= 0, first_child, _take(next_sib, anc))

    end = n   # virtual end-of-list sentinel
    nxt = torch.where(succ >= 0, succ, end)
    nxt = torch.where(is_elem | (idx == HEAD), nxt, idx)   # padding: self-loop
    nxt = torch.cat([nxt, nxt.new_full((1,), end)])
    dist = torch.where(is_elem | (idx == HEAD), 1, 0).to(I32)
    dist = torch.cat([dist, dist.new_zeros(1)])
    for _ in range(steps + 1):
        dist, nxt = dist + _take(dist, nxt), _take(nxt, nxt)

    # dist[i] = #chain nodes from i (inclusive) to end; head is position -1
    pos = dist[HEAD] - dist[:n] - 1
    return torch.where(is_elem, pos,
                       torch.where(idx == HEAD, -1, big)).to(I32)
