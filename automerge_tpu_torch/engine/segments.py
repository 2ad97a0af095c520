"""Host mirror of the device chain/segment structure + planned linearization.

The condensed materialization (`ops/ingest.py:_materialize_core`) spends its
structural stage — segment-head discovery, the (parent, attach, ctr, actor)
children sort, and the pointer-doubling linearization — recomputing facts the
host fully determined when it planned the round: every segment head is either
a run head, a residual insert, or a chain break at a planned parent, all of
which `DeviceTextDoc._plan_round` computes before anything is staged. This
module keeps that structure on the host:

- `SegmentMirror` tracks, per segment, the head slot, the head's parent slot,
  and the head's Lamport key — exactly the device chain-bit structure
  (`is_elem & ~chain`), maintained functionally per round so multi-round
  prepared plans can thread it through their planning shadow.
- `plan()` linearizes the condensed tree in numpy (same algorithm as the
  device kernel: per-parent children descending by (attach, ctr, actor),
  successor chain, weighted pointer-doubling ranking) and packs the result
  into one (4, S) int32 `segplan` matrix the planned materialize kernels
  (`ops/ingest.py:_materialize_core_planned`) consume. The device then does
  no sort and no pointer doubling at all — only the two data-dependent
  prefix sums (visibility, expansion) and the codes scatter remain.

Segment counts are ~#concurrent-insertion-points (thousands), orders of
magnitude below element counts (millions), so the numpy stage is sub-ms and
rides the *untimed* prepare phase; it removes the S-stage (~20 ms at
headline-bench scale, docs/PROFILE_r3.md) from the merge critical path.

The mirror replaces recomputation, not trust: the planned kernel re-derives,
from the real chain bits, the segment count plus two nonlinearly-mixed
hashes — one over the head slots, one over the heads' (parent, ctr, actor)
columns, i.e. every input that determines the linearization order — and the
engine verifies all three at its existing scalar sync. On any mismatch the
mirror is REBUILT from the real chain bits (`SegmentMirror.rebuild`) and
the affected read re-materializes through the self-contained kernel; only
a failed rebuild degrades the document to the self-contained path for good
(`DeviceTextDoc._scalars`, `DeviceTextDocSet.texts`).

Reference semantics being mirrored: RGA sibling order, descending Lamport
per insertion point (reference backend/op_set.js:440-489); the chain
bits' incremental maintenance is ops/ingest.py:_break_chains_core.
"""

from __future__ import annotations

import math

import numpy as np

SEGPLAN_HEADS, SEGPLAN_PERM, SEGPLAN_STARTS, SEGPLAN_META = range(4)


def _linearize_np(pnode: np.ndarray, attach: np.ndarray, ctr: np.ndarray,
                  actor: np.ndarray, weight: np.ndarray) -> np.ndarray:
    """Numpy twin of the device `_linearize_segments` for n = n_segs+1 nodes
    (node 0 is the virtual head). Returns each segment's start position."""
    n = len(pnode)
    if n <= 1:
        return np.zeros(n, np.int64)
    idx = np.arange(n)
    is_seg = idx != 0
    big = n + 1
    sp = np.where(is_seg, pnode, big)
    # lexsort: last key primary -> (parent asc, attach desc, ctr desc,
    # actor desc); full ties impossible ((ctr, actor) is the unique elemId)
    order = np.lexsort((-actor, -ctr, -attach, sp))
    p_s = sp[order]
    in_group = p_s < big

    same_next = np.zeros(n, bool)
    same_next[:-1] = (p_s[1:] == p_s[:-1]) & in_group[1:]
    nxt_sorted = np.empty(n, np.int64)
    nxt_sorted[:-1] = order[1:]
    nxt_sorted[-1] = -1
    next_sib = np.full(n, -1, np.int64)
    next_sib[order] = np.where(same_next, nxt_sorted, -1)

    group_start = np.zeros(n, bool)
    group_start[0] = True
    group_start[1:] = p_s[1:] != p_s[:-1]
    group_start &= in_group
    first_child = np.full(n, -1, np.int64)
    first_child[p_s[group_start]] = order[group_start]

    steps = max(1, math.ceil(math.log2(max(2, n))))
    has_next = next_sib >= 0
    anc = np.where(has_next | (idx == 0), idx, pnode)
    for _ in range(steps):
        anc = anc[anc]
    succ = np.where(first_child >= 0, first_child, next_sib[anc])

    nxt = np.append(np.where(succ >= 0, succ, n), n)
    dist = np.append(np.where(is_seg, weight, 0).astype(np.int64), 0)
    for _ in range(steps + 1):
        dist = dist + dist[nxt]
        nxt = nxt[nxt]
    starts = dist[0] - dist[:n]
    starts[0] = 0
    return starts


class SegmentMirror:
    """Per-segment host state, aligned arrays sorted by head slot.

    Index 0 is the virtual-head pseudo-segment (slot 0); real segments are
    1..n_segs in slot order — the same numbering the device derives from
    `cumsum(is_elem & ~chain)`.
    """

    __slots__ = ("heads", "par", "hctr", "hactor")

    def __init__(self, heads, par, hctr, hactor):
        self.heads = heads    # int64[n_segs+1], sorted, heads[0] == 0
        self.par = par        # parent SLOT of each head (par[0] == 0)
        self.hctr = hctr      # head elemId counter (0 for node 0)
        self.hactor = hactor  # head elemId actor rank (0 for node 0)

    @classmethod
    def empty(cls) -> "SegmentMirror":
        z = np.zeros(1, np.int64)
        return cls(z, z.copy(), z.copy(), z.copy())

    @classmethod
    def rebuild(cls, chain: np.ndarray, parent: np.ndarray, n_elems: int,
                rev) -> "SegmentMirror":
        """Reconstruct the mirror from fetched device columns — the heal
        path after a divergence: heads are the chain-clear live slots,
        parents come from the parent column, and the heads' Lamport keys
        resolve through the range index (`rev(slots) -> (actor, ctr)`)."""
        heads = 1 + np.flatnonzero(~chain[1: n_elems + 1]).astype(np.int64)
        par = parent[heads].astype(np.int64)
        if len(heads):
            hactor, hctr = rev(heads)
        else:
            hactor = hctr = np.empty(0, np.int64)
        z = np.zeros(1, np.int64)
        return cls(np.concatenate([z, heads]), np.concatenate([z, par]),
                   np.concatenate([z, hctr]), np.concatenate([z, hactor]))

    @property
    def n_segs(self) -> int:
        return len(self.heads) - 1

    def copy(self) -> "SegmentMirror":
        """Independent copy — required wherever one mirror value could be
        shared across documents (the per-batch mirror cache,
        engine/text_doc.py), because `remap_actors` mutates in place."""
        return SegmentMirror(self.heads.copy(), self.par.copy(),
                             self.hctr.copy(), self.hactor.copy())

    def head_checksum(self) -> int:
        """Wrapping sum of a NONLINEAR 32-bit mix of each live head slot —
        the host twin of the device-side reduce the planned kernel derives
        from the chain bits (ops/ingest._mix32). The nonlinearity matters:
        a plain (or multiplicative — still linear) sum passes head-set
        swaps like {3,5} vs {2,6}; the mixed sum does not."""
        from ..ops.ingest import mix32_np
        h = mix32_np(self.heads[1:])
        return int(np.int32(np.uint32(h.sum(dtype=np.uint32))))

    def aux_checksum(self) -> int:
        """Wrapping mixed sum over each head's (parent slot, ctr, actor) —
        the columns that fully determine the linearization order, which the
        count + head hash alone never verify. Host twin of the device
        reduce over the parent/ctr/actor columns at seg-start slots
        (ops/ingest.HASH_K2..K4 + _mix32)."""
        from ..ops.ingest import HASH_K2, HASH_K3, HASH_K4, mix32_np
        key = (self.par[1:].astype(np.uint32) * HASH_K2
               + self.hctr[1:].astype(np.uint32) * HASH_K3
               + self.hactor[1:].astype(np.uint32) * HASH_K4)
        h = mix32_np(key + self.heads[1:].astype(np.uint32))
        return int(np.int32(np.uint32(h.sum(dtype=np.uint32))))

    def remap_actors(self, remap: np.ndarray) -> None:
        self.hactor = remap.astype(np.int64)[self.hactor]
        self.hactor[0] = 0

    def apply_round(self, ins_slot, ins_par, ins_ctr, ins_actor,
                    n_elems_after: int, rev) -> "SegmentMirror":
        """New mirror after one planned round.

        `ins_*`: every element inserted with its chain bit CLEAR — run heads
        and residual inserts — with parent slot and Lamport key; exactly the
        rows the round stages as chain-touch/break inputs. `rev(slots) ->
        (actor_rank, ctr)` resolves slots against the post-round element
        index. Chain breaks mirror `_break_chains_core`: slot p+1 loses its
        chain bit when a new child of p Lamport-exceeds it."""
        ins_slot = np.asarray(ins_slot, np.int64)
        ins_par = np.asarray(ins_par, np.int64)
        ins_ctr = np.asarray(ins_ctr, np.int64)
        ins_actor = np.asarray(ins_actor, np.int64)

        q = ins_par + 1
        cand = (ins_par >= 1) & (q <= n_elems_after)
        if cand.any():
            qc = q[cand]
            # q is a chain continuation iff it is not a head already (old or
            # minted this round) — every non-head live slot has chain set
            pos = np.searchsorted(self.heads, qc)
            in_old = (pos < len(self.heads)) & (self.heads[
                np.clip(pos, 0, len(self.heads) - 1)] == qc)
            in_new = np.isin(qc, ins_slot)
            chainq = ~in_old & ~in_new
            if chainq.any():
                qq = qc[chainq]
                c_ctr = ins_ctr[cand][chainq]
                c_act = ins_actor[cand][chainq]
                qa, qr = rev(qq)
                brk = (c_ctr > qr) | ((c_ctr == qr) & (c_act > qa))
                bq = np.unique(qq[brk])
            else:
                bq = np.empty(0, np.int64)
        else:
            bq = np.empty(0, np.int64)

        new_heads = [self.heads, ins_slot]
        new_par = [self.par, ins_par]
        new_ctr = [self.hctr, ins_ctr]
        new_act = [self.hactor, ins_actor]
        if len(bq):
            ba, bc = rev(bq)
            new_heads.append(bq)
            new_par.append(bq - 1)   # a chain continuation's parent slot
            new_ctr.append(bc)
            new_act.append(ba)
        heads = np.concatenate(new_heads)
        order = np.argsort(heads, kind="stable")
        return SegmentMirror(
            heads[order],
            np.concatenate(new_par)[order],
            np.concatenate(new_ctr)[order],
            np.concatenate(new_act)[order])

    def plan(self, S: int, n_elems: int) -> np.ndarray:
        """Linearize and pack the (4, S) int32 segplan matrix: rows
        [head slots, position->segment permutation, segment starts, meta]
        with meta[0] = n_segs. Requires S >= n_segs + 2."""
        n = len(self.heads)
        n_segs = n - 1
        if n_segs + 2 > S:
            raise ValueError(f"segplan bucket S={S} < n_segs+2={n_segs + 2}")
        heads = self.heads
        w = np.zeros(n, np.int64)
        if n_segs:
            w[1:-1] = heads[2:] - heads[1:-1]
            w[-1] = n_elems + 1 - heads[-1]
        pnode = np.searchsorted(heads, self.par, side="right") - 1
        attach = self.par - heads[pnode]
        starts = _linearize_np(pnode, attach, self.hctr, self.hactor, w)

        segplan = np.zeros((4, S), np.int32)
        segplan[SEGPLAN_HEADS, :n] = heads
        segplan[SEGPLAN_PERM, :n_segs] = (
            np.argsort(starts[1:], kind="stable") + 1)
        segplan[SEGPLAN_PERM, n_segs] = 0
        segplan[SEGPLAN_PERM, n:] = np.arange(n, S, dtype=np.int32)
        segplan[SEGPLAN_STARTS, :n] = starts
        segplan[SEGPLAN_META, 0] = n_segs
        return segplan
