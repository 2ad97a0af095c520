"""Typing-run detection over columnar op batches.

A *run* is an INS immediately followed by its SET, chained so each next INS
continues the previous element with a consecutive counter — the shape every
text editor produces. Runs are the engine's unit of bulk transfer: ~20-byte
descriptors + a value blob instead of 2 op rows per character
(ops/fused_round.py `_fused_expand`), used by the single-doc engine
(text_doc.DeviceTextDoc).

Detection runs the vectorized numpy formulation (the port carries no
native walker).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .._common import KIND_INS, KIND_SET
from .. import obs


@dataclass
class RoundPlan:
    """Run/residual partition of one causally-ready round's op columns."""

    n_ops: int
    n_ins: int
    hpos: np.ndarray         # run-head op positions
    run_len: np.ndarray      # int64[n_runs]
    head_slot: np.ndarray    # int64[n_runs]: slot of each run's first elem
    rpos: np.ndarray         # residual op positions
    res_new_slot: np.ndarray  # int64[n_res]: slot per residual INS (-1 else)
    blob: np.ndarray         # int32[n_pairs]: run SET values, op order
    blob_lt_128: bool
    blob_lt_256: bool

    def rebase(self, delta: int) -> "RoundPlan":
        """The same partition with inserted-element slots shifted by
        ``delta``. Only `head_slot`/`res_new_slot` encode the document's
        pre-round element count (`base_elems`); everything else is a pure
        function of the op columns — which is what makes the detection
        cacheable on the (immutable) batch and reusable across documents
        of different sizes (replica fan-out or replay applying one decoded
        batch to several docs; the bench re-applies one batch per rep).
        Arrays the shift does not touch are shared, not copied: every
        downstream consumer treats the plan as read-only."""
        if delta == 0:
            return self
        return RoundPlan(
            n_ops=self.n_ops, n_ins=self.n_ins, hpos=self.hpos,
            run_len=self.run_len,
            head_slot=self.head_slot + delta,
            rpos=self.rpos,
            res_new_slot=np.where(self.res_new_slot >= 0,
                                  self.res_new_slot + delta,
                                  self.res_new_slot),
            blob=self.blob, blob_lt_128=self.blob_lt_128,
            blob_lt_256=self.blob_lt_256)

    @property
    def n_runs(self) -> int:
        return len(self.hpos)

    @property
    def n_pairs(self) -> int:
        return len(self.blob)

    @property
    def res_is_ins(self) -> np.ndarray:
        return self.res_new_slot >= 0

    @property
    def n_res_ins(self) -> int:
        return int((self.res_new_slot >= 0).sum())


def detect_runs(kind, ta, tc, pa, pc, val64, op_row, base_elems: int
                ) -> RoundPlan:
    """Partition one round's op columns into runs and residual ops.

    `base_elems` is the document's live element count before this round;
    inserted elements take slots base_elems+1.. in op order.

    Batches above `_SHARD_MIN_OPS` shard across the planning worker pool
    (engine/pipeline.planner_pool): the walk is embarrassingly parallel
    once split at change boundaries — every pair/continuation predicate
    compares adjacent ops of EQUAL change row, so no run or pair spans a
    boundary where the change row differs, and per-shard detection with a
    slot base offset by the preceding shards' insert counts concatenates
    into the exact unsharded partition (pinned bit-identical by
    tests/test_pipeline.py). The numpy passes release the GIL, so shards
    run at real parallelism on multicore hosts; one worker (AMTPU_PLAN_WORKERS=1) short-circuits to the
    single-shard path."""
    n_ops = len(kind)
    _t0 = obs.now() if obs.ENABLED else 0
    plan = None
    if n_ops >= _SHARD_MIN_OPS:
        plan = _detect_runs_sharded(kind, ta, tc, pa, pc, val64, op_row,
                                    base_elems)
    if plan is None:
        plan = _detect_runs_single(kind, ta, tc, pa, pc, val64, op_row,
                                   base_elems)
    if obs.ENABLED:
        # the cold-prepare term, span-derived
        obs.span("plan", "detect_runs", _t0, args={
            "n_ops": n_ops, "n_runs": plan.n_runs})
    return plan


def _detect_runs_single(kind, ta, tc, pa, pc, val64, op_row,
                        base_elems: int) -> RoundPlan:
    return _detect_runs_numpy(kind, ta, tc, pa, pc, val64, op_row,
                              base_elems)


_SHARD_MIN_OPS = 1 << 18     # below this, thread fan-out costs more than
                             # the walk itself


def _detect_runs_sharded(kind, ta, tc, pa, pc, val64, op_row,
                         base_elems: int):
    """Parallel shard-and-concatenate form of `_detect_runs_single`;
    None when sharding is unavailable (one worker, or no usable change
    boundary to split at)."""
    from .pipeline import plan_workers, planner_pool
    pool = planner_pool()
    if pool is None:
        return None
    w = plan_workers()
    n_ops = len(kind)
    bounds = np.flatnonzero(op_row[1:] != op_row[:-1]) + 1
    if not len(bounds):
        return None
    targets = np.arange(1, w) * (n_ops // w)
    cuts = np.unique(bounds[np.clip(
        np.searchsorted(bounds, targets), 0, len(bounds) - 1)])
    # bounds lie in [1, n_ops-1], so the endpoints stay sorted-unique
    cuts = np.concatenate(([0], cuts, [n_ops]))
    if len(cuts) < 3:
        return None

    is_ins = kind == KIND_INS
    shard_ins = np.add.reduceat(is_ins.astype(np.int64), cuts[:-1])
    shard_base = base_elems + np.concatenate(
        ([0], np.cumsum(shard_ins)[:-1]))

    def one(i):
        s, e = int(cuts[i]), int(cuts[i + 1])
        return _detect_runs_single(
            kind[s:e], ta[s:e], tc[s:e], pa[s:e], pc[s:e], val64[s:e],
            op_row[s:e], int(shard_base[i]))

    plans = list(pool.map(one, range(len(cuts) - 1)))
    offs = cuts[:-1]
    return RoundPlan(
        n_ops=n_ops,
        n_ins=int(shard_ins.sum()),
        hpos=np.concatenate([p.hpos + o for p, o in zip(plans, offs)]),
        run_len=np.concatenate([p.run_len for p in plans]),
        head_slot=np.concatenate([p.head_slot for p in plans]),
        rpos=np.concatenate([p.rpos + o for p, o in zip(plans, offs)]),
        res_new_slot=np.concatenate([p.res_new_slot for p in plans]),
        blob=np.concatenate([p.blob for p in plans]),
        blob_lt_128=all(p.blob_lt_128 for p in plans),
        blob_lt_256=all(p.blob_lt_256 for p in plans))


def _detect_runs_numpy(kind, ta, tc, pa, pc, val64, op_row,
                       base_elems: int) -> RoundPlan:
    n_ops = len(kind)
    is_ins = kind == KIND_INS
    n_ins = int(is_ins.sum())
    new_slot = np.where(is_ins, base_elems + np.cumsum(is_ins), 0)

    is_pair = np.zeros(n_ops, bool)
    if n_ops >= 2:
        is_pair[:-1] = ((kind[:-1] == KIND_INS) & (kind[1:] == KIND_SET)
                        & (op_row[1:] == op_row[:-1])
                        & (ta[1:] == ta[:-1]) & (tc[1:] == tc[:-1])
                        & (val64[1:] >= 0) & (val64[1:] < 2**31))
    cont = np.zeros(n_ops, bool)
    if n_ops >= 3:
        cont[2:] = (is_pair[2:] & is_pair[:-2]
                    & (op_row[2:] == op_row[:-2]) & (ta[2:] == ta[:-2])
                    & (tc[2:] == tc[:-2] + 1) & (pa[2:] == ta[:-2])
                    & (pc[2:] == tc[:-2]))
    run_head = is_pair & ~cont
    covered = np.zeros(n_ops, bool)
    covered[is_pair] = True
    covered[1:] |= is_pair[:-1]

    hpos = np.flatnonzero(run_head)
    pair_pos = np.flatnonzero(is_pair)
    if len(hpos):
        run_len = np.diff(np.append(
            np.searchsorted(pair_pos, hpos), len(pair_pos))).astype(np.int64)
        blob = val64[pair_pos + 1].astype(np.int32)
    else:
        run_len = np.empty(0, np.int64)
        blob = np.empty(0, np.int32)
    rpos = np.flatnonzero(~covered)
    res_new_slot = np.where(kind[rpos] == KIND_INS,
                            new_slot[rpos], -1).astype(np.int64)
    # the pair predicate guarantees 0 <= value < 2^31, so the int32 blob
    # holds the exact values — derive the flags from it directly
    return RoundPlan(
        n_ops=n_ops, n_ins=n_ins, hpos=hpos.astype(np.int64),
        run_len=run_len, head_slot=new_slot[hpos].astype(np.int64),
        rpos=rpos.astype(np.int64), res_new_slot=res_new_slot, blob=blob,
        blob_lt_128=bool((blob < 128).all()),
        blob_lt_256=bool((blob < 256).all()))
