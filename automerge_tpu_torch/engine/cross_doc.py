"""Cross-doc columnar planning: one planning pass per lane per round.

The PyTorch port's copy of `automerge_tpu/engine/cross_doc.py` (host
code: numpy only), with the default path alone.

A stacked apply (engine/stacked.py) often delivers one SMALL batch PER
DOC per round, and the whole touched population carries the SAME wire
shape. Every pure-function-of-batch planning fact — run detection over
the op columns, the dep-closure admission partition, packed head keys,
the (9, R) descriptor template — is then derived once per population
instead of once per document:

- batches group by a content digest of their planning columns (op
  columns + per-change metadata; the obj id deliberately excluded — it
  names the target, it does not change the plan);
- per group, ONE shared `ColumnarChangeBatch` companion, ONE run
  detection (`runs.detect_runs` at base 0, rebased per doc by the
  `RoundPlan.rebase` contract), and ONE admission template per distinct
  clock projection (the only per-doc input admission reads);
- the shared plan JOINS to per-doc state by a vectorized rank lookup of
  the group's actor table in each distinct doc interning table (rank
  order == lex order, so the doc table is presorted), seeding every
  doc's batch rank cache — packed head keys, parent prehashes, and the
  descriptor template included — once per distinct interning table.

Everything downstream is unchanged: `_plan_round` consumes the seeded
caches through its existing fast paths, and the bulk index merge and
parent resolution (genuinely per-doc state) stay per doc.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .. import obs
from . import learned_index
from .base import _GroupedRound
from .runs import detect_runs
from .wire_columns import change_columns

__all__ = ["preplan", "plan_signature"]


def plan_signature(batch):
    """Content digest of a batch's PLANNING columns, cached on the batch.

    Covers everything admission + run planning read — per-change actors,
    seqs, dep contents, the batch actor table, and all seven op columns —
    and nothing they do not (obj id, messages). Two batches with equal
    signatures produce identical schedules and run partitions against
    equal doc state by construction. None = out of scope (pooled rich
    values, whose planning reads per-batch pool state)."""
    sig = getattr(batch, "_plan_sig", None)
    if sig is not None:
        return sig if sig != () else None
    if getattr(batch, "value_pool", None):
        try:
            batch._plan_sig = ()
        except AttributeError:
            pass
        return None
    h = hashlib.sha1()
    for col in (batch.op_kind, batch.op_target_actor, batch.op_target_ctr,
                batch.op_parent_actor, batch.op_parent_ctr, batch.op_value,
                batch.op_change, np.asarray(batch.seqs)):
        h.update(np.ascontiguousarray(col))
    h.update("\0".join(batch.actors).encode())
    h.update("\0".join(batch.actor_table).encode())
    for d in batch.deps:
        h.update(repr(sorted(d.items())).encode())
    sig = (batch.n_changes, batch.n_ops, h.digest())
    try:
        batch._plan_sig = sig
    except AttributeError:
        pass
    return sig


class _Group:
    """One planning group: docs whose batches carry identical planning
    columns this apply."""

    __slots__ = ("members", "cols", "run_plan", "sched", "row_table_idx",
                 "batch_table")

    def __init__(self):
        self.members = []        # [(doc, batch)]
        self.cols = None         # shared ColumnarChangeBatch companion
        self.run_plan = None     # (0, RoundPlan) full-batch detection
        self.sched = {}          # clock projection -> (rounds tmpl, queue)
        self.row_table_idx = None  # change row -> batch actor-table pos
        self.batch_table = None  # object ndarray of the batch actor table


def _table_positions(doc, batch_table):
    """Positions of the batch's actors in the doc's sorted actor table, or
    None when one is missing. The doc's packed position model answers
    when the table packs and the "cross_doc_seed" site is not demoted
    (engine/learned_index.py), a searchsorted over the object table
    otherwise; both are exact."""
    table = doc.actor_table
    model = learned_index.doc_actor_model(doc, "cross_doc_seed")
    got = (learned_index.actor_positions(table, batch_table,
                                         "cross_doc_seed", model)
           if model is not None else None)
    if got is not None:
        pos, found = got
        return pos.astype(np.int64) if found.all() else None
    tbl = np.asarray(table, object)
    pos = np.searchsorted(tbl, batch_table)
    safe = np.clip(pos, 0, len(tbl) - 1)
    if not (tbl[safe] == batch_table).all():
        return None
    return pos.astype(np.int64)


class CrossDocPlan:
    """The shared planning state of one stacked apply (one lane round)."""

    def __init__(self):
        self.groups = []
        self._by_batch = {}      # id(batch) -> _Group
        self.stats = {"groups": 0, "docs": 0, "sched_shared": 0,
                      "sched_templated": 0, "detect_shared": 0,
                      "rank_seeded": 0}

    # -- admission -------------------------------------------------------

    def schedule(self, doc, batch):
        """The admission result for (doc, batch) — from the group's
        template when this clock projection was already scheduled, from
        one real `_schedule` run (which then seeds the template)
        otherwise. None = not in a group; caller falls back to
        `doc._schedule`."""
        g = self._by_batch.get(id(batch))
        if g is None or doc.queue:
            return None
        ckey = tuple(doc.clock.get(a, 0) for a in g.cols.local_actors)
        tmpl = g.sched.get(ckey)
        if tmpl is not None:
            self.stats["sched_shared"] += 1
            rounds = [_GroupedRound([(batch, rows, mask)])
                      for rows, mask in tmpl[0]]
            queue_after = [(batch, r) for r in tmpl[1]]
            return rounds, queue_after, []
        out = doc._schedule(batch)
        rounds, queue_after, _prior = out
        # template-ize: every round/queue item must reference THIS batch
        # alone (guaranteed with an empty prior queue; defensive check)
        t_rounds = []
        ok = True
        for r in rounds:
            groups = doc._group_round(r)
            if len(groups) != 1 or groups[0][0] is not batch:
                ok = False
                break
            t_rounds.append((groups[0][1], groups[0][2]))
        qrows = []
        if ok:
            for it in queue_after:
                if it[0] is not batch:
                    ok = False
                    break
                qrows.append(int(it[1]))
        if ok:
            g.sched[ckey] = (t_rounds, qrows)
            self.stats["sched_templated"] += 1
        return out

    # -- rank seeding (the vectorized per-doc join) ----------------------

    def seed_ranks(self):
        """Join the shared plans to per-doc state: one vectorized rank
        lookup per DISTINCT interning table per group, seeding every
        member doc's batch rank cache — packed head keys, parent
        prehashes and the descriptor template included — so `_plan_round`
        runs its cached fast path for the whole population. Must run
        AFTER actor interning covered every batch (the stacked apply's
        hoisted interning pass)."""
        from .text_doc import build_desc_template, run_head_fields
        from ..ops.ingest import bucket

        _t0 = obs.now() if obs.ENABLED else 0
        for g in self.groups:
            _doc0, b0 = g.members[0]
            plan0 = g.run_plan[1] if g.run_plan is not None else None
            by_table = {}
            for doc, b in g.members:
                tkey = tuple(doc.actor_table)
                ent = by_table.get(tkey)
                if ent is None:
                    if not doc.actor_table:
                        # every change of this doc's batch queued, so the
                        # interning hoist never saw it — nothing to seed
                        continue
                    batch_rank = _table_positions(doc, g.batch_table)
                    if batch_rank is None:
                        # an actor the hoist did not intern (defensive;
                        # unreachable post-hoist): skip this doc's seed,
                        # _plan_round resolves per doc as before
                        continue
                    ent = {"batch_rank": batch_rank,
                           "row_rank": batch_rank[g.row_table_idx]
                           .astype(np.int32)}
                    if plan0 is not None and plan0.n_runs:
                        ent.update(run_head_fields(
                            plan0, batch_rank, b0.op_target_actor,
                            b0.op_target_ctr, b0.op_parent_actor,
                            b0.op_parent_ctr))
                        R = bucket(plan0.n_runs, 64)
                        N = bucket(plan0.n_pairs, 256)
                        tmpl = build_desc_template(
                            plan0, b0.op_target_ctr, b0.op_change,
                            ent["head_rank"], ent["row_rank"],
                            np.asarray(b0.seqs, np.int32), R, N)
                        tmpl.setflags(write=False)
                        ent["desc_tmpl"] = tmpl
                    by_table[tkey] = ent
                g.cols.rank_cache[doc] = {"gen": doc._intern_gen, **ent}
                self.stats["rank_seeded"] += 1
        if obs.ENABLED:
            obs.span("plan", "rank_resolve", _t0, args={
                "what": "cross_doc_seed", **self.stats})


def preplan(decoded):
    """Group one apply's decoded ``[(doc, batch), ...]`` population by
    planning-column content and derive each group's shared state (cols
    companion, full-batch run detection). Returns None when no group
    reaches 2 members (each doc then plans on its own)."""
    from .text_doc import DeviceTextDoc

    _t0 = obs.now() if obs.ENABLED else 0
    by_sig = {}
    for doc, batch in decoded:
        if not isinstance(doc, DeviceTextDoc):
            continue
        if doc.queue or not batch.n_changes or not batch.n_ops:
            continue
        sig = plan_signature(batch)
        if sig is None:
            continue
        by_sig.setdefault(sig, []).append((doc, batch))

    plan = CrossDocPlan()
    for sig, members in by_sig.items():
        if len(members) < 2:
            continue
        g = _Group()
        g.members = members
        _doc0, b0 = members[0]
        g.cols = change_columns(b0)
        g.batch_table = np.asarray(b0.actor_table, object)
        tpos = {a: i for i, a in enumerate(b0.actor_table)}
        g.row_table_idx = np.asarray([tpos[a] for a in b0.actors],
                                     np.int64)
        # ONE full-batch run detection per group (base 0; per-doc rebase
        # via the RoundPlan.rebase contract), reusing an existing cache
        # when the representative batch already detected
        rp = getattr(b0, "_run_plan_cache", None)
        if rp is not None and rp[1].n_ops == b0.n_ops:
            g.run_plan = (0, rp[1].rebase(-rp[0]))
        else:
            p0 = detect_runs(b0.op_kind, b0.op_target_actor,
                             b0.op_target_ctr, b0.op_parent_actor,
                             b0.op_parent_ctr, b0.op_value, b0.op_change,
                             0)
            for arr in (p0.hpos, p0.run_len, p0.head_slot, p0.rpos,
                        p0.res_new_slot, p0.blob):
                if isinstance(arr, np.ndarray):
                    arr.setflags(write=False)
            g.run_plan = (0, p0)
        for _doc, b in members:
            # shared companions: every member batch plans off ONE cols
            # object (mirror/pairs caches included) and ONE detection
            b._change_columns = g.cols
            if getattr(b, "_run_plan_cache", None) is None:
                b._run_plan_cache = g.run_plan
                plan.stats["detect_shared"] += 1
            plan._by_batch[id(b)] = g
        plan.groups.append(g)
    if not plan.groups:
        return None
    plan.stats["groups"] = len(plan.groups)
    plan.stats["docs"] = sum(len(g.members) for g in plan.groups)
    if obs.ENABLED:
        obs.span("plan", "cross_doc", _t0, args=dict(plan.stats))
    return plan
