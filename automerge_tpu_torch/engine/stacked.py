"""Stacked multi-object rounds: one round program per causal round.

The PyTorch counterpart of `automerge_tpu/engine/stacked.py` (its fused
path, the JAX package's default). A nested document — a board of cards,
a form of many small sections — routes ONE causal round across many
small per-object engine docs. Applied per object, each (object, round)
pays its own round program and h2d staging. Here the SAME rounds run as
a constant number of stacked round programs per round, independent of
object count. A program is one call of a function over the doc axis —
in the JAX package one jitted program, here about 60 eager kernel
launches — so what stays constant is the number of program calls; the
host work around them, and the copies of `_stack_padded` for documents
below the common capacity, still grow with the object count:

- per-object admission and planning stay on the host and REUSE the
  per-object machinery verbatim (`_decode_wire` -> `_schedule` ->
  `_group_round` -> `_round_bookkeeping` -> `_plan_round` /
  `_plan_map_round`), so the stacked tier changes WHERE device work
  happens, never what is computed;
- per-object tables pad to a common capacity and stack along a doc axis
  (one gather program per kind, pending actor-rank remaps folded in so a
  reordering intern costs zero extra programs);
- each causal round (each pass) is ONE `fused_stacked_round` over both
  lanes — every map/table object's register round and every text/list
  object's mixed round, written over the doc axis (ops/fused_round.py;
  the text lane's expansion is one `multi_scan` launch on (D * 6, N)) —
  fed by one packed (D, ...) upload per operand;
- the host slow-register residue of ALL objects reads back as one packed
  slow_info fetch per lane and writes back as one
  `fused_scatter_registers` program; one unstack plus one packed mirror
  fetch (carrying every text doc's RGA positions too) re-seed every
  doc's tables and host mirrors at the end of the apply.

Padding waste is bounded by the eligibility gate
(``AMTPU_STACKED_MAX_CELLS``); skewed populations, single documents and
tiny payloads (``AMTPU_STACKED_MIN_OPS``) are declined and the caller
applies per object.

Failure atomicity: a mid-apply failure leaves per-doc state partially
advanced exactly like a failed per-object apply that already touched
earlier docs; every participating doc's plans are invalidated on the way
out, and the caller rebuilds from its change log.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import obs
from ..obs import lineage
from . import accounting, cross_doc
from .map_doc import DeviceMapDoc
from .pipeline import stage_h2d
from .text_doc import DeviceTextDoc

#: Stats of the most recent stacked apply (bench / budget-test
#: introspection): docs, rounds, passes, round-program calls
#: (`dispatches`, the JAX package's name for them: one per program call,
#: not per kernel launch), blocking syncs, packed h2d uploads.
LAST_STATS: dict = {}

#: Asserted program budget: a stacked apply may call at most
#: APPLY_DISPATCH_BASE + PASS_DISPATCH_BUDGET * passes round programs —
#: CONSTANT in the number of objects. It bounds program calls, not kernel
#: launches (a program is many eager launches; `chip_smoke.py --profile`
#: counts the device operations of one apply at two population sizes).
#: A PASS is one (round,
#: source-batch-group) step, so the pass count scales with delivery
#: fragmentation, never with object count. BASE covers the per-apply
#: fixed programs (gathers, unstacks, mirror fetches, the linearize);
#: PER_PASS is double one pass's structural count (the round program +
#: at most one combined slow-path scatter), so a single added program
#: trips the assert before it doubles the round cost.
APPLY_DISPATCH_BASE = 8
PASS_DISPATCH_BUDGET = 4

_MAP_MIRROR_KEYS = ("value", "has_value", "win_counter")
_TEXT_MIRROR_KEYS = ("parent", "ctr", "actor", "value", "has_value")
_BOOL_KEYS = frozenset(("has_value", "win_counter", "chain"))


def _min_ops() -> int:
    return int(os.environ.get("AMTPU_STACKED_MIN_OPS", "16"))


def _max_cells() -> int:
    return int(os.environ.get("AMTPU_STACKED_MAX_CELLS", str(1 << 23)))


def worth_trying(n_wire_ops: int, n_op_docs: int) -> bool:
    """Cheap pre-gate a caller applies BEFORE building per-object change
    windows: the stacked path only ever engages for >= 2 op-bearing
    objects carrying >= AMTPU_STACKED_MIN_OPS wire ops — the same gates
    `apply_stacked` re-checks, hoisted so a declined attempt costs no
    window/decoding work."""
    return n_op_docs >= 2 and n_wire_ops >= _min_ops()


def assert_round_budget(stats: dict = None):
    """Assert the object-count-independent program budget against the
    most recent stacked apply (or `stats`)."""
    s = LAST_STATS if stats is None else stats
    assert s, "no stacked apply recorded"
    limit = APPLY_DISPATCH_BASE + PASS_DISPATCH_BUDGET * max(1, s["passes"])
    assert s["dispatches"] <= limit, (
        f"stacked apply called {s['dispatches']} round programs for "
        f"{s['passes']} round-pass(es) over {s['docs']} objects "
        f"(budget {limit}; per-pass program calls must not scale with "
        f"object count)")
    # every finalized text doc's RGA positions were seeded from the ONE
    # stacked linearize + packed fetch, so reading positions right after
    # the apply pays zero per-object linearize dispatches
    assert s.get("pos_seeded", 0) == s.get("text_finalized", 0), (
        f"stacked apply finalized {s.get('text_finalized', 0)} text docs "
        f"but seeded positions for {s.get('pos_seeded', 0)} — reads "
        "would fall back to per-object linearize dispatches")
    # a round's minted ranges land as ONE bulk index merge per doc
    assert s.get("index_merges", 0) <= s.get("text_plans", 0), (
        f"stacked apply performed {s.get('index_merges', 0)} index merges "
        f"for {s.get('text_plans', 0)} planned text rounds (budget: one "
        "bulk merge per doc per round)")


def _count(stats: dict, label: str):
    accounting.record_dispatch(1, None, label=label)
    stats["dispatches"] += 1


def _count_sync(stats: dict, label: str, t0_ns: int, d2h_bytes: int = 0):
    accounting.record_sync(1, None, label=label,
                           dur_ns=(obs.now() - t0_ns) if t0_ns else 0,
                           d2h_bytes=d2h_bytes)
    stats["syncs"] += 1


def _upload(stats: dict, device, *arrays):
    """One stacked upload seam: each (D, ...) host matrix goes to `device`
    as one copy (non-blocking from pinned memory on a card, on the
    current stream). Counts the transfers into the per-apply stats and
    the exact bytes into the process meter."""
    stream = (torch.cuda.current_stream(device)
              if device.type == "cuda" else None)
    out = tuple(stage_h2d(np.ascontiguousarray(a), device, stream)[0]
                for a in arrays)
    stats["h2d"] += len(arrays)
    accounting.record_h2d(sum(a.nbytes for a in arrays))
    return out


def _fetch(stats: dict, label: str, t: torch.Tensor) -> np.ndarray:
    """One packed d2h fetch (a blocking sync)."""
    _ts = obs.now() if obs.ENABLED else 0
    out = t.cpu().numpy()
    _count_sync(stats, label, _ts, d2h_bytes=out.nbytes)
    return out


class _LaneSet:
    """Stacked device tables for one kind's participating docs.

    Gathered lazily at the first pass that needs them (pending
    actor-rank remaps folded into the gather program); `cols` then hold
    the live stacked (D, cap) tables until the final unstack."""

    def __init__(self, docs, keys, kind: str, device):
        self.docs = list(docs)
        self.keys = keys
        self.kind = kind                       # "map" | "text"
        self.device = device
        self.idx = {id(d): i for i, d in enumerate(self.docs)}
        self.cols = None
        self.cap = 0
        self.remaps: dict = {}                 # id(doc) -> composite remap

    def note_remap(self, doc, remap: np.ndarray):
        acc = self.remaps.get(id(doc))
        self.remaps[id(doc)] = (remap if acc is None
                                else remap[acc].astype(np.int32))

    def ensure(self, out_cap: int, stats: dict):
        """Gather per-doc tables into the stacked columns (one program,
        one upload: column 0 of the matrix is each row's element count,
        the rest its actor-rank remap)."""
        if self.cols is not None:
            return
        from ..ops import ingest as K
        tables = tuple(tuple(doc._ensure_dev()[k] for k in self.keys)
                       for doc in self.docs)
        L = max([len(doc.actor_table) for doc in self.docs] + [1])
        meta = np.zeros((len(self.docs), L + 1), np.int32)
        meta[:, 1:] = np.arange(L, dtype=np.int32)
        for i, doc in enumerate(self.docs):
            r = self.remaps.get(id(doc))
            if r is not None:
                meta[i, 1: 1 + len(r)] = r
            if self.kind == "text":
                meta[i, 0] = doc.n_elems
        self.remaps.clear()
        out_cap = max(out_cap, max(doc._cap for doc in self.docs))
        (meta_t,) = _upload(stats, self.device, meta)
        _count(stats, "stacked_gather")
        if self.kind == "map":
            self.cols = K.stack_register_tables(tables, meta_t[:, 1:],
                                                out_cap=out_cap)
        else:
            self.cols = K.stack_element_tables(tables, meta_t[:, 1:],
                                               meta_t[:, 0], out_cap=out_cap)
        self.cap = out_cap


def _host_remap(doc, remap: np.ndarray):
    """The host half of `_apply_remap` (conflicts + index/mirror
    re-rank); the device half — the actor columns — folds into the
    stacked gather instead of paying one remap program per doc."""
    for ops in doc.conflicts.values():
        for op in ops:
            op["actor_rank"] = int(remap[op["actor_rank"]])
    if isinstance(doc, DeviceTextDoc):
        doc.index = doc.index.remap_actors(remap.astype(np.int64))
        if doc.seg_mirror is not None:
            doc.seg_mirror.remap_actors(remap.astype(np.int64))
    doc._invalidate()


def _item_ops(subs) -> int:
    """Wire-op count of one item's change window: a list of wire dicts or
    an already-decoded columnar batch (the DocSet feeds decoded
    batches)."""
    if hasattr(subs, "n_ops"):
        return int(subs.n_ops)
    return sum(len(c.get("ops", ())) for c in subs)


def apply_stacked(items):
    """Apply one routed delivery as stacked multi-object rounds.

    `items`: ``[(doc, sub_changes), ...]`` — one entry per participating
    engine doc (map or text, all on one device), each with its change
    window as wire dicts or an already-decoded columnar batch. Returns
    False when the population is ineligible (the caller then applies per
    object, with nothing mutated); the apply's stats dict (truthy — also
    mirrored in LAST_STATS) when the delivery was applied."""
    if len(items) < 2:
        return False
    n_wire_ops = sum(_item_ops(subs) for _, subs in items)
    if n_wire_ops < _min_ops():
        return False
    docs = [d for d, _ in items]
    for doc in docs:
        if not isinstance(doc, (DeviceMapDoc, DeviceTextDoc)):
            return False
        if doc._device_lost or doc.donate_buffers:
            return False
    device = docs[0].device
    if any(doc.device != device for doc in docs):
        return False

    # cheap PRE-decode gates, from wire-op counts / doc kinds / current
    # caps only: a population that is ineligible every apply (one hot
    # object, or a skewed-capacity mix) must not pay a discarded
    # decode+schedule on top of the per-object fallback's own
    op_docs = [d for d, subs in items if _item_ops(subs)]
    n_map = sum(isinstance(d, DeviceMapDoc) for d in op_docs)
    n_text = len(op_docs) - n_map
    if n_map + n_text < 2:
        return False
    # padded-stacking memory gate: a skewed population (one huge doc
    # among many small ones) would inflate every row to the max cap
    if max(d._cap for d in op_docs) * (5 * n_map + 9 * n_text) \
            > _max_cells():
        return False

    # ---- decode + admission (pure: nothing committed until the GO) ----
    _t0 = obs.now() if obs.ENABLED else 0
    decoded = [(doc, changes if hasattr(changes, "n_changes")
                else doc._decode_wire(changes))
               for doc, changes in items]
    # cross-doc columnar planning (engine/cross_doc.py): ONE planning
    # pass for the whole touched population — batches with identical
    # planning columns share admission templates, run detection and
    # (after the interning hoist below) rank caches. None when no two
    # docs share a shape.
    cross = cross_doc.preplan(decoded)
    sched = []           # (doc, [groups per round], queue_after, n_ops)
    for doc, batch in decoded:
        out = cross.schedule(doc, batch) if cross is not None else None
        if out is None:
            out = doc._schedule(batch)
        rounds, queue_after, _prior = out
        groups = [doc._group_round(r) for r in rounds]
        n_ops = sum(b.n_ops for gs in groups for b, _r, _m in gs)
        sched.append((doc, groups, queue_after, n_ops))

    # device lanes: docs whose ROUNDS carry ops (released queue batches
    # included, all-duplicate batches excluded); the rest only need
    # clock/deps bookkeeping and never touch the device this apply
    map_docs = [d for d, g, _q, n in sched
                if n and isinstance(d, DeviceMapDoc)]
    text_docs = [d for d, g, _q, n in sched
                 if n and isinstance(d, DeviceTextDoc)]
    if map_docs or text_docs:
        # released queue batches can pull in docs the pre-gate never
        # saw: re-check the memory gate against the real lane sets (a
        # rare late fallback beats stacking an unbounded row width)
        cap_hint = max(d._cap for d in map_docs + text_docs)
        if cap_hint * (5 * len(map_docs) + 9 * len(text_docs)) \
                > _max_cells():
            return False

    # ---- GO: commit queues, hoist interning, run the passes ----------
    stats = {"docs": len(docs), "map_docs": len(map_docs),
             "text_docs": len(text_docs), "rounds": 0, "passes": 0,
             "dispatches": 0, "syncs": 0, "h2d": 0,
             "text_finalized": 0, "pos_seeded": 0,
             "text_plans": 0, "index_merges": 0, "fused": True}
    map_set = (_LaneSet(map_docs, DeviceMapDoc._TABLE_KEYS, "map", device)
               if map_docs else None)
    text_set = (_LaneSet(text_docs, DeviceTextDoc._TABLE_KEYS, "text",
                         device) if text_docs else None)
    lane_of = {}
    for s in (map_set, text_set):
        if s is not None:
            for d in s.docs:
                lane_of[id(d)] = s

    for doc in docs:
        doc._busy += 1
    try:
        for doc, groups, queue_after, _n in sched:
            doc.queue = queue_after
        # actor interning, hoisted across every round (content-free: it
        # renames ranks consistently and adds no document content).
        # Device-lane remaps fold into the gather; bookkeeping-only docs
        # remap through the normal path.
        for doc, groups, _q, _n in sched:
            lane = lane_of.get(id(doc))
            for gs in groups:
                for b, _rows, _mask in gs:
                    remap = doc._intern_batch_actors(b)
                    if remap is None:
                        continue
                    if lane is None:
                        doc._apply_remap(remap)
                    else:
                        _host_remap(doc, remap)
                        lane.note_remap(doc, remap)
        if cross is not None:
            # the vectorized per-doc rank join runs AFTER the interning
            # hoist (ranks are only defined once every batch actor is
            # interned); the seeded caches feed every _plan_round below
            cross.seed_ranks()
            stats["cross_doc"] = dict(cross.stats)
        if obs.ENABLED:
            obs.span("plan", "stack", _t0, args={
                "docs": len(docs), "map_docs": len(map_docs),
                "text_docs": len(text_docs), "n_ops": n_wire_ops})
        if lineage.ENABLED:
            # the stacked-plan hop: the change's round is part of THIS
            # multi-object device program population (recorded at the
            # GO, after every ineligibility gate passed)
            for _doc, batch in decoded:
                lineage.hop_delivery(batch, "plan/stacked",
                                     doc=batch.obj_id)

        max_rounds = max((len(g) for _, g, _q, _n in sched), default=0)
        stats["rounds"] = max_rounds
        for k in range(max_rounds):
            in_round = [(doc, groups[k]) for doc, groups, _q, _n in sched
                        if len(groups) > k]
            max_groups = max((len(gs) for _, gs in in_round), default=0)
            for j in range(max_groups):
                _tp = obs.now() if obs.ENABLED else 0
                d0 = stats["dispatches"]
                map_plans, text_plans = [], []
                for doc, gs in in_round:
                    if len(gs) <= j:
                        continue
                    b, rows_arr, mask = gs[j]
                    doc._round_bookkeeping(b, rows_arr)
                    if not b.n_ops:
                        continue
                    if isinstance(doc, DeviceMapDoc):
                        p = doc._plan_map_round(b, mask)
                        if p is not None:
                            map_plans.append((doc, b, p))
                    else:
                        plan, _sh = doc._plan_round(
                            b, mask, doc._plan_shadow(), stage=False)
                        if plan is not None:
                            text_plans.append((doc, b, plan))
                if text_plans:
                    stats["text_plans"] += len(text_plans)
                    stats["index_merges"] += sum(
                        p.n_index_merges for _, _, p in text_plans)
                if map_plans or text_plans:
                    _exec_fused_pass(map_set, map_plans, text_set,
                                     text_plans, stats)
                stats["passes"] += 1
                if obs.ENABLED:
                    obs.span("commit", "stacked_round", _tp, args={
                        "round": k, "pass": j,
                        "map_objs": len(map_plans),
                        "text_objs": len(text_plans),
                        "dispatches": stats["dispatches"] - d0})

        _finalize(map_set, stats)
        _finalize(text_set, stats)
    except BaseException:
        # partial device work happened: per-doc plans/caches can no
        # longer be trusted; the caller rebuilds from its change log
        for doc in docs:
            doc._gen += 1
            doc._plan_failed()
        raise
    finally:
        for doc in docs:
            doc._busy -= 1

    LAST_STATS.clear()
    LAST_STATS.update(stats)
    return stats


def _conflict_matrix(docs, out_cap: int):
    """(D, K) conflict-slot matrix shared by the map and text lanes:
    every doc's host-held conflict slots, padded with the out-of-range
    sentinel."""
    from ..ops.ingest import bucket

    Kc = bucket(max([len(d.conflicts) for d in docs] + [1]), 64)
    conflict = np.full((len(docs), Kc), out_cap, np.int32)
    for d, doc in enumerate(docs):
        if doc.conflicts:
            cl = list(doc.conflicts)
            conflict[d, : len(cl)] = cl
    return conflict


def _wb_matrix(n_docs: int, wbs: dict, out_cap: int):
    """Stack per-doc (6, S_d) host-resolved writebacks into one
    (D, 6, S) upload (padding rows: out-of-range slot, dropped by the
    scatter)."""
    from ..ops.ingest import bucket

    S = bucket(max(wb.shape[1] for wb in wbs.values()), 64)
    m = np.zeros((n_docs, 6, S), np.int32)
    m[:, 0, :] = out_cap
    for d, wb in wbs.items():
        m[d, :, : wb.shape[1]] = wb
    return m


def _exec_fused_pass(map_set, map_plans, text_set, text_plans,
                     stats: dict):
    """One causal round across EVERY participating object — both lanes —
    as ONE `fused_stacked_round` program, then (when any object's round
    left slow residue) ONE `fused_scatter_registers` program. The text
    lane runs the flag-free fused core: every plan shares one uniform
    scatter-expansion program, and padding drops through the scatter's
    out-of-range sentinel."""
    from ..ops import fused_round as F
    from ..ops import ingest as K
    from ..ops.ingest import (DESC_ELEM_BASE, RES_NEW_SLOT, RES_SLOT,
                              bucket)

    device = (map_set or text_set).device
    absent = F._absent(device)

    # ---- map lane staging ----
    with_map = bool(map_plans)
    m_active = {}
    map_cap = 1
    args_map = (absent,) * 7
    if with_map:
        m_docs = map_set.docs
        map_cap = max(max(p["out_cap"] for _, _, p in map_plans),
                      map_set.cap)
        map_set.ensure(map_cap, stats)
        map_cap = max(map_cap, map_set.cap)
        M = bucket(max(p["n_ops"] for _, _, p in map_plans), 128)
        m_ops = np.zeros((len(m_docs), 5, M), np.int32)
        m_ops[:, K.MOP_KIND, :] = -1
        m_ops[:, K.MOP_SLOT, :] = map_cap
        m_conflict = _conflict_matrix(m_docs, map_cap)
        for doc, b, p in map_plans:
            d = map_set.idx[id(doc)]
            m_active[d] = (doc, b, p)
            n = p["n_ops"]
            m_ops[d, K.MOP_KIND, :n] = p["kind"]
            m_ops[d, K.MOP_SLOT, :n] = p["slot"]
            m_ops[d, K.MOP_VALUE, :n] = p["value"]
            m_ops[d, K.MOP_WIN_ACTOR, :n] = p["win_actor"]
            m_ops[d, K.MOP_WIN_SEQ, :n] = p["win_seq"]
        args_map = (tuple(map_set.cols)
                    + _upload(stats, device, m_ops, m_conflict))

    # ---- text lane staging: ONE uniform group ----
    with_text = bool(text_plans)
    t_active = {}
    text_cap = 1
    text_res = False
    args_text = (absent,) * 14
    if with_text:
        t_docs = text_set.docs
        Dt = len(t_docs)
        text_cap = max(max(p.out_cap for _, _, p in text_plans),
                       text_set.cap)
        text_set.ensure(text_cap, stats)
        text_cap = max(text_cap, text_set.cap)
        R = bucket(max([p.desc.shape[1] for _, _, p in text_plans
                        if p.desc is not None] + [1]), 64)
        N = bucket(max([p.blob.shape[0] for _, _, p in text_plans
                        if p.blob is not None] + [1]), 256)
        desc_g = np.zeros((Dt, 9, R), np.int32)
        desc_g[:, DESC_ELEM_BASE, :] = N
        blob_g = np.zeros((Dt, N), np.int32)
        Mt = bucket(max([p.res.shape[1] for _, _, p in text_plans
                         if p.res is not None] + [1]), 128)
        res_g = np.zeros((Dt, 8, Mt), np.int32)
        res_g[:, 0, :] = -1                      # RES_KIND padding
        res_g[:, RES_SLOT, :] = text_cap
        res_g[:, RES_NEW_SLOT, :] = text_cap
        conflict_g = _conflict_matrix(t_docs, text_cap)
        T = bucket(max([p.touch.shape[1] for _, _, p in text_plans
                        if p.touch is not None] + [1]), 64)
        touch_g = np.zeros((Dt, 3, T), np.int32)
        touch_g[:, 1:, :] = -1
        for doc, b, p in text_plans:
            d = text_set.idx[id(doc)]
            t_active[d] = (doc, b, p)
            if p.desc is not None:
                w = p.desc.shape[1]
                desc_g[d, :, :w] = p.desc
                pn = p.blob.shape[0]
                eb = desc_g[d, DESC_ELEM_BASE]
                eb[eb == pn] = N                 # re-pad the sentinel
                blob_g[d, :pn] = p.blob
            if p.res is not None:
                text_res = True
                w = p.res.shape[1]
                res_g[d, :, :w] = p.res
                for r in (RES_SLOT, RES_NEW_SLOT):
                    row = res_g[d, r]
                    row[row == p.out_cap] = text_cap
            if p.touch is not None:
                w = p.touch.shape[1]
                touch_g[d, :, :w] = p.touch
            doc._begin_round_host(p)
        args_text = (tuple(text_set.cols)
                     + _upload(stats, device, desc_g, blob_g, res_g,
                               conflict_g, touch_g))

    # ---- THE program of the pass ----
    _count(stats, "fused_stacked_round")
    out = F.fused_stacked_round(
        *args_map, *args_text, map_cap=map_cap, text_cap=text_cap,
        with_map=with_map, with_text=with_text)
    i = 0
    m_info_dev = t_info_dev = None
    if with_map:
        map_set.cols = out[:5]
        map_set.cap = map_cap
        m_info_dev = out[5]
        i = 6
    if with_text:
        text_set.cols = out[i: i + 9]
        text_set.cap = text_cap
        t_info_dev = out[i + 9]
        for _d, (doc, _b, p) in t_active.items():
            doc._cap = text_cap
            doc._finish_round_host(p)

    # ---- slow residue: one packed d2h fetch per lane, host resolution,
    # one COMBINED scatter program ----
    map_wbs = {}
    if with_map:
        info = _fetch(stats, "stacked_slow_info", m_info_dev)
        for d, (doc, b, p) in m_active.items():
            row = info[d][:, : p["n_ops"]]
            if row[0].any():
                idxs = np.nonzero(row[0])[0]
                map_wbs[d] = doc._resolve_slow_host(
                    b, row[1][idxs], p["kind"][idxs], p["val64"][idxs],
                    p["win_actor"][idxs], p["win_seq"][idxs],
                    slot_cap=map_cap,
                    reg_state=tuple(row[r][idxs] for r in range(2, 7)))
    text_wbs = {}
    if text_res:
        info = _fetch(stats, "stacked_slow_info", t_info_dev)
        for d, (doc, b, p) in t_active.items():
            row = info[d][:, : p.n_res]
            if not p.n_res or not row[0].any():
                continue
            res_kind, res_vals, res_rank, res_seq = p.res_host
            idxs = np.nonzero(row[0])[0]
            text_wbs[d] = doc._resolve_slow_host(
                b, row[1][idxs], res_kind[idxs], res_vals[idxs],
                res_rank[idxs], res_seq[idxs], slot_cap=text_cap,
                reg_state=tuple(row[r][idxs] for r in range(2, 7)))
    if map_wbs or text_wbs:
        args_m = (absent,) * 6
        args_t = (absent,) * 6
        if map_wbs:
            args_m = tuple(map_set.cols) + _upload(
                stats, device, _wb_matrix(len(map_set.docs), map_wbs,
                                          map_cap))
        if text_wbs:
            args_t = tuple(text_set.cols[3:8]) + _upload(
                stats, device, _wb_matrix(len(text_set.docs), text_wbs,
                                          text_cap))
        _count(stats, "fused_scatter")
        out = F.fused_scatter_registers(*args_m, *args_t,
                                        with_map=bool(map_wbs),
                                        with_text=bool(text_wbs))
        i = 0
        if map_wbs:
            map_set.cols = out[:5]
            i = 5
        if text_wbs:
            text_set.cols = (tuple(text_set.cols[:3]) + tuple(out[i: i + 5])
                             + tuple(text_set.cols[8:]))
    for _d, (doc, _b, _p) in m_active.items():
        doc._cap = map_cap
        doc._invalidate()
    for d in text_wbs:
        t_active[d][0]._invalidate()


def _finalize(lane_set: _LaneSet, stats: dict):
    """Unstack the final stacked tables back onto each doc — views of
    fresh buffers of its own (`unstack_rows`), so a later in-place write
    to one doc can reach no other and releasing one doc frees its
    tables — and seed every doc's host mirror from ONE packed d2h
    fetch, so reads right after the apply touch pure host state. For the
    text lane the fetch also carries every doc's RGA positions (one
    `stacked_linearize` program riding the same transfer).

    The fetch (and the linearize) is sliced to the LIVE slot prefix, not
    the table capacity. Host mirrors are rebuilt at full width with ZERO
    padding; no consumer reads a slot past its live count."""
    if lane_set is None:
        return
    from ..ops import ingest as K
    from ..ops.ingest import bucket
    if lane_set.cols is None:
        # no round ran on this kind, but a pending remap must still
        # reach the device columns: gather + unstack applies it
        if not lane_set.remaps:
            return
        lane_set.ensure(lane_set.cap or 1, stats)
    _count(stats, "stacked_unstack")
    rows = K.unstack_rows(lane_set.cols)
    mirror_keys = (_MAP_MIRROR_KEYS if lane_set.kind == "map"
                   else _TEXT_MIRROR_KEYS)
    m_idx = [lane_set.keys.index(k) for k in mirror_keys]
    cap = lane_set.cap
    if lane_set.kind == "text":
        live = [doc.n_elems + 1 for doc in lane_set.docs]
    else:
        live = [len(doc.key_table) for doc in lane_set.docs]
    w = min(cap, bucket(max(live + [1]), 64))
    fetch_cols = [lane_set.cols[i][:, :w] for i in m_idx]
    if lane_set.kind == "text":
        from ..ops.linearize import stacked_linearize
        n_el = np.asarray([doc.n_elems for doc in lane_set.docs], np.int32)
        (n_el_t,) = _upload(stats, lane_set.device, n_el)
        _count(stats, "stacked_linearize")
        fetch_cols.append(stacked_linearize(
            lane_set.cols[lane_set.keys.index("parent")][:, :w],
            lane_set.cols[lane_set.keys.index("ctr")][:, :w],
            lane_set.cols[lane_set.keys.index("actor")][:, :w], n_el_t))
        stats["text_finalized"] += len(lane_set.docs)
    _count(stats, "stacked_mirror_fetch")
    packed = _fetch(stats, "stacked_mirror_fetch",
                    K.stacked_pack_rows(*fetch_cols))
    for d, doc in enumerate(lane_set.docs):
        doc._dev = dict(zip(lane_set.keys, rows[d]))
        doc._cap = cap
        host = {}
        for i, k in enumerate(mirror_keys):
            if k in _BOOL_KEYS:
                full = np.zeros(cap, bool)
                full[:w] = packed[d, i].astype(bool)
            else:
                full = np.zeros(cap, np.int32)
                full[:w] = packed[d, i]
            host[k] = full
        doc._host = host
        if lane_set.kind == "text":
            doc._pos_cache = packed[d, len(mirror_keys)][: doc.n_elems + 1]
            stats["pos_seeded"] += 1
