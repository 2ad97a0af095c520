"""Multi-document text engine: one device program for a whole DocSet.

The PyTorch counterpart of `automerge_tpu/engine/doc_set.py`. A DocSet
merged one document at a time pays one program launch per document; for
small documents that launch dominates. This engine stacks every
document's element tables into (docs, capacity) tensors and runs
ingestion and materialization as ONE program over the doc axis. (The JAX
package `vmap`s its one-document programs; the port writes them over
the doc axis, ops/ingest.py's row forms, because a kernel bound through
ctypes cannot be vmapped.)

Scope: the stacked fast path covers rounds that are *runs-only* and fully
causally ready (the overwhelming bulk-sync shape). Its run expansion scans
every document's five boundary-delta channels with ONE `multi_scan`
launch on (D * 5, N). A document whose batch needs the general machinery
(residual ops, queueing, conflicts) permanently *graduates* to its own
`DeviceTextDoc` built from its table row; the graduated documents of one
call then merge together through the stacked executor
(engine/stacked.py `apply_stacked`) — correctness never depends on the
fast path applying. The host plans a round over the doc axis too: one
run walk over every ready document (engine/runs.py `detect_runs_axis`),
then one native pass a stage (`_plan_axis`: index merge, parent lookup,
segment-mirror update) over every document the fast tier takes.

`texts()` materializes every stacked document at once: from each row's
host segment mirror (the planned program; one native pass over the doc
axis plans every row and checksums its mirror), or, for a call where a
mirror is missing or diverged from the chain bits, through the
self-contained program whose segment scans are ONE row-form
`fused_segment_scans` launch over (D, C).

With a mesh (parallel/mesh.py: axes "doc", "elem"; the JAX package's
`mesh=`), the tables are held as (doc, elem) blocks on the mesh's
devices. The fast-tier round runs per doc group, on the group's rows
gathered onto its first device (one `multi_scan` launch a group), and
scatters them back; `texts()` scans the blocks in place through the row
form of `sharded_fused_scans` and materializes planned rows
element-sharded (`sharded_planned_materialize_r`), self-contained rows
on each group's first device. A graduated document lives on its group's
first device, and graduated documents apply one by one (the JAX package
keeps its per-document loop for mesh sets too).
"""

from __future__ import annotations

import collections
import weakref

import numpy as np
import torch

from .. import native, obs
from .._common import HEAD_PARENT, make_elem_id
from ..ops.ingest import TEXT_TABLE_FILLS
from . import learned_index as _learned
from .base import resolve_device, transitive_closure
from .columnar import TextChangeBatch
from .host_index import BatchRangeIndex, DuplicateElemId, pack_keys, unpack_key
from .pipeline import stage_h2d
from .runs import detect_runs_axis
from .segments import SegmentMirror
from .text_doc import DeviceTextDoc, logger

#: the fast tier's doc-axis planning since the last reset: the rounds and
#: documents the one pass (`_plan_axis`) planned, and the rounds it
#: declined to the per-document planner (`_plan_fast`)
axis_plans = {"rounds": 0, "docs": 0, "declined": 0}


def reset_axis_plans():
    for k in axis_plans:
        axis_plans[k] = 0


#: `texts()`'s reads since the last reset: the reads the doc-axis read
#: pass (`native.segplan_axis`) planned and the planned program served, the
#: stacked rows that pass planned, and the reads the self-contained program
#: served because a mirror was missing or diverged
axis_reads = {"planned": 0, "rows": 0, "self_contained": 0}


def reset_axis_reads():
    for k in axis_reads:
        axis_reads[k] = 0


def _places(rows: np.ndarray, counts: np.ndarray) -> tuple:
    """(row, column) of each item of groups concatenated in order: group
    i goes to row rows[i], at columns 0 .. counts[i] - 1."""
    start = np.cumsum(counts) - counts
    return (np.repeat(rows, counts),
            np.arange(int(counts.sum())) - np.repeat(start, counts))


def _int_rows(arrays: list) -> list:
    """Each of `arrays` as a list of Python ints, from one conversion."""
    flat = np.concatenate(arrays).tolist() if arrays else []
    out, o = [], 0
    for a in arrays:
        out.append(flat[o: o + len(a)])
        o += len(a)
    return out


class _FastRound:
    """The fast tier's plan of one round: per planned document (`docs`,
    in call order) its staged state, then the run descriptors of all of
    them and the value blob of all their pairs, concatenated in that
    order. `staged[i]` is (index, mirror, clock, all_deps, ascii,
    actors) of docs[i]."""

    __slots__ = ("docs", "n_runs", "n_pairs", "n_breaks", "staged",
                 "parent_slot", "ctr0", "actor", "win_actor", "win_seq",
                 "elem_base", "blob")

    _RUN_KEYS = ("parent_slot", "ctr0", "actor", "win_actor", "win_seq",
                 "elem_base")

    def __init__(self, docs, n_runs, n_pairs, n_breaks, staged, columns,
                 blob):
        self.docs, self.staged, self.blob = docs, staged, blob
        self.n_runs = np.asarray(n_runs, np.int64)
        self.n_pairs = np.asarray(n_pairs, np.int64)
        self.n_breaks = np.asarray(n_breaks, np.int64)
        for k, col in zip(self._RUN_KEYS, columns):
            setattr(self, k, col)

    @classmethod
    def from_packs(cls, packs: list) -> "_FastRound":
        """The per-document planner's packs (`_plan_fast`), stacked."""
        return cls(
            [p["d"] for p in packs], [p["n_runs"] for p in packs],
            [p["n_pairs"] for p in packs], [p["n_breaks"] for p in packs],
            [(p["staged_index"], p["staged_mirror"], p["staged_clock"],
              p["staged_all_deps"], p["staged_ascii"], p["staged_actors"])
             for p in packs],
            [np.concatenate([p[k] for p in packs]) for k in cls._RUN_KEYS],
            np.concatenate([p["blob"] for p in packs]))


class _DocMeta:
    __slots__ = ("clock", "actor_table", "actor_rank", "index", "n_elems",
                 "seg_bound", "all_ascii", "all_deps", "mirror")

    def __init__(self):
        self.clock: dict = {}
        self.actor_table: list = []
        self.actor_rank: dict = {}
        self.index = BatchRangeIndex()
        self.n_elems = 0
        self.seg_bound = 2
        self.all_ascii = True
        self.all_deps: dict = {}   # (actor, seq) -> transitive deps clock
        self.mirror = SegmentMirror.empty()  # host segment structure


class DeviceTextDocSet:
    """A set of text documents merged as one stacked device program, on a
    CUDA card (``device=None``) or, when asked with ``device="cpu"``, on
    the CPU; or, given a `parallel.Mesh`, sharded over its devices
    (documents along "doc", each document's elements along "elem")."""

    def __init__(self, obj_ids, capacity: int = 1024, device=None,
                 mesh=None):
        from ..ops.ingest import bucket
        if mesh is not None and device is not None:
            raise ValueError("DeviceTextDocSet takes a device or a mesh, "
                             "not both")
        self.obj_ids = list(obj_ids)
        self.mesh = mesh
        # a mesh set's own device is its first shard's
        self.device = (mesh.device((0, 0)) if mesh is not None
                       else resolve_device(device))
        self._idx = {o: i for i, o in enumerate(self.obj_ids)}
        self._meta = [_DocMeta() for _ in self.obj_ids]
        self._cap = bucket(max(capacity, 16))
        self._dev = None                      # stacked (D, cap) tables
        self._overlay: dict = {}              # doc idx -> DeviceTextDoc
        self._codes_cache = None
        # the doc-axis pass's bookkeeping: the index each row last had
        # published read-only, the slabs its rows' state lives in, and
        # the bytes of each row's state it made
        self._published: list = [None] * self.n_docs
        self._slabs: list = []                # weakrefs
        self._state_bytes: list = [0] * self.n_docs
        # the newest mirror slab, when it was made of every row's mirror in
        # row order: (weakref to the slab, its (4, D + 1) row offsets);
        # `texts()` reads it as its columns while every row's mirror is a
        # view of it
        self._mirror_slab = None
        if mesh is not None:
            if self.n_docs % mesh.shape["doc"]:
                raise ValueError(
                    f"the mesh's doc axis ({mesh.shape['doc']}) must divide "
                    f"n_docs ({self.n_docs})")
            if self._cap % mesh.shape["elem"]:
                raise ValueError(
                    f"the mesh's elem axis ({mesh.shape['elem']}) must "
                    f"divide the bucketed capacity ({self._cap}); pick a "
                    f"power-of-two elem axis")

    @property
    def n_docs(self) -> int:
        return len(self.obj_ids)

    _TABLE_KEYS = DeviceTextDoc._TABLE_KEYS

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """One (D, ...) host matrix -> the set's device (non-blocking from
        pinned memory on a card, on the current stream)."""
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        return stage_h2d(np.ascontiguousarray(arr), self.device, stream)[0]

    def _ensure_dev(self):
        if self._dev is None:
            from ..parallel.mesh import ShardedArray
            shape = (self.n_docs, self._cap)
            self._dev = {}
            for k, fill in zip(self._TABLE_KEYS, TEXT_TABLE_FILLS):
                dtype = torch.bool if isinstance(fill, bool) else torch.int32
                self._dev[k] = (
                    torch.full(shape, fill, dtype=dtype, device=self.device)
                    if self.mesh is None else
                    ShardedArray.full(self.mesh, shape, ("doc", "elem"),
                                      fill, dtype))
        return self._dev

    def _group(self, d: int) -> tuple:
        """A mesh set's doc d: (its group's first coordinate, its row in
        the group's blocks)."""
        per = self.n_docs // self.mesh.shape["doc"]
        return (d // per, 0), d % per

    def _rows(self, d: int) -> dict:
        """Doc d's table rows, as tensors on the device it graduates to
        (a mesh set gathers the row's element blocks onto its group's
        first device)."""
        dev = self._ensure_dev()
        if self.mesh is None:
            return {k: dev[k][d].clone() for k in self._TABLE_KEYS}
        from ..parallel import mesh as pm
        lead, row = self._group(d)
        return {k: pm.gather(dev[k], "elem", lines=[lead],
                             index=[row])[lead][0] for k in self._TABLE_KEYS}

    # ------------------------------------------------------------------

    def _graduate(self, d: int) -> DeviceTextDoc:
        """Extract doc d into its own DeviceTextDoc (general path). The
        doc's tables are copies of its rows: an in-place round on the doc
        can never reach the stacked tables or another row."""
        if d in self._overlay:
            return self._overlay[d]
        meta = self._meta[d]
        rows = self._rows(d)
        doc = DeviceTextDoc(self.obj_ids[d], capacity=self._cap,
                            device=rows["parent"].device)
        doc._dev = rows
        doc._cap = self._cap
        doc.n_elems = meta.n_elems
        doc.index = meta.index
        doc.clock = dict(meta.clock)
        doc.actor_table = list(meta.actor_table)
        doc._actor_rank = dict(meta.actor_rank)
        doc._all_deps = dict(meta.all_deps)
        doc._seg_bound = meta.seg_bound
        doc.all_ascii = meta.all_ascii
        doc.seg_mirror = meta.mirror   # None degrades to the self-contained
        # programs; otherwise the mirror carries over with the table rows
        self._overlay[d] = doc
        return doc

    def doc(self, obj_id: str) -> DeviceTextDoc:
        """The general-path engine for one document (graduates it)."""
        return self._graduate(self._idx[obj_id])

    def apply_batches(self, batches: dict):
        """Merge {obj_id: TextChangeBatch}: the stacked fast path for
        runs-only ready batches; the general stacked executor
        (engine/stacked.py) otherwise — every batch the fast tier can't
        serve graduates its doc and the whole graduated group executes as
        ONE stacked multi-object apply per call.

        Traced as `docset/apply`; inside it `docset/plan` (the planning
        of every document), `docset/general`, `docset/stack` (the staged
        state committed, the descriptors packed) and `docset/expand`
        (the uploads and the expansion; its `out_cap` argument shows a
        capacity regrowth). Inside `docset/plan`, one `plan/detect_runs`
        a call: the run detection of every document that passed
        readiness, in one walk (its `n_docs`); then one `plan/index_merge`,
        `docset/lookup` and `docset/mirror` a call: the doc-axis pass's
        stages over every document it plans (`docset/plan`'s `n_axis`).
        Where the pass declines a round, the per-document planner's
        spans (`_plan_fast`'s stages) feed the aggregates only."""
        _t0 = obs.now() if obs.ENABLED else 0
        try:
            return self._apply_batches(batches)
        finally:
            if obs.ENABLED:
                obs.span("docset", "apply", _t0,
                         args={"n_docs": len(batches)})

    def _apply_batches(self, batches: dict):
        from ..ops.ingest import (DESC_ACTOR, DESC_CTR0, DESC_ELEM_BASE,
                                  DESC_HAS_VALUE, DESC_META,
                                  DESC_PARENT_SLOT, DESC_WIN_ACTOR,
                                  DESC_WIN_SEQ, META_BASE_SLOT,
                                  META_N_ELEMS, bucket)

        self._codes_cache = None
        _tp = obs.now() if obs.ENABLED else 0
        # readiness per document, then the run detection of every ready
        # one in ONE walk over the round's doc axis, and their planning in
        # one pass over it
        order: list = []              # (d, batch, ready), in call order
        seqs = _int_rows([b.seqs for b in batches.values()])
        for (obj_id, batch), row_seqs in zip(batches.items(), seqs):
            d = self._idx[obj_id]
            ready = (d not in self._overlay
                     and self._ready(d, batch, row_seqs))
            if ready != "skip":
                order.append((d, batch, ready))
        walked = [(d, b) for d, b, ready in order if ready]
        walk = detect_runs_axis(
            [(b.op_kind, b.op_target_actor, b.op_target_ctr,
              b.op_parent_actor, b.op_parent_ctr, b.op_value, b.op_change)
             for _, b in walked],
            [self._meta[d].n_elems for d, _ in walked])
        fast = self._plan_axis(walked, walk) if walked else None
        n_axis = 0 if fast is None else len(fast.docs)
        if fast is not None:
            on_tier = set(fast.docs)
            general = [(self._graduate(d), batch) for d, batch, _ in order
                       if d not in on_tier]
            fast = fast if fast.docs else None
        else:
            fast, general = self._plan_docs(order, walk)
        if obs.ENABLED:
            obs.span("docset", "plan", _tp, args={
                "n_fast": 0 if fast is None else len(fast.docs),
                "n_general": len(general), "n_axis": n_axis})
        if general:
            _tg = obs.now() if obs.ENABLED else 0
            self._apply_general(general)
            if obs.ENABLED:
                obs.span("docset", "general", _tg,
                         args={"n_docs": len(general)})
        if fast is None:
            return self

        # --- commit staged per-doc state now that every plan succeeded ---
        _ts = obs.now() if obs.ENABLED else 0
        for d, (index, mirror, clock, all_deps, ascii_, actors) in zip(
                fast.docs, fast.staged):
            meta = self._meta[d]
            meta.index = self._published[d] = index
            meta.mirror = mirror
            meta.clock.update(clock)
            meta.all_deps.update(all_deps)
            meta.all_ascii = meta.all_ascii and ascii_
            if actors is not None:
                meta.actor_table, meta.actor_rank = actors

        # --- stack run descriptors over the doc axis and expand once ---
        R = bucket(int(fast.n_runs.max()), 64)
        N = bucket(int(fast.n_pairs.max()), 256)
        # every doc's write window [n_elems+1, n_elems+1+N) must fit: the
        # dense expansion writes the whole padded window for ALL rows
        # (inactive docs write only past their live region)
        need = max(m.n_elems for m in self._meta) + 1 + N
        out_cap = max(bucket(need), self._cap)
        if self.mesh is not None:
            # bucket() can yield 3*2^(k-1) sizes that a power-of-two elem
            # axis doesn't divide; keep the constructor's sharding invariant
            # by rounding up to a multiple of the elem axis
            e = self.mesh.shape["elem"]
            out_cap = -(-out_cap // e) * e
        D = self.n_docs

        # one (D, 9, R) descriptor upload in the run-descriptor layout
        # (ops/ingest.py DESC_*); META = [n_run_elems, base_slot]. Inactive
        # rows write garbage past their live region (harmless). Each run
        # lands at (its doc, its place among the doc's runs), each pair
        # likewise in the (D, N) blob.
        docs = np.asarray(fast.docs, np.int64)
        run_doc, run_col = _places(docs, fast.n_runs)
        desc = np.zeros((D, 9, R), np.int32)
        desc[:, DESC_ELEM_BASE] = N
        desc[:, DESC_META, META_BASE_SLOT] = [m.n_elems + 1
                                              for m in self._meta]
        for r, k in ((DESC_PARENT_SLOT, "parent_slot"), (DESC_CTR0, "ctr0"),
                     (DESC_ACTOR, "actor"), (DESC_WIN_ACTOR, "win_actor"),
                     (DESC_WIN_SEQ, "win_seq"),
                     (DESC_ELEM_BASE, "elem_base")):
            desc[run_doc, r, run_col] = getattr(fast, k)
        desc[run_doc, DESC_HAS_VALUE, run_col] = 1
        desc[docs, DESC_META, META_N_ELEMS] = fast.n_pairs
        blob = np.zeros((D, N), np.int32)
        blob[_places(docs, fast.n_pairs)] = fast.blob

        # chain breaks for touched parents (stacked, one scatter): every
        # run of a document with a break
        touch = None
        broken = fast.n_breaks > 0
        if broken.any():
            T = bucket(int(fast.n_runs[broken].max()), 64)
            touch = np.zeros((D, 3, T), np.int32)
            touch[:, 1:] = -1
            on = np.repeat(broken, fast.n_runs)
            at = (run_doc[on], run_col[on])
            touch[at[0], 0, at[1]] = fast.parent_slot[on]
            touch[at[0], 1, at[1]] = fast.ctr0[on]
            touch[at[0], 2, at[1]] = fast.actor[on]
        if obs.ENABLED:
            obs.span("docset", "stack", _ts, args={
                "n_fast": len(fast.docs), "R": R, "N": N})
        _te = obs.now() if obs.ENABLED else 0
        if self.mesh is None:
            self._dev = self._expand_rows(
                self._ensure_dev(), self._put(desc), self._put(blob),
                None if touch is None else self._put(touch), out_cap)
        else:
            self._expand_on_mesh(desc, blob, touch, out_cap)
        if obs.ENABLED:
            obs.span("docset", "expand", _te, args={"out_cap": out_cap})
        self._cap = out_cap

        for d, n_pairs, n_runs in zip(fast.docs, fast.n_pairs.tolist(),
                                      fast.n_runs.tolist()):
            meta = self._meta[d]
            meta.n_elems += n_pairs
            if meta.mirror is not None:
                meta.seg_bound = max(meta.mirror.n_segs, 1)
            else:
                meta.seg_bound += 3 * n_runs + 2
        return self

    def _expand_rows(self, dev: dict, desc_t, blob_t, touch_t,
                     out_cap: int) -> dict:
        """The fast tier's round on (D', cap) table rows and their
        (D', 9, R) descriptors, (D', N) blobs and (D', 3, T) touches (or
        None): the dense run expansion, ONE `multi_scan` launch on
        (D' * 5, N), then the chain breaks. Returns the new tables."""
        from ..ops.ingest import (DESC_ACTOR, DESC_CTR0, DESC_ELEM_BASE,
                                  DESC_HAS_VALUE, DESC_META,
                                  DESC_PARENT_SLOT, DESC_WIN_ACTOR,
                                  DESC_WIN_SEQ, META_BASE_SLOT,
                                  META_N_ELEMS, break_chains_r,
                                  expand_runs_dense_r)
        expanded = expand_runs_dense_r(
            *(dev[k] for k in self._TABLE_KEYS), *(desc_t[:, r] for r in (
                DESC_PARENT_SLOT, DESC_CTR0, DESC_ACTOR, DESC_WIN_ACTOR,
                DESC_WIN_SEQ, DESC_ELEM_BASE)),
            desc_t[:, DESC_HAS_VALUE].bool(), blob_t,
            desc_t[:, DESC_META, META_N_ELEMS],
            desc_t[:, DESC_META, META_BASE_SLOT], out_cap=out_cap)
        tables = dict(zip(self._TABLE_KEYS, expanded))
        if touch_t is not None:
            tables["chain"] = break_chains_r(
                tables["chain"], tables["parent"], tables["ctr"],
                tables["actor"], touch_t[:, 0], touch_t[:, 1], touch_t[:, 2])
        return tables

    def _expand_on_mesh(self, desc, blob, touch, out_cap: int):
        """`_expand_rows` per doc group of a mesh set: the group's rows
        gather onto its first device, expand there, and scatter back as
        (doc, elem) blocks of `out_cap` columns."""
        from ..parallel import mesh as pm
        rows = {k: pm.gather(v, "elem") for k, v in self._ensure_dev().items()}
        per = self.n_docs // self.mesh.shape["doc"]
        out = {k: {} for k in self._TABLE_KEYS}
        for lead in rows["parent"]:
            dev = self.mesh.device(lead)
            sl = slice(lead[0] * per, (lead[0] + 1) * per)

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev)
            new = self._expand_rows(
                {k: rows[k][lead] for k in self._TABLE_KEYS}, put(desc),
                put(blob), None if touch is None else put(touch), out_cap)
            for k, t in new.items():
                out[k][lead] = t
        self._dev = {k: pm.scatter(self.mesh, out[k], "elem", ("doc", "elem"))
                     for k in self._TABLE_KEYS}

    def _apply_general(self, general: list):
        """Apply the graduated group: one stacked multi-object apply per
        call (engine/stacked.apply_stacked consumes the already-decoded
        batches), per-doc `apply_batch` when the stacked tier declines the
        population (single doc / tiny payload / skewed caps) or the set
        is on a mesh (its graduated docs live on their groups' devices)."""
        if self.mesh is None and len(general) >= 2:
            from . import stacked as _stacked
            if _stacked.apply_stacked(general):
                return
        for doc, batch in general:
            doc.apply_batch(batch)

    def _ready(self, d: int, b: TextChangeBatch, seqs: list):
        """Whether doc d's batch is fully causally ready for the fast
        tier: True; "skip" for a redelivery of applied changes (a no-op);
        False -> general engine (not ready, or a partial duplicate, which
        the general path filters). `seqs` are the batch's seqs as ints."""
        clock = self._meta[d].clock
        # the clock advances through the loop (`ahead` over the document's
        # clock), so sequential same-actor changes stay fast and any
        # duplicate — pre-applied or repeated within the batch — is
        # detected
        ahead: dict = {}
        dups = 0
        for row in range(b.n_changes):
            actor, seq = b.actors[row], seqs[row]
            have = ahead.get(actor, clock.get(actor, 0))
            if seq <= have:
                dups += 1
                continue
            for a, s in b.deps[row].items():
                if a != actor and ahead.get(a, clock.get(a, 0)) < s:
                    return False
            if have != seq - 1:
                return False
            ahead[actor] = seq
        if dups == b.n_changes:
            return "skip"
        return not dups

    def _plan_docs(self, order: list, walk):
        """The per-document planner over the round: `_plan_fast` on each
        ready document's cut of the walk; every other document graduates
        as it comes. The reference the doc-axis pass (`_plan_axis`) is
        held to, and the round's path where the pass declines it.
        Returns (the round's plan or None, the graduated group)."""
        plans = iter(walk.cut())
        packs: list = []
        general: list = []            # (graduated doc, batch)
        with obs.aggregate_only():
            for d, batch, ready in order:
                pack = (self._plan_fast(d, batch, next(plans))
                        if ready else None)
                if pack is None:
                    general.append((self._graduate(d), batch))
                else:
                    packs.append(pack)
        return (_FastRound.from_packs(packs) if packs else None), general

    #: pass slabs may hold this many bytes more than twice the rows' state
    #: before the next pass moves every row's state into a fresh one
    _SLAB_SLACK = 1 << 20

    def _slabs_pinned(self) -> bool:
        """Whether the pass's slabs still alive hold more than twice the
        bytes of the state they serve (plus `_SLAB_SLACK`): rows left
        behind by later rounds keep a whole slab alive."""
        alive = [r for r in self._slabs if r() is not None]
        self._slabs = alive
        held = sum(r().nbytes for r in alive)
        return held > 2 * sum(self._state_bytes) + self._SLAB_SLACK

    def _plan_axis(self, walked: list, walk):
        """The fast tier's planning of the round in ONE pass over the doc
        axis, in a fixed number of numpy calls: every walked document
        whose round is runs-only and whose new actors intern in order (an
        order change sends it to the general path, as in `_plan_fast`)
        is planned by one native pass (`native.AxisPass`) a stage:

        - `plan/index_merge`: its run heads' key ranges checked and merged
          into its index, tier for tier as `BatchRangeIndex.merge` does;
        - `docset/lookup`: its run parents through its staged index, and
          the run descriptors;
        - the transitive closures of its changes (`transitive_closure`, a
          change at a time);
        - `docset/mirror`: its segment mirror, as
          `SegmentMirror.apply_round` makes it.

        Every document's staged state and descriptors equal
        `_plan_fast`'s on that document alone. The new index tiers and
        mirrors are views of one slab each a round (the index slab read
        only); when the live slabs outgrow the state they hold
        (`_slabs_pinned`), the pass also copies every other stacked row's
        state into its slabs, so a row left behind keeps no old slab
        alive. Returns the round's plan (its `docs` may be empty; the
        walked documents not on it take the general path), or None when
        the pass declines the round: an input `_plan_fast` raises or
        degrades on (a duplicate element id, an unknown parent, a mirror
        update that fails, ...), which the caller then plans per
        document. Commits nothing but the moved rows' copies, and those
        only when every stage succeeded."""
        cols = walk.columns
        if any(cols[k].dtype != np.int32 for k in (1, 2, 3, 4, 6)):
            return self._declined()
        n_runs_w = np.diff(walk.h_cut)
        n_pairs_w = np.diff(walk.b_cut)
        plannable = ((np.diff(walk.r_cut) == 0) & (n_runs_w > 0)).tolist()
        sel: list = []                # walk position of each planned doc
        docs: list = []
        batches: list = []
        interned: list = []           # staged (actor_table, actor_rank)
        ranks: list = []
        row_ranks: list = []
        seqs: list = []
        rank_off, crow_off = [0], [0]
        tiers = ([], [], [])
        tier_len: list = []
        tier_off = [0]
        mirrors = ([], [], [], [])
        m_len: list = []
        n_elems: list = []

        def add_state(d, meta):
            index = meta.index
            if self._published[d] is not index:
                # a merge publishes its every tier read-only
                for run in index._runs:
                    for arr in run:
                        arr.setflags(write=False)
            for run in index._runs:
                for out, arr in zip(tiers, run):
                    out.append(arr)
                tier_len.append(len(run[0]))
            tier_off.append(len(tier_len))
            mirror = meta.mirror
            if mirror is None:
                m_len.append(-1)
            else:
                arrays = (mirror.heads, mirror.par, mirror.hctr,
                          mirror.hactor)
                n = len(arrays[0])
                if any(len(a) != n for a in arrays):
                    return False
                for out, arr in zip(mirrors, arrays):
                    out.append(arr)
                m_len.append(n)
            n_elems.append(meta.n_elems)
            return True

        for i, (d, b) in enumerate(walked):
            if not plannable[i]:
                continue
            meta = self._meta[d]
            actor_rank, staged = meta.actor_rank, None
            missing = [a for a in b.actor_table if a not in actor_rank]
            if missing:
                merged = sorted(set(meta.actor_table).union(missing))
                if meta.actor_table and \
                        merged[: len(meta.actor_table)] != meta.actor_table:
                    continue
                actor_rank = {a: k for k, a in enumerate(merged)}
                staged = (merged, actor_rank)
            try:
                row_ranks.extend(map(actor_rank.__getitem__, b.actors))
            except KeyError:
                return self._declined()    # an author the batch lacks
            if len(b.seqs) != b.n_changes or not add_state(d, meta):
                return self._declined()
            ranks.extend(map(actor_rank.__getitem__, b.actor_table))
            rank_off.append(len(ranks))
            seqs.append(b.seqs)
            crow_off.append(len(row_ranks))
            sel.append(i)
            docs.append(d)
            batches.append(b)
            interned.append(staged)
        # the rows whose state moves into this round's slabs as it is
        moved: list = []
        if docs and self._slabs_pinned():
            on = set(docs)
            moved = [d for d in range(self.n_docs)
                     if d not in on and d not in self._overlay]
            for d in moved:
                if not add_state(d, self._meta[d]):
                    return self._declined()
                rank_off.append(len(ranks))
                crow_off.append(len(row_ranks))
        n_docs = len(docs)
        if not n_docs:
            return _FastRound([], [], [], [], [], [None] * 6, None)

        def cat(parts, dtype):
            return (np.concatenate(parts).astype(dtype, copy=False)
                    if parts else np.empty(0, dtype))

        sel_a = np.asarray(sel, np.int64)
        n_runs = n_runs_w[sel_a]
        n_pairs = n_pairs_w[sel_a]
        every = n_docs == walk.n_docs
        run_off = np.zeros(n_docs + len(moved) + 1, np.int64)
        np.cumsum(n_runs, out=run_off[1: n_docs + 1])
        run_off[n_docs + 1:] = run_off[n_docs]
        if every:
            runs = slice(None)
            blob = walk.plan.blob
        else:
            runs = (np.repeat(walk.h_cut[sel_a] - run_off[:n_docs], n_runs)
                    + np.arange(run_off[-1]))
            blob = walk.plan.blob[np.repeat(np.isin(
                np.arange(walk.n_docs), sel_a), n_pairs_w)]
        hpos = walk.plan.hpos[runs]
        ta, tc, pa, pc = (cols[k][hpos] for k in (1, 2, 3, 4))
        row = cols[6][hpos] - np.repeat(walk.row_shift[sel_a], n_runs)
        row_seq = cat(seqs, np.int32)
        relocate = np.full(n_docs + len(moved), bool(moved), np.uint8)
        pass_ = native.AxisPass(n_docs + len(moved),
                                BatchRangeIndex._COMPACT_TIERS, (
            run_off, ta, tc, pa, pc, row,
            np.ascontiguousarray(walk.plan.run_len[runs]),
            np.ascontiguousarray(walk.head_slot[runs]),
            np.asarray(rank_off, np.int64), np.asarray(ranks, np.int64),
            np.asarray(crow_off, np.int64),
            np.asarray(row_ranks, np.int32), row_seq,
            np.asarray(tier_off, np.int64), np.asarray(tier_len, np.int64),
            *(cat(t, np.int64) for t in tiers),
            np.asarray(m_len, np.int64), *(cat(m, np.int64) for m in mirrors),
            np.asarray(n_elems, np.int64),
            np.append(n_pairs, np.zeros(len(moved), np.int64)), relocate))
        try:
            return self._run_axis(pass_, docs + moved, n_docs, batches,
                                  interned, row_seq.tolist(), n_runs,
                                  n_pairs, tc, blob,
                                  [walk.lt128[i] for i in sel])
        finally:
            pass_.close()

    def _declined(self):
        axis_plans["declined"] += 1
        return None

    def _run_axis(self, pass_, rows: list, n_docs: int, batches: list,
                  interned: list, seq_rows: list, n_runs, n_pairs, ctr0,
                  blob, ascii_: list):
        """`_plan_axis`'s stages on its native pass over `rows` (the
        planned documents, then the rows whose state only moves)."""
        _t0 = obs.now() if obs.ENABLED else 0
        merged = pass_.merge()
        if merged is None:
            return self._declined()
        keep, new_off, new_len, actor, slab = merged
        slab.setflags(write=False)
        self._slabs.append(weakref.ref(slab))
        s, l, z = slab
        keep, new_off, new_len = (keep.tolist(), new_off.tolist(),
                                  new_len.tolist())
        indexes = []
        o = 0
        for j, d in enumerate(rows):
            old = self._meta[d].index
            runs = old._runs[: keep[j]]
            for k in range(new_off[j], new_off[j + 1]):
                e = o + new_len[k]
                runs += ((s[o:e], l[o:e], z[o:e]),)
                o = e
            index = BatchRangeIndex()
            index._runs = runs
            index.n_ranges = sum(len(r[0]) for r in runs)
            if len(runs) == 1:
                index._flat = runs[0]
            if keep[j]:
                index._model = old._model
            indexes.append(index)
        if obs.ENABLED:
            obs.span("plan", "index_merge", _t0, args={
                "structure": "batch_tiers", "n_docs": n_docs,
                "n_new": len(ctr0), "n_moved": len(rows) - n_docs})

        _t0 = obs.now() if obs.ENABLED else 0
        looked = pass_.lookup()
        if looked is None:
            return self._declined()
        parent_slot, win_actor, win_seq, elem_base, n_breaks = looked
        # the probes the learned path counts: an index of one affine
        # range is its ε=0 model, which the pass's probe is; one whose
        # base run could hold a model was probed exactly
        site = _learned.RANGE_SITE
        if not site.demoted:
            for index, k in zip(indexes, n_runs.tolist()):
                base = index._runs[0][0]
                if len(index._runs) == 1 and len(base) == 1:
                    site.note(k, 0)
                elif len(base) >= _learned._MIN_KEYS:
                    site.note_exact()
        if obs.ENABLED:
            obs.span("docset", "lookup", _t0, args={"n_docs": n_docs})

        # transitive dependency closure per change (the graduated doc's
        # slow path needs it to judge causal coverage); a dep may
        # reference an earlier change of the batch, so close over its
        # staged entries as well
        clocks, closures = [], []
        c0 = 0
        for d, b in zip(rows, batches):
            n = b.n_changes
            actors, row_seq = b.actors, seq_rows[c0: c0 + n]
            c0 += n
            clocks.append(dict(zip(actors, row_seq)))
            all_deps = self._meta[d].all_deps
            staged: dict = {}
            if n > 1:
                all_deps = collections.ChainMap(staged, all_deps)
            for author, seq, deps in zip(actors, row_seq, b.deps):
                staged[(author, seq)] = transitive_closure(all_deps, author,
                                                           seq, deps)
            closures.append(staged)

        _t0 = obs.now() if obs.ENABLED else 0
        mirrored = pass_.mirror()
        if mirrored is None:
            return self._declined()
        m_len, slab = mirrored
        self._slabs.append(weakref.ref(slab))
        h, par, c, a = slab
        mirrors = []
        o = 0
        for n in m_len.tolist():
            if n < 0:
                mirrors.append(None)
                continue
            e = o + n
            mirrors.append(SegmentMirror(h[o:e], par[o:e], c[o:e], a[o:e]))
            o = e
        if obs.ENABLED:
            obs.span("docset", "mirror", _t0, args={"n_docs": n_docs})
        self._mirror_slab = None
        if rows == list(range(self.n_docs)) and (m_len >= 0).all():
            off = np.concatenate(([0], np.cumsum(m_len)))
            self._mirror_slab = (weakref.ref(slab), np.tile(off, (4, 1)))

        for d, index, mirror in zip(rows, indexes, mirrors):
            self._state_bytes[d] = 24 * index.n_ranges + (
                0 if mirror is None else 32 * len(mirror.heads))
        for d, index, mirror in zip(rows[n_docs:], indexes[n_docs:],
                                    mirrors[n_docs:]):
            self._meta[d].index = index
            self._meta[d].mirror = mirror
            self._published[d] = index
        axis_plans["rounds"] += 1
        axis_plans["docs"] += n_docs
        return _FastRound(
            rows[:n_docs], n_runs, n_pairs, n_breaks[:n_docs],
            list(zip(indexes, mirrors, clocks, closures, ascii_, interned)),
            (parent_slot, ctr0, actor, win_actor, win_seq, elem_base), blob)

    def _plan_fast(self, d: int, b: TextChangeBatch, plan):
        """Host planning for the stacked path of doc d's ready batch,
        given its `plan` (its cut of the round's run walk); None ->
        general engine.

        Pure: all state updates are staged in the returned pack and
        committed by apply_batches only after every doc's plan succeeds.
        Traced per stage: `docset/lookup` (the run parents through the
        merged index) and `docset/mirror`."""
        meta = self._meta[d]
        if len(plan.rpos) or plan.n_runs == 0:
            return None

        # intern actors; order change would need a remap -> general path
        staged_actors = None
        actor_rank = meta.actor_rank
        missing = sorted(set(a for a in b.actor_table
                             if a not in meta.actor_rank))
        if missing:
            merged = sorted(set(meta.actor_table) | set(missing))
            if meta.actor_table and \
                    merged[: len(meta.actor_table)] != meta.actor_table:
                return None
            actor_rank = {a: i for i, a in enumerate(merged)}
            staged_actors = (merged, actor_rank)

        batch_rank = np.asarray(
            [actor_rank[a] for a in b.actor_table], np.int64)
        row_rank = np.asarray([actor_rank[a] for a in b.actors], np.int32)
        row_seq = np.asarray(b.seqs, np.int32)
        hpos = plan.hpos
        ta, tc = b.op_target_actor, b.op_target_ctr
        pa, pc = b.op_parent_actor, b.op_parent_ctr

        try:
            staged_index = meta.index.merge(
                pack_keys(batch_rank[ta[hpos]], tc[hpos].astype(np.int64)),
                plan.run_len, plan.head_slot)
        except DuplicateElemId as e:
            rank, k_ctr = unpack_key(e.key)
            table = staged_actors[0] if staged_actors else meta.actor_table
            raise ValueError(
                f"Duplicate list element ID "
                f"{make_elem_id(table[rank], k_ctr)} "
                f"in {self.obj_ids[d]}") from None
        _t0 = obs.now() if obs.ENABLED else 0
        is_head = pa[hpos] == HEAD_PARENT
        keys = pack_keys(batch_rank[np.where(is_head, 0, pa[hpos])],
                         pc[hpos].astype(np.int64))
        slots, found = staged_index.lookup_learned(keys)
        if not (found | is_head).all():
            raise ValueError(
                f"ins references unknown parent element in {self.obj_ids[d]}")
        parent_slot = np.where(is_head, 0, slots)
        if obs.ENABLED:
            obs.span("docset", "lookup", _t0)

        # transitive dependency closure per change (the graduated doc's slow
        # path needs it to judge causal coverage); a dep may reference an
        # earlier in-batch change, so close over staged entries as well
        staged_all_deps: dict = {}
        combined = dict(meta.all_deps)
        for row in range(b.n_changes):
            actor, seq = b.actors[row], int(b.seqs[row])
            closure = transitive_closure(combined, actor, seq, b.deps[row])
            staged_all_deps[(actor, seq)] = closure
            combined[(actor, seq)] = closure

        # host segment mirror (same round inputs as the stacked chain
        # breaks); failure degrades THIS doc to the self-contained
        # materialization, never the round itself
        _t0 = obs.now() if obs.ENABLED else 0
        staged_mirror = None
        if meta.mirror is not None:
            try:
                staged_mirror = meta.mirror.apply_round(
                    plan.head_slot, parent_slot,
                    tc[hpos].astype(np.int64), batch_rank[ta[hpos]],
                    meta.n_elems + plan.n_pairs, staged_index.slot_to_key)
            except Exception:
                logger.warning(
                    "segment-mirror planning failed for %s (doc-set row %d)",
                    self.obj_ids[d], d, exc_info=True)
        if obs.ENABLED:
            obs.span("docset", "mirror", _t0)

        return {
            "d": d, "n_runs": plan.n_runs, "n_pairs": plan.n_pairs,
            "staged_mirror": staged_mirror,
            "parent_slot": parent_slot,
            "ctr0": tc[hpos], "actor": batch_rank[ta[hpos]],
            "win_actor": row_rank[b.op_change[hpos]],
            "win_seq": row_seq[b.op_change[hpos]],
            "elem_base": np.cumsum(plan.run_len) - plan.run_len,
            "blob": plan.blob,
            "n_breaks": int((~is_head).sum()),
            "staged_index": staged_index,
            "staged_clock": {b.actors[r]: int(b.seqs[r])
                             for r in range(b.n_changes)},
            "staged_all_deps": staged_all_deps,
            "staged_ascii": plan.blob_lt_128,
            "staged_actors": staged_actors,
        }

    # ------------------------------------------------------------------

    def _rebuild_row_mirror(self, d: int):
        """Heal path: reconstruct row d's segment mirror from its fetched
        chain/parent rows (None if that fails too). Traced as
        `read/rebuild`."""
        _t0 = obs.now() if obs.ENABLED else 0
        rows = self._rows(d)
        meta = self._meta[d]
        try:
            meta.mirror = SegmentMirror.rebuild(
                rows["chain"].cpu().numpy(), rows["parent"].cpu().numpy(),
                meta.n_elems, meta.index.slot_to_key)
        except Exception:
            logger.warning("mirror rebuild failed for doc-set row %d", d,
                           exc_info=True)
            meta.mirror = None
        if obs.ENABLED:
            obs.span("read", "rebuild", _t0, args={"row": d})

    @staticmethod
    def _fetch(t) -> np.ndarray:
        """A blocking fetch of the read path, traced as `read/wait`."""
        _t0 = obs.now() if obs.ENABLED else 0
        out = t.cpu().numpy()
        if obs.ENABLED:
            obs.span("read", "wait", _t0)
        return out

    def texts(self) -> dict:
        """Materialize every document: one stacked program + one fetch.

        When every stacked document has a live segment mirror, the
        HOST-PLANNED program runs (no per-doc sort or pointer doubling on
        the device); per-doc plan consistency is verified against the
        chain bits. A divergent or missing mirror is REBUILT from the real
        chain bits (the affected call serves through the self-contained
        program; the next call is planned again) and only drops to None if
        the rebuild itself fails.

        Traced as `read/texts`; inside it `read/plan` (every row's segment
        plan and mirror checksums, one native pass over the doc axis:
        `_plan_rows`), `read/wait` (each blocking fetch), `read/check`
        (the device's checksums against the pass's, one comparison over
        the rows), `read/rebuild` (the heal path, a row at a time) and
        `read/decode`. Counted in `axis_reads`."""
        from ..ops.ingest import (bucket, materialize_codes_planned_r,
                                  materialize_codes_r)

        _t0 = obs.now() if obs.ENABLED else 0
        out = {}
        stacked_idx = [d for d in range(self.n_docs)
                       if d not in self._overlay]
        if stacked_idx:
            if self._codes_cache is None:
                dev = self._ensure_dev()
                cols = tuple(dev[k] for k in ("parent", "ctr", "actor",
                                               "value", "has_value",
                                               "chain"))
                all_ascii = all(self._meta[d].all_ascii for d in stacked_idx)
                n_el = np.asarray([m.n_elems for m in self._meta], np.int32)
                if self.mesh is None:
                    n_el = self._put(n_el)
                else:
                    from ..parallel import mesh as pm
                    n_el = pm.shard(self.mesh, n_el, ("doc",))
                for d in stacked_idx:
                    # a row whose plan-time mirror update failed rebuilds
                    # here from its chain bits, so one bad round degrades
                    # one call, not the doc-set forever
                    if self._meta[d].mirror is None:
                        self._rebuild_row_mirror(d)
                planned = all(self._meta[d].mirror is not None
                              for d in stacked_idx)

                def run(S):
                    if self.mesh is not None:
                        return self._mesh_self_contained(cols, n_el, S,
                                                         all_ascii)
                    return materialize_codes_r(*cols, n_el, S=S,
                                               as_u8=all_ascii)

                if planned:
                    _tp = obs.now() if obs.ENABLED else 0
                    plans, checks, S = self._plan_rows()
                    if obs.ENABLED:
                        obs.span("read", "plan", _tp, args={
                            "S": S, "n_rows": len(stacked_idx)})
                    axis_reads["rows"] += len(stacked_idx)
                    if self.mesh is not None:
                        codes, scalars = self._mesh_planned(
                            cols, n_el, plans, S, all_ascii)
                    else:
                        codes, scalars = materialize_codes_planned_r(
                            *cols, n_el, self._put(plans), S=S,
                            as_u8=all_ascii)
                    scalars_np = self._fetch(scalars)  # (D, 5)
                    _tc = obs.now() if obs.ENABLED else 0
                    rows = np.asarray(stacked_idx, np.int64)
                    got = scalars_np[rows]
                    want = checks[rows]
                    bad = rows[(got[:, 1] != got[:, 2])
                               | (got[:, 3] != want[:, 0])
                               | (got[:, 4] != want[:, 1])].tolist()
                    if obs.ENABLED:
                        obs.span("read", "check", _tc,
                                 args={"n_bad": len(bad)})
                    if bad:
                        # rebuild diverged mirrors from the real chain bits
                        # (a small per-row fetch; None only if that fails),
                        # then serve THIS call via the self-contained program
                        logger.warning(
                            "segment mirror diverged for doc-set rows %s; "
                            "rebuilding and re-materializing", bad)
                        for d in bad:
                            self._rebuild_row_mirror(d)
                            self._meta[d].seg_bound = max(
                                int(scalars_np[d, 2]), 1)
                        planned = False
                    else:
                        axis_reads["planned"] += 1
                if not planned:
                    axis_reads["self_contained"] += 1
                    S = bucket(max(self._meta[d].seg_bound
                                   for d in stacked_idx) + 2, 64)
                    codes, scalars = run(S)
                    scalars_np = self._fetch(scalars)  # (D, 2): n_vis, n_segs
                    if (scalars_np[:, 1] + 2 > S).any():
                        S = bucket(int(scalars_np[:, 1].max()) + 2, 64)
                        codes, scalars = run(S)
                        scalars_np = self._fetch(scalars)
                for d in stacked_idx:
                    self._meta[d].seg_bound = int(scalars_np[d, 1])
                self._codes_cache = (self._fetch(codes), scalars_np[:, 0],
                                     all_ascii)
            fetched, n_vis, all_ascii = self._codes_cache
            _td = obs.now() if obs.ENABLED else 0
            for d in stacked_idx:
                row = fetched[d][: n_vis[d]]
                if all_ascii:
                    out[self.obj_ids[d]] = row.tobytes().decode("ascii")
                else:
                    out[self.obj_ids[d]] = "".join(
                        chr(v) for v in row.astype(np.uint32))
            if obs.ENABLED:
                obs.span("read", "decode", _td,
                         args={"n_docs": len(stacked_idx)})
        for d, doc in self._overlay.items():
            out[self.obj_ids[d]] = doc.text()
        if obs.ENABLED:
            obs.span("read", "texts", _t0, args={"n_docs": self.n_docs})
        return out

    def _plan_rows(self):
        """Every row's segment plan and mirror checksums, by one native
        pass over the doc axis (`native.segplan_axis`): -> (plans (D, 4,
        S), checks (D, 2): head, aux; S). The overlay (graduated) rows ride
        along with the empty mirror's plan; their stacked tables are stale
        and their output ignored. A row whose mirror the pass cannot plan
        (no true mirror: unsorted heads, a parent outside its tree) gets
        the empty mirror's plan too, which `read/check` refutes, so the row
        is healed. S is the largest mirror's length + 1 (n_segs + 2),
        bucketed.

        The pass reads the rows' mirror columns concatenated: the newest
        mirror slab itself (`_mirror_slab`) while every row's mirror is a
        view of it, else one copy a column."""
        from ..ops.ingest import bucket
        n_elems = [meta.n_elems for meta in self._meta]
        ref = self._mirror_slab
        slab = ref[0]() if ref is not None else None
        if slab is not None and not self._overlay and all(
                m.heads.base is slab and m.par.base is slab
                and m.hctr.base is slab and m.hactor.base is slab
                for m in (meta.mirror for meta in self._meta)):
            offsets = ref[1]
            columns = tuple(slab)
        else:
            empty = SegmentMirror.empty()
            heads, par, hctr, hactor = [], [], [], []
            for d, meta in enumerate(self._meta):
                if d in self._overlay:
                    m = empty
                    n_elems[d] = 0
                else:
                    m = meta.mirror
                heads.append(m.heads)
                par.append(m.par)
                hctr.append(m.hctr)
                hactor.append(m.hactor)
            parts = (heads, par, hctr, hactor)
            offsets = np.zeros((4, self.n_docs + 1), np.int64)
            for row, col in zip(offsets, parts):
                np.cumsum(np.fromiter(map(len, col), np.int64, self.n_docs),
                          out=row[1:])
            columns = tuple(np.concatenate(c) for c in parts)
        S = bucket(int(np.diff(offsets[0]).max()) + 1, 64)
        plans, checks = native.segplan_axis(offsets, *columns, n_elems, S)
        return plans, checks, S

    def _mesh_planned(self, cols, n_el, plans, S: int, as_u8: bool):
        """The planned materialization of a mesh set's rows, element-
        sharded (`sharded_planned_materialize_r`); (codes, scalars) on the
        host."""
        from ..parallel import mesh as pm
        codes, scalars = pm.sharded_planned_materialize_r(
            self.mesh, cols, n_el, pm.shard(self.mesh, plans, ("doc",)), S,
            as_u8)
        return pm.unshard(codes, "cpu"), pm.unshard(scalars, "cpu")

    def _mesh_self_contained(self, cols, n_el, S: int, as_u8: bool):
        """The self-contained materialization of a mesh set's rows: the
        segment scans on the blocks in place (`sharded_fused_scans`, row
        form), the rest on each group's rows gathered onto its first
        device; (codes, scalars) on the host."""
        from ..ops.ingest import _materialize_core_r
        from ..ops.scan_kernels import sharded_fused_scans
        from ..parallel import mesh as pm
        rank, _head, cumvis = sharded_fused_scans(self.mesh, cols[5], cols[4],
                                                  n_el)
        rows = [pm.gather(x, "elem") for x in (*cols, rank, cumvis)]
        out = [_materialize_core_r(*(x[lead] for x in rows[:6]),
                                   n_el.blocks[lead], S, False, as_u8,
                                   scans=(rows[6][lead], rows[7][lead]))
               for lead in sorted(rows[0])]
        return (torch.cat([o[0].cpu() for o in out]),
                torch.cat([o[1].cpu() for o in out]))
