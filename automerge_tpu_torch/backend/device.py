"""Device-engine backend behind the frontend↔backend protocol seam.

The port's public API serves documents from the port's engines on a CUDA
card through the same plain-JSON change/patch protocol as the oracle
backend (the reference's backend-injection seam, reference
frontend/index.js:110-114, src/automerge.js:20-29).

Scope and strategy — device-first with graduation:

- **Arbitrary document trees ride the device.** The root map and every
  ``makeMap``/``makeTable`` object are ``DeviceMapDoc`` register tables;
  every ``makeText``/``makeList`` object is a ``DeviceTextDoc`` columnar
  element table; ``link`` ops store interned child-object references in the
  owning object's registers (map keys or list elements), mirroring the
  reference's uniform link handling (reference backend/op_set.js:196-258).
  Paths resolve host-side by walking winning link values from the root.
- **One lineage, one device.** ``_DeviceCore(device)`` holds the device
  its engines live on; every engine it builds, every fork and every
  restore inherits it. A backend namespace is bound to one device:
  ``DeviceBackend`` is the card (``device=None``; without one, ``init()``
  raises the engine's "no CUDA device" error), and ``backend_for("cpu")``
  gives a namespace whose documents run the engines' plain PyTorch
  versions on the CPU. Nothing falls back from the card to the CPU.
- **Undo/redo run on the device tier too**: inverse ops are captured
  host-side at local-change apply time (from the mirrors/conflict map —
  the reference captures inside applyAssign, op_set.js:201-213), and
  undo/redo requests re-apply them through the normal batch path.
- **Only unknown op shapes graduate.** A delivery containing ops outside
  the device grammar replays the delivery log into the oracle backend
  (``facade.py``) and hands the lineage over. Semantics are identical
  either way; graduation is a performance cliff, not a behavior change —
  and it is SURFACED: each graduation logs via
  ``logging.getLogger("automerge_tpu_torch.backend.device")`` and
  increments the module-level ``GRADUATION_STATS`` counters so users can
  tell which tier served them.

Patches are **net diffs**: instead of the reference's per-op incremental diff
emission (skip-list order statistics per op, op_set.js:144-171), the device
applies a whole batch, then one vectorized pass compares the before/after
element tables and emits remove/insert/set diffs with sequentially-correct
indexes (removes at descending old indexes, inserts at ascending final
indexes). The diff *sequence* differs from the reference's, but patches are
document-transformers, and the resulting document is identical. The
engines' host reads (``_mirrors``, ``_positions``, ``visible_order``) are
numpy, each fetched with one counted sync (engine/accounting.py), so the
diffing here is host numpy on either device.

States are immutable views ``(shared core, version)`` like the oracle's
command-log design (facade.py): applying to a stale state forks the core by
deterministic replay of the delivery log, on the core's device.
"""

from __future__ import annotations

import bisect
import logging
from typing import Optional

import numpy as np
import torch

from .. import obs
from .._common import ROOT_ID, transitive_deps
from ..engine.base import resolve_device
from ..resilience.validation import prevalidated, validate_changes
from . import facade as _oracle
from .facade import BackendState as _OracleState

logger = logging.getLogger("automerge_tpu_torch.backend.device")

# obj kinds minted by each make action (reference op_set.js applyMake :63-82)
_MAKE_KIND = {"makeMap": "map", "makeTable": "table",
              "makeText": "text", "makeList": "list"}
_MAKES = tuple(_MAKE_KIND)

#: How often (and why) lineages left the device tier. Key: reason string
#: ("out_of_scope"). Reset-able by tests.
GRADUATION_STATS: dict = {}


def _graduate_signal(reason: str, detail: str = ""):
    GRADUATION_STATS[reason] = GRADUATION_STATS.get(reason, 0) + 1
    logger.info("device lineage graduating to oracle backend: %s%s",
                reason, f" ({detail})" if detail else "")


def _in_scope(changes, known_kinds) -> bool:
    """True iff every op stays within the device shape: makes of any kind,
    link/set/del/inc on known objects, ins on known list/text objects.
    `known_kinds` maps object id -> kind at the target state.

    ONE pass over the delivery (bulk deliveries carry 100k+ op dicts, and
    this gate runs before every apply): causal admission may apply a make
    delivered after an op that references it in this same list, so
    membership checks that fail at walk time are DEFERRED and re-checked
    against the fully-collected makes at the end. Equivalent to the old
    collect-makes-first two-pass formulation for every input: membership
    (`obj in known`) is monotone — keys are never removed, so a walk-time
    pass can never become a final fail and every walk-time fail gets the
    full-knowledge re-check — while the KIND predicate on ins targets is
    NOT monotone (a later make can overwrite the kind), so every ins
    target is deferred unconditionally and judged only on final kinds."""
    known = dict(known_kinds)
    deferred_objs: set = set()   # must be known once all makes are seen
    ins_objs: set = set()        # must end up known AND text/list
    for change in changes:
        for op in change.get("ops", ()):
            action = op.get("action")
            obj = op.get("obj")
            if action in _MAKE_KIND:
                if obj is None:
                    # an obj-less make must NOT register known[None]: a
                    # later obj-less set/del would then pass the scope
                    # gate on a nonsense pairing — out of scope instead,
                    # so the oracle tier rejects it properly
                    return False
                known[obj] = _MAKE_KIND[action]
            elif action == "link":
                if obj != ROOT_ID and obj not in known:
                    deferred_objs.add(obj)
                if op.get("value") not in known:
                    deferred_objs.add(op.get("value"))
            elif action == "ins":
                ins_objs.add(obj)
            elif action in ("set", "del", "inc"):
                if obj != ROOT_ID and obj not in known:
                    deferred_objs.add(obj)
            else:
                return False
    return (all(obj in known for obj in deferred_objs)
            and all(known.get(obj) in ("text", "list")
                    for obj in ins_objs))


_transitive = transitive_deps  # shared closure (see _common.transitive_deps)


def _clean(change: dict) -> dict:
    if "requestType" in change or "undoable" in change:
        return {k: v for k, v in change.items()
                if k not in ("requestType", "undoable")}
    return change


def _sub_change(change: dict, ops: list) -> dict:
    return {"actor": change["actor"], "seq": change["seq"],
            "deps": change.get("deps", {}), "ops": ops}


_DELETED = object()   # overlay sentinel: register emptied by a pending del


class _TextOverlay:
    """Host view of one text/list object while local rounds are pending
    (the write-behind fast path, INTERNALS §4.8): element order and
    visibility by position, plus every pending register write, kept
    WITHOUT device work. Built once from the device state, advanced
    incrementally per local change, discarded at flush."""

    __slots__ = ("order", "vis", "writes", "path")

    def __init__(self, order: np.ndarray, vis: np.ndarray):
        self.order = order          # int64[n] packed (actor_rank, ctr)
        self.vis = vis              # bool[n], aligned with order
        self.writes: dict = {}      # elemId -> {"value":..} | _DELETED
        self.path = False           # object's root path, resolved lazily
                                    # (False = not yet; stable while the
                                    # overlay lives: links cannot change
                                    # without an engine apply, which
                                    # discards the overlay)

    @classmethod
    def build(cls, doc) -> "_TextOverlay":
        """One positions+mirrors read of the CURRENT device state (the
        only device interaction the overlay ever does)."""
        n = doc.n_elems
        if n == 0:
            return cls(np.empty(0, np.int64), np.empty(0, bool))
        from ..engine.host_index import pack_keys
        pos = np.asarray(doc._positions()[1:])
        order_slot = np.empty(n, np.int64)
        order_slot[pos] = np.arange(1, n + 1)
        h = doc._mirrors()
        actor, ctr = doc.index.slot_to_key(order_slot)
        order = pack_keys(actor.astype(np.int64), ctr.astype(np.int64))
        vis = np.array(h["has_value"], bool)[order_slot]
        return cls(order, vis)

    def pos_of(self, packed: int) -> int:
        """Raw position of an element (vectorized scan); -1 if absent."""
        hit = np.flatnonzero(self.order == packed)
        return int(hit[0]) if hit.size else -1


class _TextObj:
    """Host wrapper for one device text/list object + diffing snapshots."""

    __slots__ = ("kind", "doc", "max_elem", "prev_n", "prev_vis",
                 "prev_value", "prev_conf", "announced", "ov",
                 "_pool_scan")

    def __init__(self, obj_id: str, kind: str, device,
                 capacity_hint: int = 64):
        from ..engine.text_doc import DeviceTextDoc
        self.kind = kind                     # "text" | "list"
        self.doc = DeviceTextDoc(obj_id, capacity=capacity_hint,
                                 device=device)
        self.max_elem = 0
        self.prev_n = 0                      # n_elems at last snapshot
        self.prev_vis = np.zeros(1, bool)    # slot-aligned visibility
        self.prev_value = np.zeros(1, np.int32)
        self.prev_conf: dict = {}            # slot -> conflict signature
        self.announced = False               # create diff emitted?
        self.ov: Optional[_TextOverlay] = None   # live while rounds pend
        self._pool_scan = (0, False)         # (pool len scanned, has links)

    def pool_has_links(self) -> bool:
        """Whether any pooled value is a link — scanned incrementally
        (pool entries only ever append), so the per-keystroke fast-path
        eligibility check and `_link_children` stay O(new entries)."""
        pool = self.doc.value_pool
        n, hit = self._pool_scan
        if hit or len(pool) == n:
            return hit
        hit = any(e.get("link") for e in pool[n:])
        self._pool_scan = (len(pool), hit)
        return hit

    def conflict_sig(self) -> dict:
        """Comparable, decode-free conflict snapshot: slot -> tuple of
        (actor_id, raw value ref, counter flag)."""
        doc = self.doc
        return {s: tuple((doc.actor_table[o["actor_rank"]], o["value"],
                          o["counter"]) for o in ops)
                for s, ops in doc.conflicts.items() if ops}

    def snapshot(self):
        doc = self.doc
        n = doc.n_elems
        h = doc._mirrors() if n else {"has_value": np.zeros(1, bool),
                                      "value": np.zeros(1, np.int32)}
        self.prev_n = n
        self.prev_vis = np.array(h["has_value"][: n + 1], bool)
        self.prev_value = np.array(h["value"][: n + 1], np.int32)
        self.prev_conf = self.conflict_sig()


class _MapOverlay:
    """Pending-register view of one map/table object (write-behind fast
    path, INTERNALS §4.8): maps need no positions — just the pending
    writes and the object's cached root path."""

    __slots__ = ("writes", "path")

    def __init__(self):
        self.writes: dict = {}      # key -> {"value":..} | _DELETED
        self.path = False           # resolved lazily; stable while alive
                                    # (link-overwriting rounds are
                                    # ineligible, so reachability is
                                    # frozen until the next engine apply)


class _MapObj:
    """Host wrapper for one device map/table object + diffing snapshot
    (the root map is `_MapObj(ROOT_ID, "map")`)."""

    __slots__ = ("kind", "doc", "max_elem", "prev", "announced", "ov")

    def __init__(self, obj_id: str, kind: str, device,
                 capacity_hint: int = 16):
        from ..engine.map_doc import DeviceMapDoc
        self.kind = kind                     # "map" | "table"
        self.doc = DeviceMapDoc(obj_id, capacity=capacity_hint,
                                device=device)
        self.max_elem = 0                    # uniform wrapper interface
        self.prev: dict = {}                 # key -> (raw value, conflict sig)
        self.announced = False
        self.ov: Optional[_MapOverlay] = None    # live while rounds pend

    def current(self) -> dict:
        doc = self.doc
        h = doc._mirrors()
        conf = {}
        for s, ops in doc.conflicts.items():
            if ops:
                conf[s] = tuple((doc.actor_table[o["actor_rank"]],
                                 o["value"], o["counter"]) for o in ops)
        out = {}
        for key, slot in doc._key_slot.items():
            if h["has_value"][slot]:
                out[key] = (int(h["value"][slot]), conf.get(slot))
        return out


class _DeviceCore:
    """Shared mutable engine state for one document lineage, on one
    device (`None` is the CUDA card; see `engine.base.resolve_device`)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.states: dict = {}               # actor -> [{change, allDeps}]
        self.history: list = []              # applied changes, application order
        self.queue: list = []
        self.clock: dict = {}
        self.deps: dict = {}
        self.undo_pos = 0
        self.undo_stack: list = []           # op-lists (inverse ops)
        self.redo_stack: list = []
        self.objects: dict = {}              # obj_id -> _TextObj | _MapObj
        self.obj_order: list = []            # creation order
        self.root = _MapObj(ROOT_ID, "map", self.device)
        self.commands: list = []             # delivery log for fork/replay
        self._cv = None                      # (actors, lens) vector cache
        self.actor_rank: dict = {}           # actor -> dense rank (states order)
        self.pending: list = []              # fast-path local changes not
                                             # yet replayed into the engine
        self._pending_routed: list = []      # aligned (change, by_obj,
                                             # root_ops) routing triples,
                                             # cached at fast-apply time so
                                             # the flush replay never
                                             # re-walks the ops

    def clock_vectors(self):
        """(actors list, per-actor applied-change counts as int64 vector),
        ranks in `states` insertion order; cached until the next admit."""
        if self._cv is None:
            actors = list(self.states)
            self.actor_rank = {a: i for i, a in enumerate(actors)}
            lens = np.asarray([len(self.states[a]) for a in actors],
                              np.int64)
            self._cv = (actors, lens)
        return self._cv

    # -- admission (mirror of op_set.js addChange/applyQueuedOps) -------

    def _admit(self, change: dict, creations: dict) -> bool:
        actor, seq = change["actor"], change["seq"]
        prior = self.states.get(actor, [])
        if seq <= len(prior):
            if prior[seq - 1]["change"] != change:
                raise RuntimeError(
                    f"Inconsistent reuse of sequence number {seq} by {actor}")
            return False  # idempotent duplicate
        base = dict(change.get("deps", {}))
        base[actor] = seq - 1
        all_deps = _transitive(self.states, base)
        if any(op.get("action") in _MAKE_KIND
               for op in change.get("ops", ())):
            creations[(actor, seq)] = dict(self.clock)
        self.states.setdefault(actor, []).append(
            {"change": change, "allDeps": all_deps})
        self._cv = None                      # clock vectors are stale
        new_deps = {a: s for a, s in self.deps.items()
                    if s > all_deps.get(a, 0)}
        new_deps[actor] = seq
        self.deps = new_deps
        self.clock[actor] = seq
        self.history.append(change)
        return True

    def _ready(self, change: dict) -> bool:
        deps = dict(change.get("deps", {}))
        deps[change["actor"]] = change["seq"] - 1
        return all(self.clock.get(a, 0) >= s for a, s in deps.items())

    # -- application ----------------------------------------------------

    def apply(self, changes, undoable: bool, is_local: bool = False) -> list:
        """Admit + distribute + diff one delivery. Returns patch diffs.

        `is_local` marks a change originated by THIS document's frontend
        (apply_local_change / undo / redo); local changes may always try
        the write-behind fast path. A remote delivery may ride it ONLY
        when its dep closure covers the whole current document clock
        (`_try_fast_remote`): then nothing can be concurrent with it and
        the engine's concurrency resolution (covering checks, add-wins,
        RGA sibling ordering) is trivially vacuous. Any other remote
        delivery takes the engine."""
        frame = None
        if hasattr(changes, "batch") and hasattr(changes, "n_ops"):
            # a decoded binary wire delivery (engine/wire_format.py):
            # admission/history run on its canonical dict view; the
            # decoded batch rides through to the engine when the whole
            # frame admits cleanly (_distribute_frame)
            frame = changes
            changes = frame.changes()
        changes = [_clean(c) for c in changes]
        # frames are bulk by construction (the encode-side min-ops gate):
        # the interactive write-behind overlay would just defer a dict
        # window decode to flush_pending — the decoded batch is already
        # in hand, so frames go straight to the engine
        if frame is None and len(changes) == 1 and not self.queue:
            if is_local:
                fast = self._try_fast_local(changes[0], undoable)
            else:
                fast = self._try_fast_remote(changes[0])
            if fast is not None:
                return fast
        # anything the fast path cannot serve first replays pending local
        # rounds into the engine so device state is current again
        self.flush_pending()
        t0 = obs.now() if obs.ENABLED else 0
        local = changes[0] if (undoable and changes) else None
        queued_before = bool(self.queue)
        self.queue.extend(changes)
        applied: list = []
        creations: dict = {}                 # (actor, seq) -> clock before
        while True:
            rest = []
            progress = False
            for ch in self.queue:
                if self._ready(ch):
                    if self._admit(ch, creations):
                        applied.append(ch)
                    progress = True
                else:
                    rest.append(ch)
            self.queue = rest
            if not progress:
                break
        if local is not None and local in applied:
            self._push_undo(self._capture_inverse(local))
        if obs.ENABLED:
            obs.span("backend", "admit", t0, args={
                "changes": len(changes), "applied": len(applied)})
            t0 = obs.now()
        out = None
        if frame is not None and not queued_before and not self.queue \
                and len(applied) == frame.n_changes:
            # whole-frame admission (no prior queue, no leftovers, no
            # duplicates): hand the decoded batch straight to the target
            # engine doc — the zero-copy ingest lane (INTERNALS §17)
            out = self._distribute_frame(applied, frame)
        if out is None:
            out = self._distribute(applied, creations)
        touched, created = out
        if obs.ENABLED:
            obs.span("backend", "distribute", t0, args={
                "objects": len(touched) + len(created)})
            t0 = obs.now()
        diffs = self._emit_diffs(touched, created)
        if obs.ENABLED:
            obs.span("backend", "diffs", t0, args={"diffs": len(diffs)})
        return diffs

    def _distribute_frame(self, applied, frame):
        """Feed a one-object binary-frame delivery to its engine doc as
        the decoded columnar batch: no window dicts, no per-op routing
        walk, no re-decode — ``prepare_batch`` consumes the frame's
        zero-copy views directly (and the stacked/cross-doc tiers see
        the batch through the same ``apply_batch`` seam). Returns None
        when the frame's object kind does not match the wrapper (the
        caller falls back to the generic routed walk, which materializes
        windows and preserves exact parity)."""
        obj = frame.obj_id
        wrapper = self.root if obj == ROOT_ID else self.objects.get(obj)
        if wrapper is None:
            # same failure as the routing walk's use-before-make branch
            raise ValueError(f"Modification of unknown object {obj}")
        batch = frame.batch()
        is_text_frame = hasattr(batch, "op_target_actor")
        if is_text_frame != isinstance(wrapper, _TextObj):
            return None
        wrapper.ov = None
        if is_text_frame:
            from .._common import KIND_INS
            ins = batch.op_kind == KIND_INS
            if bool(ins.any()):
                wrapper.max_elem = max(
                    wrapper.max_elem, int(batch.op_target_ctr[ins].max()))
        wrapper.doc.apply_batch(batch)
        # bulk causal advance for every doc the delivery never touched
        # (identical to the _distribute_routed tail)
        entries = {}
        clock_delta: dict = {}
        for ch in applied:
            actor, seq = ch["actor"], ch["seq"]
            entries[(actor, seq)] = self.states[actor][seq - 1]["allDeps"]
            if seq > clock_delta.get(actor, 0):
                clock_delta[actor] = seq
        quiet = [self.objects[oid].doc for oid in self.obj_order
                 if oid != obj]
        if obj != ROOT_ID:
            quiet.append(self.root.doc)
        for doc in quiet:
            doc._all_deps.update(entries)
            clock = doc.clock
            for a, s in clock_delta.items():
                if s > clock.get(a, 0):
                    clock[a] = s
        return {obj}, []

    def _capture_inverse(self, local: dict) -> list:
        """Inverse-op capture: the reference captures inside applyAssign
        (op_set.js:201-213), i.e. each op sees the previous ops of the
        SAME change already applied. Simulate that with an as-applied
        overlay: a local change causally covers the whole current
        state, so after a set/link the register is exactly [that op],
        after a del it is empty, and an inc folds into covered
        counter values. Pre-state reads come from _field_ops."""
        inverse: list = []
        seen: dict = {}    # (obj, key) -> simulated register op list
        for op in local.get("ops", ()):
            action = op.get("action")
            if action not in ("set", "del", "link", "inc"):
                continue
            k = (op["obj"], op["key"])
            cur = seen.get(k)
            if cur is None:
                cur = self._field_ops(op["obj"], op["key"])
            if action == "inc":
                inverse.append({"action": "inc", "obj": op["obj"],
                                "key": op["key"], "value": -op["value"]})
                seen[k] = [
                    {**o, "value": o["value"] + op["value"]}
                    if o.get("datatype") == "counter" else o
                    for o in cur]
                continue
            inverse.extend(cur or [{"action": "del", "obj": op["obj"],
                                    "key": op["key"]}])
            if action == "del":
                seen[k] = []
            else:
                rec = {"action": action, "obj": op["obj"],
                       "key": op["key"], "value": op["value"]}
                if op.get("datatype"):
                    rec["datatype"] = op["datatype"]
                seen[k] = [rec]
        return inverse

    def _push_undo(self, inverse: list):
        self.undo_stack = self.undo_stack[: self.undo_pos] + [inverse]
        self.undo_pos += 1
        self.redo_stack = []   # a fresh change invalidates pending redos

    # -- write-behind fast path (INTERNALS §4.8) ------------------------
    #
    # Small LOCAL rounds in the three interactive shapes — a chained
    # typing run (ins+set pairs), a contiguous delete run, a single set —
    # are served entirely on the host: causal admission, op-wise diff
    # emission against a position/visibility overlay, and undo capture,
    # with the change queued for deferred engine replay. The device is
    # caught up (`flush_pending`) before anything the overlay cannot
    # answer. Reference shape being matched: per-op application + diff
    # emission, op_set.js:283-300.

    _FAST_MAX_OPS = 512

    def _try_fast_remote(self, change: dict):
        """A remote delivery whose dep closure covers the WHOLE current
        document is a frontier extension: nothing in the document can be
        concurrent with it, so LWW/add-wins resolution and RGA sibling
        ordering are all trivial — exactly the contract a local change
        has by construction. Those deliveries (the shape of every quiet
        author->peers fan-out: each received keystroke covers the
        receiving replica) may ride the same write-behind fast path,
        cutting steady remote apply from ~2.3 ms to the local path's
        sub-ms. Anything not covering, multi-change, queued, or outside
        the fast shapes falls to the engine as before. Never undoable:
        the reference's undo stack records local operations only."""
        return self._try_fast_local(change, undoable=False,
                                    require_covered=True)

    def _try_fast_local(self, change: dict, undoable: bool,
                        require_covered: bool = False):
        """Serve one local change host-side; None -> take the device path.

        ``require_covered`` (the remote entry): after the cheap shape
        gates, the change must cover the whole document clock — computed
        lazily at the per-shape gates below (never before the shape
        classification: ineligible deliveries must not pay the closure)."""
        ops = change.get("ops", ())
        if not ops or len(ops) > self._FAST_MAX_OPS:
            return None
        actor, seq = change.get("actor"), change.get("seq")
        if not isinstance(actor, str) or not isinstance(seq, int):
            return None
        if seq != len(self.states.get(actor, ())) + 1 \
                or not self._ready(change):
            # duplicates/queued deliveries keep the general machinery
            return None
        covered = None
        obj = ops[0].get("obj")
        if any(op.get("obj") != obj for op in ops):
            # multi-object rounds: eligible only when EVERY target is a
            # map/table register object (the nested-board edit shape)
            wrappers = {}
            for op in ops:
                o = op.get("obj")
                if o not in wrappers:
                    w = self.root if o == ROOT_ID else self.objects.get(o)
                    if not isinstance(w, _MapObj):
                        return None
                    wrappers[o] = w
            return self._try_fast_map(change, ops, actor, seq, wrappers,
                                      undoable, covered)
        wrapper = self.root if obj == ROOT_ID else self.objects.get(obj)
        if isinstance(wrapper, _MapObj):
            return self._try_fast_map(change, ops, actor, seq,
                                      {obj: wrapper}, undoable, covered)
        if not isinstance(wrapper, _TextObj):
            return None
        doc = wrapper.doc
        if doc.conflicts or doc.queue or wrapper.pool_has_links():
            return None     # conflict semantics / links: device path
        rank = doc._actor_rank.get(actor)
        if rank is None:
            return None     # first change by this actor interns on the
                            # device path; later ones ride the overlay

        shape = self._fast_shape(ops, actor, wrapper)
        if shape is None:
            return None
        kind_, payload = shape
        if require_covered or kind_ in ("del_run", "set_run"):
            if covered is None:
                covered = self._covers_doc(change, actor, seq)
            if not covered:
                return None

        if wrapper.ov is None:
            wrapper.ov = _TextOverlay.build(doc)
        ov = wrapper.ov
        plan = self._fast_plan(kind_, payload, ov, doc)
        if plan is None:
            # the change falls to the device path, which will mutate the
            # engine: a kept overlay would go stale (and with no pending
            # rounds, nothing else clears it)
            if not self.pending:
                wrapper.ov = None
            return None

        if not self._admit(change, {}):
            return []        # idempotent duplicate: nothing to do
        if undoable:
            if kind_ == "ins_run":
                # every set targets an element this change mints, so the
                # generic capture would read an empty register for each:
                # the inverse is one del per new element, directly
                inverse = [{"action": "del", "obj": obj,
                            "key": f"{actor}:{e}"} for e in plan[1]]
                self._push_undo(inverse)
            else:
                self._push_undo(self._capture_inverse(change))
        diffs = self._fast_execute(kind_, plan, wrapper, obj, ov, actor,
                                   rank)
        self.pending.append(change)
        self._pending_routed.append((change, {obj: list(ops)}, []))
        return diffs

    def _covers_doc(self, change: dict, actor: str, seq: int) -> bool:
        """Whether the change's dep closure covers the WHOLE document
        clock: deletes/overwrites are unconditional only then (true for
        real local changes by construction); anything else needs the
        engine's add-wins/LWW resolution."""
        base = dict(change.get("deps", {}))
        if seq > 1:
            base[actor] = seq - 1
        closure = _transitive(self.states, base)
        return not any(s > closure.get(a, 0)
                       for a, s in self.clock.items())

    def _try_fast_map(self, change, ops, actor, seq, wrappers: dict,
                      undoable, covered=None):
        """Map/table register rounds: set/del across one or more map
        objects — the nested interactive shape (board field edits touch
        the card map AND its meta map in one change). No positions, so
        each overlay is just the pending writes; rounds that would
        overwrite a LINK value are ineligible (reachability must stay
        frozen while path caches live)."""
        for w in wrappers.values():
            if w.doc.conflicts or w.doc.queue:
                return None
        recs = []
        for op in ops:
            action = op.get("action")
            key = op.get("key")
            if action not in ("set", "del") or not key \
                    or not isinstance(key, str):
                return None
            if action == "set" and isinstance(op.get("value"), dict):
                return None
            recs.append((op["obj"], action, key, op.get("value"),
                         op.get("datatype")))
        if covered is None:
            covered = self._covers_doc(change, actor, seq)
        if not covered:
            return None
        # current register of every touched key must not hold a link
        # (overwriting one changes reachability under live path caches)
        for o, _, key, _, _ in recs:
            for cur in self._field_ops(o, key):
                if cur.get("action") == "link":
                    return None

        if not self._admit(change, {}):
            return []
        if undoable:
            self._push_undo(self._capture_inverse(change))
        diffs = []
        paths = None   # one BFS per round at most, shared by fresh overlays
        for o, action, key, value, dt in recs:
            wrapper = wrappers[o]
            if wrapper.ov is None:
                wrapper.ov = _MapOverlay()
            ov = wrapper.ov
            if ov.path is False:
                if o == ROOT_ID:
                    ov.path = []
                else:
                    if paths is None:
                        paths = self._paths()
                    ov.path = paths.get(o)
            typ = wrapper.kind
            if action == "set":
                diff = {"action": "set", "obj": o, "type": typ,
                        "key": key, "value": value, "path": ov.path}
                if dt:
                    diff["datatype"] = dt
                rec = {"value": value}
                if dt:
                    rec["datatype"] = dt
                ov.writes[key] = rec
            else:
                diff = {"action": "remove", "obj": o, "type": typ,
                        "key": key, "path": ov.path}
                ov.writes[key] = _DELETED
            diffs.append(diff)
        self.pending.append(change)
        by_obj: dict = {}
        root_ops: list = []
        for op in ops:
            if op["obj"] == ROOT_ID:
                root_ops.append(op)
            else:
                by_obj.setdefault(op["obj"], []).append(op)
        self._pending_routed.append((change, by_obj, root_ops))
        return diffs

    def _fast_shape(self, ops, actor: str, wrapper: "_TextObj"):
        """Classify ops as one of the fast shapes; None if anything else."""
        first = ops[0]
        a0 = first.get("action")
        if a0 == "ins":
            # chained typing run: ins(parent, e0), set(actor:e0, v0),
            # ins(actor:e0, e1), set(actor:e1, v1), ...
            if len(ops) % 2 or first.get("elem") is None \
                    or first["elem"] <= wrapper.max_elem:
                return None
            elems, values = [], []
            prev_key = first.get("key")
            for i in range(0, len(ops), 2):
                ins_op, set_op = ops[i], ops[i + 1]
                e = ins_op.get("elem")
                if (ins_op.get("action") != "ins"
                        or set_op.get("action") != "set"
                        or e is None
                        or (elems and e != elems[-1] + 1)
                        or ins_op.get("key") !=
                        (prev_key if i == 0 else f"{actor}:{elems[-1]}")
                        or set_op.get("key") != f"{actor}:{e}"
                        or isinstance(set_op.get("value"), dict)):
                    return None
                elems.append(e)
                values.append((set_op.get("value"),
                               set_op.get("datatype")))
            return ("ins_run", (first.get("key"), elems, values))
        if a0 == "del":
            keys = []
            for op in ops:
                if op.get("action") != "del" or not op.get("key"):
                    return None
                keys.append(op["key"])
            return ("del_run", keys)
        if a0 == "set":
            # one or more register re-assertions on EXISTING elements —
            # singly from interactive .set, in runs from redo (do_undo
            # captures the whole field set it re-applies)
            sets = []
            for op in ops:
                if op.get("action") != "set" or not op.get("key") \
                        or isinstance(op.get("value"), dict):
                    return None
                sets.append((op["key"], (op.get("value"),
                                         op.get("datatype"))))
            return ("set_run", sets)
        return None

    @staticmethod
    def _fast_packed(doc, elem_key: str):
        """elemId string -> packed (rank, ctr) in the owning doc's actor
        space (the overlay's order encoding); None when unparseable or
        the actor is unknown to this doc."""
        from .._common import parse_elem_id
        try:
            actor, ctr = parse_elem_id(elem_key)
        except Exception:
            return None
        rank = doc._actor_rank.get(actor)
        if rank is None:
            return None
        return (int(rank) << 32) | int(ctr)

    def _fast_plan(self, kind_, payload, ov: "_TextOverlay", doc):
        """Resolve every referenced element BEFORE mutating anything;
        None -> ineligible (device path)."""
        if kind_ == "ins_run":
            parent_key, elems, values = payload
            if parent_key == "_head":
                p = -1
            else:
                pk = self._fast_packed(doc, parent_key)
                if pk is None:
                    return None
                p = ov.pos_of(pk)
                if p < 0:
                    return None
            return (p, elems, values)
        if kind_ == "del_run":
            # contiguous VISIBLE run: scan for the FIRST target only, then
            # walk forward — each next target must be the next visible
            # element (one O(n) scan total, not one per key)
            keys = payload
            pk = self._fast_packed(doc, keys[0])
            if pk is None:
                return None
            p = ov.pos_of(pk)
            if p < 0 or not ov.vis[p]:
                return None
            positions = [p]
            n = len(ov.order)
            for key in keys[1:]:
                pk = self._fast_packed(doc, key)
                if pk is None:
                    return None
                q = p + 1
                while q < n and not ov.vis[q]:
                    q += 1
                if q >= n or int(ov.order[q]) != pk:
                    return None
                positions.append(q)
                p = q
            return (positions, keys)
        # set_run: every target must resolve to a KNOWN element;
        # invisible targets are legal — a covered set on a tombstoned
        # element re-asserts it visible (the redo-after-undo shape),
        # emitted as an insert diff at execute time
        resolved = []
        for key, value in payload:
            pk = self._fast_packed(doc, key)
            if pk is None:
                return None
            p = ov.pos_of(pk)
            if p < 0:
                return None
            resolved.append((p, key, value))
        return resolved

    def _fast_execute(self, kind_, plan, wrapper: "_TextObj", obj: str,
                      ov: "_TextOverlay", actor: str, rank: int):
        """Mutate the overlay and emit op-wise diffs (cannot fail)."""
        if ov.path is False:
            ov.path = self._paths().get(obj)   # one BFS per overlay life
        path = ov.path
        typ = wrapper.kind
        diffs: list = []
        cum = np.cumsum(ov.vis)         # visible count through position i
        if kind_ == "ins_run":
            p, elems, values = plan
            base = int(cum[p]) if p >= 0 else 0
            new_packed = (np.int64(rank) << 32) | np.asarray(elems,
                                                             np.int64)
            ov.order = np.insert(ov.order, p + 1, new_packed)
            ov.vis = np.insert(ov.vis, p + 1, np.ones(len(elems), bool))
            for j, (e, (v, dt)) in enumerate(zip(elems, values)):
                elem_id = f"{actor}:{e}"
                diff = {"action": "insert", "obj": obj, "type": typ,
                        "index": base + j, "elemId": elem_id,
                        "value": v, "path": path}
                if dt:
                    diff["datatype"] = dt
                diffs.append(diff)
                rec = {"value": v}
                if dt:
                    rec["datatype"] = dt
                ov.writes[elem_id] = rec
            wrapper.max_elem = max(wrapper.max_elem, elems[-1])
            diffs.append({"action": "maxElem", "obj": obj, "type": typ,
                          "value": wrapper.max_elem, "path": path})
        elif kind_ == "del_run":
            positions, keys = plan
            index = int(cum[positions[0]]) - 1
            for p, key in zip(positions, keys):
                diffs.append({"action": "remove", "obj": obj, "type": typ,
                              "index": index, "path": path})
                ov.vis[p] = False
                ov.writes[key] = _DELETED
        else:  # set_run
            flipped: list = []    # positions made visible by THIS run
            for p, key, (v, dt) in plan:
                if ov.vis[p]:     # plain value update; bisect_right
                    # counts a flip of p ITSELF (same elemId set twice
                    # in one change: the first set made it visible, so
                    # this set's index is one right of the snapshot)
                    shift = bisect.bisect_right(flipped, p)
                    diff = {"action": "set", "obj": obj, "type": typ,
                            "index": int(cum[p]) - 1 + shift, "value": v,
                            "path": path}
                else:             # covered re-assert of a tombstoned
                    shift = bisect.bisect_left(flipped, p)
                    ov.vis[p] = True             # element: re-insertion
                    diff = {"action": "insert", "obj": obj, "type": typ,
                            "index": int(cum[p]) + shift, "elemId": key,
                            "value": v, "path": path}
                    bisect.insort(flipped, p)
                if dt:
                    diff["datatype"] = dt
                diffs.append(diff)
                rec = {"value": v}
                if dt:
                    rec["datatype"] = dt
                ov.writes[key] = rec
        return diffs

    def flush_pending(self):
        """Replay pending fast-path rounds into the engine (no diffs: they
        were emitted op-wise when the rounds applied); refresh the diff
        snapshots and drop the overlays. Decodes inside the replay tag
        as ``plan/decode_replay``: these changes never crossed the wire,
        so the wire-ingest decode term stays attributable."""
        if not self.pending:
            return
        pending, self.pending = self.pending, []
        routed, self._pending_routed = self._pending_routed, []
        from ..engine import wire_columns as _wc
        _wc.REPLAY_DEPTH += 1
        try:
            touched, _ = self._distribute(pending, {}, routed=routed)
        finally:
            _wc.REPLAY_DEPTH -= 1
        for oid in touched:
            w = self.root if oid == ROOT_ID else self.objects.get(oid)
            if isinstance(w, _TextObj):
                w.snapshot()
            elif isinstance(w, _MapObj):
                w.prev = w.current()
            if w is not None:
                w.ov = None

    # -- undo/redo (mirror of backend/index.js:258-316 + op_set undo) ---

    def _field_ops(self, obj_id: str, key: str) -> list:
        """Current surviving ops at (obj, key) as re-appliable op dicts
        (winner first, conflicts after — the oracle's rec.keys order),
        read from the host mirrors/conflict map. Empty if the field is
        absent or the object unknown."""
        if obj_id == ROOT_ID:
            wrapper = self.root
        else:
            wrapper = self.objects.get(obj_id)
            if wrapper is None:
                return []
        doc = wrapper.doc
        if wrapper.ov is not None:
            # pending fast-path rounds: their register writes live in the
            # overlay (engine state is behind); untouched registers fall
            # through to the device mirrors, which are still valid for them
            hit = wrapper.ov.writes.get(key)
            if hit is _DELETED:
                return []
            if hit is not None:
                op = {"action": "set", "obj": obj_id, "key": key,
                      "value": hit["value"]}
                if hit.get("datatype"):
                    op["datatype"] = hit["datatype"]
                return [op]
        if isinstance(wrapper, _TextObj):
            from ..engine.host_index import pack_keys
            from .._common import parse_elem_id
            try:
                actor, ctr = parse_elem_id(key)
            except Exception:
                return []
            rank = doc._actor_rank.get(actor)
            if rank is None:
                return []
            slots, found = doc.index.lookup_learned(pack_keys(
                np.asarray([rank], np.int64), np.asarray([ctr], np.int64)))
            if not found[0]:
                return []
            slot = int(slots[0])
            h = doc._mirrors()
            decode = self._decode_text
        else:
            slot = doc._key_slot.get(key)
            if slot is None:
                return []
            h = doc._mirrors()
            decode = lambda w, v: self._decode_map(doc, v)  # noqa: E731

        def as_op(raw: int) -> dict:
            d = decode(wrapper, int(raw))
            op = {"action": "link" if d.get("link") else "set",
                  "obj": obj_id, "key": key, "value": d["value"]}
            if d.get("datatype"):
                op["datatype"] = d["datatype"]
            return op

        ops = []
        if h["has_value"][slot]:
            ops.append(as_op(int(h["value"][slot])))
        for extra in doc.conflicts.get(slot, []):
            ops.append(as_op(int(extra["value"])))
        return ops

    def do_undo(self, request: dict) -> list:
        if self.undo_pos < 1:
            raise ValueError("Cannot undo: there is nothing to be undone")
        undo_ops = self.undo_stack[self.undo_pos - 1]
        change = {"actor": request["actor"], "seq": request["seq"],
                  "deps": request.get("deps", {}),
                  "message": request.get("message"), "ops": undo_ops}
        redo_ops = []
        for op in undo_ops:
            if op["action"] not in ("set", "del", "link", "inc"):
                raise ValueError(
                    f"Unexpected operation type in undo history: {op}")
            if op["action"] == "inc":
                redo_ops.append({"action": "inc", "obj": op["obj"],
                                 "key": op["key"], "value": -op["value"]})
            else:
                field = self._field_ops(op["obj"], op["key"])
                redo_ops.extend(field or [{"action": "del", "obj": op["obj"],
                                           "key": op["key"]}])
        self.undo_pos -= 1
        self.redo_stack = self.redo_stack + [redo_ops]
        return self.apply([change], False, is_local=True)

    def do_redo(self, request: dict) -> list:
        if not self.redo_stack:
            raise ValueError("Cannot redo: the last change was not an undo")
        redo_ops = self.redo_stack[-1]
        change = {"actor": request["actor"], "seq": request["seq"],
                  "deps": request.get("deps", {}),
                  "message": request.get("message"), "ops": redo_ops}
        self.undo_pos += 1
        self.redo_stack = self.redo_stack[:-1]
        return self.apply([change], False, is_local=True)

    def _seed_all_deps(self) -> dict:
        return {(a, i + 1): e["allDeps"]
                for a, lst in self.states.items() for i, e in enumerate(lst)}

    def _distribute(self, applied, creations, routed=None):
        """Feed applied changes to the per-object device docs.

        Per-change windows (with empty sub-changes carrying causal
        bookkeeping) are built ONLY for objects the delivery touches or
        creates; every other object's causal state advances in bulk — one
        dict update per doc instead of per (doc x change) Python work
        (the nested Trellis shape has many objects, few touched).

        `routed` (the flush path, `flush_pending`): the per-change
        (change, by_obj, root_ops) triples were already computed when
        each fast-path round applied, so replaying pending rounds skips
        the whole per-op routing walk — `creations` is empty there (the
        fast path never serves makes) and `max_elem` was maintained at
        fast-apply time."""
        if not applied:
            return set(), []
        if routed is not None:
            created_at: dict = {}
            touched: set = set()
            n_root_ops = 0
            for _ch, by_obj, root_ops in routed:
                touched |= by_obj.keys()
                if root_ops:
                    touched.add(ROOT_ID)
                    n_root_ops += len(root_ops)
            if len(applied) >= 4 and n_root_ops:
                # same root pre-size as the walk below: a root-key-heavy
                # flush must not grow the root map bucket by bucket
                self.root.doc.reserve(n_root_ops + 16)
            return self._distribute_routed(applied, routed, created_at,
                                           touched)
        routed = []                  # (change, by_obj, root_ops) per change
        op_totals = None             # per-obj op counts, for creation sizing

        def totals() -> dict:
            nonlocal op_totals
            if op_totals is None:
                op_totals = {}
                for c2 in applied:
                    for o2 in c2["ops"]:
                        # link counts too: nested-object keys and table
                        # rows are assigned via link, not set
                        if o2.get("action") in ("ins", "set", "link"):
                            t = o2["obj"]
                            op_totals[t] = op_totals.get(t, 0) + 1
            return op_totals

        if len(applied) >= 4:
            # bulk delivery (load replays whole histories): pre-size the
            # ROOT map too — it exists from core init and never gets a
            # creation hint, but a root-key-heavy load would otherwise
            # grow it through every bucket, one table reallocation each
            self.root.doc.reserve(totals().get(ROOT_ID, 0) + 16)
        created_at = {}              # obj -> index of its creating change
        # (insertion-ordered: doubles as the created-object list)
        touched = set()
        for idx, ch in enumerate(applied):
            by_obj: dict = {}
            root_ops: list = []
            for op in ch["ops"]:
                action = op["action"]
                obj = op["obj"]
                if action in _MAKE_KIND:
                    # creation sizing: a bulk delivery (load replays the
                    # whole history) otherwise grows each new doc through
                    # every capacity bucket, reallocating its tables per
                    # bucket. One O(ops) pass over the delivery pre-sizes
                    # every object it creates to its final bucket.
                    kind = _MAKE_KIND[action]
                    hint = totals().get(obj, 0)
                    if kind in ("text", "list"):
                        wrapper = _TextObj(obj, kind, self.device,
                                           capacity_hint=hint + 64)
                    else:
                        wrapper = _MapObj(obj, kind, self.device,
                                          capacity_hint=hint + 16)
                    wrapper.doc.clock = dict(
                        creations.get((ch["actor"], ch["seq"]), self.clock))
                    wrapper.doc.clock.pop(ch["actor"], None)
                    if ch["seq"] > 1:
                        wrapper.doc.clock[ch["actor"]] = ch["seq"] - 1
                    wrapper.doc._all_deps = self._seed_all_deps()
                    self.objects[obj] = wrapper
                    self.obj_order.append(obj)
                    created_at[obj] = idx
                elif obj == ROOT_ID:
                    root_ops.append(op)
                else:
                    if obj not in self.objects:
                        # use-before-make inside one delivery: causal
                        # admission guarantees make-before-use order when
                        # the using change depends on the making one, so
                        # reaching here means the delivery is malformed —
                        # raise like the oracle (op_set.js:88,199); the
                        # caller's restore path rolls the core back
                        raise ValueError(
                            f"Modification of unknown object {obj}")
                    by_obj.setdefault(obj, []).append(op)
                    if action == "ins":
                        self.objects[obj].max_elem = max(
                            self.objects[obj].max_elem, op["elem"])
            routed.append((ch, by_obj, root_ops))
            touched |= by_obj.keys()
            if root_ops:
                touched.add(ROOT_ID)
        return self._distribute_routed(applied, routed, created_at,
                                       touched)

    def _distribute_routed(self, applied, routed, created_at: dict,
                           touched: set):
        """Apply a routed delivery to the per-object engine docs: the
        stacked multi-object path when `worth_trying` admits it (one
        round program per causal round across ALL touched objects —
        engine/stacked.py), the per-object window loop otherwise (a
        declined or ineligible round)."""
        # engine application stales any overlay on a touched object (the
        # single choke point: every path that mutates an object's engine
        # state goes through here)
        for oid in touched:
            w = self.root if oid == ROOT_ID else self.objects.get(oid)
            if w is not None:
                w.ov = None

        window_ids = (touched | set(created_at)) - {ROOT_ID}
        stacked_done = False
        if len(window_ids) + (ROOT_ID in touched) >= 2:
            from ..engine import stacked as _stacked
            # cheap pre-gates from the already-routed triples, BEFORE
            # paying the per-object window construction: the common
            # small interactive flush must not build `items` twice
            # (once for a declined stacked attempt, once per-object)
            n_wire = 0
            op_objs: set = set()
            for _ch, by_obj, root_ops in routed:
                for o, ops_l in by_obj.items():
                    if ops_l:
                        op_objs.add(o)
                        n_wire += len(ops_l)
                if root_ops:
                    op_objs.add(ROOT_ID)
                    n_wire += len(root_ops)
            if _stacked.worth_trying(n_wire, len(op_objs)):
                items = []
                if ROOT_ID in touched:
                    items.append((self.root.doc,
                                  [_sub_change(ch, root_ops)
                                   for ch, _, root_ops in routed]))
                for oid in self.obj_order:
                    if oid in window_ids:
                        start = created_at.get(oid, 0)
                        items.append(
                            (self.objects[oid].doc,
                             [_sub_change(ch, by_obj.get(oid, []))
                              for ch, by_obj, _ in routed[start:]]))
                stacked_done = _stacked.apply_stacked(items)
        if not stacked_done:
            if ROOT_ID in touched:
                self.root.doc.apply_changes(
                    [_sub_change(ch, root_ops)
                     for ch, _, root_ops in routed])
            for oid in self.obj_order:
                if oid not in window_ids:
                    continue
                start = created_at.get(oid, 0)
                self.objects[oid].doc.apply_changes(
                    [_sub_change(ch, by_obj.get(oid, []))
                     for ch, by_obj, _ in routed[start:]])

        # bulk causal advance for everything the delivery never touched:
        # clock entries + shared (read-only) allDeps rows, needed for
        # future covering checks
        entries = {}
        clock_delta: dict = {}
        for ch in applied:
            actor, seq = ch["actor"], ch["seq"]
            entries[(actor, seq)] = self.states[actor][seq - 1]["allDeps"]
            if seq > clock_delta.get(actor, 0):
                clock_delta[actor] = seq
        quiet = [self.objects[oid].doc for oid in self.obj_order
                 if oid not in window_ids]
        if ROOT_ID not in touched:
            quiet.append(self.root.doc)
        for doc in quiet:
            doc._all_deps.update(entries)
            clock = doc.clock
            for a, s in clock_delta.items():
                if s > clock.get(a, 0):
                    clock[a] = s
        return touched, list(created_at)

    # -- diff emission (net diffs, vectorized) --------------------------

    def _decode_text(self, tobj: _TextObj, v: int) -> dict:
        if v >= 0:
            return {"value": chr(int(v))}
        e = tobj.doc.value_pool[-int(v) - 1]
        out = {"value": e["value"]}
        if e.get("datatype"):
            out["datatype"] = e["datatype"]
        if e.get("link"):
            out["link"] = True
        return out

    def _decode_map(self, doc, v: int) -> dict:
        if v >= 0:
            return {"value": int(v)}
        e = doc.value_pool[-int(v) - 1]
        out = {"value": e["value"]}
        if e.get("datatype"):
            out["datatype"] = e["datatype"]
        if e.get("link"):
            out["link"] = True
        return out

    def _text_conflicts(self, tobj: _TextObj, slot: int):
        ops = tobj.doc.conflicts.get(slot)
        if not ops:
            return None
        out = []
        for op in ops:
            c = {"actor": tobj.doc.actor_table[op["actor_rank"]]}
            c.update(self._decode_text(tobj, op["value"]))
            out.append(c)
        return out

    def _map_conflicts(self, doc, slot: int):
        ops = doc.conflicts.get(slot)
        if not ops:
            return None
        out = []
        for op in ops:
            c = {"actor": doc.actor_table[op["actor_rank"]]}
            c.update(self._decode_map(doc, op["value"]))
            out.append(c)
        return out

    def _link_children(self, wrapper) -> list:
        """(path-step, child obj id) pairs for a wrapper's winning link
        values. Text/list objects without pooled link entries short-circuit
        host-side (no device work)."""
        doc = wrapper.doc
        out = []
        if isinstance(wrapper, _TextObj):
            if not wrapper.pool_has_links():
                return out
            if doc.n_elems == 0:
                return out
            h = doc._mirrors()
            for idx, slot in enumerate(doc.visible_order()):
                v = int(h["value"][slot])
                if v < 0 and doc.value_pool[-v - 1].get("link"):
                    out.append((idx, doc.value_pool[-v - 1]["value"]))
        else:
            h = doc._mirrors()
            for key, slot in doc._key_slot.items():
                if h["has_value"][slot]:
                    v = int(h["value"][slot])
                    if v < 0 and doc.value_pool[-v - 1].get("link"):
                        out.append((key, doc.value_pool[-v - 1]["value"]))
        return out

    def _paths(self) -> dict:
        """obj_id -> root-relative path for currently reachable objects
        (walks winning link values breadth-first from the root; the
        reference's getPath, op_set.js:43-58)."""
        paths: dict = {}
        frontier = [(self.root, [])]
        while frontier:
            wrapper, base = frontier.pop(0)
            for step, child in self._link_children(wrapper):
                if child in self.objects and child not in paths:
                    paths[child] = base + [step]
                    frontier.append((self.objects[child], paths[child]))
        return paths

    def _text_diffs(self, obj_id: str, tobj: _TextObj, path, out: list,
                    rebuild: bool = False):
        doc = tobj.doc
        n = doc.n_elems
        if n == 0:
            if tobj.max_elem and (rebuild or tobj.prev_n != n):
                out.append({"action": "maxElem", "obj": obj_id,
                            "type": tobj.kind, "value": tobj.max_elem,
                            "path": path})
            return
        pos = doc._positions()               # RGA position per slot, len n+1
        order = np.empty(n, np.int64)
        order[np.asarray(pos[1:])] = np.arange(1, n + 1)  # slots in list order
        h = doc._mirrors()
        vis = np.array(h["has_value"][: n + 1], bool)
        val = np.array(h["value"][: n + 1], np.int32)
        old_n = 0 if rebuild else tobj.prev_n
        old_vis = np.zeros(n + 1, bool)
        old_vis[: old_n + 1] = tobj.prev_vis[: old_n + 1] if not rebuild else False
        old_val = np.zeros(n + 1, np.int32)
        if not rebuild:
            old_val[: old_n + 1] = tobj.prev_value[: old_n + 1]
        conf = tobj.conflict_sig()
        old_conf = {} if rebuild else tobj.prev_conf

        o_vis = old_vis[order]
        n_vis = vis[order]
        old_rank = np.cumsum(o_vis) - o_vis   # old index per ordered slot
        new_rank = np.cumsum(n_vis) - n_vis   # new index per ordered slot

        typ = tobj.kind

        # removes, descending old index
        rem = np.flatnonzero(o_vis & ~n_vis)
        for p in rem[::-1]:
            out.append({"action": "remove", "obj": obj_id, "type": typ,
                        "index": int(old_rank[p]), "path": path})
        # inserts, ascending final index. Bulk-shaped: a fresh peer's
        # initial sync emits the WHOLE document here (100k+ diffs), so the
        # loop body is flattened — numpy columns are converted to Python
        # lists once (tolist is one C pass; per-element np-scalar int()
        # casts were a measured hotspot), the plain-codepoint value case
        # is inlined, and the sparse conflict lookup replaces a per-elem
        # method call. Emitted dicts are byte-identical to the old loop.
        ins = np.flatnonzero(~o_vis & n_vis)
        actor_col = h["actor"]
        ctr_col = h["ctr"]
        if len(ins):
            at = doc.actor_table
            ins_slots = order[ins]
            conflicts = doc.conflicts
            decode = self._decode_text
            for slot, idx, a, c, v in zip(
                    ins_slots.tolist(), new_rank[ins].tolist(),
                    actor_col[ins_slots].tolist(),
                    ctr_col[ins_slots].tolist(),
                    val[ins_slots].tolist()):
                diff = {"action": "insert", "obj": obj_id, "type": typ,
                        "index": idx, "elemId": f"{at[a]}:{c}",
                        "path": path}
                if v >= 0:
                    diff["value"] = chr(v)      # _decode_text fast case
                else:
                    diff.update(decode(tobj, v))
                if slot in conflicts:
                    cf = self._text_conflicts(tobj, slot)
                    if cf:
                        diff["conflicts"] = cf
                out.append(diff)
        # sets: surviving elements whose value or conflicts changed.
        # Vectorized: the value comparison runs as one numpy pass and the
        # (sparse) conflict signatures touch only slots that carry one —
        # a 10-op change on a 100k-element doc emits in O(changed) Python,
        # not an O(n) per-element loop (the interactive-latency path,
        # reference per-op diff emission op_set.js:173-194).
        both_mask = o_vis & n_vis
        changed = both_mask & (val[order] != old_val[order])
        for slot in set(conf) | set(old_conf):
            if conf.get(slot) != old_conf.get(slot) and slot <= n:
                p = int(pos[slot])
                if 0 <= p < n and both_mask[p]:
                    changed[p] = True
        for p in np.flatnonzero(changed):
            slot = int(order[p])
            diff = {"action": "set", "obj": obj_id, "type": typ,
                    "index": int(new_rank[p]), "path": path}
            diff.update(self._decode_text(tobj, int(val[slot])))
            c = self._text_conflicts(tobj, slot)
            if c:
                diff["conflicts"] = c
            out.append(diff)
        if tobj.max_elem and (rebuild or ins.size or tobj.prev_n != n):
            out.append({"action": "maxElem", "obj": obj_id, "type": typ,
                        "value": tobj.max_elem, "path": path})

    def _map_diffs(self, obj_id: str, mobj: _MapObj, path, out: list,
                   rebuild: bool = False):
        doc = mobj.doc
        cur = mobj.current()
        prev = {} if rebuild else mobj.prev
        typ = mobj.kind
        for key in prev:
            if key not in cur:
                out.append({"action": "remove", "obj": obj_id, "type": typ,
                            "key": key, "path": path})
        for key, (raw, sig) in cur.items():
            if prev.get(key) == (raw, sig):
                continue
            diff = {"action": "set", "obj": obj_id, "type": typ,
                    "key": key, "path": path}
            diff.update(self._decode_map(doc, raw))
            if typ == "map":
                # table rows carry no conflict annotations in the patch
                # protocol (reference apply_patch.js updateTableObject)
                c = self._map_conflicts(doc, doc._key_slot[key])
                if c:
                    diff["conflicts"] = c
            out.append(diff)
        mobj.prev = cur

    def _content_diffs(self, oid: str, paths: dict, out: list,
                       rebuild: bool = False):
        wrapper = self.objects[oid]
        if isinstance(wrapper, _TextObj):
            self._text_diffs(oid, wrapper, paths.get(oid), out,
                             rebuild=rebuild)
            wrapper.snapshot()
        else:
            self._map_diffs(oid, wrapper, paths.get(oid), out,
                            rebuild=rebuild)

    def _emit_diffs(self, touched: set, created: list) -> list:
        # creates go FIRST (creation order): a link diff resolves its child
        # by object id in the applier's updated/cache maps, so every child
        # must be registered before any content diff references it; the
        # applier's update_parent_objects pass re-links parents afterwards
        diffs: list = []
        paths = self._paths()
        for oid in created:
            wrapper = self.objects[oid]
            if not wrapper.announced:
                diffs.append({"action": "create", "obj": oid,
                              "type": wrapper.kind})
                wrapper.announced = True
        for oid in self.obj_order:
            if oid in touched or oid in created:
                self._content_diffs(oid, paths, diffs)
        if ROOT_ID in touched:
            self._map_diffs(ROOT_ID, self.root, [], diffs)
        return diffs

    def rebuild_diffs(self) -> list:
        """Whole-document construction diffs (getPatch semantics)."""
        self.flush_pending()   # materialization reads the engine state
        diffs: list = []
        paths = self._paths()
        for oid in self.obj_order:
            diffs.append({"action": "create", "obj": oid,
                          "type": self.objects[oid].kind})
        for oid in self.obj_order:
            self._content_diffs(oid, paths, diffs, rebuild=True)
        self._map_diffs(ROOT_ID, self.root, [], diffs, rebuild=True)
        return diffs

    # -- fork / restore -------------------------------------------------

    def fork(self, version: int) -> "_DeviceCore":
        """Deterministic replay of the delivery log prefix (facade's
        fork-by-replay, paid only on divergence or restore), on this
        core's device."""
        clone = _DeviceCore(self.device)
        for cmd in self.commands[:version]:
            if cmd[0] == "apply":
                clone.apply(cmd[1], cmd[2])
            elif cmd[0] == "undo":
                clone.do_undo(cmd[1])
            elif cmd[0] == "redo":
                clone.do_redo(cmd[1])
            else:  # "local"
                clone.apply([cmd[1]],
                            cmd[1].get("undoable", True) is not False,
                            is_local=True)
            clone.commands.append(cmd)
        return clone

    def restore(self, version: int):
        """Rebuild in place after a failed mutation (facade._restore)."""
        clean = self.fork(version)
        for slot in ("states", "history", "queue", "clock", "deps",
                     "undo_pos", "undo_stack", "redo_stack", "objects",
                     "obj_order", "root", "commands", "_cv", "actor_rank",
                     "pending", "_pending_routed"):
            setattr(self, slot, getattr(clean, slot))

    def graduate(self, version: int) -> _OracleState:
        """Replay the delivery log into an oracle backend state.

        Everything in the log was validated at original admission, so the
        replay skips the per-op validation walk (`prevalidated`)."""
        state = _oracle.init()
        with prevalidated():
            return self._graduate_replay(state, version)

    def _graduate_replay(self, state: _OracleState,
                         version: int) -> _OracleState:
        for cmd in self.commands[:version]:
            if cmd[0] == "apply":
                state, _ = _oracle.apply_changes(state, cmd[1])
            elif cmd[0] == "undo":
                # dispatch on the tag: requests recorded through the public
                # undo()/redo() seam need not carry a requestType
                state, _ = _oracle.undo(state, cmd[1])
            elif cmd[0] == "redo":
                state, _ = _oracle.redo(state, cmd[1])
            else:  # "local"
                state, _ = _oracle.apply_local_change(state, cmd[1])
        return state


class DeviceBackendState:
    """Immutable view of one point in a device-backed document lineage."""

    __slots__ = ("_core", "_version", "_fork_cache", "clock", "deps",
                 "can_undo", "can_redo", "queue", "history_len")

    def __init__(self, core: _DeviceCore, version: int):
        self._core = core
        self._version = version
        self._fork_cache: Optional[_DeviceCore] = None
        self.clock = dict(core.clock)
        self.deps = dict(core.deps)
        self.can_undo = core.undo_pos > 0
        self.can_redo = len(core.redo_stack) > 0
        self.queue = tuple(core.queue)
        self.history_len = len(core.history)

    def _is_current(self) -> bool:
        return len(self._core.commands) == self._version

    def writable_core(self) -> _DeviceCore:
        if self._is_current():
            return self._core
        return self._core.fork(self._version)

    def read_core(self) -> _DeviceCore:
        if self._is_current():
            return self._core
        if self._fork_cache is None:
            self._fork_cache = self._core.fork(self._version)
        return self._fork_cache

    def history(self) -> list:
        return self._core.history[: self.history_len]


def _make_patch(state, diffs: list) -> dict:
    return {"clock": dict(state.clock), "deps": dict(state.deps),
            "canUndo": state.can_undo, "canRedo": state.can_redo,
            "diffs": diffs}


def init(device=None) -> DeviceBackendState:
    """A fresh lineage on `device` (None: the CUDA card, raising without
    one)."""
    return DeviceBackendState(_DeviceCore(device), 0)


def _device_apply(state: DeviceBackendState, changes, undoable: bool,
                  command):
    # scope gate BEFORE any forking: graduation replays the log prefix into
    # the oracle and never needs a device fork. For the common current-state
    # case the live object table answers scope directly; for a stale state,
    # the makes in its applied history reconstruct the same kind map.
    if state._is_current():
        known = {oid: w.kind for oid, w in state._core.objects.items()}
    else:
        known = {op["obj"]: _MAKE_KIND[op["action"]]
                 for ch in state.history()
                 for op in ch.get("ops", ())
                 if op.get("action") in _MAKE_KIND}
    frame = changes if hasattr(changes, "batch") else None
    if frame is not None:
        # frame-level scope answer (no per-op walk): the frame grammar
        # is device-shaped by construction, so scope is just "does the
        # target object exist with a compatible kind". A mismatch (or a
        # frame for an object this lineage never made) degrades to the
        # dict view and the generic gate below.
        kind = "map" if frame.obj_id == ROOT_ID else known.get(frame.obj_id)
        if kind not in (("text", "list") if frame.kind == "text"
                        else ("map", "table")):
            changes, frame = frame.changes(), None
    if frame is None and not _in_scope(changes, known):
        _graduate_signal("out_of_scope",
                         f"{len(changes)} change(s) outside device op shape")
        oracle_state = state._core.graduate(state._version)
        if command[0] == "local":
            return _oracle.apply_local_change(oracle_state, command[1])
        # `changes` was validated by the caller (apply_changes) already
        with prevalidated():
            return _oracle.apply_changes(oracle_state, changes)
    core = state.writable_core()
    try:
        diffs = core.apply(changes, undoable,
                           is_local=command[0] == "local")
    except Exception:
        core.restore(state._version)
        raise
    core.commands.append(command)
    new_state = DeviceBackendState(core, len(core.commands))
    return new_state, _make_patch(new_state, diffs)


def apply_changes(state, changes):
    from ..engine.wire_format import WireFrame
    if isinstance(changes, WireFrame):
        # a binary wire delivery: decode (idempotent — the gate already
        # validated it) IS the structural validation; the frame grammar
        # is a strict subset of the device op shape, so per-op walks are
        # redundant. The command log records the canonical dict view so
        # fork/graduation replay stays frame-free and deterministic.
        changes.validate()
        if isinstance(state, _OracleState):
            with prevalidated():
                return _oracle.apply_changes(state, changes.changes())
        return _device_apply(state, changes, False,
                             ("apply", changes.changes(), False))
    # validation materializes BEFORE logging (iterator inputs must see
    # identical content in the live apply and the replay log) and rejects
    # structurally malformed changes with a typed ProtocolError before any
    # core mutation; unknown op actions still flow to graduation + the
    # oracle's authoritative rejection (tests/test_graduation.py)
    changes = validate_changes(changes, strict=False)
    if isinstance(state, _OracleState):
        return _oracle.apply_changes(state, changes)
    return _device_apply(state, changes, False, ("apply", changes, False))


def apply_local_change(state, change: dict):
    if isinstance(state, _OracleState):
        return _oracle.apply_local_change(state, change)
    if not isinstance(change.get("actor"), str) or \
            not isinstance(change.get("seq"), int):
        raise TypeError("Change request requires `actor` and `seq` properties")
    if change["seq"] <= state.clock.get(change["actor"], 0):
        raise ValueError("Change request has already been applied")
    request_type = change.get("requestType")
    if request_type == "change":
        undoable = change.get("undoable", True) is not False
        new_state, patch = _device_apply(state, [change], undoable,
                                         ("local", change))
    elif request_type == "undo":
        new_state, patch = undo(state, change)
    elif request_type == "redo":
        new_state, patch = redo(state, change)
    else:
        raise ValueError(f"Unknown requestType: {request_type}")
    patch["actor"] = change["actor"]
    patch["seq"] = change["seq"]
    return new_state, patch


def get_patch(state) -> dict:
    if isinstance(state, _OracleState):
        return _oracle.get_patch(state)
    core = state.read_core()
    return _make_patch(state, core.rebuild_diffs())


def _state_changes(state, have_deps: dict, clock_bound=None) -> list:
    """Changes the holder of `have_deps` is missing, bounded by
    `clock_bound` (a stale state's clock). Vectorized: per-actor clock
    comparison happens as numpy ops over interned actor ranks, and the
    host loop runs ONLY over actors the comparison flagged — not over
    every actor in the document (the reference walks all of them,
    op_set.js:388-395)."""
    core = state._core
    actors, lens_vec = core.clock_vectors()
    n = len(actors)
    if n == 0:
        return []
    rank = core.actor_rank
    # fast cover check: a peer whose raw clock already covers every actor
    # is missing nothing — skip the transitive closure entirely (the
    # common case for every broadcast after a peer caught up)
    have_vec = np.zeros(n, np.int64)
    for a, s in have_deps.items():
        i = rank.get(a)
        if i is not None and s > have_vec[i]:
            have_vec[i] = s
    bound_vec = lens_vec
    if clock_bound is not None:
        bound_vec = np.zeros(n, np.int64)
        for a, s in clock_bound.items():
            i = rank.get(a)
            if i is not None:
                bound_vec[i] = min(s, lens_vec[i])
    if (have_vec >= bound_vec).all():
        return []
    all_deps = _transitive(core.states, have_deps)
    lo_vec = np.zeros(n, np.int64)
    for a, s in all_deps.items():
        i = rank.get(a)
        if i is not None:
            lo_vec[i] = s
    changes = []
    for i in np.nonzero(bound_vec > lo_vec)[0]:
        lst = core.states[actors[i]]
        for entry in lst[int(lo_vec[i]): int(bound_vec[i])]:
            changes.append(entry["change"])
    return changes


def get_changes(old_state, new_state) -> list:
    if isinstance(new_state, _OracleState):
        if isinstance(old_state, _OracleState):
            return _oracle.get_changes(old_state, new_state)
        # mixed lineage (graduated): diff by clocks via the oracle index
        return _oracle.get_missing_changes(new_state, old_state.clock)
    from .._common import less_or_equal
    if not less_or_equal(old_state.clock, new_state.clock):
        raise ValueError("Cannot diff two states that have diverged")
    return _state_changes(new_state, old_state.clock, new_state.clock)


def get_changes_for_actor(state, actor_id: str) -> list:
    if isinstance(state, _OracleState):
        return _oracle.get_changes_for_actor(state, actor_id)
    lst = state._core.states.get(actor_id, [])
    upper = min(len(lst), state.clock.get(actor_id, 0))
    return [e["change"] for e in lst[:upper]]


def get_missing_changes(state, clock: dict) -> list:
    if isinstance(state, _OracleState):
        return _oracle.get_missing_changes(state, clock)
    return _state_changes(state, clock, state.clock)


def get_missing_deps(state) -> dict:
    if isinstance(state, _OracleState):
        return _oracle.get_missing_deps(state)
    from .op_set import OpSetIndex
    return OpSetIndex.missing_deps_of_queue(state.queue, state.clock)


def merge(local, remote):
    changes = get_missing_changes(remote, local.clock)
    # changes come from an admitted lineage: skip the per-op validation
    # walk (the merge-heavy soak/reconciliation hot path)
    with prevalidated():
        return apply_changes(local, changes)


def _device_undo_redo(state, request, tag: str):
    core = state.writable_core()
    try:
        diffs = core.do_undo(request) if tag == "undo" \
            else core.do_redo(request)
    except Exception:
        core.restore(state._version)
        raise
    core.commands.append((tag, request))
    new_state = DeviceBackendState(core, len(core.commands))
    return new_state, _make_patch(new_state, diffs)


def undo(state, request):
    if isinstance(state, _OracleState):
        return _oracle.undo(state, request)
    return _device_undo_redo(state, request, "undo")


def redo(state, request):
    if isinstance(state, _OracleState):
        return _oracle.redo(state, request)
    return _device_undo_redo(state, request, "redo")


class DeviceBackend:
    """Injectable backend namespace (the options.backend seam) routing
    document trees to the device engines on the CUDA card, with oracle
    graduation. `backend_for(device)` gives the namespace bound to
    another device."""

    init = staticmethod(init)
    applyChanges = staticmethod(apply_changes)
    applyLocalChange = staticmethod(apply_local_change)
    getPatch = staticmethod(get_patch)
    getChanges = staticmethod(get_changes)
    getChangesForActor = staticmethod(get_changes_for_actor)
    getMissingChanges = staticmethod(get_missing_changes)
    getMissingDeps = staticmethod(get_missing_deps)
    merge = staticmethod(merge)
    apply_changes = staticmethod(apply_changes)
    apply_local_change = staticmethod(apply_local_change)
    get_patch = staticmethod(get_patch)
    get_changes = staticmethod(get_changes)
    get_changes_for_actor = staticmethod(get_changes_for_actor)
    get_missing_changes = staticmethod(get_missing_changes)
    get_missing_deps = staticmethod(get_missing_deps)
    undo = staticmethod(undo)
    redo = staticmethod(redo)
    device = None       # the device `init()` starts lineages on (a
    # checkpoint restored for this namespace lands there too)


Backend = DeviceBackend

_BOUND: dict = {}


def backend_for(device) -> type:
    """The backend namespace whose `init()` starts lineages on `device`
    ("cpu", "cuda", "cuda:1", a torch.device; None is `DeviceBackend`).
    Every other entry dispatches on the state it is given, so a lineage
    stays on the device it started on. Pass it through the frontend's
    ``options["backend"]``: ``am.init({"backend": backend_for("cpu")})``."""
    if device is None:
        return DeviceBackend
    key = str(torch.device(device))
    ns = _BOUND.get(key)
    if ns is None:
        ns = type(f"DeviceBackend_{key.replace(':', '_')}", (DeviceBackend,),
                  {"init": staticmethod(lambda: init(key)),
                   "device": key,
                   "__doc__": f"DeviceBackend bound to {key}."})
        _BOUND[key] = ns
    return ns
