"""Functional backend API over the mutable op-set index.

Counterpart of the reference's ``backend/index.js`` (reference backend/
index.js:125-321): ``(state, changes) -> (state', patch)`` with patches in the
reference's exact wire format. Persistence of old states is provided not by
persistent data structures but by an append-only command log: every
``BackendState`` is (shared index, log version, cheap snapshots); applying to
a stale state forks the index by deterministic replay. Forward application is
O(change); branching pays O(history) once per divergence.
"""

from __future__ import annotations

from typing import Optional

from .._common import ROOT_ID, less_or_equal, parse_elem_id
from ..resilience.validation import prevalidated, validate_changes
from .op_set import OpSetIndex


class BackendState:
    """An immutable view of one point in a document lineage."""

    __slots__ = ("_index", "_version", "_fork_cache",
                 "clock", "deps", "can_undo", "can_redo", "queue", "history_len")

    def __init__(self, index: OpSetIndex, version: int):
        self._index = index
        self._version = version
        self._fork_cache: Optional[OpSetIndex] = None
        self.clock = dict(index.clock)
        self.deps = dict(index.deps)
        self.can_undo = index.undo_pos > 0
        self.can_redo = len(index.redo_stack) > 0
        self.queue = tuple(index.queue)
        self.history_len = len(index.history)

    # -- index access ---------------------------------------------------

    def _is_current(self) -> bool:
        return len(self._index.commands) == self._version

    def writable_index(self) -> OpSetIndex:
        """The index positioned exactly at this state, ready to mutate."""
        if self._is_current():
            return self._index
        return self._index.fork(self._version)

    def read_index(self) -> OpSetIndex:
        """An index whose deep state (object trees, stacks) matches this state."""
        if self._is_current():
            return self._index
        if self._fork_cache is None:
            self._fork_cache = self._index.fork(self._version)
        return self._fork_cache

    def history(self) -> list:
        return self._index.history[: self.history_len]


def init() -> BackendState:
    return BackendState(OpSetIndex(), 0)


def _snapshot(index: OpSetIndex) -> BackendState:
    return BackendState(index, len(index.commands))


def _make_patch(state: BackendState, diffs: list) -> dict:
    return {"clock": dict(state.clock), "deps": dict(state.deps),
            "canUndo": state.can_undo, "canRedo": state.can_redo, "diffs": diffs}


def _clean_change(change: dict) -> dict:
    if "requestType" in change or "undoable" in change:
        return {k: v for k, v in change.items() if k not in ("requestType", "undoable")}
    return change


def _restore(index):
    """Rebuild `index` in place from its command log after a failed mutation.

    A change that raises mid-application (unknown object, inconsistent seq
    reuse, …) has already mutated the shared index; replaying the log into a
    fresh index and swapping its guts back restores the invariant that the
    index equals its log, so every BackendState holding a reference stays
    valid. The reference got this for free from immutability; here the error
    path pays an O(history) replay instead.
    """
    clean = index.fork(len(index.commands))
    for slot in vars(clean):
        setattr(index, slot, getattr(clean, slot))


def _apply(state: BackendState, changes, undoable: bool):
    index = state.writable_index()
    cleaned = [_clean_change(c) for c in changes]
    diffs = []
    try:
        for change in cleaned:
            diffs.extend(index.add_change(change, undoable))
    except Exception:
        _restore(index)
        raise
    index.record(("apply", cleaned, undoable))
    new_state = _snapshot(index)
    return new_state, _make_patch(new_state, diffs)


def apply_changes(state: BackendState, changes):
    """Apply remote changes; returns (state', patch) (backend/index.js:166-168).

    Structurally malformed changes raise ``ProtocolError`` before any index
    mutation (lenient mode: unknown op *action strings* pass through to the
    op-set's authoritative ``Unknown operation type`` rejection)."""
    return _apply(state, validate_changes(changes, strict=False), False)


def apply_local_change(state: BackendState, change: dict):
    """Apply a frontend change request (backend/index.js:178-201)."""
    if not isinstance(change.get("actor"), str) or not isinstance(change.get("seq"), int):
        raise TypeError("Change request requires `actor` and `seq` properties")
    if change["seq"] <= state.clock.get(change["actor"], 0):
        raise ValueError("Change request has already been applied")

    request_type = change.get("requestType")
    if request_type == "change":
        undoable = change.get("undoable", True) is not False
        state, patch = _apply(state, [change], undoable)
    elif request_type == "undo":
        state, patch = undo(state, change)
    elif request_type == "redo":
        state, patch = redo(state, change)
    else:
        raise ValueError(f"Unknown requestType: {request_type}")
    patch["actor"] = change["actor"]
    patch["seq"] = change["seq"]
    return state, patch


def undo(state: BackendState, request: dict):
    index = state.writable_index()
    try:
        diffs = index.do_undo(request)
    except Exception:
        _restore(index)
        raise
    index.record(("undo", request))
    new_state = _snapshot(index)
    return new_state, _make_patch(new_state, diffs)


def redo(state: BackendState, request: dict):
    index = state.writable_index()
    try:
        diffs = index.do_redo(request)
    except Exception:
        _restore(index)
        raise
    index.record(("redo", request))
    new_state = _snapshot(index)
    return new_state, _make_patch(new_state, diffs)


class MaterializationContext:
    """Builds the diff list that constructs the current document from scratch.

    Counterpart of backend/index.js:5-122: children-before-parents emission so
    the frontend can resolve links as it applies the diffs.
    """

    def __init__(self, index: OpSetIndex):
        self.index = index
        self.diffs: dict[str, list] = {}
        self.children: dict[str, list] = {}

    def _get_op_value(self, op: dict):
        if op["action"] == "link":
            return self.instantiate_object(op["value"])
        if op["action"] == "set":
            result = {"value": op["value"]}
            if op.get("datatype"):
                result["datatype"] = op["datatype"]
            return result
        raise TypeError(f"Unexpected operation action: {op['action']}")

    def _unpack_value(self, parent_id: str, diff: dict, data: dict):
        diff.update(data)
        if data.get("link"):
            self.children[parent_id].append(data["value"])

    def _unpack_conflicts(self, parent_id: str, diff: dict, conflicts):
        if conflicts:
            diff["conflicts"] = []
            for actor, value in conflicts.items():
                conflict = {"actor": actor}
                self._unpack_value(parent_id, conflict, value)
                diff["conflicts"].append(conflict)

    def _instantiate_map(self, object_id: str, obj_type: str):
        diffs = self.diffs[object_id]
        if object_id != ROOT_ID:
            diffs.append({"obj": object_id, "type": obj_type, "action": "create"})
        conflicts = self.index.get_object_conflicts(object_id, self._get_op_value)
        for key in self.index.get_object_fields(object_id):
            diff = {"obj": object_id, "type": obj_type, "action": "set", "key": key}
            ops = self.index.get_field_ops(object_id, key)
            self._unpack_value(object_id, diff, self._get_op_value(ops[0]))
            self._unpack_conflicts(object_id, diff, conflicts.get(key))
            diffs.append(diff)

    def _instantiate_list(self, object_id: str, obj_type: str):
        diffs = self.diffs[object_id]
        max_counter = 0
        diffs.append({"obj": object_id, "type": obj_type, "action": "create"})
        for item in self.index.list_iterator(object_id, self._get_op_value):
            max_counter = max(max_counter, parse_elem_id(item["elemId"])[1])
            if "index" in item:
                diff = {"obj": object_id, "type": obj_type, "action": "insert",
                        "index": item["index"], "elemId": item["elemId"]}
                self._unpack_value(object_id, diff, item["value"])
                self._unpack_conflicts(object_id, diff, item["conflicts"])
                diffs.append(diff)
        diffs.append({"obj": object_id, "type": obj_type, "action": "maxElem", "value": max_counter})

    def instantiate_object(self, object_id: str):
        if object_id in self.diffs:
            return {"value": object_id, "link": True}
        rec = self.index.by_object[object_id]
        self.diffs[object_id] = []
        self.children[object_id] = []
        obj_type = rec.obj_type
        if object_id == ROOT_ID or obj_type == "makeMap":
            self._instantiate_map(object_id, "map")
        elif obj_type == "makeTable":
            self._instantiate_map(object_id, "table")
        elif obj_type == "makeList":
            self._instantiate_list(object_id, "list")
        elif obj_type == "makeText":
            self._instantiate_list(object_id, "text")
        else:
            raise ValueError(f"Unknown object type: {obj_type}")
        return {"value": object_id, "link": True}

    def make_patch(self, object_id: str, diffs: list):
        for child_id in self.children[object_id]:
            self.make_patch(child_id, diffs)
        diffs.extend(self.diffs[object_id])


def get_patch(state: BackendState) -> dict:
    """Patch that builds the whole document from scratch (backend/index.js:207-213)."""
    index = state.read_index()
    context = MaterializationContext(index)
    context.instantiate_object(ROOT_ID)
    diffs: list = []
    context.make_patch(ROOT_ID, diffs)
    return _make_patch(state, diffs)


def get_changes(old_state: BackendState, new_state: BackendState) -> list:
    if not less_or_equal(old_state.clock, new_state.clock):
        raise ValueError("Cannot diff two states that have diverged")
    return new_state._index.get_missing_changes(old_state.clock, new_state.clock)


def get_changes_for_actor(state: BackendState, actor_id: str) -> list:
    return state._index.get_changes_for_actor(actor_id, 0, state.clock)


def get_missing_changes(state: BackendState, clock: dict) -> list:
    return state._index.get_missing_changes(clock, state.clock)


def get_missing_deps(state: BackendState) -> dict:
    return OpSetIndex.missing_deps_of_queue(state.queue, state.clock)


def merge(local: BackendState, remote: BackendState):
    """Apply changes present in `remote` but not `local` (backend/index.js:246-249)."""
    changes = remote._index.get_missing_changes(local.clock, remote.clock)
    # extracted from an admitted local lineage: already schema-valid, skip
    # the per-op validation walk on this in-process hot path
    with prevalidated():
        return apply_changes(local, changes)


class Backend:
    """Namespace object mirroring the reference's Backend module interface,
    for injection into the frontend (frontend/index.js:110-114 seam)."""

    init = staticmethod(init)
    applyChanges = staticmethod(apply_changes)
    applyLocalChange = staticmethod(apply_local_change)
    getPatch = staticmethod(get_patch)
    getChanges = staticmethod(get_changes)
    getChangesForActor = staticmethod(get_changes_for_actor)
    getMissingChanges = staticmethod(get_missing_changes)
    getMissingDeps = staticmethod(get_missing_deps)
    merge = staticmethod(merge)
    # snake_case aliases
    apply_changes = staticmethod(apply_changes)
    apply_local_change = staticmethod(apply_local_change)
    get_patch = staticmethod(get_patch)
    get_changes = staticmethod(get_changes)
    get_changes_for_actor = staticmethod(get_changes_for_actor)
    get_missing_changes = staticmethod(get_missing_changes)
    get_missing_deps = staticmethod(get_missing_deps)
    undo = staticmethod(undo)
    redo = staticmethod(redo)
