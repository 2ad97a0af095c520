"""Frontend: user-visible document state + change/patch plumbing.

Counterpart of reference frontend/index.js. The frontend holds the
materialized document (immutable view objects) and talks to a backend only via
plain-JSON change requests and patches, so the backend can be the in-process
oracle, a device-resident columnar engine, or a remote process.

Supports both operation modes of the reference:
- immediate backend (``backend=`` option): changes apply synchronously;
- async mode (no backend): requests queue with optimistic local application,
  reconciled on ``apply_patch`` with sequence matching and an OT transform of
  in-flight requests (frontend/index.js:151-212).
"""

from __future__ import annotations

from .._common import ROOT_ID
from .._uuid import uuid as _uuid
from ..obs import lineage
from .apply_patch import (InboundIndex, apply_diffs, clone_root_object,
                          copy_inbound, update_parent_objects)
from .context import Context
from .proxies import ListProxy, MapProxy, root_object_proxy
from .types import Counter, ListDoc, MapDoc, Table, Text

__all__ = [
    "init", "from_", "change", "empty_change", "apply_patch",
    "can_undo", "undo", "can_redo", "redo",
    "get_object_id", "get_object_by_id", "get_actor_id", "set_actor_id",
    "get_conflicts", "get_backend_state", "get_element_ids",
    "Text", "Table", "Counter", "Frontend",
]


def _update_root_object(doc, updated, inbound, state):
    """New immutable root reflecting `updated`, sharing everything else
    (frontend/index.js:17-50)."""
    new_doc = updated.get(ROOT_ID)
    if new_doc is None:
        new_doc = clone_root_object(doc._cache[ROOT_ID])
        updated[ROOT_ID] = new_doc
    new_doc._options = doc._options
    new_doc._cache = updated
    new_doc._inbound = inbound
    new_doc._state = state

    for object_id, obj in doc._cache.items():
        if object_id not in updated:
            updated[object_id] = obj

    if doc._options.get("freeze"):
        for obj in updated.values():
            if hasattr(obj, "_freeze"):
                obj._freeze()
    return new_doc


def _ensure_single_assignment(ops):
    """Keep only the most recent assignment per (obj, key); merge counter incs
    (frontend/index.js:57-78)."""
    assignments: dict = {}
    result = []
    for op in reversed(ops):
        obj, key, action = op.get("obj"), op.get("key"), op["action"]
        if action in ("set", "del", "link", "inc"):
            if obj not in assignments:
                assignments[obj] = {key: op}
                result.append(op)
            elif key not in assignments[obj]:
                assignments[obj][key] = op
                result.append(op)
            elif assignments[obj][key]["action"] == "inc" and action in ("set", "inc"):
                assignments[obj][key]["action"] = action
                assignments[obj][key]["value"] += op["value"]
        else:
            result.append(op)
    result.reverse()
    return result


def _make_change(doc, request_type, context, options):
    """Queue or apply a change request; returns (new_doc, request)
    (frontend/index.js:89-125)."""
    actor = get_actor_id(doc)
    if not actor:
        raise ValueError("Actor ID must be initialized with set_actor_id() "
                         "before making a change")
    state = dict(doc._state)
    state["seq"] += 1
    deps = dict(state["deps"])
    deps.pop(actor, None)

    request = {"requestType": request_type, "actor": actor, "seq": state["seq"],
               "deps": deps}
    if options and options.get("message") is not None:
        request["message"] = options["message"]
    if options and options.get("undoable") is False:
        request["undoable"] = False
    if context is not None:
        request["ops"] = _ensure_single_assignment(context.ops)

    backend = doc._options.get("backend")
    if backend:
        backend_state, patch = backend.apply_local_change(state["backendState"], request)
        state["backendState"] = backend_state
        state["requests"] = []
        if lineage.ENABLED:
            # the origin hop: the change exists as of this local commit.
            # The origin replica is identified by its actor id — the one
            # label every downstream replica can reconstruct from the
            # change itself with zero coordination (INTERNALS §18.1)
            lineage.hop(actor, state["seq"], "origin", site=actor)
        return _apply_patch_to_doc(doc, patch, state, from_backend=True), request

    if context is None:
        context = Context(doc, actor)
    queued = dict(request)
    queued["before"] = doc
    queued["diffs"] = context.diffs
    state["requests"] = state["requests"] + [queued]
    return _update_root_object(doc, context.updated, context.inbound, state), request


def _apply_patch_to_doc(doc, patch, state, from_backend):
    actor = get_actor_id(doc)
    inbound = copy_inbound(doc._inbound)
    updated: dict = {}
    apply_diffs(patch["diffs"], doc._cache, updated, inbound)
    update_parent_objects(doc._cache, updated, inbound)

    if from_backend:
        seq = (patch.get("clock") or {}).get(actor)
        if seq and seq > state["seq"]:
            state["seq"] = seq
        state["deps"] = patch["deps"]
        state["canUndo"] = patch["canUndo"]
        state["canRedo"] = patch["canRedo"]
    return _update_root_object(doc, updated, inbound, state)


def _transform_request(request, patch):
    """Simple OT of an in-flight local request past a remote patch
    (frontend/index.js:188-212 — same documented-incomplete transform; the
    result is transient and replaced by the backend's authoritative patch)."""
    transformed = []
    for local in request["diffs"]:
        local = dict(local)
        drop = False
        for remote in patch["diffs"]:
            if (local["obj"] == remote["obj"] and local["type"] == "list"
                    and local["action"] in ("insert", "set", "remove")):
                if remote["action"] == "insert" and remote["index"] <= local["index"]:
                    local["index"] += 1
                if remote["action"] == "remove" and remote["index"] < local["index"]:
                    local["index"] -= 1
                if remote["action"] == "remove" and remote["index"] == local["index"]:
                    if local["action"] == "set":
                        local["action"] = "insert"
                    if local["action"] == "remove":
                        drop = True
                        break
        if not drop:
            transformed.append(local)
    request["diffs"] = transformed


def init(options=None):
    """Create an empty document (frontend/index.js:217-241).

    `options` may be an actor-id string or a dict with keys `actorId`,
    `deferActorId`, `freeze`, `backend`.
    """
    if isinstance(options, str):
        options = {"actorId": options}
    elif options is None:
        options = {}
    elif not isinstance(options, dict):
        raise TypeError(f"Unsupported value for init() options: {options!r}")
    else:
        options = dict(options)
    if options.get("actorId") is None and not options.get("deferActorId"):
        options["actorId"] = _uuid()

    root = MapDoc(object_id=ROOT_ID)
    state = {"seq": 0, "requests": [], "deps": {}, "canUndo": False, "canRedo": False}
    if options.get("backend"):
        state["backendState"] = options["backend"].init()
    root._options = options
    root._cache = {ROOT_ID: root}
    root._inbound = InboundIndex()
    root._state = state
    root._freeze()
    return root


def from_(initial_state, options=None):
    """New document initialized with `initial_state` (frontend/index.js:246-248)."""
    new_doc, _ = change(init(options), "Initialization",
                        lambda doc: doc.update(initial_state))
    return new_doc


def change(doc, options=None, callback=None):
    """Run `callback` against a mutable view; returns (new_doc, request)
    (frontend/index.js:264-295)."""
    if isinstance(doc, (MapProxy, ListProxy)):
        raise TypeError("Calls to change cannot be nested")
    if not isinstance(doc, MapDoc) or doc._object_id != ROOT_ID:
        raise TypeError("The first argument to change must be the document root")
    if callable(options) and callback is None:
        options, callback = None, options
    if isinstance(options, str):
        options = {"message": options}
    if options is not None and not isinstance(options, dict):
        raise TypeError("Unsupported type of options")

    actor_id = get_actor_id(doc)
    if not actor_id:
        raise ValueError("Actor ID must be initialized with set_actor_id() "
                         "before making a change")
    context = Context(doc, actor_id)
    callback(root_object_proxy(context))

    if not context.updated:
        context.closed = True
        return doc, None
    update_parent_objects(doc._cache, context.updated, context.inbound)
    result = _make_change(doc, "change", context, options)
    context.closed = True
    return result


def empty_change(doc, options=None):
    """A change with no ops — acknowledges received changes via deps
    (frontend/index.js:305-318)."""
    if isinstance(options, str):
        options = {"message": options}
    if options is not None and not isinstance(options, dict):
        raise TypeError("Unsupported type of options")
    actor_id = get_actor_id(doc)
    if not actor_id:
        raise ValueError("Actor ID must be initialized with set_actor_id() "
                         "before making a change")
    return _make_change(doc, "change", Context(doc, actor_id), options)


def apply_patch(doc, patch):
    """Apply a backend patch, reconciling the in-flight request queue
    (frontend/index.js:326-361)."""
    state = dict(doc._state)

    if state["requests"]:
        base_doc = state["requests"][0]["before"]
        if patch.get("actor") == get_actor_id(doc) and patch.get("seq") is not None:
            if state["requests"][0]["seq"] != patch["seq"]:
                raise ValueError(
                    f"Mismatched sequence number: patch {patch['seq']} does not match "
                    f"next request {state['requests'][0]['seq']}")
            state["requests"] = [dict(r) for r in state["requests"][1:]]
        else:
            state["requests"] = [dict(r) for r in state["requests"]]
    else:
        base_doc = doc
        state["requests"] = []

    if doc._options.get("backend"):
        if patch.get("state") is None:
            raise ValueError("When an immediate backend is used, a patch must "
                             "contain the new backend state")
        state["backendState"] = patch["state"]
        state["requests"] = []
        return _apply_patch_to_doc(doc, patch, state, from_backend=True)

    new_doc = _apply_patch_to_doc(base_doc, patch, state, from_backend=True)
    for request in state["requests"]:
        request["before"] = new_doc
        _transform_request(request, patch)
        new_doc = _apply_patch_to_doc(request["before"], request, state, from_backend=False)
    return new_doc


def _is_undo_redo_in_flight(doc) -> bool:
    return any(r["requestType"] in ("undo", "redo") for r in doc._state["requests"])


def can_undo(doc) -> bool:
    return bool(doc._state["canUndo"]) and not _is_undo_redo_in_flight(doc)


def undo(doc, options=None):
    if isinstance(options, str):
        options = {"message": options}
    if options is not None and not isinstance(options, dict):
        raise TypeError("Unsupported type of options")
    if not doc._state["canUndo"]:
        raise ValueError("Cannot undo: there is nothing to be undone")
    if _is_undo_redo_in_flight(doc):
        raise ValueError("Can only have one undo in flight at any one time")
    return _make_change(doc, "undo", None, options)


def can_redo(doc) -> bool:
    return bool(doc._state["canRedo"]) and not _is_undo_redo_in_flight(doc)


def redo(doc, options=None):
    if isinstance(options, str):
        options = {"message": options}
    if options is not None and not isinstance(options, dict):
        raise TypeError("Unsupported type of options")
    if not doc._state["canRedo"]:
        raise ValueError("Cannot redo: there is no prior undo")
    if _is_undo_redo_in_flight(doc):
        raise ValueError("Can only have one redo in flight at any one time")
    return _make_change(doc, "redo", None, options)


def get_object_id(obj):
    return getattr(obj, "_object_id", None)


def get_object_by_id(doc, object_id):
    if isinstance(doc, (MapProxy, ListProxy)):
        return doc._context.instantiate_proxy(object_id)
    return doc._cache.get(object_id)


def get_actor_id(doc):
    return doc._state.get("actorId") or doc._options.get("actorId")


def set_actor_id(doc, actor_id):
    state = dict(doc._state)
    state["actorId"] = actor_id
    return _update_root_object(doc, {}, doc._inbound, state)


def get_conflicts(obj, key):
    """Conflicting concurrently-assigned values at `key`: {actor_id: value}."""
    if isinstance(obj, ListDoc):
        if 0 <= key < len(obj._conflicts):
            return obj._conflicts[key]
        return None
    if isinstance(obj, Text):
        return obj.elems[key].get("conflicts")
    return obj._conflicts.get(key)


def get_backend_state(doc):
    return doc._state.get("backendState")


def get_element_ids(lst):
    if isinstance(lst, Text):
        return [e.get("elemId") for e in lst.elems]
    return list(lst._elem_ids)


class Frontend:
    """Namespace mirroring the reference's Frontend module, for symmetry with
    ``backend.Backend``."""

    init = staticmethod(init)
    from_ = staticmethod(from_)
    change = staticmethod(change)
    emptyChange = staticmethod(empty_change)
    empty_change = staticmethod(empty_change)
    applyPatch = staticmethod(apply_patch)
    apply_patch = staticmethod(apply_patch)
    canUndo = staticmethod(can_undo)
    can_undo = staticmethod(can_undo)
    undo = staticmethod(undo)
    canRedo = staticmethod(can_redo)
    can_redo = staticmethod(can_redo)
    redo = staticmethod(redo)
    getObjectId = staticmethod(get_object_id)
    get_object_id = staticmethod(get_object_id)
    getObjectById = staticmethod(get_object_by_id)
    get_object_by_id = staticmethod(get_object_by_id)
    getActorId = staticmethod(get_actor_id)
    get_actor_id = staticmethod(get_actor_id)
    setActorId = staticmethod(set_actor_id)
    set_actor_id = staticmethod(set_actor_id)
    getConflicts = staticmethod(get_conflicts)
    get_conflicts = staticmethod(get_conflicts)
    getBackendState = staticmethod(get_backend_state)
    get_backend_state = staticmethod(get_backend_state)
    getElementIds = staticmethod(get_element_ids)
    get_element_ids = staticmethod(get_element_ids)
    Text = Text
    Table = Table
    Counter = Counter
