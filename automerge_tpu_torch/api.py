"""Top-level API: binds the frontend to an in-process backend.

Counterpart of reference src/automerge.js. Documents are immutable
values; every mutation returns a new document. ``save``/``load`` serialize the
change history as plain JSON (the reference uses transit-JSON; the logical
content — history ++ queue — is the same, src/automerge.js:59-66).

Documents live on the backend their ``init`` options name: by default the
device backend on the CUDA card (``backend.default``, whose namespace is
``backend.DeviceBackend``; without a card ``init()`` raises), or
``{"backend": backend.backend_for("cpu")}`` for the engines' plain PyTorch
versions on the CPU. (``backend.Backend`` is the oracle facade's
namespace, as in the JAX package.) Every helper that builds a document
(``load``, ``restore``, ``get_all_changes``, a history entry's snapshot)
builds it on the backend of the document it serves or the backend its
``options`` name. The checkpoint forms: ``save(doc, checkpoint=)`` writes
a delta save, ``load(data, checkpoint=)`` restores one, and ``restore``
rebuilds a document from a checkpoint bundle (checkpoint/).
"""

from __future__ import annotations

import json

from . import frontend as Frontend
from .backend import default as Backend
from ._common import ROOT_ID
from ._uuid import uuid  # noqa: F401  (re-exported, like the reference)
from .frontend import Counter, Table, Text  # noqa: F401
from .resilience.validation import validate_save_payload

_SAVE_FORMAT = "automerge-tpu-v1"


def _backend_of(doc):
    """The backend namespace a document was made with."""
    return doc._options.get("backend") or Backend.Backend


def _doc_from_changes(options, changes):
    doc = init(options)
    backend = _backend_of(doc)
    state, _ = backend.apply_changes(backend.init(), changes)
    patch = backend.get_patch(state)
    patch["state"] = state
    return Frontend.apply_patch(doc, patch)


def init(options=None):
    if isinstance(options, str):
        options = {"actorId": options}
    elif options is None:
        options = {}
    elif not isinstance(options, dict):
        raise TypeError(f"Unsupported options for init(): {options!r}")
    return Frontend.init({"backend": Backend.Backend, **options})


def from_(initial_state, options=None):
    new_doc = change(init(options), {"message": "Initialization", "undoable": False},
                     lambda doc: doc.update(initial_state))
    return new_doc


def change(doc, options=None, callback=None):
    new_doc, _ = Frontend.change(doc, options, callback)
    return new_doc


def empty_change(doc, options=None):
    new_doc, _ = Frontend.empty_change(doc, options)
    return new_doc


def undo(doc, options=None):
    new_doc, _ = Frontend.undo(doc, options)
    return new_doc


def redo(doc, options=None):
    new_doc, _ = Frontend.redo(doc, options)
    return new_doc


def save(doc, checkpoint=None) -> str:
    """Serialize a document's change history as plain JSON.

    With ``checkpoint=`` (a :class:`~.checkpoint.Checkpoint` or bundle
    bytes from :func:`~.checkpoint.checkpoint_doc`), the save is
    DELTA-COMPACTED: the change prefix the checkpoint's clock frontier
    covers is dropped and only the op-log tail is written; ``load`` then
    needs the same base checkpoint back (checkpoint/__init__.py)."""
    state = Frontend.get_backend_state(doc)
    if checkpoint is not None:
        from .checkpoint import save_delta
        return save_delta(state, checkpoint)
    changes = state.history() + list(state.queue)
    return json.dumps({"format": _SAVE_FORMAT, "changes": changes})


def load(data: str, options=None, checkpoint=None):
    """A document rebuilt from ``save`` output, on the backend `options`
    name (the default binding otherwise). A delta save needs its base
    ``checkpoint``: the checkpoint restores, then the tail replays."""
    from .checkpoint import DELTA_FORMAT, load_delta
    payload = json.loads(data)
    # envelope validation (resilience.validation): non-dict payloads and a
    # missing/non-array `changes` raise a typed ProtocolError (a
    # ValueError) instead of leaking AttributeError/KeyError
    validate_save_payload(payload, require_changes=False)
    fmt = payload["format"]
    if fmt == DELTA_FORMAT:
        return load_delta(payload, checkpoint, options)
    if fmt != _SAVE_FORMAT:
        raise ValueError(f"Unsupported save format: {fmt!r}")
    validate_save_payload(payload, require_changes=True)
    return _doc_from_changes(options, payload["changes"])


def restore(checkpoint, options=None):
    """A document restored directly from a checkpoint bundle, on the
    backend `options` name. Raises
    :class:`~.resilience.errors.CheckpointError` if the bundle is corrupt
    or truncated (every array is content-hashed)."""
    from .checkpoint import restore_doc
    return restore_doc(checkpoint, options)


def merge(local_doc, remote_doc):
    """Apply remote's changes to local (src/automerge.js:68-78)."""
    if Frontend.get_actor_id(local_doc) == Frontend.get_actor_id(remote_doc):
        raise ValueError("Cannot merge an actor with itself")
    local_state = Frontend.get_backend_state(local_doc)
    remote_state = Frontend.get_backend_state(remote_doc)
    state, patch = Backend.merge(local_state, remote_state)
    # "no diffs" does NOT mean "nothing applied": this backend emits NET
    # diffs, so a remote history whose net effect is zero (e.g. a delete
    # followed by its undo) applies real changes yet produces an empty
    # diff list. Returning local_doc then would silently drop those
    # changes from the returned lineage (they would never re-sync — the
    # clock says we have them). Short-circuit only when the clock proves
    # nothing was applied. The reference's diff-based guard
    # (src/automerge.js:68-78) is safe only under per-op diff emission.
    if not patch["diffs"] and patch["clock"] == dict(local_state.clock):
        return local_doc
    patch["state"] = state
    return Frontend.apply_patch(local_doc, patch)


def diff(old_doc, new_doc) -> list:
    old_state = Frontend.get_backend_state(old_doc)
    new_state = Frontend.get_backend_state(new_doc)
    changes = Backend.get_changes(old_state, new_state)
    _, patch = Backend.apply_changes(old_state, changes)
    return patch["diffs"]


def get_changes(old_doc, new_doc) -> list:
    old_state = Frontend.get_backend_state(old_doc)
    new_state = Frontend.get_backend_state(new_doc)
    return Backend.get_changes(old_state, new_state)


def get_all_changes(doc) -> list:
    backend = _backend_of(doc)
    return backend.get_changes(backend.init(),
                               Frontend.get_backend_state(doc))


def apply_changes(doc, changes):
    old_state = Frontend.get_backend_state(doc)
    new_state, patch = Backend.apply_changes(old_state, changes)
    patch["state"] = new_state
    return Frontend.apply_patch(doc, patch)


def get_missing_deps(doc) -> dict:
    return Backend.get_missing_deps(Frontend.get_backend_state(doc))


def equals(val1, val2) -> bool:
    """Deep structural equality ignoring CRDT metadata (src/automerge.js:109-118)."""
    if isinstance(val1, dict) and isinstance(val2, dict):
        if set(val1.keys()) != set(val2.keys()):
            return False
        return all(equals(val1[k], val2[k]) for k in val1)
    if isinstance(val1, (list, tuple)) and isinstance(val2, (list, tuple)):
        return len(val1) == len(val2) and all(equals(a, b) for a, b in zip(val1, val2))
    return val1 == val2


class _HistoryEntry:
    """Lazy history item: the raw change plus a replayed snapshot
    (src/automerge.js:120-134)."""

    __slots__ = ("_history", "_index", "_actor", "_backend")

    def __init__(self, history, index, actor, backend):
        self._history = history
        self._index = index
        self._actor = actor
        self._backend = backend

    @property
    def change(self):
        return self._history[self._index]

    @property
    def snapshot(self):
        return _doc_from_changes({"actorId": self._actor,
                                  "backend": self._backend},
                                 self._history[: self._index + 1])

    def __repr__(self):
        return f"<HistoryEntry seq={self._index + 1}>"


def get_history(doc) -> list:
    state = Frontend.get_backend_state(doc)
    actor = Frontend.get_actor_id(doc)
    backend = _backend_of(doc)
    history = state.history()
    return [_HistoryEntry(history, i, actor, backend)
            for i in range(len(history))]


def to_json(doc):
    """Plain-Python snapshot of a document (dicts/lists/str values)."""
    def convert(value):
        if isinstance(value, Text):
            return str(value)
        if isinstance(value, Table):
            return {k: convert(v) for k, v in value.to_json().items()}
        if isinstance(value, Counter):
            return value.value
        if isinstance(value, dict):
            return {k: convert(v) for k, v in value.items()}
        if isinstance(value, list):
            return [convert(v) for v in value]
        return value
    return convert(doc)
