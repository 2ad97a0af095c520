"""Checkpoint & compaction tier: columnar snapshots + delta restore.

``api.save()`` serializes the full change log and ``load()`` replays every
change through the round protocol, so cold-starting a large document pays
its entire ingest history again — and a late-joining sync peer pays it
over the wire. This tier snapshots the engine and backend state
*directly*, as the JAX package's ``checkpoint`` package does, in the same
``AMTPUCKPT1`` bundles (a bundle made by either package restores in the
other):

- :mod:`.bundle` — the versioned manifest + per-array SHA-256 container.
  Corruption of any byte raises the typed :class:`CheckpointError` before
  restored state escapes.
- :mod:`.engine_codec` — ``DeviceTextDoc``/``DeviceMapDoc`` columnar
  tables, host range index, and causal host state; restore = one h2d
  staging pass, no replay.
- :mod:`.backend_codec` — whole lineages (device core or oracle state),
  history-complete so a restored doc syncs/saves like the original.
- :mod:`.writer` — the async capture path riding the pipeline ring's
  seam: generation-checked grabs overlap ingestion, degrading to a
  synchronous grab on sustained conflict.
- delta saves (:func:`save_delta` / ``api.save(doc, checkpoint=...)``) —
  a checkpoint records the clock frontier it covers; later saves carry
  only the op-log tail, and restore = snapshot + tail replay.

A restore lands on a device: ``restore_doc`` on the device of the backend
namespace its ``options`` name (``backend.DeviceBackend``, the default,
is the CUDA card; ``backend.backend_for("cpu")`` the CPU), and
``restore_engine(data, device=None)`` on `device` (None: the card). The
bundle carries no device. The snapshot-bootstrapped sync of the JAX
package (``SyncHub``/``DocSet``) comes with the sync tier.
"""

from __future__ import annotations

import json

from .._common import less_or_equal
from ..resilience.errors import CheckpointError  # noqa: F401  (re-export)
from . import bundle as _bundle
from .backend_codec import (  # noqa: F401
    capture_state, restore_state, restore_state_or_replay,
)
from .writer import AsyncCheckpointer, CheckpointHandle  # noqa: F401

DELTA_FORMAT = "automerge-tpu-delta-v1"


class Checkpoint:
    """A checkpoint bundle plus its cheap metadata (id, frontier clock).

    Wraps the raw bundle bytes; the manifest is peeked lazily (header
    parse only — full integrity verification happens at restore)."""

    __slots__ = ("data", "_id", "_manifest")

    def __init__(self, data: bytes):
        self.data = bytes(data)
        self._id = None
        self._manifest = None

    @classmethod
    def wrap(cls, obj) -> "Checkpoint":
        if isinstance(obj, Checkpoint):
            return obj
        if isinstance(obj, (bytes, bytearray, memoryview)):
            return cls(obj)
        raise CheckpointError(
            f"expected a Checkpoint or bundle bytes, got "
            f"{type(obj).__name__}")

    @property
    def id(self) -> str:
        if self._id is None:
            self._id = _bundle.bundle_id(self.data)
        return self._id

    @property
    def manifest(self) -> dict:
        if self._manifest is None:
            self._manifest = _bundle.peek(self.data)
        return self._manifest

    @property
    def clock(self) -> dict:
        """The clock frontier this checkpoint covers."""
        return dict(self.manifest.get("clock", {}))

    def __len__(self):
        return len(self.data)


# ---------------------------------------------------------------------------
# document-level capture/restore
# ---------------------------------------------------------------------------

def checkpoint_doc(doc) -> Checkpoint:
    """Capture a frontend document's backend lineage into a checkpoint."""
    from .. import frontend as Frontend
    state = Frontend.get_backend_state(doc)
    if state is None:
        raise CheckpointError(
            "this object has no backend state to checkpoint (a snapshot "
            "from the history?)")
    return Checkpoint(capture_state(state))


def restore_doc(checkpoint, options=None):
    """A frontend document restored from a checkpoint bundle (verified),
    on the device of the backend `options` name."""
    state = restore_state(Checkpoint.wrap(checkpoint).data,
                          _device_of(options))
    return _doc_from_state(state, options)


def restore_doc_or_replay(checkpoint, fallback_changes, options=None):
    """Restore a document; a corrupt bundle falls back to full log replay
    of ``fallback_changes`` (raises CheckpointError when none given)."""
    ck = Checkpoint.wrap(checkpoint)
    state = restore_state_or_replay(ck.data, fallback_changes,
                                    _device_of(options))
    return _doc_from_state(state, options)


def _device_of(options):
    """The device of the backend namespace `options` name: its `device`
    (None, the CUDA card, for the default binding)."""
    if isinstance(options, dict) and options.get("backend") is not None:
        return getattr(options["backend"], "device", None)
    return None


def _doc_from_state(state, options=None):
    from .. import frontend as Frontend
    from ..api import _backend_of, init
    doc = init(options)
    patch = _backend_of(doc).get_patch(state)
    patch["state"] = state
    return Frontend.apply_patch(doc, patch)


# ---------------------------------------------------------------------------
# delta saves (compaction)
# ---------------------------------------------------------------------------

def save_delta(state, checkpoint) -> str:
    """A compacted save: only the op-log tail past the checkpoint's clock
    frontier (the covered prefix is dropped — the compaction contract;
    ``api.load`` needs the base checkpoint back to restore it)."""
    from ..backend import default as Backend
    ck = Checkpoint.wrap(checkpoint)
    frontier = ck.clock
    if not less_or_equal(frontier, dict(state.clock)):
        raise ValueError(
            "checkpoint is not an ancestor of this document (its frontier "
            "exceeds the document clock)")
    tail = Backend.get_missing_changes(state, frontier)
    tail = tail + [c for c in state.queue
                   if c.get("seq", 0) > frontier.get(c.get("actor"), 0)]
    return json.dumps({"format": DELTA_FORMAT, "checkpointId": ck.id,
                       "frontier": frontier, "changes": tail})


def load_delta(payload: dict, checkpoint, options=None):
    """Restore a delta save: verified snapshot restore + tail replay."""
    if checkpoint is None:
        raise ValueError(
            "this save is delta-compacted; pass its base checkpoint "
            "(load(data, checkpoint=...))")
    ck = Checkpoint.wrap(checkpoint)
    want = payload.get("checkpointId")
    if want is not None and want != ck.id:
        raise CheckpointError(
            f"wrong base checkpoint: save references {want!r}, got "
            f"{ck.id!r}")
    doc = restore_doc(ck, options)
    tail = payload.get("changes") or []
    if tail:
        from ..api import apply_changes
        doc = apply_changes(doc, tail)
    return doc


# ---------------------------------------------------------------------------
# engine-doc capture/restore (the bench-level building block)
# ---------------------------------------------------------------------------

def capture_engine(doc) -> bytes:
    """A standalone bundle of one engine doc (DeviceTextDoc/DeviceMapDoc)."""
    return AsyncCheckpointer.capture(doc)


def restore_engine(data: bytes, device=None):
    """Rebuild an engine doc from a :func:`capture_engine` bundle, its
    tables on `device` (None: the CUDA card)."""
    from .engine_codec import restore_engine_doc
    manifest, arrays = _bundle.decode(data)
    if manifest.get("engine") != "engine-doc":
        raise CheckpointError(
            f"not an engine-doc checkpoint: {manifest.get('engine')!r}")
    frag = manifest.get("doc")
    if not isinstance(frag, dict):
        raise CheckpointError("engine-doc checkpoint is missing its doc "
                              "fragment")
    return restore_engine_doc(frag, arrays, device=device)


__all__ = [
    "AsyncCheckpointer", "Checkpoint", "CheckpointError",
    "CheckpointHandle", "DELTA_FORMAT", "capture_engine", "capture_state",
    "checkpoint_doc", "load_delta", "restore_doc", "restore_doc_or_replay",
    "restore_engine", "restore_state", "restore_state_or_replay",
    "save_delta",
]
