"""Backend-level checkpoint codec: whole document lineages <-> bundles.

Captures a backend state — the device tier's ``DeviceBackendState`` (the
``_DeviceCore`` object graph: per-object columnar docs, root map, change
history, clock/deps) or the oracle's ``BackendState`` — into one bundle,
and restores it without replaying the op history through the round
protocol.

Restore contract (pinned by tests/test_checkpoint.py):

- The restored document renders byte-identically to ``load(save(doc))``
  and serves ``save``/``get_changes``/sync exactly like it (the full
  change history rides in the bundle as a hashed JSON blob; per-actor
  ``states`` and their allDeps closures are rebuilt with cheap host dict
  work — the transitive-closure walk — never via engine replay).
- Undo/redo history is dropped, matching ``api.load`` semantics.
- The restored core's command log is a single synthetic
  ``("apply", history ++ queue, False)`` entry, so the log-replay
  invariants (failure-atomic restore, stale-state forks, oracle
  graduation) hold unchanged.
- Oracle lineages have no columnar state to snapshot; they checkpoint as
  compact change-log bundles and restore by oracle replay (host-only,
  no device work — still far cheaper than a device replay, and the
  uniform fallback tier).
- A device lineage restores onto the device the caller names
  (``restore_state(data, device)``; None is the CUDA card): the bundle
  carries no device. A capture that replays a fork (a stale state, or
  the async writer's worker) replays it on the lineage's own device.

The manifest and arrays are those of the JAX package's
``checkpoint/backend_codec.py``: a bundle made by either package
restores in the other.
"""

from __future__ import annotations

from .._common import ROOT_ID, transitive_deps
from ..resilience.errors import CheckpointError
from . import bundle as _bundle
from .engine_codec import capture_engine_doc, encode_grab, grab, \
    restore_engine_doc

_ENGINE_DEVICE = "device"
_ENGINE_ORACLE = "oracle"


def _backend_mods():
    from ..backend import device as _device
    from ..backend import facade as _oracle
    return _device, _oracle


def capture_state(state, assume_quiescent: bool = True) -> bytes:
    """Serialize a backend state (device or oracle lineage) to a bundle.

    ``assume_quiescent=True`` (the default) is for callers on the
    document's mutator thread — the sync tier, a quiescent test, the
    ``api.checkpoint`` path — and captures the live core directly. An
    async caller (the checkpoint writer's worker) passes ``False``: the
    capture then runs against a PRIVATE core forked from the state's
    command-log prefix, so a mutation racing the walk can never tear the
    snapshot (the fork replay happens on the worker, off the commit
    path)."""
    manifest, arrays = capture_state_pieces(state, assume_quiescent)
    return _bundle.encode(manifest, arrays)


def capture_state_pieces(state, assume_quiescent: bool = True):
    _device, _oracle = _backend_mods()
    if isinstance(state, _oracle.BackendState):
        manifest = {
            "engine": _ENGINE_ORACLE,
            "clock": dict(state.clock),
            "deps": dict(state.deps),
        }
        arrays = {
            "history_json": _bundle.json_array(state.history()),
            "queue_json": _bundle.json_array(list(state.queue)),
        }
        return manifest, arrays
    if not isinstance(state, _device.DeviceBackendState):
        raise CheckpointError(
            f"cannot checkpoint backend state of type {type(state).__name__}")
    if assume_quiescent and state._is_current():
        core = state._core
        core.flush_pending()   # engine state must be current before capture
    else:
        # a stale view, or a live core owned by another thread: replay the
        # command-log prefix into a private core (deterministic, immutable
        # inputs) and capture that — never a torn read of shared state
        core = state._core.fork(state._version)
        core.flush_pending()
    objects = []
    arrays = {}
    for i, oid in enumerate([ROOT_ID] + list(core.obj_order)):
        wrapper = core.root if oid == ROOT_ID else core.objects[oid]
        prefix = f"obj{i}_"
        frag, obj_arrays = capture_engine_doc(wrapper.doc, prefix)
        frag.pop("all_deps", None)   # rebuilt once from history at restore
        frag["prefix"] = prefix
        frag["wrapper_kind"] = wrapper.kind
        frag["max_elem"] = int(wrapper.max_elem)
        frag["announced"] = bool(getattr(wrapper, "announced", True))
        objects.append(frag)
        arrays.update(obj_arrays)
    manifest = {
        "engine": _ENGINE_DEVICE,
        "clock": dict(core.clock),
        "deps": dict(core.deps),
        "objects": objects,
        "obj_order": list(core.obj_order),
    }
    arrays["history_json"] = _bundle.json_array(core.history)
    arrays["queue_json"] = _bundle.json_array(core.queue)
    return manifest, arrays


def _rebuild_states(history: list) -> dict:
    """Per-actor change lists + allDeps closures from the applied history
    (history is in application order, so every closure input precedes its
    use) — the cheap host-dict half of ``_DeviceCore._admit``."""
    states: dict = {}
    for ch in history:
        try:
            actor, seq = ch["actor"], ch["seq"]
        except (TypeError, KeyError) as exc:
            raise CheckpointError(
                f"malformed change in checkpoint history: {exc}") from None
        base = dict(ch.get("deps", {}))
        base[actor] = seq - 1
        all_deps = transitive_deps(states, base)
        lst = states.setdefault(actor, [])
        if seq != len(lst) + 1:
            raise CheckpointError(
                f"checkpoint history is not in application order: actor "
                f"{actor!r} seq {seq} after {len(lst)} prior changes")
        lst.append({"change": ch, "allDeps": all_deps})
    return states


def restore_state(data: bytes, device=None):
    """Rebuild a backend state from a bundle, a device lineage's tables on
    `device` (None: the CUDA card). Raises CheckpointError on any
    integrity or structural failure, before any state escapes."""
    manifest, arrays = _bundle.decode(data)
    engine = manifest.get("engine")
    _device, _oracle = _backend_mods()
    try:
        history = _bundle.json_unarray(arrays["history_json"])
        queue = _bundle.json_unarray(arrays["queue_json"])
    except (KeyError, ValueError) as exc:
        raise CheckpointError(
            f"checkpoint history payload unreadable: {exc}") from None
    if not isinstance(history, list) or not isinstance(queue, list):
        raise CheckpointError("checkpoint history/queue must be arrays")

    if engine == _ENGINE_ORACLE:
        from ..resilience.validation import prevalidated
        state = _oracle.init()
        with prevalidated():
            if history or queue:
                state, _ = _oracle.apply_changes(state, history + queue)
        return state
    if engine != _ENGINE_DEVICE:
        raise CheckpointError(f"unknown checkpoint engine {engine!r}")

    core = _device._DeviceCore(device)
    core.states = _rebuild_states(history)
    core.history = list(history)
    core.queue = list(queue)
    core.clock = dict(manifest.get("clock", {}))
    core.deps = dict(manifest.get("deps", {}))
    shared_deps = core._seed_all_deps()

    objects = manifest.get("objects")
    obj_order = manifest.get("obj_order")
    if not isinstance(objects, list) or not isinstance(obj_order, list):
        raise CheckpointError("checkpoint manifest is missing its object "
                              "table")
    by_id = {}
    for frag in objects:
        doc = restore_engine_doc(frag, arrays, frag.get("prefix", ""),
                                 shared_all_deps=shared_deps,
                                 device=core.device)
        if frag["type"] == "text":
            wrapper = _device._TextObj.__new__(_device._TextObj)
            wrapper.kind = frag.get("wrapper_kind", "text")
            wrapper.doc = doc
            wrapper.max_elem = int(frag.get("max_elem", 0))
            wrapper.prev_n = 0
            wrapper.prev_vis = None
            wrapper.prev_value = None
            wrapper.prev_conf = {}
            wrapper.announced = bool(frag.get("announced", True))
            wrapper.ov = None
            wrapper._pool_scan = (0, False)
            wrapper.snapshot()      # net-diff baseline (host mirrors are
            # already planted by restore_engine_doc — no device fetch)
        else:
            wrapper = _device._MapObj.__new__(_device._MapObj)
            wrapper.kind = frag.get("wrapper_kind", "map")
            wrapper.doc = doc
            wrapper.max_elem = int(frag.get("max_elem", 0))
            wrapper.announced = bool(frag.get("announced", True))
            wrapper.ov = None
            wrapper.prev = wrapper.current()
        by_id[doc.obj_id] = wrapper
    if ROOT_ID not in by_id:
        raise CheckpointError("checkpoint bundle has no root object")
    core.root = by_id[ROOT_ID]
    core.obj_order = list(obj_order)
    try:
        core.objects = {oid: by_id[oid] for oid in obj_order}
    except KeyError as exc:
        raise CheckpointError(
            f"checkpoint object table is missing {exc}") from None
    # one synthetic log entry keeps the core == its-log invariant for
    # stale-state forks, failure-atomic restore, and oracle graduation
    if history or queue:
        core.commands = [("apply", list(history) + list(queue), False)]
    return _device.DeviceBackendState(core, len(core.commands))


def restore_state_or_replay(data: bytes, fallback_changes=None,
                            device=None):
    """Restore from a bundle; on CheckpointError, fall back to full log
    replay of ``fallback_changes`` (when provided) on `device`, else
    re-raise."""
    try:
        return restore_state(data, device)
    except CheckpointError:
        if fallback_changes is None:
            raise
        import logging
        logging.getLogger("automerge_tpu_torch.checkpoint").warning(
            "checkpoint bundle failed validation; falling back to full "
            "log replay (%d changes)", len(fallback_changes))
        backend = _backend_mods()[0].backend_for(device)
        state, _ = backend.apply_changes(backend.init(), fallback_changes)
        return state


# re-exported for the writer / tests
__all__ = ["capture_state", "capture_state_pieces", "restore_state",
           "restore_state_or_replay", "grab", "encode_grab"]
