"""Engine-level checkpoint codec: columnar device docs <-> bundle pieces.

This is the layer where checkpointing beats replay: a ``DeviceTextDoc``/
``DeviceMapDoc`` is captured as its padded columnar element tables
(trimmed to the live prefix on the device before the d2h copy), the
compressed host range index, and the small host-side causal state (clock,
allDeps closures, conflict registers, value pool) — and restored by
staging those arrays straight back to the device (pinned memory,
`engine/pipeline.py` `stage_h2d`, with the exact h2d bytes metered). No
causal admission, no run detection, no round programs: restore costs one
h2d of the live tables plus O(ranges) host work, instead of replaying the
whole op history through the round protocol. The pieces are those of the
JAX package's ``checkpoint/engine_codec.py``, and a bundle made by either
package restores in the other.

Capture is split in two phases so the async writer (:mod:`.writer`) can
overlap the heavy half with ingestion:

- ``grab()`` — a generation-stamped consistent snapshot of the doc's
  mutable host state plus *references* to its device tables. Rounds that
  run out of place replace the tables and never write a published one, so
  a grabbed reference stays valid while ingestion advances; host dicts
  are copied. Tables are torch tensors, and an in-place round
  (``donate_buffers``, ops/ingest.py `TableStore`) overwrites its tables
  without any sign on the tensor but its version counter, so the grab
  records each table's ``_version`` (`ops.ingest.table_versions`) and a
  later read of a cached grab checks them (`buffers_consumed`). On a card
  the grab also records a CUDA event on the stream that produced the
  tables, and the d2h half waits on it from whatever stream it runs on.
  Raises :class:`CaptureConflict` when the doc's generation moved
  mid-grab.
- ``encode_grab()`` — the d2h fetch, trimming, and hashing. Safe on any
  thread at any later time; it touches only the grab.

The segment mirror and closure memo are rebuilt/dropped on restore (both
are derivable caches, and the mirror is self-verifying against the device
chain bits at the next ``_scalars`` sync anyway).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..resilience.errors import CheckpointError


class CaptureConflict(RuntimeError):
    """The document mutated while its state was being grabbed."""


_TEXT_KEYS = ("parent", "ctr", "actor", "value", "has_value",
              "win_actor", "win_seq", "win_counter", "chain")
_MAP_KEYS = ("value", "has_value", "win_actor", "win_seq", "win_counter")
_BOOL_KEYS = frozenset(("has_value", "win_counter", "chain"))
_FILLS = {"win_actor": -1}
_TEXT_MIRROR = ("parent", "ctr", "actor", "value", "has_value")
_MAP_MIRROR = ("value", "has_value", "win_counter")


def _copy_conflicts(conflicts: dict) -> list:
    """Deterministic, deep-enough copy: the slow register path mutates
    conflict op dicts in place (counter inc folds), so each op is copied."""
    return [[int(slot), [dict(op) for op in ops]]
            for slot, ops in sorted(conflicts.items())]


def _copy_all_deps(all_deps: dict) -> list:
    return [[a, int(s), dict(cl)] for (a, s), cl in
            sorted(all_deps.items(), key=lambda kv: (kv[0][0], kv[0][1]))]


def grab(doc, inline: bool = False, stream=None) -> dict:
    """Generation-stamped consistent snapshot of one engine doc.

    Cheap (no d2h traffic). A grab racing a mutation serves the doc's
    last cached commit-boundary snapshot (a fully-copied prior grab —
    "some consistent prefix", the writer's contract) instead of
    conflicting; :class:`CaptureConflict` survives only for in-place
    tables and the cold first-grab race.

    A document running the streaming tier's in-place rounds
    (``doc.donate_buffers``) breaks the zero-copy contract: the next
    commit writes into the grabbed tables. Such docs refuse the deferred
    grab (:class:`CaptureConflict`, so the async writer degrades to its
    commit-boundary sync path) unless ``inline=True`` — the caller's
    promise that the grab is ENCODED before any further commit can run
    (writer.result() / the synchronous capture path).

    ``stream``: on a card, the stream whose work produced the tables (the
    mutating thread's current stream; default: this thread's current
    stream). The grab records an event there, which ``encode_grab``
    waits on."""
    from ..engine.map_doc import DeviceMapDoc
    from ..engine.text_doc import DeviceTextDoc
    from ..ops.ingest import table_versions

    if getattr(doc, "donate_buffers", False) and not inline:
        raise CaptureConflict(doc.obj_id)
    if getattr(doc, "_busy", 0):
        # a mutation is in flight: gen stamps alone can't expose one that
        # spans this whole grab (the bump lands at mutation end). Serve
        # the last commit-boundary snapshot instead of conflicting — the
        # writer's contract is "SOME consistent prefix", and every cached
        # grab is exactly one (built at a quiescent point, host dicts
        # copied, tables unwritten since — checked by version — and the
        # index persistent)
        served = _serve_snapshot(doc)
        if served is not None:
            return served
        if obs.ENABLED:
            obs.event("ckpt", "busy_wait", args={"doc": doc.obj_id})
        raise CaptureConflict(doc.obj_id)
    if doc.queue:
        raise CheckpointError(
            f"cannot checkpoint {doc.obj_id!r}: it holds causally-unready "
            "queued changes (drain or drop them first)")
    gen0 = doc._gen
    dev = dict(doc._dev) if doc._dev is not None else None
    g = {
        "gen": gen0,
        "obj_id": doc.obj_id,
        "actor_table": list(doc.actor_table),
        "clock": dict(doc.clock),
        "all_deps": _copy_all_deps(doc._all_deps),
        "conflicts": _copy_conflicts(doc.conflicts),
        "value_pool": [dict(e) for e in doc.value_pool],
        "dev": dev,
        "versions": dict(zip(dev, table_versions(dev.values())))
        if dev else {},
        "ready": None,
    }
    if isinstance(doc, DeviceTextDoc):
        g["type"] = "text"
        g["n_elems"] = doc.n_elems
        g["all_ascii"] = doc.all_ascii
        # O(1) zero-coordination snapshot: the range index is persistent
        # (merge/remap return new indexes), so the snapshot can never
        # observe a torn bulk merge; flattening to rows happens in
        # encode_grab, off the grab's critical path
        g["index"] = doc.index.snapshot()
    elif isinstance(doc, DeviceMapDoc):
        g["type"] = "map"
        g["key_table"] = list(doc.key_table)
    else:
        raise CheckpointError(
            f"cannot checkpoint engine doc of type {type(doc).__name__}")
    if doc._gen != gen0 or getattr(doc, "_busy", 0) \
            or (doc._dev is not None and dev is not None
                and dev.keys() != doc._dev.keys()):
        served = _serve_snapshot(doc)
        if served is not None:
            return served
        raise CaptureConflict(doc.obj_id)
    if dev and doc.device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(stream if stream is not None
                  else torch.cuda.current_stream(doc.device))
        g["ready"] = ev
    g["mode"] = "live"
    if not getattr(doc, "donate_buffers", False):
        # cache the grab as the doc's commit-boundary snapshot: every
        # copy above froze it, so a later grab racing a mutation (a bulk
        # index merge, a whole stacked apply) reads it with zero
        # coordination. Docs with in-place tables never cache — their
        # next commit writes the grabbed tables. Cost: the snapshot pins
        # one table-set generation between grabs.
        doc._last_grab = g
    return g


def _serve_snapshot(doc):
    """The doc's cached commit-boundary grab, as a fresh dict marked
    ``mode='snapshot'`` (None when no snapshot exists or it is no
    longer servable)."""
    snap = getattr(doc, "_last_grab", None)
    if snap is None:
        return None
    if getattr(doc, "donate_buffers", False):
        # in-place commits write the table storage: only the inline
        # (caller-owns-quiescence) path may capture such a doc
        return None
    dev = snap.get("dev")
    if dev:
        from ..ops.ingest import buffers_consumed
        if buffers_consumed(dev.values(), snap["versions"].values()):
            # an in-place session since the grab wrote the snapshot's
            # tables — the cache is dead, drop it (the cold
            # CaptureConflict path takes over, as pre-snapshot)
            doc._last_grab = None
            return None
    if obs.ENABLED:
        obs.event("ckpt", "snapshot_serve",
                  args={"doc": doc.obj_id, "gen": snap["gen"]})
    out = dict(snap)
    out["mode"] = "snapshot"
    return out


def _fetch_columns(g: dict, keys, n_live: int) -> dict:
    """The grabbed tables' live prefixes as host numpy arrays: trimmed on
    the device, copied d2h on this thread's current stream after the
    grab's producer event. Raises if an in-place round wrote a table
    since the grab (a deferred read of in-place tables)."""
    from ..ops.ingest import buffers_consumed
    dev = g["dev"]
    tables = [dev[k] for k in keys]
    cuda = bool(tables) and tables[0].device.type == "cuda"
    if cuda:
        stream = torch.cuda.current_stream(tables[0].device)
        if g.get("ready") is not None:
            stream.wait_event(g["ready"])
        for t in tables:
            # read on this stream: the allocator must not hand the memory
            # on before this stream's copies are done
            t.record_stream(stream)
    out = {k: t[:n_live].cpu().numpy() for k, t in zip(keys, tables)}
    if buffers_consumed(tables, [g["versions"][k] for k in keys]):
        raise CaptureConflict(
            f"{g['obj_id']}: its tables were written in place after the "
            "grab")
    return out


def encode_grab(g: dict, prefix: str = ""):
    """A grab -> (manifest fragment, {array name: np.ndarray}).

    The d2h half of capture: fetches the device tables the grab
    references, trims them to the live prefix, and emits the bundle
    pieces. Deterministic for a given grab."""
    frag = {
        "type": g["type"],
        "obj_id": g["obj_id"],
        "actor_table": g["actor_table"],
        "clock": g["clock"],
        "all_deps": g["all_deps"],
        "conflicts": g["conflicts"],
        "value_pool": g["value_pool"],
    }
    arrays = {}
    if g["type"] == "text":
        n_live = g["n_elems"] + 1
        frag["n_elems"] = g["n_elems"]
        frag["all_ascii"] = g["all_ascii"]
        idx = g["index"]
        starts, lens, slots = (idx if isinstance(idx, tuple)
                               else idx.rows())
        arrays[prefix + "idx_starts"] = np.asarray(starts, np.int64)
        arrays[prefix + "idx_lens"] = np.asarray(lens, np.int64)
        arrays[prefix + "idx_slots"] = np.asarray(slots, np.int64)
        keys = _TEXT_KEYS if g["n_elems"] else ()
    else:
        frag["key_table"] = g["key_table"]
        n_live = len(g["key_table"])
        keys = _MAP_KEYS if n_live else ()
    cols = _fetch_columns(g, keys, n_live) if keys else {}
    for key in keys:
        col = cols[key]
        if key in _BOOL_KEYS:
            col = col.astype(bool)
        else:
            col = col.astype(np.int32)
        arrays[prefix + "tbl_" + key] = col
    return frag, arrays


def capture_engine_doc(doc, prefix: str = ""):
    """One-shot synchronous capture (grab + encode on this thread) —
    encodes before returning, so docs with in-place tables are safe
    (inline contract)."""
    return encode_grab(grab(doc, inline=True), prefix)


def _require(arrays: dict, name: str) -> np.ndarray:
    try:
        return arrays[name]
    except KeyError:
        raise CheckpointError(
            f"checkpoint bundle is missing array {name!r}") from None


def _padded_host(arrays: dict, prefix: str, keys, n_live: int,
                 cap: int) -> dict:
    """{key: host table padded to `cap` with its fill}; raises
    CheckpointError on a table of the wrong shape or dtype."""
    host = {}
    for key in keys:
        col = _require(arrays, prefix + "tbl_" + key)
        want_bool = key in _BOOL_KEYS
        if len(col) < n_live or col.ndim != 1 \
                or (want_bool and col.dtype != np.bool_) \
                or (not want_bool and col.dtype != np.int32):
            raise CheckpointError(
                f"checkpoint table {key!r} has wrong shape/dtype")
        out = np.full(cap, _FILLS.get(key, 0),
                      np.bool_ if want_bool else np.int32)
        out[:n_live] = col[:n_live]
        host[key] = out
    return host


class _Staging:
    """The restore's h2d pass: padded host tables -> the doc's device,
    non-blocking from pinned memory on the current stream, with the exact
    staged bytes metered (engine/accounting.py). ``finish()`` is the
    barrier after which the pinned buffers may go; host work placed
    between the two overlaps the copies."""

    def __init__(self, doc, host: dict):
        from ..engine.pipeline import stage_h2d
        device = doc.device
        stream = (torch.cuda.current_stream(device)
                  if device.type == "cuda" else None)
        self.dev, self._pinned = {}, []
        staged = 0
        for key, arr in host.items():
            t, pin = stage_h2d(arr, device, stream)
            self.dev[key] = t
            if pin is not None:
                self._pinned.append(pin)
            staged += arr.nbytes
        self.done = None
        if stream is not None:
            self.done = torch.cuda.Event()
            self.done.record(stream)
        doc._count_h2d(staged)

    def finish(self):
        if self.done is not None:
            self.done.synchronize()
        self._pinned = []


def restore_engine_doc(frag: dict, arrays: dict, prefix: str = "",
                       shared_all_deps: dict = None, device=None):
    """Rebuild a DeviceTextDoc/DeviceMapDoc from bundle pieces, its tables
    on `device` (None: the CUDA card, raising without one).

    ``shared_all_deps``: backend-level restores pass the closure map
    rebuilt once from the core history (per-doc closure maps all converge
    to the same content); engine-level bundles carry their own."""
    from ..engine.host_index import BatchRangeIndex
    from ..engine.map_doc import DeviceMapDoc
    from ..engine.segments import SegmentMirror
    from ..engine.text_doc import DeviceTextDoc
    from ..ops.ingest import bucket

    try:
        typ = frag["type"]
        obj_id = frag["obj_id"]
        actor_table = list(frag["actor_table"])
        clock = dict(frag["clock"])
        conflicts = {int(slot): [dict(op) for op in ops]
                     for slot, ops in frag["conflicts"]}
        value_pool = [dict(e) for e in frag["value_pool"]]
    except (KeyError, TypeError, ValueError) as exc:
        raise CheckpointError(
            f"malformed engine-doc checkpoint fragment: {exc}") from None
    if shared_all_deps is not None:
        all_deps = dict(shared_all_deps)
    else:
        all_deps = {(a, int(s)): dict(cl)
                    for a, s, cl in frag.get("all_deps", [])}

    if typ == "text":
        n_elems = int(frag["n_elems"])
        doc = DeviceTextDoc(obj_id, capacity=max(n_elems + 1, 16),
                            device=device)
        doc.all_ascii = bool(frag["all_ascii"])
        doc.n_elems = n_elems
        idx = BatchRangeIndex.from_rows(*(
            np.asarray(_require(arrays, prefix + name), np.int64)
            for name in ("idx_starts", "idx_lens", "idx_slots")))
        doc.index = idx
        if n_elems:
            n_live = n_elems + 1
            cap = max(bucket(n_live), doc._cap)
            host = _padded_host(arrays, prefix, _TEXT_KEYS, n_live, cap)
            staging = _Staging(doc, host)
            # host work while the copies run: the mirror rebuild
            try:
                doc.seg_mirror = SegmentMirror.rebuild(
                    host["chain"], host["parent"], n_elems, idx.slot_to_key)
                doc._seg_bound = max(doc.seg_mirror.n_segs, 1)
            except Exception:
                # degraded-but-correct: the self-contained materialize
                # kernels take over (same contract as the heal path)
                doc.seg_mirror = None
                doc._seg_bound = n_elems + 2
            staging.finish()
            doc._dev = staging.dev
            doc._host = {k: host[k] for k in _TEXT_MIRROR}
            doc._cap = cap
        else:
            doc.seg_mirror = SegmentMirror.empty()
    elif typ == "map":
        key_table = list(frag["key_table"])
        doc = DeviceMapDoc(obj_id, capacity=max(len(key_table), 16),
                           device=device)
        doc.key_table = key_table
        doc._key_slot = {k: i for i, k in enumerate(key_table)}
        if key_table:
            n_live = len(key_table)
            cap = max(bucket(n_live, 16), doc._cap)
            host = _padded_host(arrays, prefix, _MAP_KEYS, n_live, cap)
            staging = _Staging(doc, host)
            staging.finish()
            doc._dev = staging.dev
            doc._host = {k: host[k] for k in _MAP_MIRROR}
            doc._cap = cap
    else:
        raise CheckpointError(f"unknown engine doc type {typ!r} in "
                              "checkpoint fragment")

    doc.actor_table = actor_table
    doc._actor_rank = {a: i for i, a in enumerate(actor_table)}
    doc._intern_gen += 1
    doc.clock = clock
    doc._all_deps = all_deps
    doc.conflicts = conflicts
    doc.value_pool = value_pool
    doc._note_footprint()
    return doc
