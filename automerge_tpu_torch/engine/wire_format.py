"""Binary columnar wire format: zero-copy from socket to device staging.

``AMTPUWIRE1`` is a versioned flat binary change-batch container whose
wire layout IS the engine's struct-of-arrays batch: the sections are the
op columns of :class:`~.columnar.TextChangeBatch` /
:class:`~.columnar.MapChangeBatch` plus the per-change columns of
:class:`~.wire_columns.ColumnarChangeBatch` (dense actor ids, seq
column, CSR-flattened content-deduped dep groups), exactly as the
columnar planner consumes them. ``decode()`` is therefore a header
parse + integrity hash + bounds check returning numpy views
(``np.frombuffer`` over the frame — no copy, no per-change or per-op
Python), and the first ``prepare_batch`` after a decode runs fully
columnar with zero derivation: service ingest -> admission -> h2d
staging is a bounds-check + view, not a parse (ROADMAP item 4; the
dict-shaped decode was the dominant host-CPU term left on the
service-scale serial profile).

Container discipline follows the checkpoint tier's ``AMTPUCKPT1``
(checkpoint/bundle.py): magic + u64 manifest length + SHA-256 over the
manifest, canonical-JSON manifest with a per-section table
(name/dtype/shape/offset/nbytes) plus ONE SHA-256 over the whole
section body, raw little-endian section bytes. Any truncation, bit flip, version mismatch, or out-of-envelope
column value raises the typed :class:`WireFormatError` (a
``ProtocolError``) BEFORE any state escapes — the malformed-frame
property tests feed truncated/flipped/oversize frames through the sync
gate and assert nothing but typed rejections.

Scope and the parity contract:

- A frame carries the changes of ONE object (text/list or map/table
  grammar; no ``make*`` ops, no multi-object changes). Everything else
  stays on the dict wire — :func:`split_outgoing` peels the longest
  frame-scoped suffix off an outgoing change list and leaves the rest
  (typically just the creation change) as the dict prefix of the same
  message. Frames below ``AMTPU_WIRE_MIN_OPS`` ops are not minted (the
  manifest overhead would exceed the payload).
- ``encode()`` is byte-deterministic, and the frame is LOSSLESS against
  the dict form: :func:`materialize_changes` reconstructs the canonical
  wire dicts (the exact key order the frontend mints), so committed
  state — save bytes, history — is byte-identical across binary and
  dict deliveries (pinned by tests/test_torch_api.py against the JAX
  package's frames).
- The dict path stays fully supported: decoding is always on, so a
  document takes binary and dict deliveries alike. A hub always mints
  frames for in-scope payloads (the JAX package's default; its
  ``AMTPU_WIRE_BINARY`` mint switch selects a dict comparator and is
  not ported).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import struct

import numpy as np

from .._common import (HEAD_PARENT, INT32_MAX, KIND_DEL, KIND_INC, KIND_INS,
                       KIND_SET)
from ..obs.lineage import MAX_CONTEXT_ENTRIES
from ..resilience.errors import ProtocolError

__all__ = ["WireFormatError", "WireFrame", "encode_batch", "encode_changes",
           "decode", "materialize_changes", "split_outgoing",
           "combine_frames", "as_frame", "wire_min_ops",
           "validate_trace_context", "validate_group_token"]

MAGIC = b"AMTPUWIRE1\n"
FORMAT = "automerge-tpu-wire"
VERSION = 1


class WireFormatError(ProtocolError):
    """A malformed, truncated, corrupt, or wrong-version binary frame.

    Subclasses :class:`ProtocolError` so every existing typed-rejection
    path (gate, hub, service per-tenant degradation) handles binary
    malformation exactly like dict-wire malformation."""


def wire_min_ops() -> int:
    """Minimum op count worth a frame: below it the manifest/hash
    overhead (~3 KB) exceeds the payload and the per-op dict walk is
    already cheap — the same bulk threshold the columnar decode gate
    uses (``wire_columns._NUMPY_MIN_OPS``). Read per call, so a test
    can lower it."""
    try:
        return int(os.environ.get("AMTPU_WIRE_MIN_OPS", "64") or 0)
    except ValueError:
        return 64


# ---------------------------------------------------------------------------
# container (AMTPUCKPT1 discipline, wire magic)
# ---------------------------------------------------------------------------


def _pack(manifest: dict, arrays: dict) -> bytes:
    """Sections pack as one contiguous body hashed ONCE (the manifest —
    itself header-hashed — pins every section's dtype/shape/extent, so
    a single SHA-256 over the body plus the manifest hash covers
    everything a per-section hash would, at one hash setup instead of
    N; decode is a hot per-message path, unlike checkpoint restore)."""
    table = []
    blobs = []
    offset = 0
    for name in sorted(arrays):
        arr = np.ascontiguousarray(arrays[name])
        raw = arr.tobytes()
        table.append({"name": name, "dtype": arr.dtype.str,
                      "shape": list(arr.shape), "offset": offset,
                      "nbytes": len(raw)})
        blobs.append(raw)
        offset += len(raw)
    body = b"".join(blobs)
    man = dict(manifest)
    man["format"] = FORMAT
    man["version"] = VERSION
    man["sections"] = table
    man["body_sha256"] = hashlib.sha256(body).hexdigest()
    mj = json.dumps(man, sort_keys=True, separators=(",", ":")).encode("utf-8")
    return (MAGIC + struct.pack("<Q", len(mj))
            + hashlib.sha256(mj).digest() + mj + body)


def _unpack(data):
    """-> (manifest, {name: zero-copy np view}); WireFormatError on any
    structural or integrity failure, before anything is handed out."""
    if isinstance(data, (bytearray, memoryview)):
        data = bytes(data)
    if not isinstance(data, bytes):
        raise WireFormatError(
            f"wire frame must be bytes, got {type(data).__name__}")
    hdr = len(MAGIC) + 8 + 32
    if len(data) < hdr or not data.startswith(MAGIC):
        raise WireFormatError("wire frame has a bad or truncated header "
                              "(not an AMTPUWIRE1 frame)")
    (mlen,) = struct.unpack_from("<Q", data, len(MAGIC))
    digest = data[len(MAGIC) + 8: hdr]
    if mlen > len(data) or hdr + mlen > len(data):
        raise WireFormatError("wire frame truncated inside its manifest")
    mj = data[hdr: hdr + mlen]
    if hashlib.sha256(mj).digest() != digest:
        raise WireFormatError("wire manifest failed its content hash "
                              "(corrupt or tampered frame)")
    try:
        manifest = json.loads(mj.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as exc:
        raise WireFormatError(
            f"wire manifest is not valid JSON: {exc}") from None
    if not isinstance(manifest, dict) or manifest.get("format") != FORMAT:
        raise WireFormatError(
            f"unsupported wire format: "
            f"{manifest.get('format') if isinstance(manifest, dict) else manifest!r}")
    if manifest.get("version") != VERSION:
        raise WireFormatError(
            f"unsupported wire format version: "
            f"{manifest.get('version')!r} (this build reads {VERSION})")
    table = manifest.get("sections")
    if not isinstance(table, list):
        raise WireFormatError("wire manifest is missing its section table")
    base = hdr + mlen
    view = memoryview(data)
    body_sha = manifest.get("body_sha256")
    if not isinstance(body_sha, str) \
            or hashlib.sha256(view[base:]).hexdigest() != body_sha:
        raise WireFormatError("wire frame body failed its content hash "
                              "(corrupt or tampered frame)")
    sections = {}
    for ent in table:
        try:
            name = ent["name"]
            dtype = _DTYPE_OBJS.get(ent["dtype"])
            if dtype is None:
                dtype = np.dtype(ent["dtype"])
            shape = tuple(ent["shape"])
            off, nbytes = ent["offset"], ent["nbytes"]
        except (KeyError, TypeError, ValueError) as exc:
            raise WireFormatError(
                f"malformed wire section entry: {exc}") from None
        if not isinstance(off, int) or not isinstance(nbytes, int) \
                or off < 0 or nbytes < 0:
            raise WireFormatError(
                f"wire section {name!r} has a malformed extent")
        lo = base + off
        if lo + nbytes > len(data):
            raise WireFormatError(
                f"wire frame truncated inside section {name!r}")
        try:
            arr = np.frombuffer(view[lo: lo + nbytes],
                                dtype).reshape(shape)
        except ValueError:
            raise WireFormatError(
                f"wire section {name!r} shape/byte-length mismatch"
            ) from None
        sections[name] = arr
    return manifest, sections


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

#: Expected section dtypes; a frame advertising anything else for a known
#: section is rejected (dtype confusion = silent misinterpretation).
_DTYPES = {
    "actor_idx": "<i4", "seqs": "<i4", "dep_gid": "<i4", "g_off": "<i4",
    "g_actor": "<i4", "g_seq": "<i8", "op_change": "<i4", "op_kind": "|i1",
    "op_target_actor": "<i4", "op_target_ctr": "<i4",
    "op_parent_actor": "<i4", "op_parent_ctr": "<i4", "op_key": "<i4",
    "op_value": "<i8",
}

_DTYPE_OBJS = {s: np.dtype(s) for s in
               set(_DTYPES.values()) | {"|u1", "<i8"}}


def _json_section(obj) -> np.ndarray:
    raw = json.dumps(obj, separators=(",", ":"))
    return np.frombuffer(raw.encode("utf-8"), np.uint8)


def _wire_dep_groups(deps_list, local_rank: dict, n: int):
    """Order-preserving CSR dep grouping for the wire: groups key on the
    ORDERED item tuple, not sorted content. ``intern_deps`` (and the
    planner's ``change_columns``) collapse content-equal dicts to the
    first occurrence — fine for admission, but the wire must
    reconstruct every change's deps dict with its exact insertion order
    or the materialized history would serialize differently from the
    dict-wire history (the byte-parity contract)."""
    gid_by_id: dict = {}
    by_items: dict = {}
    groups: list = []
    dgid = np.empty(n, np.int32)
    for i, d in enumerate(deps_list):
        g = gid_by_id.get(id(d))
        if g is None:
            key = tuple(d.items())
            g = by_items.get(key)
            if g is None:
                g = by_items[key] = len(groups)
                groups.append(d)
            gid_by_id[id(d)] = g
        dgid[i] = g
    g_off = np.zeros(len(groups) + 1, np.int32)
    ga: list = []
    gs: list = []
    for g, d in enumerate(groups):
        for a, s in d.items():
            ga.append(local_rank[a])
            gs.append(s)
        g_off[g + 1] = len(ga)
    return dgid, g_off, np.asarray(ga, np.int32), np.asarray(gs, np.int64)


def validate_trace_context(trace):
    """Schema-check one lineage trace-context value (the optional
    ``trace`` manifest entry / dict-wire field, INTERNALS §18.2):
    ``[[actor, seq, origin_ns, origin_site], ...]``, bounded.  Raises
    the typed :class:`WireFormatError` (a ``ProtocolError``) on any
    malformation — context must never be able to crash a decoder, and
    old decoders that predate it simply never look."""
    if not isinstance(trace, list) or len(trace) > MAX_CONTEXT_ENTRIES:
        raise WireFormatError("malformed trace context: must be a "
                              "bounded list of [actor, seq, origin_ns, "
                              "origin_site] entries")
    for ent in trace:
        if not isinstance(ent, list) or len(ent) != 4:
            raise WireFormatError(
                "malformed trace-context entry: expected [actor, seq, "
                f"origin_ns, origin_site], got {ent!r}")
        actor, seq, t0, site = ent
        if not isinstance(actor, str) or not actor:
            raise WireFormatError("trace-context actor must be a "
                                  "non-empty string")
        if not isinstance(seq, int) or isinstance(seq, bool) \
                or not 1 <= seq <= INT32_MAX:
            raise WireFormatError("trace-context seq outside the int32 "
                                  "envelope")
        if not isinstance(t0, int) or isinstance(t0, bool) \
                or not 0 <= t0 < 2**63:
            raise WireFormatError("trace-context origin_ns must be a "
                                  "non-negative int64")
        if not isinstance(site, str):
            raise WireFormatError("trace-context origin_site must be a "
                                  "string")
    return trace


def validate_group_token(group):
    """Schema-check one per-replication-group ordering token (the
    optional ``group`` manifest entry): ``[origin_region, room, token]``
    — the cheap causal metadata one federated region stamps on the
    frames it mints. One monotone counter per (room, origin region):
    cross-region ordering costs O(groups), never O(peers). Typed
    :class:`WireFormatError` on malformation — like trace context, a
    flipped bit must reject, never crash, and decoders that predate the
    entry simply never look."""
    if not isinstance(group, list) or len(group) != 3:
        raise WireFormatError(
            "malformed group token: expected [origin_region, room, "
            f"token], got {group!r}")
    region, room, token = group
    if not isinstance(region, str) or not region:
        raise WireFormatError("group-token origin_region must be a "
                              "non-empty string")
    if not isinstance(room, str) or not room:
        raise WireFormatError("group-token room must be a non-empty "
                              "string")
    if not isinstance(token, int) or isinstance(token, bool) \
            or not 1 <= token < 2**63:
        raise WireFormatError("group-token counter must be a positive "
                              "int64")
    return group


def encode_batch(batch, deps=None, trace=None, group=None) -> bytes:
    """Serialize an op-columnar batch (with its per-change columns) to
    one byte-deterministic ``AMTPUWIRE1`` frame.

    The batch must be in frame scope (single object, device grammar);
    batches built by ``TextChangeBatch.from_changes`` /
    ``MapChangeBatch.from_changes`` always are. ``deps`` optionally
    carries the ORIGINAL per-change deps dicts (pre ``intern_deps``
    content collapse) so the wire preserves their exact insertion
    order. ``trace`` optionally attaches lineage trace context
    (INTERNALS §18.2) as a manifest entry: version-tolerant — decoders
    that predate it ignore unknown manifest keys — and covered by the
    manifest hash, so a flipped bit in the context is a typed rejection
    like any other corruption."""
    from .columnar import MapChangeBatch, TextChangeBatch
    from .wire_columns import change_columns
    cols = change_columns(batch)
    if isinstance(batch, TextChangeBatch):
        kind = "text"
        arrays = {
            "op_target_actor": batch.op_target_actor,
            "op_target_ctr": batch.op_target_ctr,
            "op_parent_actor": batch.op_parent_actor,
            "op_parent_ctr": batch.op_parent_ctr,
            "actor_table": _json_section(batch.actor_table),
        }
    elif isinstance(batch, MapChangeBatch):
        kind = "map"
        arrays = {
            "op_key": batch.op_key,
            "key_table": _json_section(batch.key_table),
        }
    else:
        raise TypeError(f"cannot encode {type(batch).__name__} as a wire "
                        "frame")
    local_rank = {a: i for i, a in enumerate(cols.local_actors)}
    dep_gid, g_off, g_actor, g_seq = _wire_dep_groups(
        batch.deps if deps is None else deps, local_rank, batch.n_changes)
    arrays.update({
        "actor_idx": cols.actor_idx, "seqs": cols.seqs,
        "dep_gid": dep_gid, "g_off": g_off,
        "g_actor": g_actor, "g_seq": g_seq,
        "op_change": batch.op_change, "op_kind": batch.op_kind,
        "op_value": batch.op_value,
        "local_actors": _json_section(cols.local_actors),
    })
    if any(m is not None for m in batch.messages):
        arrays["messages"] = _json_section(batch.messages)
    if batch.value_pool:
        arrays["value_pool"] = _json_section(batch.value_pool)
    manifest = {"kind": kind, "obj_id": batch.obj_id,
                "n_changes": batch.n_changes, "n_ops": batch.n_ops,
                "n_change_actors": cols.n_change_actors}
    if trace:
        manifest["trace"] = validate_trace_context(trace)
    if group:
        # per-replication-group ordering token: version-tolerant like
        # `trace`, covered by the manifest hash
        manifest["group"] = validate_group_token(list(group))
    return _pack(manifest, arrays)


def encode_changes(changes, obj_id: str = None, trace=None) -> bytes:
    """Encode wire-dict changes (all frame-scoped, one object) to a
    frame. Raises ``WireFormatError`` when out of scope — callers that
    want graceful degradation use :func:`split_outgoing`."""
    from .columnar import MapChangeBatch, TextChangeBatch
    kind, obj = _frame_scope(changes)
    if kind is None:
        raise WireFormatError(f"changes are not frame-scoped: {obj}")
    if obj_id is not None and obj != obj_id:
        raise WireFormatError(
            f"changes target {obj!r}, frame requested for {obj_id!r}")
    cls = TextChangeBatch if kind == "text" else MapChangeBatch
    return encode_batch(cls.from_changes(changes, obj),
                        deps=[c["deps"] for c in changes], trace=trace)


# -- outbound scope classification ------------------------------------------

_CHANGE_KEYS = (("actor", "seq", "deps", "ops"),
                ("actor", "seq", "deps", "message", "ops"))
_OP_KEYS = {
    "ins": (("action", "obj", "key", "elem"),),
    "del": (("action", "obj", "key"),),
    "inc": (("action", "obj", "key", "value"),),
    "set": (("action", "obj", "key", "value"),
            ("action", "obj", "key", "value", "datatype")),
    "link": (("action", "obj", "key", "value"),),
}


def _is_elem_id(key) -> bool:
    if not isinstance(key, str) or not key:
        return False
    actor, sep, ctr = key.rpartition(":")
    return bool(actor and sep and ctr.isdigit() and int(ctr) <= INT32_MAX)


def _op_scope(op, obj):
    """-> "text" | "map" | "both" | None for one op against the frame
    grammar (canonical key order enforced: the frame must round-trip to
    byte-identical dicts)."""
    if not isinstance(op, dict):
        return None
    action = op.get("action")
    orders = _OP_KEYS.get(action)
    if orders is None or tuple(op.keys()) not in orders:
        return None
    if op.get("obj") != obj or not isinstance(obj, str) or not obj:
        return None
    key = op.get("key")
    if not isinstance(key, str) or not key:
        return None
    if action == "ins":
        elem = op.get("elem")
        if not isinstance(elem, int) or isinstance(elem, bool) \
                or not 1 <= elem <= INT32_MAX:
            return None
        if key != "_head" and not _is_elem_id(key):
            return None
        return "text"
    if action == "inc":
        v = op["value"]
        if not isinstance(v, int) or isinstance(v, bool) \
                or not -2**62 < v < 2**62:
            return None
    elif action == "link":
        if not isinstance(op["value"], str):
            return None
    elif action == "set":
        v = op["value"]
        if isinstance(v, (dict, list, tuple)):
            return None
        if isinstance(v, float) and not math.isfinite(v):
            return None                    # NaN breaks dict-equality dedup
        if isinstance(v, str) and len(v) == 1 \
                and 0xD800 <= ord(v) <= 0xDFFF:
            return None                    # lone surrogate: not JSON-safe
        dt = op.get("datatype")
        if "datatype" in op and not (isinstance(dt, str) and dt):
            return None                    # falsy datatype would be dropped
            # by the codec and break byte round-trip
    return "text" if _is_elem_id(key) else "map"


def _frame_scope(changes):
    """Classify a whole change list: -> ("text"|"map", obj_id) when every
    change is frame-scoped on one object, else (None, reason)."""
    if not isinstance(changes, list) or not changes:
        return None, "changes must be a non-empty list"
    kind = "both"
    obj = None
    for change in changes:
        k, o = change_in_scope(change)
        if k is None:
            return None, o
        if obj is None:
            obj = o
        elif o != obj:
            return None, "changes target more than one object"
        if k != "both":
            if kind not in ("both", k):
                return None, "mixed text/map op shapes"
            kind = k
    return ("map" if kind == "both" else kind), obj


def change_in_scope(change):
    """-> ("text"|"map"|"both", obj_id) when `change` fits the frame
    grammar with canonical key order, else (None, reason)."""
    if not isinstance(change, dict) or tuple(change.keys()) \
            not in _CHANGE_KEYS:
        return None, "non-canonical change shape"
    actor, seq = change["actor"], change["seq"]
    if not isinstance(actor, str) or not actor:
        return None, "bad actor"
    if not isinstance(seq, int) or isinstance(seq, bool) \
            or not 1 <= seq <= INT32_MAX:
        return None, "seq outside the int32 envelope"
    deps = change["deps"]
    if not isinstance(deps, dict):
        return None, "bad deps"
    for a, s in deps.items():
        if not isinstance(a, str) or not a or not isinstance(s, int) \
                or isinstance(s, bool) or not 0 <= s < 2**62:
            return None, "bad deps entry"
    if "message" in change and not isinstance(change["message"],
                                              (str, type(None))):
        return None, "bad message"
    ops = change["ops"]
    if not isinstance(ops, list) or not ops:
        return None, "empty or non-list ops"
    obj = ops[0].get("obj") if isinstance(ops[0], dict) else None
    kind = "both"
    for op in ops:
        k = _op_scope(op, obj)
        if k is None:
            return None, "op outside the frame grammar"
        if k != "both":
            if kind not in ("both", k):
                return None, "mixed text/map op shapes"
            kind = k
    return kind, obj


def split_outgoing(changes, min_ops: int = None, trace=None, group=None):
    """Peel the longest frame-scoped suffix off an outbound change list:
    -> (dict_prefix, frame_or_None). The common history shape — one
    creation change followed by a long single-object tail — becomes one
    small dict prefix plus one frame; fully out-of-scope payloads come
    back unchanged with no frame. ``trace`` (lineage context for the
    WHOLE change list, prefix included) and ``group`` (the federation's
    per-replication-group ordering token) ride the frame's manifest."""
    if min_ops is None:
        min_ops = wire_min_ops()
    if not isinstance(changes, list) or not changes:
        return changes, None
    kind = "both"
    obj = None
    start = len(changes)
    for i in range(len(changes) - 1, -1, -1):
        k, o = change_in_scope(changes[i])
        if k is None or (obj is not None and o != obj):
            break
        if k != "both":
            if kind not in ("both", k):
                break
            kind = k
        obj = o
        start = i
    suffix = changes[start:]
    if not suffix or sum(len(c["ops"]) for c in suffix) < max(1, min_ops):
        return changes, None
    if kind == "both":
        kind = "map"                     # assign-only, plain keys
    from .columnar import MapChangeBatch, TextChangeBatch
    cls = TextChangeBatch if kind == "text" else MapChangeBatch
    try:
        frame = encode_batch(cls.from_changes(suffix, obj),
                             deps=[c["deps"] for c in suffix],
                             trace=trace, group=group)
    except (ValueError, OverflowError, TypeError):
        return changes, None             # stay on the dict wire
    return changes[:start], WireFrame(frame, changes=suffix, trace=trace,
                                      group=group)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _require(cond, why: str):
    if not cond:
        raise WireFormatError(f"malformed wire frame: {why}")


def _get(sections, name, length=None):
    arr = sections.get(name)
    _require(arr is not None, f"missing section {name!r}")
    _require(arr.dtype.str == _DTYPES[name],
             f"section {name!r} has dtype {arr.dtype.str}, expected "
             f"{_DTYPES[name]}")
    _require(arr.ndim == 1, f"section {name!r} is not a flat column")
    if length is not None:
        _require(len(arr) == length,
                 f"section {name!r} length {len(arr)} != {length}")
    return arr


def _json_list(sections, name, expect_len=None, default=None):
    arr = sections.get(name)
    if arr is None:
        return default
    _require(arr.dtype == np.uint8, f"section {name!r} must be uint8")
    try:
        out = json.loads(arr.tobytes().decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        raise WireFormatError(
            f"wire section {name!r} is not valid JSON") from None
    _require(isinstance(out, list), f"section {name!r} must be a list")
    if expect_len is not None:
        _require(len(out) == expect_len,
                 f"section {name!r} length {len(out)} != {expect_len}")
    return out


def _check_bounds(arr, lo, hi, what):
    """Every value in [lo, hi); vectorized."""
    if len(arr):
        mn, mx = int(arr.min()), int(arr.max())
        _require(lo <= mn and mx < hi,
                 f"{what} outside [{lo}, {hi}) (saw {mn}..{mx})")


def decode(data):
    """Frame bytes -> op-columnar batch backed by zero-copy views, with
    the per-change ``ColumnarChangeBatch`` columns attached.

    One header parse, one integrity hash pass, vectorized bounds/
    envelope checks over every column (``_common.check_int32_envelope``
    semantics: a wrapped counter would silently reorder elements), and
    small-string-table reconstruction; no per-op Python. Any failure is
    a typed :class:`WireFormatError` raised before the batch exists."""
    from .columnar import MapChangeBatch, TextChangeBatch
    from .wire_columns import ColumnarChangeBatch
    manifest, sections = _unpack(data)
    kind = manifest.get("kind")
    _require(kind in ("text", "map"), f"unknown frame kind {kind!r}")
    obj_id = manifest.get("obj_id")
    _require(isinstance(obj_id, str) and obj_id, "bad obj_id")
    n = manifest.get("n_changes")
    m = manifest.get("n_ops")
    nca = manifest.get("n_change_actors")
    _require(isinstance(n, int) and n >= 1, "bad n_changes")
    _require(isinstance(m, int) and m >= 1, "bad n_ops")
    _require(isinstance(nca, int) and 1 <= nca <= n, "bad n_change_actors")
    # optional lineage trace context (INTERNALS §18.2): absent on frames
    # from peers that predate it (or run lineage off) — decode is
    # unconditional and tolerant either way, but a PRESENT context must
    # be schema-clean (typed rejection, like every other section)
    trace = manifest.get("trace")
    if trace is not None:
        validate_trace_context(trace)
    # optional per-replication-group ordering token: same
    # version-tolerance contract as trace context
    group = manifest.get("group")
    if group is not None:
        validate_group_token(group)

    local_actors = _json_list(sections, "local_actors")
    _require(local_actors is not None, "missing section 'local_actors'")
    _require(len(local_actors) >= nca, "local_actors shorter than its "
             "change-actor prefix")
    _require(all(isinstance(a, str) and a for a in local_actors),
             "actor ids must be non-empty strings")
    n_local = len(local_actors)

    actor_idx = _get(sections, "actor_idx", n)
    _check_bounds(actor_idx, 0, nca, "actor_idx")
    seqs = _get(sections, "seqs", n)
    _check_bounds(seqs, 1, INT32_MAX + 1, "seqs")
    dep_gid = _get(sections, "dep_gid", n)
    g_off = _get(sections, "g_off")
    _require(len(g_off) >= 2, "empty dep-group offsets")
    n_groups = len(g_off) - 1
    _check_bounds(dep_gid, 0, n_groups, "dep_gid")
    g_actor = _get(sections, "g_actor")
    g_seq = _get(sections, "g_seq", len(g_actor))
    off = g_off.astype(np.int64)
    _require(off[0] == 0 and off[-1] == len(g_actor)
             and bool((off[1:] >= off[:-1]).all()),
             "dep-group offsets are not a monotone CSR")
    _check_bounds(g_actor, 0, n_local, "dep-group actor refs")
    _check_bounds(g_seq, 0, 2**62, "dep-group seqs")

    op_change = _get(sections, "op_change", m)
    _check_bounds(op_change, 0, n, "op_change")
    op_kind = _get(sections, "op_kind", m)
    op_value = _get(sections, "op_value", m)
    messages = _json_list(sections, "messages", n, [None] * n)
    _require(all(isinstance(x, (str, type(None))) for x in messages),
             "messages must be strings or null")
    value_pool = _json_list(sections, "value_pool", None, [])
    for ent in value_pool:
        _require(isinstance(ent, dict) and "value" in ent,
                 "value-pool entries must be objects carrying 'value'")
        _require(not ent.get("link") or isinstance(ent["value"], str),
                 "link value-pool entries must carry an object id string")
        _require(not isinstance(ent["value"], (dict, list)),
                 "value-pool values must be primitives")
    kinds = op_kind.astype(np.int32)
    is_set = kinds == KIND_SET
    # pooled refs are negative: -(pool index + 1); inline bounds are
    # kind-specific (codepoints for text, int31 for map) below
    _check_bounds(op_value[is_set], -len(value_pool), 2**62, "set values")

    # reconstruct the content-distinct dep groups (a handful of dicts)
    # and per-change deps in CSR order — insertion order on the wire IS
    # the sender dicts' iteration order, so materialized dicts serialize
    # byte-identically
    ga = g_actor.tolist()
    gs = g_seq.tolist()
    group_deps = []
    for g in range(n_groups):
        lo, hi = int(off[g]), int(off[g + 1])
        group_deps.append({local_actors[ga[j]]: gs[j]
                           for j in range(lo, hi)})
        _require(len(group_deps[-1]) == hi - lo,
                 "duplicate actor inside one dep group")
    # deps are already content-distinct + identity-shared per group (the
    # wire IS the intern_deps shape the engine's frontier fast paths key
    # on); no re-interning pass needed
    deps = [group_deps[g] for g in dep_gid.tolist()]
    actors = [local_actors[i] for i in actor_idx.tolist()]
    inline = is_set & (op_value >= 0)

    if kind == "text":
        _check_bounds(kinds, 0, 4, "op_kind")
        actor_table = _json_list(sections, "actor_table")
        _require(actor_table is not None, "missing section 'actor_table'")
        _require(all(isinstance(a, str) and a for a in actor_table),
                 "actor-table ids must be non-empty strings")
        ta = _get(sections, "op_target_actor", m)
        tc = _get(sections, "op_target_ctr", m)
        pa = _get(sections, "op_parent_actor", m)
        pc = _get(sections, "op_parent_ctr", m)
        _check_bounds(ta, 0, len(actor_table), "op_target_actor")
        _check_bounds(tc, 1, INT32_MAX + 1, "op_target_ctr")
        _require(bool(((pa == HEAD_PARENT)
                       | ((pa >= 0) & (pa < len(actor_table)))).all()),
                 "op_parent_actor outside the actor table")
        is_ins = kinds == KIND_INS
        _require(bool((pa[~is_ins] == HEAD_PARENT).all()),
                 "assign ops must carry the head parent sentinel")
        ref = pa != HEAD_PARENT
        _check_bounds(pc[ref], 1, INT32_MAX + 1, "referenced parent ctr")
        _require(bool((pc[~ref] == 0).all()),
                 "head-parented ops must carry parent ctr 0")
        # inline set values are codepoints (surrogates excluded: they
        # would poison the JSON history downstream)
        iv = op_value[inline]
        _require(not bool(((iv >= 0x110000)
                           | ((iv >= 0xD800) & (iv <= 0xDFFF))).any()),
                 "inline text set values must be encodable codepoints")
        # a minted element's actor IS its change's actor — a frame whose
        # ins rows claim another actor would diverge engine state from
        # the materialized history
        if bool(is_ins.any()):
            trank = {a: i for i, a in enumerate(actor_table)}
            row_rank = np.asarray([trank.get(a, -1) for a in actors],
                                  np.int64)
            _require(bool((ta[is_ins]
                           == row_rank[op_change[is_ins]]).all()),
                     "ins rows must mint elements under their change "
                     "actor")
        batch = TextChangeBatch(
            obj_id=obj_id, actors=actors, seqs=seqs, deps=deps,
            messages=messages, op_change=op_change, op_kind=op_kind,
            op_target_actor=ta, op_target_ctr=tc, op_parent_actor=pa,
            op_parent_ctr=pc, op_value=op_value, actor_table=actor_table,
            value_pool=value_pool)
    else:
        _require(not bool((kinds == KIND_INS).any()),
                 "map frames cannot carry ins ops")
        _check_bounds(kinds, 1, 4, "op_kind")
        key_table = _json_list(sections, "key_table")
        _require(key_table is not None, "missing section 'key_table'")
        _require(all(isinstance(k, str) and k for k in key_table),
                 "map keys must be non-empty strings")
        op_key = _get(sections, "op_key", m)
        _check_bounds(op_key, 0, len(key_table), "op_key")
        _require(not bool((op_value[inline] >= 2**31).any()),
                 "inline map set values must stay below 2^31")
        batch = MapChangeBatch(
            obj_id=obj_id, actors=actors, seqs=seqs, deps=deps,
            messages=messages, op_change=op_change, op_kind=op_kind,
            op_key=op_key, op_value=op_value, key_table=key_table,
            value_pool=value_pool)

    seq_list = seqs  # int32 view; all_seq1/distinct vectorized below
    table_sorted = sorted(set(batch.actor_table))
    cols = ColumnarChangeBatch(
        n_changes=n, actor_idx=actor_idx, local_actors=local_actors,
        n_change_actors=nca, seqs=seqs, dep_gid=dep_gid,
        group_deps=group_deps, g_off=g_off, g_actor=g_actor, g_seq=g_seq,
        table_sorted=table_sorted,
        actor_set=frozenset(local_actors[:nca]),
        all_seq1=bool((seq_list == 1).all()),
        distinct_actors=bool(nca == n))
    batch._change_columns = cols
    batch._trace = trace
    batch._group = group
    return batch


# ---------------------------------------------------------------------------
# canonical dict materialization (the parity half)
# ---------------------------------------------------------------------------


def materialize_changes(batch) -> list:
    """The batch as canonical wire dicts — the exact key orders the
    frontend mints (``actor, seq, deps[, message], ops``; ops as
    ``action, obj, key, …``), so a binary-ingested history serializes
    byte-identically to a dict-ingested one (``api.save`` parity across
    ``AMTPU_WIRE_BINARY=0/1``). This is the only per-op Python the
    binary path pays, and it runs at backend ADMISSION (history
    bookkeeping), never on the planning/device hot path."""
    from .columnar import TextChangeBatch
    obj = batch.obj_id
    pool = batch.value_pool
    is_text = isinstance(batch, TextChangeBatch)
    kinds = batch.op_kind.tolist()
    vals = batch.op_value.tolist()
    rows = batch.op_change.tolist()
    if is_text:
        table = batch.actor_table
        ta = batch.op_target_actor.tolist()
        tc = batch.op_target_ctr.tolist()
        pa = batch.op_parent_actor.tolist()
        pc = batch.op_parent_ctr.tolist()
    else:
        keys = [batch.key_table[k] for k in batch.op_key.tolist()]
    ops_per = [[] for _ in range(batch.n_changes)]
    for j, kind in enumerate(kinds):
        if is_text:
            if kind == KIND_INS:
                parent = ("_head" if pa[j] == HEAD_PARENT
                          else f"{table[pa[j]]}:{pc[j]}")
                ops_per[rows[j]].append(
                    {"action": "ins", "obj": obj, "key": parent,
                     "elem": tc[j]})
                continue
            key = f"{table[ta[j]]}:{tc[j]}"
        else:
            key = keys[j]
        if kind == KIND_DEL:
            op = {"action": "del", "obj": obj, "key": key}
        elif kind == KIND_INC:
            op = {"action": "inc", "obj": obj, "key": key, "value": vals[j]}
        else:                                     # KIND_SET (set or link)
            v = vals[j]
            if v >= 0:
                op = {"action": "set", "obj": obj, "key": key,
                      "value": chr(v) if is_text else v}
            else:
                ent = pool[-v - 1]
                action = "link" if ent.get("link") else "set"
                op = {"action": action, "obj": obj, "key": key,
                      "value": ent["value"]}
                if ent.get("datatype"):
                    op["datatype"] = ent["datatype"]
        ops_per[rows[j]].append(op)
    out = []
    seq_list = batch.seqs.tolist()
    for i in range(batch.n_changes):
        ch = {"actor": batch.actors[i], "seq": seq_list[i],
              "deps": batch.deps[i]}
        if batch.messages[i] is not None:
            ch["message"] = batch.messages[i]
        ch["ops"] = ops_per[i]
        out.append(ch)
    return out


# ---------------------------------------------------------------------------
# the frame object (what rides channel payloads)
# ---------------------------------------------------------------------------


class WireFrame:
    """One encoded frame + its lazily-decoded views.

    The ``data`` bytes are the canonical wire form: channels retransmit
    them verbatim (never re-encode), byte accounting reads ``nbytes``,
    and a hub minting one frame serves every peer of the (doc, clock)
    group with the same object. ``batch()`` decodes once (zero-copy
    views; typed ``WireFormatError`` on malformation) and ``changes()``
    materializes the canonical dicts once (the quarantine/park and
    history paths)."""

    __slots__ = ("data", "_batch", "_changes", "_trace", "_group")

    def __init__(self, data: bytes, batch=None, changes=None, trace=None,
                 group=None):
        if not isinstance(data, (bytes, bytearray, memoryview)):
            raise WireFormatError(
                f"wire frame must be bytes, got {type(data).__name__}")
        self.data = bytes(data)
        self._batch = batch
        self._changes = changes
        self._trace = trace
        self._group = group

    # -- cheap introspection (decodes on first use) --------------------

    @property
    def nbytes(self) -> int:
        return len(self.data)

    @property
    def obj_id(self) -> str:
        return self.batch().obj_id

    @property
    def kind(self) -> str:
        from .columnar import TextChangeBatch
        return "text" if isinstance(self.batch(), TextChangeBatch) \
            else "map"

    @property
    def trace(self):
        """Lineage trace context carried in the frame manifest, or None
        (absent / frame not yet decoded — reads never force a decode:
        the receive side decodes via validate_msg before any hop
        runs)."""
        if self._trace is not None:
            return self._trace
        b = self._batch
        return getattr(b, "_trace", None) if b is not None else None

    @property
    def group(self):
        """Per-replication-group ordering token carried in the frame
        manifest (``[origin_region, room, token]``), or None — same
        no-forced-decode contract as ``trace``: set at encode time on
        the sender's object, read from the manifest after the receive
        side decodes."""
        if self._group is not None:
            return self._group
        b = self._batch
        return getattr(b, "_group", None) if b is not None else None

    @property
    def n_changes(self) -> int:
        return self.batch().n_changes

    @property
    def n_ops(self) -> int:
        return self.batch().n_ops

    def batch(self):
        """The decoded op-columnar batch (cached; zero-copy views)."""
        if self._batch is None:
            from .. import obs
            _t0 = obs.now() if obs.ENABLED else 0
            self._batch = decode(self.data)
            if obs.ENABLED:
                obs.span("plan", "decode", _t0, args={
                    "obj": self._batch.obj_id, "wire": True,
                    "n_changes": self._batch.n_changes,
                    "n_ops": self._batch.n_ops, "bulk": True})
        return self._batch

    def changes(self) -> list:
        """Canonical wire dicts (cached) — the compatibility view for
        quarantine parking, history bookkeeping, and dict peers."""
        if self._changes is None:
            from .. import obs
            _t0 = obs.now() if obs.ENABLED else 0
            self._changes = materialize_changes(self.batch())
            if obs.ENABLED:
                obs.span("plan", "materialize", _t0, args={
                    "obj": self.batch().obj_id,
                    "n_changes": len(self._changes)})
        return self._changes

    def validate(self) -> "WireFrame":
        """Decode (and cache) the frame, surfacing malformation as the
        typed :class:`WireFormatError`; returns self."""
        self.batch()
        return self

    def ready_under(self, clock: dict) -> bool:
        """Whether the WHOLE frame is causally admissible against
        `clock` in row order (each row next-in-sequence or a duplicate,
        deps covered by the clock plus earlier rows) — the gate's
        zero-dict fast-lane test. A False here only means the slow
        (dict/fixpoint) path runs; it never rejects."""
        b = self.batch()
        cols = b._change_columns
        sim: dict = {}
        seqs = cols.seqs.tolist()
        gids = cols.dep_gid.tolist()
        for i, a in enumerate(cols.actor_idx.tolist()):
            actor = cols.local_actors[a]
            seq = seqs[i]
            if seq > sim.get(actor, clock.get(actor, 0)) + 1:
                return False
            for da, ds in cols.group_deps[gids[i]].items():
                if sim.get(da, clock.get(da, 0)) < ds:
                    return False
            if seq > sim.get(actor, clock.get(actor, 0)):
                sim[actor] = seq
        return True


def _intern_ordered_deps(deps: list) -> list:
    """Cross-frame deps interning for :func:`combine_frames`, keyed on
    the ORDERED item tuple — `columnar.intern_deps` collapses by sorted
    content and would replace a later frame's differently-ordered (but
    content-equal) deps dict with the first frame's, breaking the
    byte-parity contract the per-frame decode preserves. Ordered-equal
    dicts still identity-share, which is all the engine's
    shared-frontier fast path keys on."""
    cache: dict = {}
    out = []
    for d in deps:
        key = tuple(d.items())
        hit = cache.get(key)
        if hit is None:
            hit = cache[key] = d
        out.append(hit)
    return out


def as_frame(wire) -> WireFrame:
    """Coerce a message's ``wire`` field (WireFrame or raw bytes) to a
    WireFrame; typed error on anything else."""
    if isinstance(wire, WireFrame):
        return wire
    return WireFrame(wire)


def combine_frames(frames):
    """Concatenate same-object frames into ONE decoded delivery (grouped
    admission: N peers' frames for one doc still cost one backend apply
    and one engine batch). Columns concatenate as C memcpys with
    vectorized id remaps — no per-op Python. -> a WireFrame-shaped
    delivery (batch()/changes()/obj_id/n_ops), or None when the frames
    don't share an object/kind."""
    frames = [as_frame(f) for f in frames]
    if len(frames) == 1:
        return frames[0]
    from .columnar import MapChangeBatch, TextChangeBatch
    from .wire_columns import change_columns
    batches = [f.batch() for f in frames]
    first = batches[0]
    is_text = isinstance(first, TextChangeBatch)
    if any(b.obj_id != first.obj_id
           or isinstance(b, TextChangeBatch) != is_text for b in batches):
        return None
    actors, seqs_l, deps, messages, pool = [], [], [], [], []
    opc, kind_c, val_c = [], [], []
    ta_c, tc_c, pa_c, pc_c, key_c = [], [], [], [], []
    table: list = []
    rank: dict = {}
    row0 = 0
    for b in batches:
        actors.extend(b.actors)
        seqs_l.append(b.seqs)
        deps.extend(b.deps)
        messages.extend(b.messages)
        opc.append(b.op_change.astype(np.int32) + row0)
        row0 += b.n_changes
        kind_c.append(b.op_kind)
        vals = b.op_value
        if b.value_pool:
            shift = np.where(vals < 0, -len(pool), 0)
            vals = vals + shift
            pool.extend(b.value_pool)
        val_c.append(vals)
        if is_text:
            remap = np.empty(max(len(b.actor_table), 1), np.int32)
            for i, a in enumerate(b.actor_table):
                r = rank.get(a)
                if r is None:
                    r = rank[a] = len(table)
                    table.append(a)
                remap[i] = r
            ta_c.append(remap[b.op_target_actor])
            pa = b.op_parent_actor
            pa_c.append(np.where(pa == HEAD_PARENT, HEAD_PARENT,
                                 remap[np.maximum(pa, 0)]).astype(np.int32))
            tc_c.append(b.op_target_ctr)
            pc_c.append(b.op_parent_ctr)
        else:
            remap = np.empty(max(len(b.key_table), 1), np.int32)
            for i, k in enumerate(b.key_table):
                r = rank.get(k)
                if r is None:
                    r = rank[k] = len(table)
                    table.append(k)
                remap[i] = r
            key_c.append(remap[b.op_key])
    common = dict(
        obj_id=first.obj_id, actors=actors,
        seqs=np.concatenate(seqs_l), deps=_intern_ordered_deps(deps),
        messages=messages, op_change=np.concatenate(opc),
        op_kind=np.concatenate(kind_c), op_value=np.concatenate(val_c),
        value_pool=pool)
    if is_text:
        batch = TextChangeBatch(
            op_target_actor=np.concatenate(ta_c),
            op_target_ctr=np.concatenate(tc_c),
            op_parent_actor=np.concatenate(pa_c),
            op_parent_ctr=np.concatenate(pc_c),
            actor_table=table, **common)
    else:
        batch = MapChangeBatch(op_key=np.concatenate(key_c),
                               key_table=table, **common)
    change_columns(batch)
    combined = WireFrame.__new__(WireFrame)
    combined.data = b""                 # synthetic: never retransmitted
    combined._batch = batch
    combined._changes = None
    # merged lineage context, deduped by change identity (N peers'
    # frames may carry overlapping sampled entries)
    merged_trace: list = []
    seen_trace: set = set()
    for f in frames:
        for ent in f.trace or ():
            key = (ent[0], ent[1])
            if key not in seen_trace:
                seen_trace.add(key)
                merged_trace.append(ent)
    combined._trace = merged_trace or None
    # group tokens: a combined delivery spanning one (origin region,
    # room) group keeps the HIGHEST token; mixed-group combines drop the
    # token — the per-frame observation already happened at delivery
    groups = [tuple(f.group) for f in frames if f.group]
    combined._group = None
    if groups and len({g[:2] for g in groups}) == 1:
        combined._group = list(max(groups, key=lambda g: g[2]))
    cached = [f._changes for f in frames]
    if all(c is not None for c in cached):
        combined._changes = [c for sub in cached for c in sub]
    return combined
