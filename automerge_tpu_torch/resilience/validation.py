"""Wire-message and change-schema validation.

One shared schema, two strictness levels:

- **strict** (the sync tier: ``SyncHub._receive``, ``Connection.receive_msg``,
  ``DocSet.deliver``): everything a peer can put on the wire is checked —
  message envelope (``docId``/``clock``/``changes``), change fields
  (``actor``/``seq``/``deps``/``ops``), and every op, including that the op
  action is one the wire grammar defines. Anything off-schema raises
  :class:`~.errors.ProtocolError` before any state is touched.

- **lenient** (backend change application: ``facade.apply_changes``,
  ``device.apply_changes``): identical structural checks, except unknown op
  *action strings* pass through. The device backend's scope gate routes those
  to the oracle via graduation, and the oracle rejects them authoritatively
  with the reference's ``Unknown operation type`` error — a pinned contract
  (tests/test_graduation.py). That is the ONLY divergence: everything the
  lenient mode admits gets stored in history and later shipped over the
  wire, so admitting anything strict peers would reject (a deps-less
  change, a container-valued set op) would mint locally-valid state that
  silently diverges the moment it syncs.

Validation never mutates or copies its input; it returns the validated value
so call sites can write ``changes = validate_changes(changes)`` (which also
materializes iterator inputs exactly once). One deliberate exception: a
bytes-typed ``wire`` field is replaced in place by its validated
``WireFrame`` so the decode is paid once (see ``validate_msg``).
"""

from __future__ import annotations

import operator
from contextlib import contextmanager

from .errors import ProtocolError

#: Op actions the wire grammar defines (the reference's full set:
#: backend/op_set.js applyOps + applyMake).
MAKE_ACTIONS = ("makeMap", "makeTable", "makeList", "makeText")
ASSIGN_ACTIONS = ("set", "del", "link", "inc")
OP_ACTIONS = frozenset(MAKE_ACTIONS) | frozenset(ASSIGN_ACTIONS) | {"ins"}

#: Assign actions that must carry a ``value`` field (a "truncated" op — an
#: assign missing its payload — is malformed, not a None assignment).
_VALUE_ACTIONS = frozenset(("set", "link", "inc"))


def _as_seq(value, what: str) -> int:
    """An integer-like value (int or numpy integer), else ProtocolError."""
    try:
        return operator.index(value)
    except TypeError:
        raise ProtocolError(f"{what} must be an integer, got "
                            f"{type(value).__name__}") from None


def validate_clock(clock, what: str = "clock") -> dict:
    if not isinstance(clock, dict):
        raise ProtocolError(f"{what} must be an object of actor -> seq, got "
                            f"{type(clock).__name__}")
    for actor, seq in clock.items():
        if not isinstance(actor, str) or not actor:
            raise ProtocolError(f"{what} keys must be non-empty actor id "
                                f"strings, got {actor!r}")
        if _as_seq(seq, f"{what}[{actor!r}]") < 0:
            raise ProtocolError(f"{what}[{actor!r}] must be >= 0, got {seq!r}")
    return clock


def validate_op(op, strict: bool = True) -> dict:
    if not isinstance(op, dict):
        raise ProtocolError(f"op must be an object, got "
                            f"{type(op).__name__}")
    action = op.get("action")
    if not isinstance(action, str):
        raise ProtocolError(f"op action must be a string, got {action!r}")
    if not isinstance(op.get("obj"), str) or not op["obj"]:
        raise ProtocolError(f"op {action!r} requires a string `obj`, got "
                            f"{op.get('obj')!r}")
    if action not in OP_ACTIONS:
        if strict:
            raise ProtocolError(f"unknown op action {action!r}")
        return op  # lenient: the backend scope gate / oracle judges it
    if action == "ins":
        if not isinstance(op.get("key"), str) or not op["key"]:
            raise ProtocolError("ins op requires a string `key` "
                               "(parent element id or _head)")
        if "elem" not in op or _as_seq(op["elem"], "ins op `elem`") < 1:
            raise ProtocolError(f"ins op requires an integer `elem` >= 1, "
                               f"got {op.get('elem')!r}")
    elif action in ASSIGN_ACTIONS:
        if not isinstance(op.get("key"), str) or not op["key"]:
            raise ProtocolError(f"{action} op requires a string `key`, got "
                               f"{op.get('key')!r}")
        if action in _VALUE_ACTIONS and "value" not in op:
            raise ProtocolError(f"truncated {action} op: missing `value`")
        if action == "link" and not isinstance(op.get("value"), str):
            raise ProtocolError(f"link op `value` must be an object id "
                               f"string, got {op.get('value')!r}")
        if action == "inc":
            v = op["value"]
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise ProtocolError(f"inc op `value` must be a number, "
                                   f"got {v!r}")
        elif action == "set" and isinstance(op.get("value"), (dict, list)):
            # nested containers arrive as make+link, never as raw set
            # payloads (the reference's wire grammar); accepting them here
            # would let one peer smuggle unmergeable state past the CRDT
            raise ProtocolError("set op `value` must be a primitive "
                               "(objects arrive as make+link)")
    return op


def validate_change(change, strict: bool = True) -> dict:
    if not isinstance(change, dict):
        raise ProtocolError(f"change must be an object, got "
                            f"{type(change).__name__}")
    actor = change.get("actor")
    if not isinstance(actor, str) or not actor:
        raise ProtocolError(f"change requires a non-empty string `actor`, "
                            f"got {actor!r}")
    if "seq" not in change or _as_seq(change["seq"], "change `seq`") < 1:
        raise ProtocolError(f"change requires an integer `seq` >= 1, got "
                            f"{change.get('seq')!r}")
    deps = change.get("deps")
    if deps is None:
        raise ProtocolError("change requires a `deps` clock object")
    validate_clock(deps, "change `deps`")
    ops = change.get("ops")
    if not isinstance(ops, (list, tuple)):
        raise ProtocolError(f"change requires an `ops` array, got "
                            f"{ops!r}")
    for op in ops:
        validate_op(op, strict)
    return change


#: Depth of `prevalidated()` extents on the stack. While non-zero, LENIENT
#: validation short-circuits to materialization: the inbound gate already
#: ran the (strictly stronger) wire checks over the same changes, so the
#: backend layer re-walking every op would be pure duplicated work on the
#: hot catch-up path. Strict validation never short-circuits. A plain
#: module counter suffices — the sync tier is single-threaded by design
#: (in-process callbacks; see docs/INTERNALS.md §7).
_prevalidated_depth = 0


@contextmanager
def prevalidated():
    """Mark the dynamic extent as carrying changes that need no lenient
    re-validation: either the inbound gate already ran the strict wire
    checks over them, or they were extracted from an admitted local
    lineage (merge) and are schema-valid by construction."""
    global _prevalidated_depth
    _prevalidated_depth += 1
    try:
        yield
    finally:
        _prevalidated_depth -= 1


def validate_changes(changes, strict: bool = True) -> list:
    """Validate a delivery; returns it materialized as a list."""
    if isinstance(changes, (str, bytes, dict)):
        raise ProtocolError(f"changes must be an array of change objects, "
                            f"got {type(changes).__name__}")
    try:
        changes = list(changes)
    except TypeError:
        raise ProtocolError(f"changes must be an array of change objects, "
                            f"got {type(changes).__name__}") from None
    if not strict and _prevalidated_depth:
        return changes   # already passed the stricter wire checks
    for change in changes:
        validate_change(change, strict)
    return changes


def validate_msg(msg) -> dict:
    """Validate one ``{docId, clock, changes?, wire?, checkpoint?,
    noSnapshot?}`` sync message (strict). ``checkpoint`` (a base64
    checkpoint bundle, the snapshot-bootstrap path) and ``noSnapshot``
    (the receiver's typed fallback request after a corrupt bundle) are
    optional extensions; the bundle's own integrity is verified by the
    checkpoint codec at restore time, not here. ``wire`` carries an
    ``AMTPUWIRE1`` binary change frame (engine/wire_format.py) — it is
    fully decoded (integrity hash + column envelope/bounds checks) HERE,
    so a truncated, bit-flipped, wrong-version, or out-of-envelope frame
    raises the typed ``WireFormatError`` (a ``ProtocolError``) before
    any state is touched, exactly like dict-wire malformation. A message
    may carry both ``changes`` (the dict prefix, e.g. a creation change)
    and ``wire`` (the frame-scoped tail); they apply in that order."""
    if not isinstance(msg, dict):
        raise ProtocolError(f"sync message must be an object, got "
                            f"{type(msg).__name__}")
    doc_id = msg.get("docId")
    if not isinstance(doc_id, str) or not doc_id:
        raise ProtocolError(f"sync message requires a non-empty string "
                            f"`docId`, got {doc_id!r}")
    clock = msg.get("clock")
    if clock is not None:
        validate_clock(clock, "message `clock`")
    changes = msg.get("changes")
    if changes is not None:
        if not isinstance(changes, (list, tuple)):
            raise ProtocolError(f"message `changes` must be an array, got "
                                f"{type(changes).__name__}")
        for change in changes:
            validate_change(change, strict=True)
    wire = msg.get("wire")
    if wire is not None:
        from ..engine.wire_format import WireFormatError, as_frame
        try:
            frame = as_frame(wire).validate()
        except WireFormatError:
            raise
        except (ValueError, TypeError, OverflowError) as exc:
            raise WireFormatError(
                f"malformed wire frame: {exc}") from exc
        if frame is not wire:
            # the ONE exception to the never-mutate rule: a bytes-typed
            # frame is replaced in place by its validated WireFrame, so
            # the decode just paid (body hash + bounds checks) is cached
            # for every downstream consumer instead of re-run per access
            # (in-process senders already pass WireFrame objects and are
            # untouched)
            msg["wire"] = frame
    trace = msg.get("trace")
    if trace is not None:
        # optional lineage trace context (INTERNALS §18.2): peers that
        # predate it never send or read it; a PRESENT value must be
        # schema-clean — WireFormatError is a ProtocolError, so a
        # malformed context degrades per-tenant like any other
        # malformed message, never crashes the tick
        from ..engine.wire_format import validate_trace_context
        validate_trace_context(trace)
    ckpt = msg.get("checkpoint")
    if ckpt is not None and not isinstance(ckpt, str):
        raise ProtocolError(f"message `checkpoint` must be a base64 string, "
                            f"got {type(ckpt).__name__}")
    if "noSnapshot" in msg and not isinstance(msg["noSnapshot"], bool):
        raise ProtocolError("message `noSnapshot` must be a boolean, got "
                            f"{msg['noSnapshot']!r}")
    return msg


def validate_save_payload(payload, require_changes: bool = True) -> dict:
    """Validate a deserialized ``api.save`` payload envelope.

    ``api.load`` historically leaked raw ``AttributeError`` on non-dict
    JSON (``load("[1]")``) and ``KeyError`` on a missing ``changes`` key;
    everything off-schema now raises :class:`ProtocolError` (a
    ``ValueError``) instead. Per-change validation stays with the backend
    apply path (lenient mode) — this checks the envelope only."""
    if not isinstance(payload, dict):
        raise ProtocolError(f"save payload must be an object, got "
                            f"{type(payload).__name__}")
    if not isinstance(payload.get("format"), str):
        raise ProtocolError(f"save payload requires a string `format`, got "
                            f"{payload.get('format')!r}")
    if require_changes and not isinstance(payload.get("changes"),
                                          (list, tuple)):
        raise ProtocolError(f"save payload requires a `changes` array, got "
                            f"{type(payload.get('changes')).__name__}")
    return payload
