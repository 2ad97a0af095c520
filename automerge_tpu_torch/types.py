"""Typed wire-format and public-surface contracts.

Counterpart of the reference's TypeScript surface
(reference @types/automerge/index.d.ts:187-285): the change/op/patch/
diff/clock/message schemas are the protocol every layer speaks — frontends,
the oracle backend, the device engines, the native codec, and the sync
layer all exchange exactly these plain-JSON shapes (the reference pins them
in INTERNALS.md:143-475; ours are identical except `save` framing).

These are `TypedDict`s: runtime objects stay plain dicts (JSON round-trip
safe — `test_changes_survive_json_round_trip`), while type checkers and
readers get the full schema.
"""

from __future__ import annotations

from typing import Any, Dict, List, Literal, Optional, TypedDict

# Vector clock: actor id -> highest seq seen (INTERNALS.md:104-141 in the
# reference; used by sync and causal admission).
Clock = Dict[str, int]

OpAction = Literal["makeMap", "makeList", "makeText", "makeTable",
                   "ins", "set", "del", "inc", "link"]

DiffAction = Literal["create", "set", "insert", "remove", "maxElem"]

CollectionType = Literal["map", "list", "text", "table"]

DataType = Literal["counter", "timestamp"]

RequestType = Literal["change", "undo", "redo"]


class Op(TypedDict, total=False):
    """One CRDT operation inside a change (INTERNALS.md:150-324)."""
    action: OpAction
    obj: str                   # target object id (UUID; ROOT_ID for root)
    key: str                   # map key / elemId / '_head'
    elem: int                  # ins: new element's counter
    value: Any                 # set/inc payload; link: child object id
    datatype: DataType


class Change(TypedDict, total=False):
    """One actor's atomic change — the unit of replication."""
    actor: str
    seq: int
    deps: Clock                # causal dependencies (other actors only)
    ops: List[Op]
    message: Optional[str]
    requestType: RequestType   # frontend->backend requests only
    undoable: bool


class Conflict(TypedDict, total=False):
    actor: str
    value: Any
    link: bool
    datatype: DataType         # e.g. a counter that lost LWW resolution


class Diff(TypedDict, total=False):
    """One materialized-state delta inside a patch (INTERNALS.md:356-475)."""
    action: DiffAction
    type: CollectionType
    obj: str
    key: str
    index: int
    elemId: str
    value: Any
    link: bool
    datatype: DataType
    conflicts: List[Conflict]
    path: Optional[list]


class Patch(TypedDict, total=False):
    """Backend -> frontend state update."""
    actor: str
    seq: int
    clock: Clock
    deps: Clock
    canUndo: bool
    canRedo: bool
    diffs: List[Diff]


class Message(TypedDict, total=False):
    """Connection sync message (src/connection.js in the reference):
    {docId, clock} advertises state; adding `changes` ships deltas."""
    docId: str
    clock: Clock
    changes: List[Change]
