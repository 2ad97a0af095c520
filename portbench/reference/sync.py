"""A sync server's rooms as plain data: each room's text, replayed from
the Automerge change dicts with a plain RGA list, and the changes the
server owes each peer under Automerge 0.14's `getMissingChanges` rule
(src/connection.js, src/backend.js): every change of another actor whose
seq is above the clock the peer declared.

Plain Python: it imports nothing of the program.
"""

from __future__ import annotations

import bisect

from .rga import HEAD, RgaText


def elem_of(key: str) -> tuple:
    """An element id "actor:ctr" as (ctr, actor), the order RGA compares
    elements in."""
    actor, ctr = key.rsplit(":", 1)
    return int(ctr), actor


def text_ops(change: dict, text_id: str) -> list:
    """The ops of `change` on the text object, as reference/rga.py's
    tuples; ops on other objects (the text's creation and its link into
    the root map) are left out."""
    out = []
    for op in change["ops"]:
        if op.get("obj") != text_id:
            continue
        action = op["action"]
        if action == "ins":
            parent = HEAD if op["key"] == "_head" else elem_of(op["key"])
            out.append(("ins", (op["elem"], change["actor"]), parent))
        elif action == "set":
            out.append(("set", elem_of(op["key"]), ord(op["value"])))
        elif action == "del":
            out.append(("del", elem_of(op["key"])))
    return out


class RoomReference:
    """One room's document: its text and the seqs it holds of each
    actor."""

    def __init__(self, text_id: str, base: list):
        self.text_id = text_id
        self.rga = RgaText()
        self.held: dict = {}            # actor -> its seqs, ascending
        self.apply(base)

    def apply(self, changes: list) -> None:
        for c in changes:
            self.rga.apply(text_ops(c, self.text_id))
            bisect.insort(self.held.setdefault(c["actor"], []), c["seq"])

    def text(self) -> str:
        return self.rga.text()

    def owed(self, actor: str, clock: dict) -> set:
        """The changes the room owes the peer of `actor` that declared
        `clock`: every (actor, seq) of another actor above that clock."""
        out = set()
        for a, seqs in self.held.items():
            if a != actor:
                i = bisect.bisect_right(seqs, clock.get(a, 0))
                out.update((a, s) for s in seqs[i:])
        return out


class SyncReference:
    """Every room of a server, round by round."""

    def __init__(self, text_id: str, base: list, room_ids):
        self.rooms = {rid: RoomReference(text_id, base) for rid in room_ids}
        self.owed: dict = {}            # (room, actor) -> {(actor, seq)}

    def round(self, peers: dict) -> None:
        """One round: {room: [(change, the clock its peer declared)]}. A
        peer is owed what the room holds past its clock once the round's
        changes are in."""
        for rid, sent in peers.items():
            room = self.rooms[rid]
            room.apply([c for c, _ in sent])
            for c, clock in sent:
                self.owed.setdefault((rid, c["actor"]), set()).update(
                    room.owed(c["actor"], clock))

    def texts(self) -> dict:
        return {rid: room.text() for rid, room in self.rooms.items()}
