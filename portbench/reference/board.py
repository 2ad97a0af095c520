"""A document of nested maps and lists, replayed from its changes' op
JSON under Automerge 0.14's rules: the plain reference of the board
cells. It imports nothing of the program.

- Causality (op_set.js:7-37, :329-345): a change applies once its deps
  and its actor's previous seq have; its `allDeps` is the vector clock
  of everything before it. Two ops are concurrent when neither change's
  `allDeps` covers the other's.
- `makeMap`/`makeList` make an object (op_set.js applyMake, :63-82);
  `link` stores a child object in a map key or list element like a
  `set` stores a value (op_set.js:196-258).
- `set`/`link`/`del` on a field (a map key, or a list element's elemId)
  (op_set.js applyAssign, :196-257): the ops causally before the new op
  are overwritten, the concurrent ones stay; `set` and `link` then join
  the field. The field keeps its ops in descending actor id: the first
  is the value, the others are its conflicts. `del` leaves the field
  empty unless concurrent ops survive: an empty list element is a
  tombstone.
- `ins` after an elemId (or `_head`) with a counter `elem`: the element
  is `actor:elem`; it goes right after its parent, past every element
  greater than itself by (elem, actor id), which are the later
  concurrent inserts after the same parent and their descendants.

Departures from the JS backend (`backend/op_set.js`):
- A field keeps at most one op per actor: a later `set`/`link` of the
  same actor supersedes its earlier one even where neither change
  covers the other (only one change assigning a field twice does that).
  op_set.js:196-257 keeps both and orders them by a sort whose ties
  depend on the application order.
- Only the makes, `ins`, `set`, `link` and `del` are read: no counters
  (`inc`, `datatype`), no `makeText`/`makeTable`, no undo or redo, no
  patches (op_set.js:144-171 emits diffs; this computes the document).
- The list order is kept as one flat list of elements, walked to place
  each insert; op_set.js walks the insertion tree (getNext, getPrevious)
  and keeps a skip list of visible elements.
"""

from __future__ import annotations

ROOT_ID = "00000000-0000-0000-0000-000000000000"
HEAD = "_head"


class _Obj:
    __slots__ = ("kind", "fields", "order", "index")

    def __init__(self, kind: str):
        self.kind = kind            # "map" | "list"
        self.fields: dict = {}      # key or elemId -> [op], winner first
        self.order: list = []       # list elements: (elem, actor, elemId)
        self.index: dict = {}       # elemId -> (elem, actor)


class BoardReference:
    """Applies changes (dicts of the wire format) in causal order and
    reads the document as `to_json` gives it, the losers of its fields
    (`conflicts`) and its vector clock (`clock`)."""

    def __init__(self):
        self.objects = {ROOT_ID: _Obj("map")}
        self.all_deps: dict = {}    # actor -> [allDeps of seq 1, 2, ...]
        self.clock: dict = {}
        self.queue: list = []

    # -- causality ----------------------------------------------------------

    def _deps_of(self, change: dict) -> dict:
        deps = dict(change.get("deps", {}))
        deps[change["actor"]] = change["seq"] - 1
        return deps

    def _ready(self, change: dict) -> bool:
        return all(self.clock.get(a, 0) >= s
                   for a, s in self._deps_of(change).items())

    def _transitive(self, deps: dict) -> dict:
        out: dict = {}
        for actor, seq in deps.items():
            if seq <= 0:
                continue
            out[actor] = max(out.get(actor, 0), seq)
            for a, s in self.all_deps[actor][seq - 1].items():
                out[a] = max(out.get(a, 0), s)
        return out

    def _concurrent(self, op1: dict, op2: dict) -> bool:
        c1 = self.all_deps[op1["actor"]][op1["seq"] - 1]
        c2 = self.all_deps[op2["actor"]][op2["seq"] - 1]
        return (c1.get(op2["actor"], 0) < op2["seq"]
                and c2.get(op1["actor"], 0) < op1["seq"])

    def apply(self, changes) -> None:
        self.queue.extend(changes)
        progress = True
        while progress:
            progress, rest = False, []
            for change in self.queue:
                if self._ready(change):
                    self._apply_change(change)
                    progress = True
                else:
                    rest.append(change)
            self.queue = rest

    def _apply_change(self, change: dict) -> None:
        actor, seq = change["actor"], change["seq"]
        seen = self.all_deps.setdefault(actor, [])
        if seq <= len(seen):
            return                  # a duplicate delivery
        seen.append(self._transitive(self._deps_of(change)))
        self.clock[actor] = seq
        for raw in change["ops"]:
            op = dict(raw, actor=actor, seq=seq)
            action = op["action"]
            if action in ("makeMap", "makeList"):
                self.objects[op["obj"]] = _Obj(
                    "map" if action == "makeMap" else "list")
            elif action == "ins":
                self._insert(op)
            elif action in ("set", "link", "del"):
                self._assign(op)
            else:
                raise ValueError(f"the reference does not read {action!r}")

    # -- objects ------------------------------------------------------------

    def _insert(self, op: dict) -> None:
        obj = self.objects[op["obj"]]
        key = (op["elem"], op["actor"])
        elem_id = f"{op['actor']}:{op['elem']}"
        if op["key"] == HEAD:
            i = 0
        else:
            parent = obj.index[op["key"]]
            i = next(j for j, e in enumerate(obj.order)
                     if e[:2] == parent) + 1
        while i < len(obj.order) and obj.order[i][:2] > key:
            i += 1
        obj.order.insert(i, (op["elem"], op["actor"], elem_id))
        obj.index[elem_id] = key

    def _assign(self, op: dict) -> None:
        obj = self.objects[op["obj"]]
        kept = [o for o in obj.fields.get(op["key"], [])
                if self._concurrent(o, op)]
        if op["action"] != "del":
            kept = [o for o in kept if o["actor"] != op["actor"]] + [op]
        kept.sort(key=lambda o: o["actor"], reverse=True)
        obj.fields[op["key"]] = kept

    def _value(self, op: dict):
        if op["action"] == "link":
            return self.to_json(op["value"])
        return op["value"]

    def _visible(self, obj: _Obj) -> list:
        """(key, ops) of each field `to_json` shows: a map's keys, a
        list's elements by their index."""
        if obj.kind == "map":
            return [(k, ops) for k, ops in obj.fields.items() if ops]
        return list(enumerate(obj.fields[e] for _, _, e in obj.order
                              if obj.fields.get(e)))

    def to_json(self, obj_id: str = ROOT_ID):
        fields = self._visible(self.objects[obj_id])
        if self.objects[obj_id].kind == "map":
            return {k: self._value(ops[0]) for k, ops in fields}
        return [self._value(ops[0]) for _, ops in fields]

    def conflicts(self, obj_id: str = ROOT_ID, path: str = "") -> dict:
        """The losers of every visible field, as `getConflicts` reads
        them ({actor: value}), by the field's path from the root
        ("cards/3/title"); fields with no loser are left out."""
        out: dict = {}
        for key, ops in self._visible(self.objects[obj_id]):
            at = f"{path}{key}"
            if len(ops) > 1:
                out[at] = {o["actor"]: self._value(o) for o in ops[1:]}
            if ops[0]["action"] == "link":
                out.update(self.conflicts(ops[0]["value"], at + "/"))
        return out
