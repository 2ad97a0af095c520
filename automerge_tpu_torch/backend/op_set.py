"""Op-set reconciliation engine (host oracle path).

This is the CRDT heart of the framework: causal-order gating, vector-clock
concurrency partitioning, LWW-with-conflicts register resolution, counter
folding, and RGA list ordering. It is the semantic counterpart of the
reference's ``backend/op_set.js`` (reference backend/op_set.js:1-573)
and of the backend-state spec in reference INTERNALS.md:477-543, but the
state design is different: instead of persistent Immutable.js maps, the engine
keeps ONE mutable index per document lineage plus an append-only command log;
divergent branches fork by deterministic replay (see ``facade.py``). That keeps
the forward path allocation-free-ish and gives the columnar device engine a
flat view to ingest.

Wire formats (changes, ops, patches, diffs) are plain dicts with the exact
key names of the reference protocol (INTERNALS.md:150-475), so fixtures and
peers are interchangeable with the JS implementation.
"""

from __future__ import annotations

from typing import Any, Optional

from .._common import ROOT_ID, make_elem_id, parse_elem_id, transitive_deps
from .skip_list import SkipList

_MAKE_ACTIONS = ("makeMap", "makeList", "makeText", "makeTable")
_ASSIGN_ACTIONS = ("set", "del", "link", "inc")


class ObjRec:
    """Per-object index: the counterpart of byObject[objectId] (INTERNALS.md:495-520)."""

    __slots__ = ("init", "keys", "inbound", "insertion", "following", "max_elem", "elem_ids")

    def __init__(self, init_op=None, is_sequence=False):
        self.init = init_op                  # the make* op, or None for the root map
        self.keys: dict[str, list] = {}      # key -> ops (LWW winner first, desc by actor)
        self.inbound: list = []              # link ops whose value is this object
        self.insertion: dict[str, dict] = {} # elemId -> ins op (lists/text only)
        self.following: dict[str, list] = {} # elemId/_head -> ins ops referencing it
        self.max_elem = 0
        self.elem_ids: Optional[SkipList] = SkipList() if is_sequence else None

    @property
    def obj_type(self) -> Optional[str]:
        return self.init["action"] if self.init else None


class OpSetIndex:
    """Mutable reconciliation state for one document lineage."""

    def __init__(self):
        self.states: dict[str, list] = {}    # actor -> [{'change':…, 'allDeps':…}]
        self.history: list = []              # applied changes, in application order
        self.queue: list = []                # causally not-yet-ready changes
        self.by_object: dict[str, ObjRec] = {ROOT_ID: ObjRec()}
        self.clock: dict[str, int] = {}
        self.deps: dict[str, int] = {}
        self.undo_pos = 0
        self.undo_stack: list = []           # list of op-lists
        self.redo_stack: list = []
        self.undo_local: Optional[list] = None  # capture buffer while a local change applies
        self.commands: list = []             # append-only log for fork-by-replay

    # ------------------------------------------------------------------
    # concurrency / causality
    # ------------------------------------------------------------------

    def is_concurrent(self, op1: dict, op2: dict) -> bool:
        """Neither op happened-before the other (op_set.js:7-16)."""
        actor1, seq1 = op1.get("actor"), op1.get("seq")
        actor2, seq2 = op2.get("actor"), op2.get("seq")
        if not actor1 or not actor2 or not seq1 or not seq2:
            return False
        clock1 = self.states[actor1][seq1 - 1]["allDeps"]
        clock2 = self.states[actor2][seq2 - 1]["allDeps"]
        return clock1.get(actor2, 0) < seq2 and clock2.get(actor1, 0) < seq1

    def causally_ready(self, change: dict) -> bool:
        deps = dict(change["deps"])
        deps[change["actor"]] = change["seq"] - 1
        return all(self.clock.get(a, 0) >= s for a, s in deps.items())

    def transitive_deps(self, base_deps: dict) -> dict:
        """Full vector clock implied by `base_deps` (op_set.js:29-37)."""
        return transitive_deps(self.states, base_deps)

    # ------------------------------------------------------------------
    # object-tree navigation
    # ------------------------------------------------------------------

    def get_path(self, object_id: str):
        """Root-to-object path of keys/indexes, None if unreachable (op_set.js:43-60)."""
        path = []
        while object_id != ROOT_ID:
            rec = self.by_object.get(object_id)
            if rec is None or not rec.inbound:
                return None
            ref = rec.inbound[0]
            object_id = ref["obj"]
            parent = self.by_object[object_id]
            if parent.obj_type in ("makeList", "makeText"):
                index = parent.elem_ids.index_of(ref["key"])
                if index < 0:
                    return None
                path.insert(0, index)
            else:
                path.insert(0, ref["key"])
        return path

    def get_field_ops(self, object_id: str, key: str) -> list:
        rec = self.by_object.get(object_id)
        if rec is None:
            return []
        return rec.keys.get(key, [])

    # ------------------------------------------------------------------
    # op application
    # ------------------------------------------------------------------

    def _apply_make(self, op: dict):
        object_id = op["obj"]
        if object_id in self.by_object:
            raise ValueError(f"Duplicate creation of object {object_id}")
        action = op["action"]
        if action == "makeMap":
            obj_type = "map"
        elif action == "makeTable":
            obj_type = "table"
        else:
            obj_type = "text" if action == "makeText" else "list"
        self.by_object[object_id] = ObjRec(op, is_sequence=obj_type in ("list", "text"))
        return [{"action": "create", "obj": object_id, "type": obj_type}]

    def _apply_insert(self, op: dict):
        object_id, elem = op["obj"], op["elem"]
        elem_id = make_elem_id(op["actor"], elem)
        rec = self.by_object.get(object_id)
        if rec is None:
            raise ValueError(f"Modification of unknown object {object_id}")
        if elem_id in rec.insertion:
            raise ValueError(f"Duplicate list element ID {elem_id}")
        obj_type = "text" if rec.obj_type == "makeText" else "list"
        rec.max_elem = max(elem, rec.max_elem)
        rec.following.setdefault(op["key"], []).append(op)
        rec.insertion[elem_id] = op
        return [{
            "obj": object_id, "type": obj_type, "action": "maxElem",
            "value": rec.max_elem, "path": self.get_path(object_id),
        }]

    @staticmethod
    def _get_conflicts(ops: list) -> list:
        conflicts = []
        for op in ops[1:]:
            conflict = {"actor": op["actor"], "value": op["value"]}
            if op["action"] == "link":
                conflict["link"] = True
            if op.get("datatype"):
                conflict["datatype"] = op["datatype"]
            conflicts.append(conflict)
        return conflicts

    def _patch_list(self, object_id: str, index: int, elem_id: str, action: str, ops):
        rec = self.by_object[object_id]
        obj_type = "text" if rec.obj_type == "makeText" else "list"
        first_op = ops[0] if ops else None
        value = first_op["value"] if first_op else None
        edit = {"action": action, "type": obj_type, "obj": object_id,
                "index": index, "path": self.get_path(object_id)}
        if first_op and first_op["action"] == "link":
            edit["link"] = True
            value = {"obj": first_op["value"]}

        if action == "insert":
            rec.elem_ids.insert_index(index, first_op["key"], value)
            edit["elemId"] = elem_id
            edit["value"] = first_op["value"]
            if first_op.get("datatype"):
                edit["datatype"] = first_op["datatype"]
        elif action == "set":
            rec.elem_ids.set_value(first_op["key"], value)
            edit["value"] = first_op["value"]
            if first_op.get("datatype"):
                edit["datatype"] = first_op["datatype"]
        elif action == "remove":
            rec.elem_ids.remove_index(index)
        else:
            raise ValueError(f"Unknown action type: {action}")

        if ops and len(ops) > 1:
            edit["conflicts"] = self._get_conflicts(ops)
        return [edit]

    def _update_list_element(self, object_id: str, elem_id: str):
        ops = self.get_field_ops(object_id, elem_id)
        rec = self.by_object[object_id]
        index = rec.elem_ids.index_of(elem_id)

        if index >= 0:
            if not ops:
                return self._patch_list(object_id, index, elem_id, "remove", None)
            return self._patch_list(object_id, index, elem_id, "set", ops)

        if not ops:
            return []  # deleting a non-existent element = no-op

        # Find the closest visible predecessor (op_set.js:159-169); the miss
        # path walks the RGA tree — the device engine replaces this with a
        # batched rank recomputation.
        prev_id = elem_id
        while True:
            index = -1
            prev_id = self.get_previous(object_id, prev_id)
            if prev_id is None:
                break
            index = rec.elem_ids.index_of(prev_id)
            if index >= 0:
                break
        return self._patch_list(object_id, index + 1, elem_id, "insert", ops)

    def _update_map_key(self, object_id: str, obj_type: str, key: str):
        ops = self.get_field_ops(object_id, key)
        edit = {"action": "", "type": obj_type, "obj": object_id, "key": key,
                "path": self.get_path(object_id)}
        if not ops:
            edit["action"] = "remove"
        else:
            first_op = ops[0]
            edit["action"] = "set"
            edit["value"] = first_op["value"]
            if first_op["action"] == "link":
                edit["link"] = True
            if first_op.get("datatype"):
                edit["datatype"] = first_op["datatype"]
            if len(ops) > 1:
                edit["conflicts"] = self._get_conflicts(ops)
        return [edit]

    def _apply_assign(self, op: dict, top_level: bool):
        """Process a set/del/link/inc op (op_set.js:196-257).

        Concurrency partition: ops causally before `op` are overwritten; truly
        concurrent ops survive as conflicts. The multi-value register is kept
        sorted descending by actor id — element 0 is the LWW winner.
        """
        object_id = op["obj"]
        rec = self.by_object.get(object_id)
        if rec is None:
            raise ValueError(f"Modification of unknown object {object_id}")
        obj_type = rec.obj_type

        if self.undo_local is not None and top_level:
            if op["action"] == "inc":
                undo_ops = [{"action": "inc", "obj": object_id, "key": op["key"],
                             "value": -op["value"]}]
            else:
                undo_ops = [
                    {k: ref[k] for k in ("action", "obj", "key", "value", "datatype") if k in ref}
                    for ref in rec.keys.get(op["key"], [])
                ]
            if not undo_ops:
                undo_ops = [{"action": "del", "obj": object_id, "key": op["key"]}]
            self.undo_local.extend(undo_ops)

        ops = rec.keys.get(op["key"], [])

        if op["action"] == "inc":
            overwritten = []
            remaining = []
            for other in ops:
                if (other["action"] == "set" and isinstance(other.get("value"), (int, float))
                        and not isinstance(other.get("value"), bool)
                        and other.get("datatype") == "counter"
                        and not self.is_concurrent(other, op)):
                    updated = dict(other)
                    updated["value"] = other["value"] + op["value"]
                    remaining.append(updated)
                else:
                    remaining.append(other)
        else:
            overwritten = [other for other in ops if not self.is_concurrent(other, op)]
            remaining = [other for other in ops if self.is_concurrent(other, op)]

        if op["action"] in ("set", "link"):
            # AT MOST ONE op per actor per register. Two same-actor ops can
            # only coexist transiently when one change assigns a key twice
            # (undo/redo re-minting a conflict set does exactly this); the
            # later op of the change supersedes its predecessor. Keeping
            # both and relying on sort order is ORDER-DEPENDENT: a full
            # reverse after a stable ascending sort flips the same-actor
            # pair on every later application that re-sorts the register,
            # so peers that applied different interleavings materialize
            # different winners from identical change sets (found by
            # scripts/soak.py, general profile seed 6; the reference's
            # sortBy(actor).reverse() has the same latent flip).
            superseded = [o for o in remaining if o["actor"] == op["actor"]]
            overwritten = overwritten + superseded
            remaining = [o for o in remaining if o["actor"] != op["actor"]]

        # Overwritten links drop out of the child's inbound index.
        for prior in overwritten:
            if prior["action"] == "link":
                child = self.by_object.get(prior["value"])
                if child is not None and prior in child.inbound:
                    child.inbound.remove(prior)
        if op["action"] == "link":
            self.by_object[op["value"]].inbound.append(op)
        if op["action"] in ("set", "link"):
            remaining = remaining + [op]
        # descending by actor id — keys are now unique per actor, so the
        # sort is total and application-order-independent
        remaining = sorted(remaining, key=lambda o: o["actor"])[::-1]
        rec.keys[op["key"]] = remaining

        if object_id == ROOT_ID or obj_type == "makeMap":
            return self._update_map_key(object_id, "map", op["key"])
        if obj_type == "makeTable":
            return self._update_map_key(object_id, "table", op["key"])
        if obj_type in ("makeList", "makeText"):
            return self._update_list_element(object_id, op["key"])
        raise ValueError(f"Unknown operation type {obj_type}")

    @staticmethod
    def _simplify_diffs(diffs: list) -> list:
        """Drop redundant maxElem diffs (op_set.js:260-281)."""
        max_elems: dict[str, int] = {}
        result = []
        for diff in reversed(diffs):
            obj, action = diff["obj"], diff["action"]
            if action == "maxElem":
                if obj not in max_elems or max_elems[obj] < diff["value"]:
                    max_elems[obj] = diff["value"]
                    result.append(diff)
            elif action == "insert":
                counter = parse_elem_id(diff["elemId"])[1]
                if obj not in max_elems or max_elems[obj] < counter:
                    max_elems[obj] = counter
                result.append(diff)
            else:
                result.append(diff)
        result.reverse()
        return result

    def _apply_ops(self, ops: list) -> list:
        all_diffs = []
        new_objects = set()
        for op in ops:
            action = op["action"]
            if action in _MAKE_ACTIONS:
                new_objects.add(op["obj"])
                diffs = self._apply_make(op)
            elif action == "ins":
                diffs = self._apply_insert(op)
            elif action in _ASSIGN_ACTIONS:
                diffs = self._apply_assign(op, op["obj"] not in new_objects)
            else:
                raise ValueError(f"Unknown operation type {action}")
            all_diffs.extend(diffs)
        return self._simplify_diffs(all_diffs)

    def _apply_change(self, change: dict) -> list:
        actor, seq = change["actor"], change["seq"]
        prior = self.states.get(actor, [])
        if seq <= len(prior):
            if prior[seq - 1]["change"] != change:
                raise RuntimeError(f"Inconsistent reuse of sequence number {seq} by {actor}")
            return []  # idempotent duplicate

        base_deps = dict(change["deps"])
        base_deps[actor] = seq - 1
        all_deps = self.transitive_deps(base_deps)
        self.states.setdefault(actor, []).append({"change": change, "allDeps": all_deps})

        ops = [{**op, "actor": actor, "seq": seq} for op in change["ops"]]
        diffs = self._apply_ops(ops)

        # New direct-dependency frontier: drop anything now transitively covered.
        new_deps = {a: s for a, s in self.deps.items() if s > all_deps.get(a, 0)}
        new_deps[actor] = seq
        self.deps = new_deps
        self.clock[actor] = seq
        self.history.append(change)
        return diffs

    def _apply_queued_ops(self) -> list:
        """Fixpoint drain of causally-ready queued changes (op_set.js:329-345)."""
        diffs = []
        while True:
            not_ready = []
            for change in self.queue:
                if self.causally_ready(change):
                    diffs.extend(self._apply_change(change))
                else:
                    not_ready.append(change)
            if len(not_ready) == len(self.queue):
                return diffs
            self.queue = not_ready

    def _push_undo_history(self):
        self.undo_stack = self.undo_stack[: self.undo_pos] + [self.undo_local]
        self.undo_pos += 1
        self.redo_stack = []
        self.undo_local = None

    def add_change(self, change: dict, undoable: bool) -> list:
        self.queue.append(change)
        if undoable:
            self.undo_local = []
            diffs = self._apply_queued_ops()
            self._push_undo_history()
            return diffs
        return self._apply_queued_ops()

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def get_missing_changes(self, have_deps: dict, clock_bound: Optional[dict] = None) -> list:
        """All changes not covered by `have_deps` (op_set.js:388-395).

        `clock_bound` restricts the view to a historical snapshot of this
        lineage (states lists are append-only, so a clock fully determines a
        past state's visible change-set).
        """
        all_deps = self.transitive_deps(have_deps)
        changes = []
        for actor, states in self.states.items():
            upper = len(states) if clock_bound is None else min(len(states), clock_bound.get(actor, 0))
            for entry in states[all_deps.get(actor, 0): upper]:
                changes.append(entry["change"])
        return changes

    def get_changes_for_actor(self, for_actor: str, after_seq: int = 0,
                              clock_bound: Optional[dict] = None) -> list:
        states = self.states.get(for_actor, [])
        upper = len(states) if clock_bound is None else min(len(states), clock_bound.get(for_actor, 0))
        return [entry["change"] for entry in states[after_seq:upper]]

    @staticmethod
    def missing_deps_of_queue(queue, clock: dict) -> dict:
        missing: dict[str, int] = {}
        for change in queue:
            deps = dict(change["deps"])
            deps[change["actor"]] = change["seq"] - 1
            for dep_actor, dep_seq in deps.items():
                if clock.get(dep_actor, 0) < dep_seq:
                    missing[dep_actor] = max(dep_seq, missing.get(dep_actor, 0))
        return missing

    def get_object_fields(self, object_id: str) -> list:
        rec = self.by_object[object_id]
        return [key for key, ops in rec.keys.items() if ops]

    def get_object_conflicts(self, object_id: str, get_value) -> dict:
        rec = self.by_object[object_id]
        conflicts = {}
        for key, ops in rec.keys.items():
            if len(ops) > 1:
                conflicts[key] = {op["actor"]: get_value(op) for op in ops[1:]}
        return conflicts

    def list_length(self, object_id: str) -> int:
        return len(self.by_object[object_id].elem_ids)

    # ------------------------------------------------------------------
    # RGA ordering (tree walk; the device path replaces this with a sort +
    # pointer-doubling linearization)
    # ------------------------------------------------------------------

    def _get_parent(self, object_id: str, key: str):
        if key == "_head":
            return None
        insertion = self.by_object[object_id].insertion.get(key)
        if insertion is None:
            raise TypeError(f"Missing index entry for list element {key}")
        return insertion["key"]

    def insertions_after(self, object_id: str, parent_id, child_id=None) -> list:
        child_key = None
        if child_id:
            actor_id, counter = parse_elem_id(child_id)
            child_key = (counter, actor_id)
        ops = self.by_object[object_id].following.get(parent_id, [])
        entries = [op for op in ops if op["action"] == "ins"]
        if child_key is not None:
            entries = [op for op in entries if (op["elem"], op["actor"]) < child_key]
        entries.sort(key=lambda op: (op["elem"], op["actor"]), reverse=True)
        return [make_elem_id(op["actor"], op["elem"]) for op in entries]

    def get_next(self, object_id: str, key: str):
        children = self.insertions_after(object_id, key)
        if children:
            return children[0]
        while True:
            ancestor = self._get_parent(object_id, key)
            if ancestor is None:
                return None
            siblings = self.insertions_after(object_id, ancestor, key)
            if siblings:
                return siblings[0]
            key = ancestor

    def get_previous(self, object_id: str, key: str):
        parent_id = self._get_parent(object_id, key)
        children = self.insertions_after(object_id, parent_id)
        if children and children[0] == key:
            return None if parent_id == "_head" else parent_id

        prev_id = None
        for child in children:
            if child == key:
                break
            prev_id = child
        while True:
            grandchildren = self.insertions_after(object_id, prev_id)
            if not grandchildren:
                return prev_id
            prev_id = grandchildren[-1]

    def list_iterator(self, list_id: str, get_value):
        """Yield {'elemId', 'index'?, 'value'?, 'conflicts'?} in RGA order."""
        elem, index = "_head", -1
        while True:
            elem = self.get_next(list_id, elem)
            if elem is None:
                return
            item = {"elemId": elem}
            ops = self.get_field_ops(list_id, elem)
            if ops:
                index += 1
                item["index"] = index
                item["value"] = get_value(ops[0])
                item["conflicts"] = None
                if len(ops) > 1:
                    item["conflicts"] = {op["actor"]: get_value(op) for op in ops[1:]}
            yield item

    # ------------------------------------------------------------------
    # undo / redo (backend/index.js:258-316)
    # ------------------------------------------------------------------

    def do_undo(self, request: dict) -> list:
        if self.undo_pos < 1 or not self.undo_stack[self.undo_pos - 1:self.undo_pos]:
            raise ValueError("Cannot undo: there is nothing to be undone")
        undo_ops = self.undo_stack[self.undo_pos - 1]
        change = {"actor": request["actor"], "seq": request["seq"],
                  "deps": request.get("deps", {}), "message": request.get("message"),
                  "ops": undo_ops}

        redo_ops = []
        for op in undo_ops:
            if op["action"] not in _ASSIGN_ACTIONS:
                raise ValueError(f"Unexpected operation type in undo history: {op}")
            field_ops = self.get_field_ops(op["obj"], op["key"])
            if op["action"] == "inc":
                redo_ops.append({"action": "inc", "obj": op["obj"], "key": op["key"],
                                 "value": -op["value"]})
            elif not field_ops:
                redo_ops.append({"action": "del", "obj": op["obj"], "key": op["key"]})
            else:
                for field_op in field_ops:
                    redo_ops.append({k: v for k, v in field_op.items()
                                     if k not in ("actor", "seq")})

        self.undo_pos -= 1
        self.redo_stack = self.redo_stack + [redo_ops]
        return self.add_change(change, False)

    def do_redo(self, request: dict) -> list:
        if not self.redo_stack:
            raise ValueError("Cannot redo: the last change was not an undo")
        redo_ops = self.redo_stack[-1]
        change = {"actor": request["actor"], "seq": request["seq"],
                  "deps": request.get("deps", {}), "message": request.get("message"),
                  "ops": redo_ops}
        self.undo_pos += 1
        self.redo_stack = self.redo_stack[:-1]
        return self.add_change(change, False)

    # ------------------------------------------------------------------
    # fork-by-replay (replaces Immutable.js structural sharing)
    # ------------------------------------------------------------------

    def record(self, command):
        self.commands.append(command)

    def fork(self, version: int) -> "OpSetIndex":
        fresh = OpSetIndex()
        for command in self.commands[:version]:
            fresh._replay(command)
        fresh.commands = list(self.commands[:version])
        return fresh

    def _replay(self, command):
        kind = command[0]
        if kind == "apply":
            _, changes, undoable = command
            for change in changes:
                self.add_change(change, undoable)
        elif kind == "undo":
            self.do_undo(command[1])
        elif kind == "redo":
            self.do_redo(command[1])
        else:  # pragma: no cover
            raise ValueError(f"Unknown command {kind}")
