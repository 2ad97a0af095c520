"""Apply backend diffs to the materialized document tree.

Counterpart of reference frontend/apply_patch.js: structural sharing via
an `updated` overlay over the previous `cache`, child->parent `inbound` index
maintenance (single-parent invariant), and parent re-linking up to the root.

Consecutive list/text insert diffs at adjacent indexes — and removes at the
same index — are applied as ONE slice splice (the reference's optimization,
apply_patch.js:332-384): a K-insert patch into an N-element document costs
O(N + K) list work instead of K separate O(N) `list.insert` shifts, which
turns bulk loads (load/merge of big Text docs) from quadratic to linear.
A single-element run degenerates to exactly the element-wise operation, so
there is one code path; ``apply_diffs(..., splice_batch=False)`` keeps the
element-wise path reachable for the A/B benchmark (benchmarks/run_all.py).
"""

from __future__ import annotations

from .._common import ROOT_ID, parse_elem_id
from .types import (Counter, ListDoc, MapDoc, Table, Text, instantiate_table,
                    instantiate_text, timestamp_to_datetime)


def get_value(diff: dict, cache: dict, updated: dict):
    """Reconstruct the value a diff assigns (apply_patch.js:10-25)."""
    if diff.get("link"):
        child = updated.get(diff["value"])
        return child if child is not None else cache[diff["value"]]
    datatype = diff.get("datatype")
    if datatype == "timestamp":
        return timestamp_to_datetime(diff["value"])
    if datatype == "counter":
        return Counter(diff["value"])
    if datatype is not None:
        raise TypeError(f"Unknown datatype: {datatype}")
    return diff["value"]


def _is_doc_object(value) -> bool:
    return isinstance(value, (MapDoc, ListDoc, Table, Text)) and value._object_id


def _child_references(obj, key) -> dict:
    """Object IDs referenced at `key` (value + conflicts) (apply_patch.js:32-41)."""
    refs = {}
    if isinstance(obj, ListDoc):
        conflicts = (obj._conflicts[key] or {}) if 0 <= key < len(obj._conflicts) else {}
        value = obj[key] if 0 <= key < len(obj) else None
    else:
        conflicts = obj._conflicts.get(key) or {}
        value = dict.get(obj, key)
    for child in [value, *conflicts.values()]:
        if _is_doc_object(child):
            refs[child._object_id] = True
    return refs


class InboundIndex(dict):
    """child object id -> parent object id, plus (``key_of``) the STABLE
    key the child sits at under that parent when one exists.

    The key record is what lets ``update_parent_objects`` relink an
    updated child into its parent by direct key access instead of
    scanning every entry of the parent — under a 100k-key root map, the
    full scan made ONE nested one-key change cost ~70 ms (1M dict probes
    per change). List children record no key (indices shift under
    splices; lists keep the scan), so ``key_of`` may lack entries — the
    relink falls back to the scan whenever a needed key is missing, and
    plain dicts (older callers, tests) behave exactly as before."""

    __slots__ = ("key_of",)

    def __init__(self, *args):
        super().__init__(*args)
        self.key_of: dict = {}

    def copy_index(self) -> "InboundIndex":
        new = InboundIndex(self)
        new.key_of = dict(self.key_of)
        return new


def copy_inbound(inbound: dict) -> dict:
    """Per-change copy preserving the key index when present."""
    if isinstance(inbound, InboundIndex):
        return inbound.copy_index()
    return dict(inbound)


_NO_KEY = object()   # sentinel: "linked at an unstable/unknown key"


def _update_inbound(object_id: str, refs_before: dict, refs_after: dict,
                    inbound: dict, key=_NO_KEY):
    key_of = getattr(inbound, "key_of", None)
    for ref in refs_before:
        if ref not in refs_after:
            inbound.pop(ref, None)
            if key_of is not None:
                key_of.pop(ref, None)
    for ref in refs_after:
        if inbound.get(ref) is not None and inbound[ref] != object_id:
            raise ValueError(f"Object {ref} has multiple parents")
        if ref not in inbound:
            inbound[ref] = object_id
        if key_of is not None:
            if key is _NO_KEY:
                key_of.pop(ref, None)
            else:
                key_of[ref] = key


def _clone_map_object(original, object_id: str) -> MapDoc:
    if original is not None and original._object_id != object_id:
        raise ValueError(f"cloneMapObject ID mismatch: {original._object_id} != {object_id}")
    obj = MapDoc(original or {}, object_id=object_id)
    obj._conflicts = {k: dict(v) for k, v in (original._conflicts if original else {}).items()}
    return obj


def _update_map_object(diff: dict, cache: dict, updated: dict, inbound: dict):
    object_id = diff["obj"]
    if object_id not in updated:
        updated[object_id] = _clone_map_object(cache.get(object_id), object_id)
    obj = updated[object_id]
    conflicts = obj._conflicts
    refs_before, refs_after = {}, {}

    action = diff["action"]
    if action == "create":
        pass
    elif action == "set":
        refs_before = _child_references(obj, diff["key"])
        dict.__setitem__(obj, diff["key"], get_value(diff, cache, updated))
        if diff.get("conflicts"):
            conflicts[diff["key"]] = {
                c["actor"]: get_value(c, cache, updated) for c in diff["conflicts"]
            }
        else:
            conflicts.pop(diff["key"], None)
        refs_after = _child_references(obj, diff["key"])
    elif action == "remove":
        refs_before = _child_references(obj, diff["key"])
        if dict.__contains__(obj, diff["key"]):
            dict.__delitem__(obj, diff["key"])
        conflicts.pop(diff["key"], None)
    else:
        raise ValueError(f"Unknown action type: {action}")

    _update_inbound(object_id, refs_before, refs_after, inbound,
                    key=diff.get("key", _NO_KEY))   # create has no key


def _parent_map_targeted(object_id: str, cache: dict, updated: dict,
                         child_ids: list, key_of: dict):
    """Relink ONLY the updated children, each at its recorded key —
    O(children) instead of O(parent size). Semantics identical to
    `_parent_map_object`: a key is rewritten only when its current value
    (or a conflict value at it) still references the stale child."""
    if object_id not in updated:
        updated[object_id] = _clone_map_object(cache.get(object_id), object_id)
    obj = updated[object_id]
    for child_id in child_ids:
        key = key_of[child_id]
        new_child = updated[child_id]
        value = dict.get(obj, key)
        if _is_doc_object(value) and value._object_id == child_id:
            dict.__setitem__(obj, key, new_child)
        conflicts = obj._conflicts.get(key)
        if conflicts:
            for actor_id, cvalue in list(conflicts.items()):
                if _is_doc_object(cvalue) and cvalue._object_id == child_id:
                    conflicts[actor_id] = new_child


def _parent_map_object(object_id: str, cache: dict, updated: dict):
    if object_id not in updated:
        updated[object_id] = _clone_map_object(cache.get(object_id), object_id)
    obj = updated[object_id]
    for key in list(obj.keys()):
        value = dict.get(obj, key)
        if _is_doc_object(value) and value._object_id in updated:
            dict.__setitem__(obj, key, updated[value._object_id])
        conflicts = obj._conflicts.get(key)
        if conflicts:
            for actor_id, cvalue in list(conflicts.items()):
                if _is_doc_object(cvalue) and cvalue._object_id in updated:
                    conflicts[actor_id] = updated[cvalue._object_id]


def _update_table_object(diff: dict, cache: dict, updated: dict, inbound: dict):
    object_id = diff["obj"]
    if object_id not in updated:
        cached = cache.get(object_id)
        updated[object_id] = cached._clone() if cached else instantiate_table(object_id)
    table = updated[object_id]
    refs_before, refs_after = {}, {}

    action = diff["action"]
    if action == "create":
        pass
    elif action == "set":
        previous = table.by_id(diff["key"])
        if _is_doc_object(previous):
            refs_before[previous._object_id] = True
        if diff.get("link"):
            child = updated.get(diff["value"])
            table._set(diff["key"], child if child is not None else cache[diff["value"]])
            refs_after[diff["value"]] = True
        else:
            table._set(diff["key"], diff["value"])
    elif action == "remove":
        previous = table.by_id(diff["key"])
        if _is_doc_object(previous):
            refs_before[previous._object_id] = True
        table.remove(diff["key"])
    else:
        raise ValueError(f"Unknown action type: {action}")

    _update_inbound(object_id, refs_before, refs_after, inbound)


def _parent_table_object(object_id: str, cache: dict, updated: dict):
    if object_id not in updated:
        updated[object_id] = cache[object_id]._clone()
    table = updated[object_id]
    for key in list(table.entries.keys()):
        value = table.by_id(key)
        if _is_doc_object(value) and value._object_id in updated:
            table._set(key, updated[value._object_id])


def _clone_list_object(original, object_id: str) -> ListDoc:
    if original is not None and original._object_id != object_id:
        raise ValueError(f"cloneListObject ID mismatch: {original._object_id} != {object_id}")
    lst = ListDoc(original or [], object_id=object_id)
    lst._conflicts = list(original._conflicts) if original is not None else []
    lst._elem_ids = list(original._elem_ids) if original is not None else []
    lst._max_elem = original._max_elem if original is not None else 0
    return lst


def _update_list_object(diff: dict, cache: dict, updated: dict, inbound: dict):
    object_id = diff["obj"]
    if object_id not in updated:
        updated[object_id] = _clone_list_object(cache.get(object_id), object_id)
    lst = updated[object_id]
    conflicts, elem_ids = lst._conflicts, lst._elem_ids

    value, conflict = None, None
    action = diff["action"]
    if action in ("insert", "set"):
        value = get_value(diff, cache, updated)
        if diff.get("conflicts"):
            conflict = {c["actor"]: get_value(c, cache, updated) for c in diff["conflicts"]}

    refs_before, refs_after = {}, {}
    if action == "create":
        pass
    elif action == "insert":
        lst._max_elem = max(lst._max_elem, parse_elem_id(diff["elemId"])[1])
        list.insert(lst, diff["index"], value)
        conflicts.insert(diff["index"], conflict)
        elem_ids.insert(diff["index"], diff["elemId"])
        refs_after = _child_references(lst, diff["index"])
    elif action == "set":
        refs_before = _child_references(lst, diff["index"])
        list.__setitem__(lst, diff["index"], value)
        conflicts[diff["index"]] = conflict
        refs_after = _child_references(lst, diff["index"])
    elif action == "remove":
        refs_before = _child_references(lst, diff["index"])
        list.__delitem__(lst, diff["index"])
        del conflicts[diff["index"]]
        del elem_ids[diff["index"]]
    elif action == "maxElem":
        lst._max_elem = max(lst._max_elem, diff["value"])
    else:
        raise ValueError(f"Unknown action type: {action}")

    _update_inbound(object_id, refs_before, refs_after, inbound)


def _splice_list_insert(run: list, cache: dict, updated: dict, inbound: dict):
    """One slice assignment for a run of adjacent-index list inserts."""
    object_id = run[0]["obj"]
    if object_id not in updated:
        updated[object_id] = _clone_list_object(cache.get(object_id), object_id)
    lst = updated[object_id]
    idx = run[0]["index"]

    values, confls, eids = [], [], []
    max_elem = lst._max_elem
    refs_after = {}
    for diff in run:
        value = get_value(diff, cache, updated)
        conflict = None
        if diff.get("conflicts"):
            conflict = {c["actor"]: get_value(c, cache, updated)
                        for c in diff["conflicts"]}
        values.append(value)
        confls.append(conflict)
        eids.append(diff["elemId"])
        max_elem = max(max_elem, parse_elem_id(diff["elemId"])[1])
        for child in (value, *(conflict or {}).values()):
            if _is_doc_object(child):
                refs_after[child._object_id] = True
    lst._max_elem = max_elem
    list.__setitem__(lst, slice(idx, idx), values)
    lst._conflicts[idx:idx] = confls
    lst._elem_ids[idx:idx] = eids
    _update_inbound(object_id, {}, refs_after, inbound)


def _splice_list_remove(run: list, cache: dict, updated: dict, inbound: dict):
    """One slice deletion for a run of same-index list removes."""
    object_id = run[0]["obj"]
    if object_id not in updated:
        updated[object_id] = _clone_list_object(cache.get(object_id), object_id)
    lst = updated[object_id]
    idx, k = run[0]["index"], len(run)
    if idx < 0 or idx + k > len(lst):
        # slice deletion would silently clamp; fail loudly like the
        # element-wise list.__delitem__ does on a malformed diff
        raise IndexError(
            f"list remove range [{idx}, {idx + k}) out of bounds "
            f"for length {len(lst)}")
    refs_before = {}
    for i in range(idx, idx + k):
        refs_before.update(_child_references(lst, i))
    list.__delitem__(lst, slice(idx, idx + k))
    del lst._conflicts[idx: idx + k]
    del lst._elem_ids[idx: idx + k]
    _update_inbound(object_id, refs_before, {}, inbound)


def _parent_list_object(object_id: str, cache: dict, updated: dict):
    if object_id not in updated:
        updated[object_id] = _clone_list_object(cache.get(object_id), object_id)
    lst = updated[object_id]
    for index in range(len(lst)):
        value = list.__getitem__(lst, index)
        if _is_doc_object(value) and value._object_id in updated:
            list.__setitem__(lst, index, updated[value._object_id])
        conflicts = lst._conflicts[index]
        if conflicts:
            for actor_id, cvalue in list(conflicts.items()):
                if _is_doc_object(cvalue) and cvalue._object_id in updated:
                    conflicts[actor_id] = updated[cvalue._object_id]


def _update_text_object(diff: dict, cache: dict, updated: dict):
    object_id = diff["obj"]
    text = _text_target(object_id, cache, updated)

    action = diff["action"]
    if action == "create":
        pass
    elif action == "insert":
        text._max_elem = max(text._max_elem, parse_elem_id(diff["elemId"])[1])
        elem = {"elemId": diff["elemId"], "value": get_value(diff, cache, updated),
                "conflicts": diff.get("conflicts")}
        text.elems.insert(diff["index"], elem)
    elif action == "set":
        text.elems[diff["index"]] = {
            "elemId": text.elems[diff["index"]]["elemId"],
            "value": get_value(diff, cache, updated),
            "conflicts": diff.get("conflicts"),
        }
    elif action == "remove":
        del text.elems[diff["index"]]
    elif action == "maxElem":
        text._max_elem = max(text._max_elem, diff["value"])
    else:
        raise ValueError(f"Unknown action type: {action}")


def _splice_text_insert(run: list, cache: dict, updated: dict):
    """One slice assignment for a run of adjacent-index text inserts.

    Bulk-shaped (a fresh peer's initial sync delivers the whole document
    as one run): the loop body inlines `get_value`'s plain-value case and
    `parse_elem_id`'s counter extraction — at 100k diffs the generic
    helpers were the measured hot path; shapes that carry links,
    datatypes, or malformed elemIds take them unchanged."""
    object_id = run[0]["obj"]
    text = _text_target(object_id, cache, updated)
    idx = run[0]["index"]
    max_elem = text._max_elem
    elems = []
    append = elems.append
    for diff in run:
        elem_id = diff["elemId"]
        _, sep, ctr = elem_id.rpartition(":")
        if sep and ctr.isdigit():
            c = int(ctr)
            if c > max_elem:
                max_elem = c
        else:
            max_elem = max(max_elem, parse_elem_id(elem_id)[1])
        if diff.get("link") or diff.get("datatype"):
            value = get_value(diff, cache, updated)
        else:
            value = diff["value"]
        append({"elemId": elem_id, "value": value,
                "conflicts": diff.get("conflicts")})
    text._max_elem = max_elem
    text.elems[idx:idx] = elems


def _splice_text_remove(run: list, cache: dict, updated: dict):
    object_id = run[0]["obj"]
    text = _text_target(object_id, cache, updated)
    idx, k = run[0]["index"], len(run)
    if idx < 0 or idx + k > len(text.elems):
        raise IndexError(
            f"text remove range [{idx}, {idx + k}) out of bounds "
            f"for length {len(text.elems)}")
    del text.elems[idx: idx + k]


def _text_target(object_id: str, cache: dict, updated: dict):
    if object_id not in updated:
        cached = cache.get(object_id)
        if cached is not None:
            # O(n_chunks) copy-on-write snapshot, NOT an O(n) list copy —
            # this is the per-keystroke frontend cost on large documents
            # (ChunkedElems docstring, types.py)
            updated[object_id] = instantiate_text(
                object_id, cached.elems.copy(), cached._max_elem)
        else:
            updated[object_id] = instantiate_text(object_id, [], 0)
    return updated[object_id]


def update_parent_objects(cache: dict, updated: dict, inbound: dict):
    """Propagate updated children into new parent versions up to the root
    (apply_patch.js:393-414). Map parents relink by recorded key
    (`InboundIndex.key_of`) when every affected child has one; lists and
    tables — and plain-dict inbound callers — keep the full scan."""
    key_of = getattr(inbound, "key_of", None)
    affected = updated
    while affected:
        parents = {}
        for child_id in list(affected.keys()):
            parent_id = inbound.get(child_id)
            if parent_id:
                parents[parent_id] = True
        affected = parents
        if not parents:
            break
        # a freshly-cloned parent starts from the CACHE version, whose
        # entries reference the stale versions of EVERY updated child —
        # group over the whole `updated` map, not just this wave
        children_of: dict = {}
        if key_of is not None:
            for child_id in updated:
                p = inbound.get(child_id)
                if p in parents:
                    children_of.setdefault(p, []).append(child_id)
        for object_id in parents:
            obj = updated.get(object_id)
            if obj is None:
                obj = cache.get(object_id)
            if isinstance(obj, ListDoc):
                _parent_list_object(object_id, cache, updated)
            elif isinstance(obj, Table):
                _parent_table_object(object_id, cache, updated)
            else:
                kids = children_of.get(object_id, [])
                if key_of is not None and kids and \
                        all(k in key_of for k in kids):
                    _parent_map_targeted(object_id, cache, updated, kids,
                                         key_of)
                else:
                    _parent_map_object(object_id, cache, updated)


def _run_end(diffs: list, i: int) -> int:
    """End (exclusive) of the maximal spliceable run starting at diffs[i]:
    same object, same action; inserts at adjacent ascending indexes,
    removes at the same index (how the backend emits a contiguous range —
    each removal shifts the next element down to the same position)."""
    first = diffs[i]
    action, obj, dtype = first["action"], first["obj"], first["type"]
    j = i + 1
    while j < len(diffs):
        d = diffs[j]
        if d["type"] != dtype or d["obj"] != obj or d["action"] != action:
            break
        if action == "insert":
            if d["index"] != diffs[j - 1]["index"] + 1:
                break
        else:  # remove
            if d["index"] != first["index"]:
                break
        j += 1
    return j


def apply_diffs(diffs: list, cache: dict, updated: dict, inbound: dict,
                *, splice_batch: bool = True):
    i, n = 0, len(diffs)
    while i < n:
        diff = diffs[i]
        diff_type = diff["type"]
        if (splice_batch and diff_type in ("list", "text")
                and diff["action"] in ("insert", "remove")):
            j = _run_end(diffs, i)
            run = diffs[i:j]
            if diff_type == "list":
                if diff["action"] == "insert":
                    _splice_list_insert(run, cache, updated, inbound)
                else:
                    _splice_list_remove(run, cache, updated, inbound)
            else:
                if diff["action"] == "insert":
                    _splice_text_insert(run, cache, updated)
                else:
                    _splice_text_remove(run, cache, updated)
            i = j
            continue
        if diff_type == "map":
            _update_map_object(diff, cache, updated, inbound)
        elif diff_type == "table":
            _update_table_object(diff, cache, updated, inbound)
        elif diff_type == "list":
            _update_list_object(diff, cache, updated, inbound)
        elif diff_type == "text":
            _update_text_object(diff, cache, updated)
        else:
            raise TypeError(f"Unknown object type: {diff_type}")
        i += 1


def clone_root_object(root: MapDoc) -> MapDoc:
    if root._object_id != ROOT_ID:
        raise ValueError(f"Not the root object: {root._object_id}")
    return _clone_map_object(root, ROOT_ID)
