"""Mutation recorder for change blocks.

Counterpart of reference frontend/context.js: every mutation made through
a proxy inside a change block is recorded twice — as a CRDT operation for the
backend (``ops``) and as an optimistic local diff applied immediately to the
document overlay (``updated``), so reads inside the block see writes.
"""

from __future__ import annotations

import datetime as _dt

from .._common import make_elem_id
from .._uuid import uuid
from .apply_patch import apply_diffs, copy_inbound
from .types import (Counter, ListDoc, MapDoc, Table, Text, WriteableCounter,
                    datetime_to_timestamp)


def _get_elem_id(obj, index):
    return obj.get_elem_id(index) if isinstance(obj, Text) else obj._elem_ids[index]


def _strict_equal(a, b) -> bool:
    """JS ===-style equality for the no-op assignment guard: type-sensitive for
    primitives (True is not 1, 1 is not 1.0), identity for document objects."""
    if a is b:
        return True
    if isinstance(a, (MapDoc, ListDoc, Text, Table, Counter)) or \
       isinstance(b, (MapDoc, ListDoc, Text, Table, Counter)):
        return False
    return type(a) is type(b) and a == b


class Context:
    def __init__(self, doc, actor_id: str):
        self.actor_id = actor_id
        self.cache = doc._cache
        self.updated: dict = {}
        self.inbound: dict = copy_inbound(doc._inbound)
        self.ops: list = []
        self.diffs: list = []
        self.closed = False  # set when the change block ends; later mutations
        # through captured handles must raise, not silently vanish

    def _check_open(self):
        if self.closed:
            raise TypeError(
                "This object belongs to a change block that has finished; "
                "objects cannot be modified outside of a change block")

    def add_op(self, operation: dict):
        self._check_open()
        self.ops.append(operation)

    def apply(self, diff: dict):
        self._check_open()
        self.diffs.append(diff)
        apply_diffs([diff], self.cache, self.updated, self.inbound)

    def get_object(self, object_id: str):
        obj = self.updated.get(object_id)
        if obj is None:
            obj = self.cache.get(object_id)
        if obj is None:
            raise KeyError(f"Target object does not exist: {object_id}")
        return obj

    def get_object_field(self, object_id: str, key):
        obj = self.get_object(object_id)
        if isinstance(obj, ListDoc):
            if not isinstance(key, int) or not (0 <= key < len(obj)):
                return None
            value = list.__getitem__(obj, key)
        else:
            value = dict.get(obj, key)
        if isinstance(value, Counter):
            return WriteableCounter(value.value, self, object_id, key)
        if isinstance(value, (MapDoc, ListDoc, Table, Text)):
            return self.instantiate_proxy(value._object_id)
        return value

    def instantiate_proxy(self, object_id: str):
        """Proxy (or writeable view) for a document object inside the block."""
        from .proxies import ListProxy, MapProxy, TextProxy
        obj = self.get_object(object_id)
        if isinstance(obj, Text):
            return TextProxy(self, object_id)
        if isinstance(obj, Table):
            return obj.get_writeable(self)
        if isinstance(obj, ListDoc):
            return ListProxy(self, object_id)
        return MapProxy(self, object_id)

    def create_nested_objects(self, value) -> str:
        """Recursively intern a fresh Python value tree as CRDT objects,
        returning the root object ID (context.js:74-124)."""
        if getattr(value, "_object_id", None):
            raise TypeError(
                "Cannot assign an object that already belongs to a document. "
                "Modify it in place, or assign a fresh copy.")
        object_id = uuid()

        if isinstance(value, Text):
            self.apply({"action": "create", "type": "text", "obj": object_id})
            self.add_op({"action": "makeText", "obj": object_id})
            if len(value) > 0:
                self.splice(object_id, 0, 0, list(value))
            # Attach so subsequent mutations of the same Text object route here.
            text = self.get_object(object_id)
            value._object_id = object_id
            value.elems = text.elems
            value._max_elem = text._max_elem
            value.context = self
        elif isinstance(value, Table):
            if value.count > 0:
                raise ValueError("Assigning a non-empty Table object is not supported")
            self.apply({"action": "create", "type": "table", "obj": object_id})
            self.add_op({"action": "makeTable", "obj": object_id})
        elif isinstance(value, (list, tuple)):
            self.apply({"action": "create", "type": "list", "obj": object_id})
            self.add_op({"action": "makeList", "obj": object_id})
            self.splice(object_id, 0, 0, list(value))
        elif isinstance(value, dict):
            self.apply({"action": "create", "type": "map", "obj": object_id})
            self.add_op({"action": "makeMap", "obj": object_id})
            for key in value:
                self.set_map_key(object_id, "map", key, value[key])
        else:  # pragma: no cover
            raise TypeError(f"Cannot create object from {value!r}")
        return object_id

    def set_value(self, obj: str, key, value) -> dict:
        """Record an assignment op; returns the normalized diff payload
        ({'value', 'link'?/'datatype'?}) (context.js:135-163)."""
        if isinstance(value, _dt.datetime):
            timestamp = datetime_to_timestamp(value)
            self.add_op({"action": "set", "obj": obj, "key": key,
                         "value": timestamp, "datatype": "timestamp"})
            return {"value": timestamp, "datatype": "timestamp"}
        if isinstance(value, Counter):
            self.add_op({"action": "set", "obj": obj, "key": key,
                         "value": value.value, "datatype": "counter"})
            return {"value": value.value, "datatype": "counter"}
        if isinstance(value, (dict, list, tuple, Text, Table)) or _is_proxy(value):
            # Proxies carry an _object_id, so create_nested_objects rejects
            # re-assignment of objects that already belong to a document.
            child_id = self.create_nested_objects(value)
            self.add_op({"action": "link", "obj": obj, "key": key, "value": child_id})
            return {"value": child_id, "link": True}
        if value is None or isinstance(value, (str, int, float, bool)):
            self.add_op({"action": "set", "obj": obj, "key": key, "value": value})
            return {"value": value}
        raise TypeError(f"Unsupported type of value: {type(value).__name__}")

    def set_map_key(self, object_id: str, obj_type: str, key, value):
        if not isinstance(key, str):
            raise TypeError(f"The key of a map entry must be a string, not {type(key).__name__}")
        if key == "":
            raise ValueError("The key of a map entry must not be an empty string")
        obj = self.get_object(object_id)
        if isinstance(dict.get(obj, key), Counter):
            raise ValueError("Cannot overwrite a Counter object; use increment()/decrement().")
        # No-op if assigning the identical value with no conflict to resolve.
        if (not _strict_equal(dict.get(obj, key), value) or obj._conflicts.get(key)
                or value is None):
            value_obj = self.set_value(object_id, key, value)
            self.apply({"action": "set", "type": obj_type, "obj": object_id,
                        "key": key, **value_obj})

    def delete_map_key(self, object_id: str, key: str):
        obj = self.get_object(object_id)
        if dict.__contains__(obj, key):
            self.apply({"action": "remove", "type": "map", "obj": object_id, "key": key})
            self.add_op({"action": "del", "obj": object_id, "key": key})
        else:
            raise KeyError(key)

    def insert_list_item(self, object_id: str, index: int, value):
        lst = self.get_object(object_id)
        if index < 0 or index > len(lst):
            raise IndexError(
                f"List index {index} is out of bounds for list of length {len(lst)}")
        max_elem = lst._max_elem + 1
        obj_type = "text" if isinstance(lst, Text) else "list"
        prev_id = "_head" if index == 0 else _get_elem_id(lst, index - 1)
        elem_id = make_elem_id(self.actor_id, max_elem)
        self.add_op({"action": "ins", "obj": object_id, "key": prev_id, "elem": max_elem})
        value_obj = self.set_value(object_id, elem_id, value)
        self.apply({"action": "insert", "type": obj_type, "obj": object_id,
                    "index": index, "elemId": elem_id, **value_obj})
        self.get_object(object_id)._max_elem = max_elem

    def set_list_index(self, object_id: str, index: int, value):
        lst = self.get_object(object_id)
        if index == len(lst):
            self.insert_list_item(object_id, index, value)
            return
        if index < 0 or index > len(lst):
            raise IndexError(
                f"List index {index} is out of bounds for list of length {len(lst)}")
        current = lst.get(index) if isinstance(lst, Text) else list.__getitem__(lst, index)
        if isinstance(current, Counter):
            raise ValueError("Cannot overwrite a Counter object; use increment()/decrement().")
        conflicts = (lst.elems[index].get("conflicts") if isinstance(lst, Text)
                     else lst._conflicts[index])
        if not _strict_equal(current, value) or conflicts or value is None:
            elem_id = _get_elem_id(lst, index)
            obj_type = "text" if isinstance(lst, Text) else "list"
            value_obj = self.set_value(object_id, elem_id, value)
            self.apply({"action": "set", "type": obj_type, "obj": object_id,
                        "index": index, **value_obj})

    def splice(self, object_id: str, start: int, deletions: int, insertions: list):
        lst = self.get_object(object_id)
        obj_type = "text" if isinstance(lst, Text) else "list"
        if deletions > 0:
            if start < 0 or start > len(lst) - deletions:
                raise IndexError(
                    f"{deletions} deletions starting at index {start} are out of bounds "
                    f"for list of length {len(lst)}")
            for i in range(deletions):
                self.add_op({"action": "del", "obj": object_id,
                             "key": _get_elem_id(lst, start)})
                self.apply({"action": "remove", "type": obj_type,
                            "obj": object_id, "index": start})
                if i == 0:
                    lst = self.get_object(object_id)
        for i, value in enumerate(insertions):
            self.insert_list_item(object_id, start + i, value)

    def add_table_row(self, object_id: str, row) -> str:
        if not isinstance(row, dict) and not _is_proxy(row):
            raise TypeError("A table row must be a dict (map of column name to value)")
        if getattr(row, "_object_id", None):
            raise TypeError("Cannot reuse an existing object as table row")
        if "id" in row:
            raise TypeError('A table row must not have an "id" property; '
                            "it is generated automatically")
        row_id = self.create_nested_objects(row)
        self.apply({"action": "set", "type": "table", "obj": object_id,
                    "key": row_id, "value": row_id, "link": True})
        self.add_op({"action": "link", "obj": object_id, "key": row_id, "value": row_id})
        return row_id

    def delete_table_row(self, object_id: str, row_id: str):
        self.apply({"action": "remove", "type": "table", "obj": object_id, "key": row_id})
        self.add_op({"action": "del", "obj": object_id, "key": row_id})

    def increment(self, object_id: str, key, delta: int):
        obj = self.get_object(object_id)
        if isinstance(obj, (ListDoc, Text)):
            current = obj.get(key) if isinstance(obj, Text) else list.__getitem__(obj, key)
            if not isinstance(current, Counter):
                raise TypeError("Only counter values can be incremented")
            value = current.value + delta
            elem_id = _get_elem_id(obj, key)
            obj_type = "text" if isinstance(obj, Text) else "list"
            self.add_op({"action": "inc", "obj": object_id, "key": elem_id, "value": delta})
            self.apply({"action": "set", "type": obj_type, "obj": object_id,
                        "index": key, "value": value, "datatype": "counter"})
        else:
            current = dict.get(obj, key)
            if not isinstance(current, Counter):
                raise TypeError("Only counter values can be incremented")
            value = current.value + delta
            self.add_op({"action": "inc", "obj": object_id, "key": key, "value": delta})
            self.apply({"action": "set", "type": "map", "obj": object_id,
                        "key": key, "value": value, "datatype": "counter"})


def _is_proxy(value) -> bool:
    from .proxies import ListProxy, MapProxy, TextProxy
    return isinstance(value, (MapProxy, ListProxy, TextProxy))
