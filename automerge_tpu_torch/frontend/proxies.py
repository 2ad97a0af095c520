"""Mutable-feeling views over document objects inside change blocks.

Counterpart of reference frontend/proxies.js, re-idiomized: instead of ES
Proxy traps, Python mapping/sequence protocols plus attribute access. Reads
come from the context's updated/cache overlay; writes are recorded as ops and
optimistic diffs.
"""

from __future__ import annotations

from .types import ListDoc, MapDoc


class MapProxy:
    """dict-like view of a map object: `d['key']`, `d.key`, `in`, iteration."""

    __slots__ = ("_context", "_object_id")

    def __init__(self, context, object_id):
        object.__setattr__(self, "_context", context)
        object.__setattr__(self, "_object_id", object_id)

    def _target(self) -> MapDoc:
        return self._context.get_object(self._object_id)

    # -- mapping protocol --

    def __getitem__(self, key):
        if not dict.__contains__(self._target(), key):
            raise KeyError(key)
        return self._context.get_object_field(self._object_id, key)

    def __setitem__(self, key, value):
        self._context.set_map_key(self._object_id, self._type_tag(), key, value)

    def __delitem__(self, key):
        self._context.delete_map_key(self._object_id, key)

    def __contains__(self, key):
        return dict.__contains__(self._target(), key)

    def __iter__(self):
        return iter(self._target().keys())

    def __len__(self):
        return len(self._target())

    def keys(self):
        return self._target().keys()

    def values(self):
        return [self._context.get_object_field(self._object_id, k) for k in self._target()]

    def items(self):
        return [(k, self._context.get_object_field(self._object_id, k))
                for k in self._target()]

    def get(self, key, default=None):
        if dict.__contains__(self._target(), key):
            return self._context.get_object_field(self._object_id, key)
        return default

    def update(self, other=(), **kwargs):
        pairs = other.items() if isinstance(other, dict) else other
        for key, value in pairs:
            self[key] = value
        for key, value in kwargs.items():
            self[key] = value

    def _type_tag(self) -> str:
        return "map"

    # -- attribute-style access (doc.key = value) --

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self[name] = value

    def __delattr__(self, name):
        if name.startswith("_"):
            object.__delattr__(self, name)
        else:
            del self[name]

    def __eq__(self, other):
        if isinstance(other, MapProxy):
            return self._object_id == other._object_id
        if isinstance(other, dict):
            return dict(self.items()) == other
        return NotImplemented

    def __repr__(self):
        return f"MapProxy({dict(self._target())!r})"

    def to_dict(self) -> dict:
        """Deep plain-Python snapshot of the current (in-block) state."""
        return {k: _plain(v) for k, v in self.items()}


class ListProxy:
    """list-like view of a list object, with the reference's list methods
    (insert_at/delete_at) plus Python sequence idioms."""

    __slots__ = ("_context", "_object_id")

    def __init__(self, context, object_id):
        object.__setattr__(self, "_context", context)
        object.__setattr__(self, "_object_id", object_id)

    def _target(self) -> ListDoc:
        return self._context.get_object(self._object_id)

    def _norm_index(self, index, for_insert=False):
        n = len(self._target())
        if index < 0:
            index += n
        if for_insert:
            return max(0, min(index, n))
        return index

    def __len__(self):
        return len(self._target())

    def __getitem__(self, index):
        if isinstance(index, slice):
            return [self[i] for i in range(*index.indices(len(self)))]
        index = self._norm_index(index)
        if not (0 <= index < len(self)):
            raise IndexError("list index out of range")
        return self._context.get_object_field(self._object_id, index)

    def __setitem__(self, index, value):
        if isinstance(index, slice):
            raise TypeError("slice assignment is not supported in change blocks; "
                            "use splice()")
        self._context.set_list_index(self._object_id, self._norm_index(index), value)

    def __delitem__(self, index):
        if isinstance(index, slice):
            indices = range(*index.indices(len(self)))
            if indices.step != 1:
                raise TypeError("stepped slice deletion is not supported")
            self._context.splice(self._object_id, indices.start, len(indices), [])
        else:
            self._context.splice(self._object_id, self._norm_index(index), 1, [])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __contains__(self, value):
        return any(v == value for v in self)

    def append(self, value):
        self._context.insert_list_item(self._object_id, len(self), value)

    def extend(self, values):
        self._context.splice(self._object_id, len(self), 0, list(values))

    def insert(self, index, value):
        self._context.insert_list_item(
            self._object_id, self._norm_index(index, for_insert=True), value)

    def insert_at(self, index, *values):
        self._context.splice(self._object_id, index, 0, list(values))
        return self

    def delete_at(self, index, num_delete=1):
        self._context.splice(self._object_id, index, num_delete, [])
        return self

    def splice(self, start, deletions=0, insertions=()):
        self._context.splice(self._object_id, start, deletions, list(insertions))

    def pop(self, index=-1):
        index = self._norm_index(index)
        value = self[index]
        self._context.splice(self._object_id, index, 1, [])
        return value

    def remove(self, value):
        for i, v in enumerate(self):
            if v == value:
                self._context.splice(self._object_id, i, 1, [])
                return
        raise ValueError(f"{value!r} not in list")

    def index(self, value):
        for i, v in enumerate(self):
            if v == value:
                return i
        raise ValueError(f"{value!r} not in list")

    def count(self, value):
        return sum(1 for v in self if v == value)

    def __eq__(self, other):
        if isinstance(other, ListProxy):
            return self._object_id == other._object_id
        if isinstance(other, (list, tuple)):
            return list(self) == list(other)
        return NotImplemented

    def __repr__(self):
        return f"ListProxy({list(self._target())!r})"

    def to_list(self) -> list:
        return [_plain(v) for v in self]


class TextProxy:
    """Live view of a Text object inside a change block: reads always come
    from the context's current overlay, so captured references never go stale."""

    __slots__ = ("_context", "_object_id")

    def __init__(self, context, object_id):
        object.__setattr__(self, "_context", context)
        object.__setattr__(self, "_object_id", object_id)

    def _target(self):
        return self._context.get_object(self._object_id)

    def __len__(self):
        return len(self._target())

    def __getitem__(self, index):
        return self._target()[index]

    def get(self, index):
        return self._target().get(index)

    def get_elem_id(self, index):
        return self._target().get_elem_id(index)

    def __iter__(self):
        return iter(self._target())

    def __str__(self):
        return str(self._target())

    def __eq__(self, other):
        return self._target() == other

    def __repr__(self):
        return f"TextProxy({str(self._target())!r})"

    def to_spans(self):
        return self._target().to_spans()

    def to_json(self):
        return str(self._target())

    def set(self, index, value):
        self._context.set_list_index(self._object_id, index, value)
        return self

    def insert_at(self, index, *values):
        self._context.splice(self._object_id, index, 0, list(values))
        return self

    def delete_at(self, index, num_delete=1):
        self._context.splice(self._object_id, index, num_delete, [])
        return self


def _plain(value):
    if isinstance(value, MapProxy):
        return value.to_dict()
    if isinstance(value, ListProxy):
        return value.to_list()
    if isinstance(value, TextProxy):
        return value._target()
    return value


def root_object_proxy(context) -> MapProxy:
    from .._common import ROOT_ID
    return MapProxy(context, ROOT_ID)
