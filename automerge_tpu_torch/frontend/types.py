"""User-visible document value types: materialized views + CRDT wrappers.

Counterparts of the reference's frontend value layer — plain JS objects/arrays
with symbol-keyed metadata plus Text/Table/Counter classes
(reference frontend/{text,table,counter}.js, constants.js). In Python the
materialized document is built from ``dict``/``list`` subclasses carrying the
same metadata as instance attributes, so documents compare equal to plain
dicts/lists and serialize naturally.

Documents are immutable by convention; with ``freeze=True`` on init, mutation
attempts raise (the reference's deep-freeze option, README.md:208-212).
"""

from __future__ import annotations

import bisect
import datetime as _dt
from typing import Any, Iterator, Optional


def _frozen_guard(self):
    if getattr(self, "_frozen", False):
        raise TypeError("Cannot modify a frozen document object outside a change block")


class MapDoc(dict):
    """A materialized map object: a dict plus CRDT metadata."""

    _object_id: Optional[str] = None
    _frozen = False

    def __init__(self, *args, object_id=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._object_id = object_id
        self._conflicts: dict = {}

    # mutation guards (active once frozen)
    def __setitem__(self, key, value):
        _frozen_guard(self)
        super().__setitem__(key, value)

    def __delitem__(self, key):
        _frozen_guard(self)
        super().__delitem__(key)

    def update(self, *args, **kwargs):
        _frozen_guard(self)
        super().update(*args, **kwargs)

    def pop(self, *args):
        _frozen_guard(self)
        return super().pop(*args)

    def clear(self):
        _frozen_guard(self)
        super().clear()

    def _freeze(self):
        self._frozen = True


class ListDoc(list):
    """A materialized list object: a list plus CRDT metadata."""

    _object_id: Optional[str] = None
    _frozen = False

    def __init__(self, *args, object_id=None):
        super().__init__(*args)
        self._object_id = object_id
        self._conflicts: list = []    # per-index conflict dicts (or None)
        self._elem_ids: list = []     # per-index elemId strings
        self._max_elem: int = 0

    def __setitem__(self, key, value):
        _frozen_guard(self)
        super().__setitem__(key, value)

    def __delitem__(self, key):
        _frozen_guard(self)
        super().__delitem__(key)

    def append(self, value):
        _frozen_guard(self)
        super().append(value)

    def insert(self, index, value):
        _frozen_guard(self)
        super().insert(index, value)

    def extend(self, values):
        _frozen_guard(self)
        super().extend(values)

    def pop(self, *args):
        _frozen_guard(self)
        return super().pop(*args)

    def remove(self, value):
        _frozen_guard(self)
        super().remove(value)

    def clear(self):
        _frozen_guard(self)
        super().clear()

    def _freeze(self):
        self._frozen = True


class Counter:
    """Convergent integer changed only by increment/decrement
    (frontend/counter.js:6-44)."""

    def __init__(self, value: int = 0):
        object.__setattr__(self, "value", value)

    def __setattr__(self, name, value):
        raise AttributeError("Counter is immutable; use increment()/decrement() in a change block")

    def __int__(self):
        return int(self.value)

    def __index__(self):
        return int(self.value)

    def __eq__(self, other):
        if isinstance(other, Counter):
            return self.value == other.value
        if isinstance(other, (int, float)):
            return self.value == other
        return NotImplemented

    def __hash__(self):
        return hash(("Counter", self.value))

    def __lt__(self, other):
        return self.value < (other.value if isinstance(other, Counter) else other)

    def __add__(self, other):
        return self.value + other

    __radd__ = __add__

    def __repr__(self):
        return f"Counter({self.value})"

    def __str__(self):
        return str(self.value)

    def to_json(self):
        return self.value


class WriteableCounter(Counter):
    """Counter view inside a change block (frontend/counter.js:50-68)."""

    def __init__(self, value, context, object_id, key):
        super().__init__(value)
        object.__setattr__(self, "context", context)
        object.__setattr__(self, "object_id", object_id)
        object.__setattr__(self, "key", key)

    def increment(self, delta: int = 1) -> int:
        self.context.increment(self.object_id, self.key, delta)
        object.__setattr__(self, "value", self.value + delta)
        return self.value

    def decrement(self, delta: int = 1) -> int:
        return self.increment(-delta)


class ChunkedElems:
    """Copy-on-write chunked sequence backing ``Text.elems``.

    The frontend's immutable-snapshot contract means every change that
    touches a Text produces a NEW elems sequence while the old document
    keeps the old one. With a flat list, the snapshot is an O(n) copy per
    change — ~1 ms per keystroke on a 100k-char document, and the
    dominant term in the interactive loop (the reference pays the same
    shape via Immutable.js `List`, frontend/apply_patch.js — its
    persistent vectors ARE structural sharing; this class is the Python
    equivalent). Here `copy()` shares chunk references in O(n_chunks) and
    each mutation privatizes only the chunk it lands in, so a 10-char
    insert costs one ~CHUNK-element chunk copy instead of 100k.

    Supports exactly the sequence surface the frontend uses: int/slice
    reads, int writes, `insert`, slice-insertion (`e[i:i] = run`),
    contiguous-range deletion, `len`, iteration.
    """

    __slots__ = ("_chunks", "_shared", "_starts", "_len")
    CHUNK = 2048

    def __init__(self, seq=None):
        data = list(seq) if seq is not None else []
        C = self.CHUNK
        self._chunks = ([data[i: i + C] for i in range(0, len(data), C)]
                        or [[]])
        self._shared = [False] * len(self._chunks)
        self._len = len(data)
        self._starts = None

    def copy(self) -> "ChunkedElems":
        """O(n_chunks) snapshot: both sides share every chunk until one
        of them writes."""
        new = ChunkedElems.__new__(ChunkedElems)
        new._chunks = list(self._chunks)
        new._len = self._len
        new._starts = self._starts   # rebuilt fresh on demand, never
        self._shared = [True] * len(self._chunks)   # mutated in place
        new._shared = [True] * len(self._chunks)
        return new

    # -- index bookkeeping ------------------------------------------
    def _offsets(self):
        if self._starts is None:
            starts, acc = [], 0
            for c in self._chunks:
                starts.append(acc)
                acc += len(c)
            self._starts = starts
        return self._starts

    def _locate(self, i):
        starts = self._offsets()
        ci = bisect.bisect_right(starts, i) - 1
        return ci, i - starts[ci]

    def _own(self, ci):
        if self._shared[ci]:
            self._chunks[ci] = list(self._chunks[ci])
            self._shared[ci] = False
        return self._chunks[ci]

    def _norm(self, i):
        if i < 0:
            i += self._len
        if not 0 <= i < self._len:
            raise IndexError("ChunkedElems index out of range")
        return i

    # -- reads -------------------------------------------------------
    def __len__(self):
        return self._len

    def __iter__(self):
        for c in self._chunks:
            yield from c

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(self._len)
            if step == 1:
                return self._slice(start, stop)
            return [self[j] for j in range(start, stop, step)]
        i = self._norm(i)
        ci, off = self._locate(i)
        return self._chunks[ci][off]

    def _slice(self, start, stop):
        out = []
        if start >= stop:
            return out
        ci, off = self._locate(start)
        remaining = stop - start
        while remaining > 0:
            take = self._chunks[ci][off: off + remaining]
            out.extend(take)
            remaining -= len(take)
            ci += 1
            off = 0
        return out

    # -- writes ------------------------------------------------------
    def __setitem__(self, i, v):
        if isinstance(i, slice):
            start, stop, step = i.indices(self._len)
            if step != 1:
                raise TypeError("extended-step slice assignment "
                                "unsupported")
            if start != stop:
                self._del_range(start, stop)
            self._insert_run(start, list(v))
            return
        i = self._norm(i)
        ci, off = self._locate(i)
        self._own(ci)[off] = v

    def insert(self, i, v):
        if i < 0:
            i += self._len
        self._insert_run(max(0, min(i, self._len)), [v])

    def __delitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(self._len)
            if step != 1:
                raise TypeError("extended-step slice deletion unsupported")
            self._del_range(start, stop)
            return
        i = self._norm(i)
        self._del_range(i, i + 1)

    def _insert_run(self, idx, items):
        n = len(items)
        if not n:
            return
        C = self.CHUNK
        if n > C:
            # bulk run (a remote peer's merged typing run): split the
            # target chunk once and splice pre-chunked pieces between the
            # halves — inserting into a chunk and re-splitting would copy
            # the run twice more
            pieces = [items[i: i + C] for i in range(0, n, C)]
            if self._len == 0:                  # replace the [[]] sentinel
                self._chunks = pieces
                self._shared = [False] * len(pieces)
            elif idx >= self._len:
                self._chunks.extend(pieces)
                self._shared.extend([False] * len(pieces))
            else:
                ci, off = self._locate(idx)
                c = self._chunks[ci]
                halves = ([c[:off]] if off else []) + pieces + \
                    ([c[off:]] if off < len(c) else [])
                self._chunks[ci: ci + 1] = halves
                self._shared[ci: ci + 1] = [False] * len(halves)
            self._len += n
            self._starts = None
            return
        if idx >= self._len:                    # append
            ci = len(self._chunks) - 1
            off = len(self._chunks[ci])
        else:
            ci, off = self._locate(idx)
        c = self._own(ci)
        c[off:off] = items
        self._len += n
        self._starts = None
        if len(c) > 2 * C:                      # keep chunks bounded
            pieces = [c[i: i + C] for i in range(0, len(c), C)]
            self._chunks[ci: ci + 1] = pieces
            self._shared[ci: ci + 1] = [False] * len(pieces)

    def _del_range(self, start, stop):
        stop = min(stop, self._len)
        if start >= stop:
            return
        ci, off = self._locate(start)
        remaining = stop - start
        while remaining > 0:
            size = len(self._chunks[ci])
            if off == 0 and remaining >= size and len(self._chunks) > 1:
                # whole-chunk delete: drop the reference — privatizing a
                # shared chunk only to discard it would be the O(n) copy
                # this class exists to avoid
                del self._chunks[ci]
                del self._shared[ci]            # next chunk slides to ci
                remaining -= size
                continue
            c = self._own(ci)
            take = min(size - off, remaining)
            del c[off: off + take]
            remaining -= take
            if not c and len(self._chunks) > 1:
                del self._chunks[ci]
                del self._shared[ci]
            else:
                ci += 1
            off = 0
        self._len -= stop - start
        self._starts = None

    def __eq__(self, other):
        if isinstance(other, (ChunkedElems, list)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other))
        return NotImplemented

    def __repr__(self):
        return f"ChunkedElems({list(self)!r})"


class Text:
    """Sequence-of-characters (or embedded objects) CRDT view
    (frontend/text.js:3-165). ``elems`` entries are dicts
    {'value', 'elemId'?, 'conflicts'?}.
    """

    def __init__(self, text=None):
        self._object_id: Optional[str] = None
        self._max_elem: int = 0
        self.context = None
        if isinstance(text, str):
            self.elems = ChunkedElems({"value": ch} for ch in text)
        elif isinstance(text, (list, tuple)):
            self.elems = ChunkedElems({"value": v} for v in text)
        elif text is None:
            self.elems = ChunkedElems()
        else:
            raise TypeError(f"Unsupported initial value for Text: {text!r}")

    def __len__(self) -> int:
        return len(self.elems)

    def get(self, index: int):
        return self.elems[index]["value"]

    def get_elem_id(self, index: int):
        return self.elems[index].get("elemId")

    def __getitem__(self, index):
        if isinstance(index, slice):
            return [e["value"] for e in self.elems[index]]
        return self.elems[index]["value"]

    def __iter__(self) -> Iterator:
        return (e["value"] for e in self.elems)

    def __eq__(self, other):
        if isinstance(other, Text):
            return [e["value"] for e in self.elems] == [e["value"] for e in other.elems]
        if isinstance(other, str):
            return str(self) == other
        return NotImplemented

    def __hash__(self):
        return hash(str(self))

    def __str__(self) -> str:
        return "".join(e["value"] for e in self.elems if isinstance(e["value"], str))

    def __repr__(self):
        return f"Text({str(self)!r})"

    def to_spans(self) -> list:
        """Runs of characters interleaved with non-character elements
        (frontend/text.js:70-88): Text(['a','b',{'x':3},'c']) -> ['ab',{'x':3},'c'].
        """
        spans: list = []
        chars = ""
        for elem in self.elems:
            if isinstance(elem["value"], str):
                chars += elem["value"]
            else:
                if chars:
                    spans.append(chars)
                    chars = ""
                spans.append(elem["value"])
        if chars:
            spans.append(chars)
        return spans

    def to_json(self) -> str:
        return str(self)

    def get_writeable(self, context) -> "Text":
        if not self._object_id:
            raise ValueError("get_writeable() requires the objectId to be set")
        instance = Text()
        instance._object_id = self._object_id
        instance.elems = self.elems
        instance._max_elem = self._max_elem
        instance.context = context
        return instance

    # -- mutators: delegate to the change context when attached --

    def set(self, index: int, value) -> "Text":
        if self.context:
            self.context.set_list_index(self._object_id, index, value)
        elif not self._object_id:
            self.elems[index] = {"value": value}
        else:
            raise TypeError("Text object cannot be modified outside of a change block")
        return self

    def insert_at(self, index: int, *values) -> "Text":
        if self.context:
            self.context.splice(self._object_id, index, 0, list(values))
        elif not self._object_id:
            self.elems[index:index] = [{"value": v} for v in values]
        else:
            raise TypeError("Text object cannot be modified outside of a change block")
        return self

    def delete_at(self, index: int, num_delete: int = 1) -> "Text":
        if self.context:
            self.context.splice(self._object_id, index, num_delete, [])
        elif not self._object_id:
            del self.elems[index:index + num_delete]
        else:
            raise TypeError("Text object cannot be modified outside of a change block")
        return self


def instantiate_text(object_id, elems, max_elem) -> Text:
    instance = Text()
    instance._object_id = object_id
    instance.elems = (elems if isinstance(elems, ChunkedElems)
                      else ChunkedElems(elems))
    instance._max_elem = max_elem or 0
    return instance


def _compare_rows(properties, row1, row2):
    for prop in properties:
        v1, v2 = row1.get(prop), row2.get(prop)
        if v1 == v2:
            continue
        if isinstance(v1, (int, float)) and isinstance(v2, (int, float)):
            return -1 if v1 < v2 else 1
        s1, s2 = str(v1), str(v2)
        if s1 == s2:
            continue
        return -1 if s1 < s2 else 1
    return 0


class Table:
    """Relational-style unordered row collection keyed by row object ID
    (frontend/table.js:25-204)."""

    def __init__(self):
        self._object_id: Optional[str] = None
        self._conflicts: dict = {}
        self._frozen = False
        self.entries: dict = {}

    def by_id(self, row_id: str):
        return self.entries.get(row_id)

    @property
    def ids(self) -> list:
        return [key for key, entry in self.entries.items()
                if isinstance(entry, dict) and entry.get("id") == key]

    @property
    def count(self) -> int:
        return len(self.ids)

    @property
    def rows(self) -> list:
        return [self.by_id(i) for i in self.ids]

    def filter(self, callback) -> list:
        return [row for row in self.rows if callback(row)]

    def find(self, callback):
        for row in self.rows:
            if callback(row):
                return row
        return None

    def map(self, callback) -> list:
        return [callback(row) for row in self.rows]

    def sort(self, arg=None) -> list:
        import functools
        if callable(arg):
            return sorted(self.rows, key=functools.cmp_to_key(arg))
        if isinstance(arg, str):
            props = [arg]
        elif isinstance(arg, (list, tuple)):
            props = list(arg)
        elif arg is None:
            props = ["id"]
        else:
            raise TypeError(f"Unsupported sorting argument: {arg!r}")
        return sorted(self.rows, key=functools.cmp_to_key(
            lambda r1, r2: _compare_rows(props, r1, r2)))

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return self.count

    def __eq__(self, other):
        if isinstance(other, Table):
            return self.entries == other.entries
        return NotImplemented

    def _clone(self) -> "Table":
        if not self._object_id:
            raise ValueError("clone() requires the objectId to be set")
        return instantiate_table(self._object_id, dict(self.entries))

    def _set(self, row_id: str, value):
        if self._frozen:
            raise TypeError("A table can only be modified in a change function")
        if isinstance(value, dict):
            value["id"] = row_id
        self.entries[row_id] = value

    def remove(self, row_id: str):
        if self._frozen:
            raise TypeError("A table can only be modified in a change function")
        del self.entries[row_id]

    def _freeze(self):
        self._frozen = True

    def get_writeable(self, context) -> "WriteableTable":
        if not self._object_id:
            raise ValueError("get_writeable() requires the objectId to be set")
        instance = WriteableTable.__new__(WriteableTable)
        instance._object_id = self._object_id
        instance._conflicts = self._conflicts
        instance._frozen = False
        instance.context = context
        return instance

    def to_json(self) -> dict:
        return {row_id: self.by_id(row_id) for row_id in self.ids}


class WriteableTable(Table):
    """Table view inside a change block: reads come from the context's current
    overlay, so captured references never go stale."""

    @property
    def entries(self) -> dict:
        return self.context.get_object(self._object_id).entries

    def by_id(self, row_id: str):
        entry = self.entries.get(row_id)
        if isinstance(entry, dict) and entry.get("id") == row_id:
            return self.context.instantiate_proxy(row_id)
        return None

    def add(self, row: dict) -> str:
        """Adds a row (column-name -> value), returns its generated row ID."""
        return self.context.add_table_row(self._object_id, row)

    def remove(self, row_id: str):
        entry = self.entries.get(row_id)
        if isinstance(entry, dict) and entry.get("id") == row_id:
            self.context.delete_table_row(self._object_id, row_id)
        else:
            raise KeyError(f"There is no row with ID {row_id} in this table")


def instantiate_table(object_id, entries=None) -> Table:
    instance = Table()
    instance._object_id = object_id
    instance.entries = entries if entries is not None else {}
    return instance


def timestamp_to_datetime(ms: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(ms / 1000, tz=_dt.timezone.utc)


def datetime_to_timestamp(value: _dt.datetime) -> int:
    return int(value.timestamp() * 1000)
