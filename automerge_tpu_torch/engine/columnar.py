"""Columnar change-batch encoding for the device engine.

The reference's wire format is row-oriented JSON (one dict per op). The device
engine consumes a struct-of-arrays encoding instead: one numpy column per op
field, with interned actor ids. `from_changes` converts wire-format changes;
high-throughput producers (benchmarks, native ingest) can build the columns
directly — this is the framework's native bulk format.

Only text/list ops are encoded (ins/set/del/inc on one target object); the
general document graph stays on the oracle path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .._common import (HEAD_PARENT, KIND_DEL, KIND_INC, KIND_INS,  # noqa: F401
                       KIND_SET, check_int32_envelope, parse_elem_id)


def _int32_col(name: str, values, lo: int = 0) -> np.ndarray:
    """Build an int32 column with a loud envelope check: numpy's cast
    behavior for out-of-range Python ints varies by version (wrap vs
    raise), and a wrapped counter/seq would silently reorder elements on
    device (int32 comparisons stand in for the reference's string
    ordering). Stage through int64, gate, then narrow."""
    arr = np.asarray(values, np.int64)
    check_int32_envelope(name, arr, lo=lo)
    return arr.astype(np.int32)


def intern_deps(deps: list) -> list:
    """Collapse equal dep dicts to one shared object. Wide concurrent
    batches (N changes all depending on the same frontier) then expose
    that shape by IDENTITY, which the engine's shared-frontier fast paths
    key on (engine/base.py:_shared_frontier) — admission and closure
    bookkeeping become O(1) dict work per change instead of a per-change
    closure walk."""
    cache: dict = {}
    out = []
    for d in deps:
        key = tuple(sorted(d.items()))
        hit = cache.get(key)
        if hit is None:
            hit = cache[key] = d
        out.append(hit)
    return out


@dataclass
class MapChangeBatch:
    """A batch of changes targeting one map object, columnar.

    Values: plain non-negative ints < 2^31 encode inline in `op_value`;
    everything else (strings, bools, floats, negatives, counters) goes in
    `value_pool` and is referenced by a negative index."""

    obj_id: str
    actors: list
    seqs: np.ndarray            # int32[n_changes]
    deps: list
    messages: list
    op_change: np.ndarray       # int32[n_ops] -> change row
    op_kind: np.ndarray         # int8[n_ops] (set/del/inc)
    op_key: np.ndarray          # int32[n_ops] -> batch key table
    op_value: np.ndarray        # int64[n_ops]
    key_table: list = field(default_factory=list)
    value_pool: list = field(default_factory=list)

    @property
    def n_changes(self) -> int:
        return len(self.actors)

    @property
    def n_ops(self) -> int:
        return len(self.op_kind)

    @property
    def actor_table(self) -> list:
        """Actors to intern (map ops carry no elemId actor refs)."""
        return self.actors

    @classmethod
    def from_changes(cls, changes, obj_id: str) -> "MapChangeBatch":
        key_id: dict = {}
        key_table: list = []
        value_pool: list = []

        def intern_key(key: str) -> int:
            if key not in key_id:
                key_id[key] = len(key_table)
                key_table.append(key)
            return key_id[key]

        actors, seqs, deps, messages = [], [], [], []
        cols = {k: [] for k in ("change", "kind", "key", "val")}
        for row, change in enumerate(changes):
            actors.append(change["actor"])
            seqs.append(change["seq"])
            deps.append(change.get("deps", {}))
            messages.append(change.get("message"))
            for op in change["ops"]:
                if op.get("obj") != obj_id:
                    raise ValueError(
                        f"op targets {op.get('obj')}, batch is for {obj_id}")
                action = op["action"]
                if action not in ("set", "del", "inc", "link"):
                    raise ValueError(
                        f"unsupported map op action: {action}")
                cols["change"].append(row)
                cols["kind"].append(
                    {"set": KIND_SET, "del": KIND_DEL, "inc": KIND_INC,
                     "link": KIND_SET}[action])
                cols["key"].append(intern_key(op["key"]))
                if action == "set":
                    value = op["value"]
                    if (isinstance(value, int) and not isinstance(value, bool)
                            and 0 <= value < 2**31 and not op.get("datatype")):
                        cols["val"].append(value)
                    else:
                        value_pool.append(
                            {"value": value, "datatype": op.get("datatype")})
                        cols["val"].append(-len(value_pool))
                elif action == "link":
                    # a link is a register op whose value is an object id
                    # (reference op_set.js:196-258 treats set/link uniformly)
                    value_pool.append({"value": op["value"], "link": True})
                    cols["val"].append(-len(value_pool))
                elif action == "inc":
                    cols["val"].append(op["value"])
                else:
                    cols["val"].append(0)

        return cls(
            obj_id=obj_id, actors=actors,
            seqs=_int32_col("seq", seqs, lo=1), deps=intern_deps(deps),
            messages=messages,
            op_change=np.asarray(cols["change"], np.int32),
            op_kind=np.asarray(cols["kind"], np.int8),
            op_key=np.asarray(cols["key"], np.int32),
            op_value=np.asarray(cols["val"], np.int64),
            key_table=key_table, value_pool=value_pool,
        )


@dataclass
class TextChangeBatch:
    """A batch of changes targeting one list/text object, columnar."""

    obj_id: str
    # per-change rows
    actors: list            # actor id string per change
    seqs: np.ndarray        # int32[n_changes]
    deps: list              # dict per change
    messages: list          # optional str per change
    # per-op columns
    op_change: np.ndarray       # int32[n_ops] -> change row
    op_kind: np.ndarray         # int8[n_ops]
    op_target_actor: np.ndarray  # int32[n_ops] -> batch actor table (elemId actor)
    op_target_ctr: np.ndarray   # int32[n_ops] (elemId counter; for ins: new elem)
    op_parent_actor: np.ndarray  # int32[n_ops] (ins only; HEAD_PARENT for '_head')
    op_parent_ctr: np.ndarray   # int32[n_ops]
    op_value: np.ndarray        # int64[n_ops] (codepoint, value-pool ref, or inc delta)
    actor_table: list = field(default_factory=list)  # batch-local actor interning
    value_pool: list = field(default_factory=list)   # non-codepoint values

    @property
    def n_changes(self) -> int:
        return len(self.actors)

    @property
    def n_ops(self) -> int:
        return len(self.op_kind)

    @classmethod
    def from_json(cls, data, obj_id: str) -> "TextChangeBatch":
        """Decode a JSON change list (str/bytes) into columns with the
        Python decoder (the port carries no native JSON codec)."""
        import json as _json
        return cls.from_changes(_json.loads(data), obj_id)

    @classmethod
    def from_changes(cls, changes, obj_id: str) -> "TextChangeBatch":
        """Decode wire-format changes (plain dicts) into columns."""
        actor_rank: dict = {}
        actor_table: list = []
        value_pool: list = []

        def intern(actor: str) -> int:
            if actor not in actor_rank:
                actor_rank[actor] = len(actor_table)
                actor_table.append(actor)
            return actor_rank[actor]

        actors, seqs, deps, messages = [], [], [], []
        cols = {k: [] for k in ("change", "kind", "ta", "tc", "pa", "pc", "val")}

        for row, change in enumerate(changes):
            actors.append(change["actor"])
            seqs.append(change["seq"])
            deps.append(change.get("deps", {}))
            messages.append(change.get("message"))
            a_idx = intern(change["actor"])
            for op in change["ops"]:
                if op.get("obj") != obj_id:
                    raise ValueError(
                        f"op targets {op.get('obj')}, batch is for {obj_id}")
                action = op["action"]
                cols["change"].append(row)
                if action == "ins":
                    cols["kind"].append(KIND_INS)
                    cols["ta"].append(a_idx)
                    cols["tc"].append(op["elem"])
                    if op["key"] == "_head":
                        cols["pa"].append(HEAD_PARENT)
                        cols["pc"].append(0)
                    else:
                        p_actor, p_ctr = parse_elem_id(op["key"])
                        cols["pa"].append(intern(p_actor))
                        cols["pc"].append(p_ctr)
                    cols["val"].append(0)
                elif action in ("set", "del", "inc", "link"):
                    kind = {"set": KIND_SET, "del": KIND_DEL, "inc": KIND_INC,
                            "link": KIND_SET}[action]
                    cols["kind"].append(kind)
                    t_actor, t_ctr = parse_elem_id(op["key"])
                    cols["ta"].append(intern(t_actor))
                    cols["tc"].append(t_ctr)
                    cols["pa"].append(HEAD_PARENT)
                    cols["pc"].append(0)
                    if action == "set":
                        value = op["value"]
                        if (isinstance(value, str) and len(value) == 1
                                and not op.get("datatype")):
                            cols["val"].append(ord(value))
                        else:
                            value_pool.append(
                                {"value": value, "datatype": op.get("datatype")})
                            cols["val"].append(-len(value_pool))  # negative = pool ref
                    elif action == "link":
                        # a link is a register op whose value is an object id
                        # (reference op_set.js:196-258 treats set/link alike)
                        value_pool.append({"value": op["value"], "link": True})
                        cols["val"].append(-len(value_pool))
                    elif action == "inc":
                        cols["val"].append(op["value"])
                    else:
                        cols["val"].append(0)
                else:
                    raise ValueError(
                        f"unsupported op action for columnar batch: {action}")

        return cls(
            obj_id=obj_id, actors=actors,
            seqs=_int32_col("seq", seqs, lo=1), deps=intern_deps(deps),
            messages=messages,
            op_change=np.asarray(cols["change"], np.int32),
            op_kind=np.asarray(cols["kind"], np.int8),
            op_target_actor=np.asarray(cols["ta"], np.int32),
            # elemId counters ride the int64 packed-key format and the
            # int32 device ctr column: wrap = silent reordering, so gate
            op_target_ctr=_int32_col("elemId counter", cols["tc"]),
            op_parent_actor=np.asarray(cols["pa"], np.int32),
            op_parent_ctr=_int32_col("parent elemId counter", cols["pc"]),
            op_value=np.asarray(cols["val"], np.int64),
            actor_table=actor_table, value_pool=value_pool,
        )
