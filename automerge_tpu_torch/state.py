"""Carry a text document's state across engines.

`tables_from_numpy` turns the 9 element tables of a document — as numpy
arrays, e.g. ``{k: np.asarray(v) for k, v in doc._dev.items()}`` of a JAX
`DeviceTextDoc` — into this package's table dict on a torch device, with
the dtypes kept exactly. `host_state` reads the whole state of a text
document of either engine into plain numpy/Python values (duck-typed: it
imports neither engine), and `load_text_doc_state` installs it into a
`DeviceTextDoc` of this package, so both engines can start from one state.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .engine.host_index import BatchRangeIndex
from .engine.segments import SegmentMirror

#: element table -> dtype (the padding fills travel with the arrays)
TABLE_DTYPES = {
    "parent": np.int32, "ctr": np.int32, "actor": np.int32,
    "value": np.int32, "has_value": np.bool_, "win_actor": np.int32,
    "win_seq": np.int32, "win_counter": np.bool_, "chain": np.bool_,
}


def tables_from_numpy(tables: dict, device) -> dict:
    """{name: np.ndarray} of the 9 element tables -> {name: torch.Tensor}
    on `device`. Raises on a missing table, a wrong dtype or mismatched
    lengths."""
    missing = set(TABLE_DTYPES) - set(tables)
    if missing:
        raise KeyError(f"missing element tables: {sorted(missing)}")
    lengths = {len(tables[k]) for k in TABLE_DTYPES}
    if len(lengths) != 1:
        raise ValueError(f"element tables differ in length: {lengths}")
    out = {}
    for k, dtype in TABLE_DTYPES.items():
        arr = np.asarray(tables[k])
        if arr.dtype != np.dtype(dtype):
            raise TypeError(f"table {k!r}: expected {np.dtype(dtype)}, "
                            f"got {arr.dtype}")
        out[k] = torch.from_numpy(np.array(arr, copy=True)).to(device)
    return out


def host_state(doc) -> dict:
    """The state of a text document (either engine) as host values: the
    element tables, counts, the elemId index rows, the segment mirror, the
    actor/clock tables and the host-held register state."""
    mirror = doc.seg_mirror
    return {
        # copies: a CPU table's numpy view would see later in-place rounds
        "tables": {k: np.array(v.cpu() if torch.is_tensor(v) else v)
                   for k, v in doc._ensure_dev().items()},
        "n_elems": int(doc.n_elems),
        "cap": int(doc._cap),
        "seg_bound": int(doc._seg_bound),
        "index_rows": tuple(np.array(a) for a in doc.index.rows()),
        "seg_mirror": (None if mirror is None else
                       (mirror.heads.copy(), mirror.par.copy(),
                        mirror.hctr.copy(), mirror.hactor.copy())),
        "all_ascii": bool(doc.all_ascii),
        "actor_table": list(doc.actor_table),
        "clock": dict(doc.clock),
        "all_deps": dict(doc._all_deps),
        "conflicts": copy.deepcopy(doc.conflicts),
        "value_pool": copy.deepcopy(doc.value_pool),
    }


def load_text_doc_state(port_doc, state: dict):
    """Install `host_state(...)` output into a DeviceTextDoc of this
    package (on the document's own device); returns the document."""
    port_doc._dev = tables_from_numpy(state["tables"], port_doc.device)
    port_doc.n_elems = state["n_elems"]
    port_doc._cap = state["cap"]
    port_doc._seg_bound = state["seg_bound"]
    port_doc.index = BatchRangeIndex.from_rows(*state["index_rows"])
    sm = state["seg_mirror"]
    port_doc.seg_mirror = None if sm is None else SegmentMirror(
        *(np.array(a) for a in sm))
    port_doc.all_ascii = state["all_ascii"]
    port_doc.actor_table = list(state["actor_table"])
    port_doc._actor_rank = {a: i for i, a in enumerate(port_doc.actor_table)}
    port_doc._intern_gen += 1
    port_doc.clock = dict(state["clock"])
    port_doc._all_deps = dict(state["all_deps"])
    port_doc.conflicts = copy.deepcopy(state["conflicts"])
    port_doc.value_pool = copy.deepcopy(state["value_pool"])
    port_doc._n_elems_dev = None
    port_doc._text_cache = None
    port_doc._touched_old = []
    port_doc._invalidate()
    return port_doc
