"""Carry a document's state across engines.

`tables_from_numpy` turns the 9 element tables of a document — as numpy
arrays, e.g. ``{k: np.asarray(v) for k, v in doc._dev.items()}`` of a JAX
`DeviceTextDoc` — into this package's table dict on a torch device, with
the dtypes kept exactly. `host_state` reads the whole state of a text
document of either engine into plain numpy/Python values (duck-typed: it
imports neither engine), and `load_text_doc_state` installs it into a
`DeviceTextDoc` of this package, so both engines can start from one state.
`map_state` / `load_map_doc_state` do the same for a map document, and
`doc_set_state` / `load_doc_set_state` for a `DeviceTextDocSet`: its
stacked (D, cap) tables, each row's meta (clock, actor table, elemId
index, segment mirror) and its graduated documents.
`backend_state_from_jax` carries a whole backend lineage: a JAX
`DeviceBackendState` becomes this package's, every object's tables on
`device`, its host bookkeeping as plain values.
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
#: map register table -> dtype
REG_DTYPES = {k: TABLE_DTYPES[k] for k in
              ("value", "has_value", "win_actor", "win_seq", "win_counter")}


def tables_from_numpy(tables: dict, device, dtypes: dict = None) -> dict:
    """{name: np.ndarray} of the 9 element tables (or the tables `dtypes`
    names) -> {name: torch.Tensor} on `device`. Raises on a missing table,
    a wrong dtype or mismatched shapes."""
    dtypes = TABLE_DTYPES if dtypes is None else dtypes
    missing = set(dtypes) - set(tables)
    if missing:
        raise KeyError(f"missing tables: {sorted(missing)}")
    shapes = {np.shape(tables[k]) for k in dtypes}
    if len(shapes) != 1:
        raise ValueError(f"tables differ in shape: {shapes}")
    out = {}
    for k, dtype in dtypes.items():
        arr = np.asarray(tables[k])
        if arr.dtype != np.dtype(dtype):
            raise TypeError(f"table {k!r}: expected {np.dtype(dtype)}, "
                            f"got {arr.dtype}")
        out[k] = torch.from_numpy(np.array(arr, copy=True)).to(device)
    return out


def _np(v) -> np.ndarray:
    # a copy: a CPU table's numpy view would see later in-place rounds
    return np.array(v.cpu() if torch.is_tensor(v) else v)


def _mirror_arrays(mirror):
    return (None if mirror is None else
            (mirror.heads.copy(), mirror.par.copy(), mirror.hctr.copy(),
             mirror.hactor.copy()))


def _mirror_from(arrays):
    return None if arrays is None else SegmentMirror(
        *(np.array(a) for a in arrays))


def _causal_state(doc) -> dict:
    """The host state both document kinds share."""
    if doc.queue:
        raise ValueError(f"{doc.obj_id!r} holds queued changes; state "
                         "carries documents with an empty queue only")
    return {
        "cap": int(doc._cap),
        "actor_table": list(doc.actor_table),
        "clock": dict(doc.clock),
        "all_deps": dict(doc._all_deps),
        "conflicts": copy.deepcopy(doc.conflicts),
        "value_pool": copy.deepcopy(doc.value_pool),
    }


def _load_causal_state(port_doc, state: dict):
    port_doc._cap = state["cap"]
    port_doc.actor_table = list(state["actor_table"])
    port_doc._actor_rank = {a: i for i, a in enumerate(port_doc.actor_table)}
    port_doc._intern_gen += 1
    port_doc.clock = dict(state["clock"])
    port_doc._all_deps = dict(state["all_deps"])
    port_doc.conflicts = copy.deepcopy(state["conflicts"])
    port_doc.value_pool = copy.deepcopy(state["value_pool"])


def host_state(doc) -> dict:
    """The state of a text document (either engine) as host values: the
    element tables, counts, the elemId index rows, the segment mirror, the
    actor/clock tables and the host-held register state."""
    return {
        "tables": {k: _np(v) for k, v in doc._ensure_dev().items()},
        "n_elems": int(doc.n_elems),
        "seg_bound": int(doc._seg_bound),
        "index_rows": tuple(np.array(a) for a in doc.index.rows()),
        "seg_mirror": _mirror_arrays(doc.seg_mirror),
        "all_ascii": bool(doc.all_ascii),
        **_causal_state(doc),
    }


def load_text_doc_state(port_doc, state: dict):
    """Install `host_state(...)` output into a DeviceTextDoc of this
    package (on the document's own device); returns the document."""
    port_doc._dev = tables_from_numpy(state["tables"], port_doc.device)
    _load_causal_state(port_doc, state)
    port_doc.n_elems = state["n_elems"]
    port_doc._seg_bound = state["seg_bound"]
    port_doc.index = BatchRangeIndex.from_rows(*state["index_rows"])
    port_doc.seg_mirror = _mirror_from(state["seg_mirror"])
    port_doc.all_ascii = state["all_ascii"]
    port_doc._n_elems_dev = None
    port_doc._invalidate()
    return port_doc


def map_state(doc) -> dict:
    """The state of a map document (either engine) as host values: the 5
    register tables, the key table and the causal/register host state."""
    return {
        "tables": {k: _np(v) for k, v in doc._ensure_dev().items()},
        "key_table": list(doc.key_table),
        **_causal_state(doc),
    }


def load_map_doc_state(port_doc, state: dict):
    """Install `map_state(...)` output into a DeviceMapDoc of this
    package; returns the document."""
    port_doc._dev = tables_from_numpy(state["tables"], port_doc.device,
                                      REG_DTYPES)
    _load_causal_state(port_doc, state)
    port_doc.key_table = list(state["key_table"])
    port_doc._key_slot = {k: i for i, k in enumerate(port_doc.key_table)}
    port_doc._invalidate()
    return port_doc


def doc_set_state(ds) -> dict:
    """The state of a DeviceTextDocSet (either engine) as host values: the
    stacked (D, cap) tables, every row's meta and the `host_state` of
    each graduated document."""
    rows = []
    for m in ds._meta:
        rows.append({
            "clock": dict(m.clock), "actor_table": list(m.actor_table),
            "index_rows": tuple(np.array(a) for a in m.index.rows()),
            "n_elems": int(m.n_elems), "seg_bound": int(m.seg_bound),
            "all_ascii": bool(m.all_ascii), "all_deps": dict(m.all_deps),
            "mirror": _mirror_arrays(m.mirror)})
    return {
        "obj_ids": list(ds.obj_ids),
        "cap": int(ds._cap),
        "tables": {k: _np(v) for k, v in ds._ensure_dev().items()},
        "rows": rows,
        "overlay": {d: host_state(doc) for d, doc in ds._overlay.items()},
    }


def load_doc_set_state(port_ds, state: dict):
    """Install `doc_set_state(...)` output into a DeviceTextDocSet of this
    package (same obj_ids); returns the set."""
    from .engine.text_doc import DeviceTextDoc
    if list(port_ds.obj_ids) != state["obj_ids"]:
        raise ValueError("doc-set state is for other documents")
    port_ds._dev = tables_from_numpy(state["tables"], port_ds.device)
    port_ds._cap = state["cap"]
    for m, r in zip(port_ds._meta, state["rows"]):
        m.clock = dict(r["clock"])
        m.actor_table = list(r["actor_table"])
        m.actor_rank = {a: i for i, a in enumerate(m.actor_table)}
        m.index = BatchRangeIndex.from_rows(*r["index_rows"])
        m.n_elems = r["n_elems"]
        m.seg_bound = r["seg_bound"]
        m.all_ascii = r["all_ascii"]
        m.all_deps = dict(r["all_deps"])
        m.mirror = _mirror_from(r["mirror"])
    port_ds._overlay = {}
    for d, st in state["overlay"].items():
        doc = DeviceTextDoc(port_ds.obj_ids[d], capacity=st["cap"],
                            device=port_ds.device)
        port_ds._overlay[d] = load_text_doc_state(doc, st)
    port_ds._codes_cache = None
    return port_ds


#: host bookkeeping of a backend core, carried as plain values (one deep
#: copy, so `history` and `states` keep sharing their change dicts)
_CORE_FIELDS = ("states", "history", "queue", "clock", "deps", "undo_pos",
                "undo_stack", "redo_stack", "obj_order", "commands",
                "actor_rank")


def _carry_text_obj(src, dst):
    load_text_doc_state(dst.doc, host_state(src.doc))
    dst.max_elem = int(src.max_elem)
    dst.prev_n = int(src.prev_n)
    dst.prev_vis = np.array(src.prev_vis, bool)
    dst.prev_value = np.array(src.prev_value, np.int32)
    dst.prev_conf = copy.deepcopy(src.prev_conf)
    dst.announced = bool(src.announced)
    dst._pool_scan = tuple(src._pool_scan)


def _carry_map_obj(src, dst):
    load_map_doc_state(dst.doc, map_state(src.doc))
    dst.max_elem = int(src.max_elem)
    dst.prev = copy.deepcopy(src.prev)
    dst.announced = bool(src.announced)


def backend_state_from_jax(jax_state, device):
    """This package's backend state for a JAX backend state, on `device`.

    A `DeviceBackendState` carries its core at the state's version (a
    stale state's fork): pending write-behind rounds are flushed into the
    JAX engines first, as any read does, then every object's tables go
    through `load_text_doc_state` / `load_map_doc_state` and the host
    bookkeeping (clock, deps, history, queue, undo and redo stacks, the
    delivery log, the diff snapshots) is copied. A graduated (oracle)
    state is carried by replaying its command log into this package's
    oracle. Both lineages then take the same further changes alike."""
    from .backend import device as _device
    from .backend import facade as _facade
    from .backend.op_set import OpSetIndex
    if not hasattr(jax_state, "_core"):
        version = jax_state._version
        log = OpSetIndex()
        log.commands = copy.deepcopy(
            list(jax_state._index.commands[:version]))
        return _facade.BackendState(log.fork(version), version)
    src = jax_state.read_core()
    src.flush_pending()
    core = _device._DeviceCore(device)
    for name, value in copy.deepcopy(
            {k: getattr(src, k) for k in _CORE_FIELDS}).items():
        setattr(core, name, value)
    _carry_map_obj(src.root, core.root)
    for oid in core.obj_order:
        w = src.objects[oid]
        if hasattr(w, "prev_n"):
            dst = _device._TextObj(oid, w.kind, core.device,
                                   capacity_hint=int(w.doc._cap))
            _carry_text_obj(w, dst)
        else:
            dst = _device._MapObj(oid, w.kind, core.device,
                                  capacity_hint=int(w.doc._cap))
            _carry_map_obj(w, dst)
        core.objects[oid] = dst
    return _device.DeviceBackendState(core, jax_state._version)
