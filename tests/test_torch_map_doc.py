"""The port's DeviceMapDoc (automerge_tpu_torch, device="cpu") against the
JAX package's DeviceMapDoc and the oracle.

tests/test_map_engine.py's scenarios and seeded random histories go
through both engines: `to_dict`, `conflicts_for` of every key, `len`, the
register tables, the value pool and the device-interaction counts must be
equal (zero tolerance), and equal to the oracle's document."""

import random

import numpy as np
import pytest

import automerge_tpu as am
from automerge_tpu import Counter
from automerge_tpu._common import ROOT_ID
from automerge_tpu.engine import DeviceMapDoc as JMap
from automerge_tpu_torch.engine import DeviceMapDoc as TMap
from automerge_tpu_torch.ops import ingest as I

from test_map_engine import root_map_changes

REG = ("value", "has_value", "win_actor", "win_seq", "win_counter")


def oracle_view(doc):
    return {k: (v.value if isinstance(v, Counter) else v)
            for k, v in am.to_json(doc).items()
            if not isinstance(v, (dict, list))}


def both(windows, donate=False):
    """The same change windows through both engines."""
    jdoc, tdoc = JMap(ROOT_ID), TMap(ROOT_ID, device="cpu")
    tdoc.donate_buffers = donate
    for w in windows:
        jdoc.apply_changes(w)
        tdoc.apply_changes(w)
    return jdoc, tdoc


def assert_maps_equal(jdoc, tdoc):
    assert tdoc.to_dict() == jdoc.to_dict()
    assert len(tdoc) == len(jdoc)
    assert tdoc.key_table == jdoc.key_table
    assert tdoc.actor_table == jdoc.actor_table
    for key in jdoc.key_table:
        assert tdoc.conflicts_for(key) == jdoc.conflicts_for(key), key
        assert (key in tdoc) == (key in jdoc)
    assert tdoc.conflicts == jdoc.conflicts
    assert tdoc.value_pool == jdoc.value_pool
    n = len(jdoc.key_table)
    jd, td = jdoc._ensure_dev(), tdoc._ensure_dev()
    for k in REG:
        a, b = np.asarray(jd[k]), td[k].numpy()
        assert b.dtype == a.dtype, k
        np.testing.assert_array_equal(b[:n], a[:n], err_msg=k)
    js, ts = jdoc.dispatch_stats, tdoc.dispatch_stats
    for k in ("dispatches", "syncs", "h2d_bytes", "d2h_bytes"):
        assert ts[k] == js[k], k


def scenario(name):
    """tests/test_map_engine.py's scenarios as oracle documents."""
    if name == "simple_sets":
        d = am.change(am.init("a1"),
                      lambda d: d.update({"x": 1, "y": "str", "z": 3}))
        return am.change(d, lambda d: d.__setitem__("x", 10))
    if name == "delete":
        d = am.change(am.init("a1"), lambda d: d.update({"x": 1, "y": 2}))
        return am.change(d, lambda d: d.__delitem__("x"))
    if name == "lww_conflict":
        a = am.change(am.init("actor-1"), lambda d: d.__setitem__("k", "low"))
        b = am.change(am.init("actor-2"),
                      lambda d: d.__setitem__("k", "high"))
        return am.merge(a, b)
    if name == "resolved_by_later_write":
        a = am.change(am.init("actor-1"), lambda d: d.__setitem__("k", 1))
        b = am.change(am.init("actor-2"), lambda d: d.__setitem__("k", 2))
        return am.change(am.merge(a, b), lambda d: d.__setitem__("k", 3))
    if name == "counter_merge":
        a = am.change(am.init("actor-1"),
                      lambda d: d.__setitem__("n", Counter(5)))
        b = am.merge(am.init("actor-2"), a)
        a2 = am.change(a, lambda d: d["n"].increment(3))
        b2 = am.change(b, lambda d: d["n"].increment(4))
        return am.merge(a2, b2)
    if name == "set_vs_delete":
        base = am.change(am.init("actor-1"), lambda d: d.__setitem__("k", "v"))
        other = am.merge(am.init("actor-2"), base)
        deleted = am.change(base, lambda d: d.__delitem__("k"))
        updated = am.change(other, lambda d: d.__setitem__("k", "w"))
        return am.merge(deleted, updated)
    raise KeyError(name)


SCENARIOS = ["simple_sets", "delete", "lww_conflict",
             "resolved_by_later_write", "counter_merge", "set_vs_delete"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenarios_match_jax_and_oracle(name):
    doc = scenario(name)
    jdoc, tdoc = both([root_map_changes(doc)])
    assert_maps_equal(jdoc, tdoc)
    assert tdoc.to_dict() == oracle_view(doc)


def test_out_of_order_queues():
    a1 = am.change(am.init("actor-1"), lambda d: d.__setitem__("x", 1))
    a2 = am.change(a1, lambda d: d.__setitem__("y", 2))
    changes = root_map_changes(a2)
    jdoc, tdoc = both([[changes[1]]])
    assert tdoc.to_dict() == jdoc.to_dict() == {}
    assert len(tdoc.queue) == len(jdoc.queue) == 1
    jdoc.apply_changes([changes[0]])
    tdoc.apply_changes([changes[0]])
    assert tdoc.to_dict() == {"x": 1, "y": 2}
    assert_maps_equal(jdoc, tdoc)


def test_duplicates_are_idempotent():
    d = am.change(am.init("a1"), lambda d: d.__setitem__("x", 1))
    changes = root_map_changes(d)
    jdoc, tdoc = both([changes, changes])
    assert tdoc.to_dict() == {"x": 1}
    assert_maps_equal(jdoc, tdoc)


def random_history(seed):
    """tests/test_map_engine.py's random multi-actor map/counter
    session."""
    rng = random.Random(seed)
    keys = [f"k{i}" for i in range(6)]
    docs = [am.init(f"actor-{i}") for i in range(3)]
    for step in range(rng.randint(8, 20)):
        i = rng.randrange(len(docs))
        op = rng.random()
        key = rng.choice(keys)
        if op < 0.45:
            if isinstance(docs[i].get(key), Counter):
                continue
            val = rng.choice([rng.randint(0, 1000), f"s{step}",
                              rng.random() < 0.5, -rng.randint(1, 9)])
            docs[i] = am.change(docs[i], lambda d, k=key, v=val:
                                d.__setitem__(k, v))
        elif op < 0.6:
            if am.to_json(docs[i]).get(key) is not None:
                docs[i] = am.change(docs[i], lambda d, k=key:
                                    d.__delitem__(k))
        elif op < 0.75:
            cur = docs[i]
            if isinstance(cur.get(key), Counter):
                docs[i] = am.change(cur, lambda d, k=key:
                                    d[k].increment(rng.randint(-5, 5)))
            else:
                docs[i] = am.change(
                    cur, lambda d, k=key:
                    d.__setitem__(k, Counter(rng.randint(0, 50))))
        else:
            j = rng.randrange(len(docs))
            if i != j:
                docs[i] = am.merge(docs[i], docs[j])
    final = docs[0]
    for j in range(1, len(docs)):
        final = am.merge(final, docs[j])
    return final


@pytest.mark.parametrize("seed", range(8))
def test_random_histories_match_jax_and_oracle(seed):
    doc = random_history(seed)
    changes = root_map_changes(doc)
    half = len(changes) // 2
    # two windows, so later rounds meet existing registers
    jdoc, tdoc = both([changes[:half], changes[half:]], donate=seed % 2 == 1)
    assert_maps_equal(jdoc, tdoc)
    assert tdoc.to_dict() == oracle_view(doc)


def test_remap_matches_jax():
    """An actor sorting before the table re-ranks the winner column."""
    def sets(actor, vals, deps=None):
        return {"actor": actor, "seq": 1, "deps": deps or {}, "ops": [
            {"action": "set", "obj": ROOT_ID, "key": k, "value": v}
            for k, v in vals.items()]}
    jdoc, tdoc = both([[sets("mm", {"a": 1, "b": 2})],
                       [sets("zz", {"c": 3})],
                       [sets("aa", {"a": 7, "d": 4}, deps={"mm": 1})]])
    assert tdoc.actor_table == ["aa", "mm", "zz"]
    assert tdoc._acct["dispatches"] == jdoc._acct["dispatches"]
    assert_maps_equal(jdoc, tdoc)
    assert tdoc.to_dict() == {"a": 7, "b": 2, "c": 3, "d": 4}


def test_map_round_op_matches_jax():
    """`apply_map_round` against the JAX round on seeded inputs, with a
    capacity extension."""
    from automerge_tpu.ops import ingest as JI
    rng = np.random.default_rng(3)
    K, out_cap, M = 256, 384, 128
    regs = (rng.integers(0, 50, K, dtype=np.int32), rng.random(K) < 0.5,
            rng.integers(-1, 4, K, dtype=np.int32),
            rng.integers(0, 5, K, dtype=np.int32), rng.random(K) < 0.1)
    ops = (rng.integers(-1, 4, M).astype(np.int8),
           rng.integers(0, out_cap + 1, M, dtype=np.int32),
           rng.integers(-3, 90, M, dtype=np.int32),
           rng.integers(0, 5, M, dtype=np.int32),
           rng.integers(1, 6, M, dtype=np.int32))
    conflicts = np.array([3, 7, out_cap, out_cap], np.int32)
    import jax.numpy as jnp
    import torch
    want = JI.apply_map_round(*map(jnp.asarray, regs + ops),
                              jnp.asarray(conflicts), out_cap=out_cap)
    got = I.apply_map_round(*map(torch.from_numpy, regs + ops),
                            torch.from_numpy(conflicts), out_cap=out_cap)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_default_device_raises_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMap(ROOT_ID)
