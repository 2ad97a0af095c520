"""The port's DeviceTextDoc (automerge_tpu_torch, device="cpu") against the
JAX package's DeviceTextDoc, as a whole.

The same streams go through both engines: a cfg5-shaped bulk merge at a
small size (4,096-char base, 64 actors x 64 ops) and random edit histories
with deletes, overwrites and conflicts through `apply_changes`. Text,
scalars, element counts, conflicts, the live prefix of every element
table and the device-interaction counts must be equal; the tolerance is
zero. The import-hygiene test pins that the port never loads JAX or the
JAX package."""

import logging
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import automerge_tpu as am
import bench as B
from automerge_tpu import Text
from automerge_tpu.engine import DeviceTextDoc as JDoc
from automerge_tpu_torch.engine import DeviceTextDoc as TDoc
from automerge_tpu_torch.engine import TextChangeBatch as TBatch
from automerge_tpu_torch.state import host_state, load_text_doc_state

from test_engine_parity import text_changes_of

KEYS = JDoc._TABLE_KEYS


def as_port(batch):
    return TBatch(**{k: getattr(batch, k)
                     for k in batch.__dataclass_fields__})


def assert_docs_equal(jdoc, tdoc):
    assert tdoc.text() == jdoc.text()
    np.testing.assert_array_equal(tdoc._scalars(), jdoc._scalars())
    assert tdoc.n_elems == jdoc.n_elems
    assert tdoc.conflicts == jdoc.conflicts
    assert tdoc.value_pool == jdoc.value_pool
    live = jdoc.n_elems + 1
    for k in KEYS:
        a = np.asarray(jdoc._ensure_dev()[k])
        b = tdoc._ensure_dev()[k].numpy()
        assert b.dtype == a.dtype, k
        np.testing.assert_array_equal(b[:live], a[:live], err_msg=k)
    js, ts = jdoc.dispatch_stats, tdoc.dispatch_stats
    assert ts["syncs"] == js["syncs"]
    assert ts["dispatches"] == js["dispatches"]
    assert ts["last_commit"] == js["last_commit"]


@pytest.fixture
def no_heal(caplog):
    """A segment-mirror heal means the device hashes disagreed with the
    host mirror: it must never happen on these streams."""
    caplog.set_level(logging.WARNING, logger="automerge_tpu_torch.engine")
    yield
    healed = [r.getMessage() for r in caplog.records
              if "diverged" in r.getMessage()]
    assert not healed, healed


@pytest.mark.parametrize("planned", [True, False])
def test_cfg5_shaped_stream_matches_jax(planned, no_heal):
    base_n, n_actors, ops = 4096, 64, 64
    docs = []
    for cls, conv in ((JDoc, lambda b: b), (TDoc, as_port)):
        kw = {} if cls is JDoc else {"device": "cpu"}
        d = cls("bench-text", **kw)
        d.eager_materialize = True
        d.prefer_planned = planned
        d.apply_batch(conv(B.base_batch("bench-text", base_n)))
        base_text = d.text()
        p = d.prepare_batch(conv(B.merge_batch("bench-text", n_actors, ops,
                                               base_n)))
        d.commit_prepared(p)
        d._materialize(with_pos=False)
        n_vis = int(d._scalars()[0])
        assert n_vis == base_n + n_actors * ops // 2
        text = d.text()
        assert len(text) == n_vis
        docs.append((d, base_text, text, dict(d.pull_stats)))
    (jd, jb, jt, jpull), (td, tb, tt, tpull) = docs
    assert (tb, tt) == (jb, jt)
    assert tpull == jpull and tpull["mode"] == "incremental"
    assert_docs_equal(jd, td)


def random_history(seed, n_actors=None, rounds=5):
    rng = random.Random(9100 + seed)
    n_actors = n_actors or rng.randint(2, 4)
    base = am.change(am.init("base"),
                     lambda d: d.__setitem__("t", Text("seed text")))
    bc = am.get_all_changes(base)
    docs = [am.apply_changes(am.init(f"actor-{i}"), bc)
            for i in range(n_actors)]
    for _ in range(rounds):
        for i in range(n_actors):
            def edit(d):
                t = d["t"]
                for _ in range(rng.randrange(1, 5)):
                    r = rng.random()
                    if r < 0.5 or len(t) == 0:
                        t.insert_at(rng.randint(0, len(t)),
                                    rng.choice("abcxyz"))
                    elif r < 0.75:
                        t.delete_at(rng.randrange(len(t)))
                    else:
                        t.set(rng.randrange(len(t)), rng.choice("ABC"))
            if rng.random() < 0.85:
                docs[i] = am.change(docs[i], edit)
        i, j = rng.sample(range(n_actors), 2)
        docs[i] = am.merge(docs[i], docs[j])
    merged = docs[0]
    for d in docs[1:]:
        merged = am.merge(merged, d)
    return merged


@pytest.mark.parametrize("seed", range(8))
def test_random_histories_match_jax(seed, no_heal):
    merged = random_history(seed)
    changes, obj_id = text_changes_of(merged)
    jdoc = JDoc(obj_id)
    tdoc = TDoc(obj_id, device="cpu")
    # deliver in two windows so later rounds meet existing state
    half = len(changes) // 2
    for window in (changes[:half], changes[half:]):
        jdoc.apply_changes(window)
        tdoc.apply_changes(window)
    views = []
    for d in (jdoc, tdoc):      # the same read sequence on both engines
        text = d.text()
        ids = d.elem_ids()
        views.append((text, ids, [d.conflicts_at(i) for i in range(len(d))]))
    assert views[1] == views[0]
    assert views[1][0] == str(merged["t"])
    assert_docs_equal(jdoc, tdoc)


@pytest.mark.parametrize("seed", [0, 5])
def test_element_wise_linearization_matches(seed):
    """`use_condensed = False` runs the element-wise rga_linearize."""
    merged = random_history(seed)
    changes, obj_id = text_changes_of(merged)
    jdoc, tdoc = JDoc(obj_id), TDoc(obj_id, device="cpu")
    for d in (jdoc, tdoc):
        d.use_condensed = False
        d.apply_changes(changes)
    assert tdoc.text() == jdoc.text() == str(merged["t"])
    assert tdoc.elem_ids() == jdoc.elem_ids()


def test_incremental_pull_after_residual_rounds_matches_full():
    """Residual rounds (deletes, conflicting overwrites, concurrent
    inserts) then the incremental pull: equal to a full re-pull and to
    the JAX engine."""
    n = 6000
    docs = []
    for cls, conv in ((JDoc, lambda b: b), (TDoc, as_port)):
        kw = {} if cls is JDoc else {"device": "cpu"}
        d = cls("t", **kw)
        d.eager_materialize = True
        d.incremental_pull_min = 64
        d.apply_batch(conv(B.base_batch("t", n)))
        d.text()
        d.apply_batch(conv(B.merge_batch("t", 6, 20, n, seed=3)))
        d.text()
        changes = [
            {"actor": "zdel", "seq": 1, "deps": {"base": 1}, "ops": [
                {"action": "del", "obj": "t", "key": f"base:{t}"}
                for t in (5, 6, 700, 5999)]},
            {"actor": "zset-0", "seq": 1, "deps": {"base": 1}, "ops": [
                {"action": "set", "obj": "t", "key": "base:42",
                 "value": "P"}]},
            {"actor": "zset-1", "seq": 1, "deps": {"base": 1}, "ops": [
                {"action": "set", "obj": "t", "key": "base:42",
                 "value": "Q"}]},
            {"actor": "zins-0", "seq": 1, "deps": {"base": 1}, "ops": [
                {"action": "ins", "obj": "t", "key": "base:9",
                 "elem": 9000}]},
            {"actor": "zins-1", "seq": 1, "deps": {"base": 1}, "ops": [
                {"action": "ins", "obj": "t", "key": "base:9",
                 "elem": 9000}]},
        ]
        d.apply_changes(changes)
        d.apply_changes([{"actor": f"zins-{k}", "seq": 2,
                          "deps": {f"zins-{k}": 1}, "ops": [
                              {"action": "set", "obj": "t",
                               "key": f"zins-{k}:9000", "value": "XY"[k]}]}
                         for k in range(2)])
        inc = d.text()
        mode = d.pull_stats["mode"]
        d._text_cache = None
        full = d.text()
        docs.append((d, inc, mode, full))
    (jd, ji, jm, jf), (td, ti, tm, tf) = docs
    assert tm == jm == "incremental"
    assert ti == tf == ji == jf
    assert td.conflicts and td.conflicts == jd.conflicts
    assert_docs_equal(jd, td)


def test_state_carried_from_jax_continues_identically(no_heal):
    """`load_text_doc_state` starts the port from a JAX document's state;
    the next batch then lands identically in both."""
    jdoc = JDoc("t")
    jdoc.eager_materialize = True
    jdoc.apply_batch(B.base_batch("t", 3000))
    jdoc.apply_batch(B.merge_batch("t", 5, 30, 3000, seed=1))
    tdoc = load_text_doc_state(TDoc("t", device="cpu"), host_state(jdoc))
    tdoc.eager_materialize = True
    assert tdoc.text() == jdoc.text()
    nxt = B.merge_batch("t", 7, 24, 3000, seed=2, actor_prefix="late")
    jdoc.apply_batch(nxt)
    tdoc.apply_batch(as_port(nxt))
    assert tdoc.text() == jdoc.text()
    np.testing.assert_array_equal(tdoc._scalars(), jdoc._scalars())


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDoc("t")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDoc("t", device="cuda")
    assert TDoc("t", device="cpu").device.type == "cpu"


def test_tables_live_on_the_requested_device():
    d = TDoc("t", device="cpu")
    d.apply_batch(as_port(B.base_batch("t", 300)))
    assert all(t.device.type == "cpu" for t in d._dev.values())
    assert d.device_footprint()["table_bytes"] == sum(
        t.numel() * t.element_size() for t in d._dev.values())


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import automerge_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'automerge_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'automerge_tpu'\n"
        "             or m.startswith('automerge_tpu.'))\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('automerge_tpu_torch')]))\n"
        "assert not bad, bad\n")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20      # every module was imported


def test_prepare_and_commit_spans_are_recorded():
    """The engine's spans (what bench-style metrics read: prepare_batch,
    commit/batch, pull/text) reach the port's trace ring."""
    from automerge_tpu_torch import obs
    d = TDoc("t", device="cpu")
    d.eager_materialize = True
    d.apply_batch(as_port(B.base_batch("t", 2000)))
    with obs.tracing():
        t0 = obs.now()
        d.commit_prepared(d.prepare_batch(as_port(
            B.merge_batch("t", 4, 20, 2000))))
        d.text()
        recs = obs.snapshot(since_ns=t0)
    for cat, name in (("plan", "prepare_batch"), ("commit", "batch"),
                      ("pull", "text")):
        assert obs.span_seconds(recs, cat, name) > 0, (cat, name)
    assert d.dispatch_stats["last_commit"]["syncs"] == 0
