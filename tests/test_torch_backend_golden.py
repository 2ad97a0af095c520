"""The port's `backend` package names the oracle facade, as the JAX
package's does (`automerge_tpu_torch.backend.Backend is
automerge_tpu_torch.backend.facade.Backend`).

- Every golden change->patch fixture of tests/test_backend.py (the
  reference's backend_test.js) runs through the port's `backend` and
  through the JAX package's `backend`: each fixture's own assertions hold
  on both, and every patch, change list and missing-deps map either
  returns is equal between them (zero tolerance).
- The oracle pin of tests/test_linearize.py (`{"backend":
  backend.Backend}`): documents built on the port's `backend.Backend`
  live on the oracle facade, whose RGA order (`read_index`) the port's
  `rga_linearize` reproduces and which equals the JAX package's order.
"""

import inspect
import itertools
import random

import numpy as np
import pytest
import torch

import automerge_tpu as J
import automerge_tpu_torch as T
import test_backend as golden
from automerge_tpu import _uuid as j_uuid
from automerge_tpu import backend as j_backend
from automerge_tpu_torch import _uuid as t_uuid
from automerge_tpu_torch import backend as t_backend


def _fixtures():
    out = {}
    for name, obj in vars(golden).items():
        if name.startswith("test_") and inspect.isfunction(obj):
            out[name] = obj
        elif name.startswith("Test") and inspect.isclass(obj):
            for meth in sorted(vars(obj)):
                if meth.startswith("test_"):
                    out[f"{name}.{meth}"] = (obj, meth)
    return out


FIXTURES = _fixtures()


class Recording:
    """A backend namespace that records what each call returns, except
    the states themselves: patches, change lists, missing deps."""

    def __init__(self, ns):
        self._ns = ns
        self.seen = []

    def __getattr__(self, name):
        fn = getattr(self._ns, name)
        if not callable(fn):
            return fn

        def call(*a, **k):
            out = fn(*a, **k)
            if isinstance(out, tuple) and len(out) == 2:
                self.seen.append((name, out[1]))
            elif isinstance(out, (dict, list)):
                self.seen.append((name, out))
            return out
        return call


def _run(fixture, ns, monkeypatch) -> list:
    rec = Recording(ns)
    monkeypatch.setattr(golden, "Backend", rec)
    if isinstance(fixture, tuple):
        cls, meth = fixture
        getattr(cls(), meth)()
    else:
        fixture()
    return rec.seen


def test_backend_names_the_oracle_facade():
    assert t_backend.Backend is t_backend.facade.Backend
    assert T.Backend is t_backend.facade.Backend
    assert t_backend.init is t_backend.facade.init
    # the API binds the device backend; backend_for names it elsewhere
    assert t_backend.default.Backend is t_backend.DeviceBackend
    assert t_backend.backend_for(None) is t_backend.DeviceBackend
    assert t_backend.backend_for("cpu").device == "cpu"
    assert isinstance(t_backend.init(), t_backend.BackendState)
    assert type(j_backend.init()).__name__ == type(t_backend.init()).__name__


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_golden_fixture_patches_equal_jax_package(name, monkeypatch):
    fixture = FIXTURES[name]
    want = _run(fixture, j_backend, monkeypatch)
    got = _run(fixture, t_backend, monkeypatch)
    assert want, "the fixture returned nothing to compare"
    assert got == want


# --------------------------------------------------------------------------
# the oracle pin of tests/test_linearize.py
# --------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def pinned_uuids():
    for m in (j_uuid, t_uuid):
        c = itertools.count(1)
        m.set_factory(lambda c=c: f"00000000-0000-0000-0000-{next(c):012d}")
    yield
    j_uuid.reset()
    t_uuid.reset()


def oracle_init(am, actor):
    """`init` pinned to the package's ORACLE backend (tests/test_linearize
    .py's view): the docs' states are the facade's, with `read_index`."""
    return am.frontend.init({"actorId": actor,
                             "backend": am.backend.Backend})


def random_history(am, seed, n_actors=3, n_rounds=5, edits_per_round=4):
    rng = random.Random(seed)
    base = am.change(oracle_init(am, "base"),
                     lambda d: d.__setitem__("xs", ["s0", "s1"]))
    base_changes = am.get_all_changes(base)
    docs = [am.apply_changes(oracle_init(am, f"actor-{i}"), base_changes)
            for i in range(n_actors)]
    for _ in range(n_rounds):
        for i, doc in enumerate(docs):
            def edit(d):
                for _ in range(rng.randrange(1, edits_per_round + 1)):
                    xs = d["xs"]
                    if len(xs) and rng.random() < 0.25:
                        xs.delete_at(rng.randrange(len(xs)))
                    else:
                        xs.insert(rng.randint(0, len(xs)),
                                  f"a{i}-{rng.randrange(1000)}")
            docs[i] = am.change(doc, edit)
        i, j = rng.sample(range(n_actors), 2)
        docs[i] = am.merge(docs[i], docs[j])
    merged = docs[0]
    for d in docs[1:]:
        merged = am.merge(merged, d)
    return merged


def oracle_order(am, doc, key):
    state = am.frontend.get_backend_state(doc)
    index = state.read_index()
    obj_id = doc[key]._object_id
    order, elem = [], "_head"
    while True:
        elem = index.get_next(obj_id, elem)
        if elem is None:
            return order, index, obj_id
        order.append(elem)


def port_device_order(index, obj_id):
    """The port's rga_linearize over the oracle's element table."""
    from automerge_tpu_torch._common import parse_elem_id
    from automerge_tpu_torch.ops.linearize import pad_capacity, rga_linearize
    rec = index.by_object[obj_id]
    elem_ids = list(rec.insertion.keys())
    actors = sorted({parse_elem_id(e)[0] for e in elem_ids})
    rank = {a: i for i, a in enumerate(actors)}
    slot = {e: i + 1 for i, e in enumerate(elem_ids)}
    cap = pad_capacity(1 + len(elem_ids))
    parent = np.zeros(cap, np.int32)
    ctr = np.zeros(cap, np.int32)
    actor = np.zeros(cap, np.int32)
    valid = np.zeros(cap, bool)
    valid[0] = True
    for e, i in slot.items():
        op = rec.insertion[e]
        a, c = parse_elem_id(e)
        parent[i] = 0 if op["key"] == "_head" else slot[op["key"]]
        ctr[i], actor[i], valid[i] = c, rank[a], True
    pos = rga_linearize(*(torch.from_numpy(x)
                          for x in (parent, ctr, actor, valid))).numpy()
    order = [None] * len(elem_ids)
    for i, e in enumerate(elem_ids):
        order[int(pos[i + 1])] = e
    return order


@pytest.mark.parametrize("seed", range(4))
def test_oracle_pinned_docs_linearize_like_the_jax_package(seed):
    jdoc, tdoc = random_history(J, seed), random_history(T, seed)
    assert isinstance(T.frontend.get_backend_state(tdoc),
                      t_backend.facade.BackendState)
    want, _, _ = oracle_order(J, jdoc, "xs")
    got, index, obj_id = oracle_order(T, tdoc, "xs")
    assert got == want
    assert port_device_order(index, obj_id) == got
    assert T.to_json(tdoc) == J.to_json(jdoc)
    assert T.save(tdoc) == J.save(jdoc)
