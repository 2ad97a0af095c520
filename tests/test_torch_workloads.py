"""The JAX package's benchmark workloads (benchmarks/run_all.py) through
both packages at small sizes, on the CPU.

`chip_smoke.py` phase 18 drives cfg5b, cfg5c, cfg6, cfg2, cfg10 and cfg7b
through the port on the card at their sources' sizes, from copies of the
run_all.py generators. Here the same generators run at small sizes
through the JAX package and the port (`device="cpu"`), and the results
must be equal: texts, scalars, element tables, conflicts, maps, planned
rounds, `save()` strings and `to_json`; the tolerance is zero. The copies
are held to run_all.py's own generators, captured by stand-ins for the
engine classes. cfg1 (two actors through the API) and cfg8's splice A/B
(host-only) complete every run_all.py configuration that does not A/B an
environment switch the port left out."""

import itertools
import json

import numpy as np
import pytest
import torch

import automerge_tpu as J
import automerge_tpu.engine as JE
import automerge_tpu_torch as T
import bench as B
import chip_smoke as cs
from automerge_tpu import _common as JC
from automerge_tpu import _uuid as j_uuid
from automerge_tpu.engine import DeviceMapDoc as JMap
from automerge_tpu.engine import DeviceTextDoc as JDoc
from automerge_tpu.engine import MapChangeBatch as JMapBatch
from automerge_tpu.engine import TextChangeBatch as JBatch
from automerge_tpu_torch import _uuid as t_uuid

from test_torch_ingest import check_live_scatters
from test_torch_text_doc import assert_docs_equal

M = cs.port_modules()
CPU = T.backend.backend_for("cpu")


def pin():
    for m in (j_uuid, t_uuid):
        c = itertools.count(1)
        m.set_factory(lambda c=c: f"00000000-0000-0000-0000-{next(c):012d}")


@pytest.fixture(autouse=True)
def uuid_factories():
    """Both packages' uuid factories pinned; teardown leaves both at their
    defaults."""
    pin()
    yield
    j_uuid.reset()
    t_uuid.reset()


@pytest.fixture(autouse=True)
def jax_full_pull(monkeypatch):
    """The port has one pull: a full one. The JAX reference takes the
    same, so the pull's dispatch and sync counts compare exactly."""
    monkeypatch.setattr(JDoc, "incremental_pull", False)


def j_opts(actor):
    return actor


def t_opts(actor):
    return {"actorId": actor, "backend": CPU}


# ---------------------------------------------------- the run_all.py sources

class _Built(Exception):
    """Raised by a stand-in engine class once a config handed it its
    inputs."""


@pytest.fixture(scope="module")
def run_all():
    """benchmarks/run_all.py, imported without its JAX compile cache (a
    process-wide setting other test files must not inherit)."""
    import benchmarks.common as BC
    real = BC.setup_jax_cache
    BC.setup_jax_cache = lambda: None
    try:
        import benchmarks.run_all as R
    finally:
        BC.setup_jax_cache = real
    return R


def built_by(monkeypatch, config, **kw) -> dict:
    """What a run_all.py config builds before it first touches the
    engine: a batch it constructs (`batch`), the changes it hands
    `from_changes` (`changes`) and the base change it applies (`base`)."""
    got = {}

    def stand_in(real):
        class Batch:
            def __new__(cls, **fields):
                got["batch"] = real(**fields)
                raise _Built

            @staticmethod
            def from_changes(changes, obj_id):
                got["changes"] = changes
                return real.from_changes(changes, obj_id)
        return Batch

    class Doc:
        def __init__(self, *a, **k):
            pass

        def apply_changes(self, changes):
            got["base"] = changes[0]
            raise _Built

    monkeypatch.setattr(JE, "TextChangeBatch", stand_in(JBatch))
    monkeypatch.setattr(JE, "MapChangeBatch", stand_in(JMapBatch))
    monkeypatch.setattr(JE, "DeviceTextDoc", Doc)
    monkeypatch.setattr(JE, "DeviceMapDoc", Doc)
    with pytest.raises(_Built):
        config(**kw)
    return got


def assert_batches_equal(a, b):
    for k in a.__dataclass_fields__:
        x, y = getattr(a, k), getattr(b, k)
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype, k
            np.testing.assert_array_equal(np.asarray(y), x, err_msg=k)
        else:
            assert y == x, k


def test_generator_copies_equal_run_all(run_all, monkeypatch):
    """chip_smoke.py's copies of the generators build what run_all.py
    builds, field for field."""
    got = built_by(monkeypatch, run_all.config5b_residual_heavy, n_actors=40)
    mine, base_n, vis = cs.residual_heavy_batch(JBatch, JC, 40)
    assert (base_n, vis) == (4000, 4000 - 40 * 100 + 40 * 400)
    assert_batches_equal(got["batch"], mine)
    got = built_by(monkeypatch, run_all.config5c_two_causal_rounds,
                   n_actors=40)
    assert_batches_equal(got["batch"],
                         cs.two_round_batch(JBatch, JC, 40, 1_000_000))
    got = built_by(monkeypatch, run_all.config6_conflict_heavy,
                   n_actors=20, n_targets=50)
    assert (got["base"], got["changes"]) == cs.conflict_changes(20, 50)
    got = built_by(monkeypatch, run_all.config2_map_counter, n_actors=10,
                   n_keys=10)
    assert (got["base"], got["changes"]) == cs.counter_changes(10, 10)


# ------------------------------------------------------ engine workloads

def jax_merge_once(batch, base_n: int):
    """run_all.py merge_once's steps on the JAX package."""
    doc = JDoc("t")
    doc.eager_materialize = True
    doc.apply_batch(B.base_batch("t", base_n))
    doc.text()
    prepared = doc.prepare_batch(batch)
    rounds = len(prepared.rounds)
    doc.commit_prepared(prepared)
    doc._materialize(with_pos=False)
    return doc, rounds, int(doc._scalars()[0])


@pytest.mark.parametrize("n_actors", [40, 60])
def test_cfg5b_residual_heavy_matches_jax(n_actors):
    jbatch, base_n, vis = cs.residual_heavy_batch(JBatch, JC, n_actors)
    jdoc, j_rounds, j_vis = jax_merge_once(jbatch, base_n)
    tbatch, _, _ = cs.residual_heavy_batch(M.TB, M.C, n_actors)
    run = cs.adv_commit(torch, M, "cpu", tbatch, base_n)
    tdoc = run["doc"]
    assert run["rounds"] == j_rounds == 1
    assert run["n_vis"] == j_vis == vis
    assert run["mixed_rounds"] == 1 and run["slow_fetches"] == 1
    assert_docs_equal(jdoc, tdoc)
    assert tdoc.text() == cs.residual_heavy_text(n_actors)


@pytest.mark.parametrize("n_actors,base_n", [(40, 4000), (25, 3000)])
def test_cfg5c_two_causal_rounds_match_jax(n_actors, base_n):
    jdoc, j_rounds, j_vis = jax_merge_once(
        cs.two_round_batch(JBatch, JC, n_actors, base_n), base_n)
    tbatch = cs.two_round_batch(M.TB, M.C, n_actors, base_n)
    run = cs.adv_commit(torch, M, "cpu", tbatch, base_n)
    assert run["rounds"] == j_rounds == 2
    assert run["n_vis"] == j_vis == base_n + len(tbatch.op_kind) // 2
    assert_docs_equal(jdoc, run["doc"])
    assert run["doc"].text() == cs.two_round_text(n_actors, base_n)


@pytest.mark.parametrize("n_actors,n_targets", [(20, 50), (7, 30)])
def test_cfg6_conflict_heavy_matches_jax(monkeypatch, n_actors, n_targets):
    """Multi-writer registers through the host slow path; every scatter
    of the port's rounds writes each live index once (the property that
    keeps CUDA's unordered scatter deterministic)."""
    base, changes = cs.conflict_changes(n_actors, n_targets)
    jdoc = JDoc("t")
    jdoc.apply_changes([base])
    jdoc.apply_batch(JBatch.from_changes(changes, "t"))
    seen = check_live_scatters(monkeypatch)
    tdoc, text, _ = cs.conflict_run(torch, M, "cpu", base,
                                    M.TB.from_changes(changes, "t"))
    assert seen and max(seen) > 0
    assert text == jdoc.text()
    assert tdoc.conflicts and tdoc.conflicts == jdoc.conflicts
    assert_docs_equal(jdoc, tdoc)


@pytest.mark.parametrize("n_actors,n_keys", [(10, 10), (16, 3)])
def test_cfg2_map_counter_matches_jax(n_actors, n_keys):
    base, changes = cs.counter_changes(n_actors, n_keys)
    jdoc = JMap("m")
    jdoc.apply_changes([base])
    jdoc.apply_batch(JMapBatch.from_changes(changes, "m"))
    tdoc, _ = cs.counter_run(torch, M, "cpu", base,
                             M.MapChangeBatch.from_changes(changes, "m"))
    assert tdoc.get("count") == jdoc.get("count") == n_actors
    assert len(tdoc) == len(jdoc) == n_actors * n_keys + 1
    assert tdoc.to_dict() == jdoc.to_dict()
    assert tdoc.conflicts == jdoc.conflicts


# --------------------------------------------------------- API workloads

@pytest.mark.parametrize("n_changes,run_chars", [(5, 50), (3, 8)])
def test_cfg10_save_load_matches_jax(n_changes, run_chars):
    pin()
    want = cs.save_load_session(J, j_opts, n_changes, run_chars, 2)
    pin()
    got = cs.save_load_session(T, t_opts, n_changes, run_chars, 2)
    assert got["blob"] == want["blob"]
    assert got["json"] == want["json"]
    assert got["text"] == got["saved_text"] == want["text"]
    assert len(got["text"]) == 1 + n_changes * run_chars


@pytest.mark.parametrize("n_root,n_changes", [(400, 10), (40, 6)])
def test_cfg7b_nested_edits_match_jax(n_root, n_changes):
    pin()
    want = cs.nested_session(J, j_opts, n_root, n_changes)
    pin()
    got = cs.nested_session(T, t_opts, n_root, n_changes)
    assert got["json"] == want["json"]
    assert got["title"] == want["title"] == f"v{n_changes - 1}"
    assert len(json.loads(got["json"])) == n_root + 1


def cfg1_session(am, opts, n_chars: int):
    """run_all.py config1_text_two_actor (:30-45): two actors insert
    concurrently into one Text and merge both ways."""
    a = am.change(am.init(opts("actor-a")),
                  lambda d: d.__setitem__("t", am.Text("x" * 10)))
    b = am.merge(am.init(opts("actor-b")), a)
    half = n_chars // 2
    a2 = am.change(a, lambda d: d["t"].insert_at(5, *("a" * half)))
    b2 = am.change(b, lambda d: d["t"].insert_at(5, *("b" * half)))
    m1 = am.merge(a2, b2)
    m2 = am.merge(b2, a2)
    return str(m1["t"]), str(m2["t"]), am.save(m1), am.save(m2)


@pytest.mark.parametrize("n_chars", [100, 30])
def test_cfg1_two_actors_match_jax(n_chars):
    pin()
    want = cfg1_session(J, j_opts, n_chars)
    pin()
    got = cfg1_session(T, t_opts, n_chars)
    assert got == want
    assert got[0] == got[1] and len(got[0]) == 10 + n_chars


def splice_elem_ids(P, n_base: int, n_ins: int, splice: bool) -> list:
    """run_all.py config8_frontend_splice's apply_once (:1540-1548) on
    package P: a mid-document insert patch applied element-wise or
    splice-batched."""
    from importlib import import_module
    apply_diffs = import_module(
        f"{P.__name__}.frontend.apply_patch").apply_diffs
    instantiate_text = import_module(
        f"{P.__name__}.frontend.types").instantiate_text
    elems = [{"elemId": f"b:{i + 1}", "value": "x", "conflicts": None}
             for i in range(n_base)]
    cache = {"T": instantiate_text("T", elems, n_base)}
    updated = {}
    diffs = [{"type": "text", "obj": "T", "action": "insert",
              "index": 1000 + i, "elemId": f"a:{i + 1}", "value": "y"}
             for i in range(n_ins)]
    apply_diffs(diffs, cache, updated, {}, splice_batch=splice)
    assert len(updated["T"].elems) == n_base + n_ins
    return [e["elemId"] for e in updated["T"].elems]


@pytest.mark.parametrize("n_base,n_ins", [(2000, 200), (1200, 7)])
def test_cfg8_splice_ab_matches_jax(n_base, n_ins):
    elementwise = splice_elem_ids(T, n_base, n_ins, False)
    spliced = splice_elem_ids(T, n_base, n_ins, True)
    assert elementwise == spliced == splice_elem_ids(J, n_base, n_ins, True)
    assert spliced[1000:1000 + n_ins] == [f"a:{i + 1}" for i in range(n_ins)]


def test_adv_phase_rehearses_on_the_cpu():
    """Phase 18 of chip_smoke.py end to end at small sizes on the CPU:
    every part's checks pass and no kernel launches."""
    rec = cs.adv_phase(torch, M, "cpu", device="cpu", n_actors=20,
                       two_round_base=2000, reps=1, conflict_actors=6,
                       conflict_targets=20, counter_actors=5, counter_keys=4,
                       save_changes=3, save_run=10, nested_root=40,
                       nested_changes=5)
    assert rec["b"]["rounds"] == 2 and rec["a"]["mixed_rounds"] == 1
    assert rec["c"]["conflicts"] and rec["d"]["count"] == 5
    assert sum(rec["launches"].values()) == 0


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """chip_smoke.py keeps copies of the generators: with the port's
    modules loaded it has imported no JAX, no JAX package and nothing of
    benchmarks/ or bench.py."""
    import os
    import subprocess
    import sys
    code = ("import sys\n"
            "import chip_smoke\n"
            "chip_smoke.port_modules()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'automerge_tpu', 'benchmarks', 'bench'))\n"
            "assert not bad, bad\n"
            "assert callable(chip_smoke.adv_phase)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
