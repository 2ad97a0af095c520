"""scripts/soak.py's tier sessions, sharded and residency, and phase 20's
cold planning stream through both packages, on the CPU
(tests/test_torch_soak_docs.py says how a session twin is run and
compared).

A shard session's documents are its meshes' checkpoint captures, so both
packages' `ShardedDocSet.capture` record every capture they return, in
order, and the two records must be byte-equal. The JAX package's
residency session leaves its two meshes open, each with its lane
workers (two lanes on two virtual devices); the twin closes every mesh
it recorded once the session returns. The port serves the sharded
stream once more with AMTPU_PARALLEL_LANES=1 (its lanes share one
device, so they run sequentially by default): that run's executor
statistics must equal the JAX package's, whose lanes span eight devices.

Phase 20's stream runs at cfg12t's `quick` size (48 documents, 4 rounds
a stream, 1 warm-up and 2 timed streams) through the JAX package's
stacked executor with bench.py's own generator and through
`chip_smoke.plan_phase` on the CPU: the final texts, the stacked
counters and the learned sites' statistics must be equal.
"""

import contextlib
import json

import pytest
import torch

import bench as B
import chip_smoke as cs
from automerge_tpu.engine import learned_index as JL
from automerge_tpu.engine import stacked as JStacked
from automerge_tpu.engine.text_doc import DeviceTextDoc as JDoc
from automerge_tpu.shard import ShardedDocSet as JMesh
from test_torch_soak_docs import (M, assert_twins, isolated, jax_session,
                                  port_session)

TMesh = M.shard.ShardedDocSet


@pytest.fixture(autouse=True)
def soak_isolated():
    with isolated():
        yield


@contextlib.contextmanager
def captures(cls, log: list):
    """`cls.capture` recording (doc, bytes) of every capture into `log`;
    every mesh that captured is closed on the way out."""
    real = cls.capture
    meshes = []

    def capture(self, doc_id):
        data = real(self, doc_id)
        log.append((doc_id, data))
        if self not in meshes:
            meshes.append(self)
        return data
    cls.capture = capture
    try:
        yield
    finally:
        cls.capture = real
        for mesh in meshes:
            mesh.close()


def twins(profile: str, seed: int) -> tuple:
    jlog, tlog = [], []
    jax = jax_session(profile, seed,
                      wrap=lambda: captures(JMesh, jlog))
    port = port_session(profile, seed,
                        wrap=lambda: captures(TMesh, tlog))
    assert jlog and [d for d, _ in tlog] == [d for d, _ in jlog]
    assert tlog == jlog
    return jax, port


@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_session_matches_the_jax_package(seed):
    jax, port = twins("sharded", seed)
    jax_exec = jax["metrics"].pop("lane_executor")
    assert port["metrics"].pop("lane_executor") == {}
    assert_twins(jax, port, checks_docs=False)
    assert port["metrics"]["migrations"] >= 1
    workers = port_session("sharded", seed, shard_counts=(8,),
                           parallel_lanes="1")
    assert workers["metrics"]["lane_executor"] == jax_exec
    assert (workers["out"]["captures"], workers["out"]["texts"]) == (
        port["out"]["captures"], port["out"]["texts"])


@pytest.mark.parametrize("seed", [0, 1])
def test_residency_session_matches_the_jax_package(seed):
    jax, port = twins("residency", seed)
    assert_twins(jax, port, checks_docs=False)
    m = port["metrics"]
    assert m["population_over_budget"] >= 10
    assert m["gauge_peak_bytes"] <= m["budget_bytes"]
    assert port["out"]["cuda_max_memory_allocated"] is None
    assert port["out"]["cuda_allocated_at_reset"] is None


QUICK = {"n_docs": 48, "n_rounds": 4, "warmup": 1, "reps": 2}


def jax_plan(monkeypatch, n_docs, n_rounds, warmup, reps, ops=8) -> dict:
    """bench.py measure_text_prepare's cross_doc leg through the JAX
    package, untimed, from bench.py's generator."""
    monkeypatch.setenv("AMTPU_CROSS_DOC_PLAN", "1")
    monkeypatch.setenv("AMTPU_BATCH_INDEX", "1")
    JL.reset_stats()
    ids = [f"tp-{i:05d}" for i in range(n_docs)]
    docs = {d: JDoc(d, capacity=1024) for d in ids}
    seed = B._sharded_text_round(ids, 1, 1, 64)
    assert seed == cs.stack_text_round(ids, 1, 1, cs.PLAN_SEED_OPS)
    assert JStacked.apply_stacked([(docs[k], v) for k, v in seed.items()])
    streams = []
    for rep in range(warmup + reps):
        seq0 = 2 + rep * n_rounds
        base = 33 + (seq0 - 2) * (ops // 2)
        streams.append([B._sharded_text_round(ids, seq0 + r,
                                              base + (ops // 2) * r, ops)
                        for r in range(n_rounds)])
    assert streams == cs.plan_streams(ids, n_rounds, ops, warmup + reps)
    merges = plans = shared = 0
    for rounds in streams:
        for chunk in rounds:
            st = JStacked.apply_stacked([(docs[k], v)
                                         for k, v in chunk.items()])
            assert st
            JStacked.assert_round_budget(st)
            merges += st["index_merges"]
            plans += st["text_plans"]
            shared += (st.get("cross_doc") or {}).get("sched_shared", 0)
    texts = {k: d.text() for k, d in docs.items()}
    return {"texts_sha256": cs._digest(json.dumps(
                texts, sort_keys=True).encode()),
            "index_merges": merges, "text_plans": plans,
            "sched_shared": shared, "sites": JL.stats_snapshot()}


def test_plan_stream_matches_the_jax_package(monkeypatch):
    want = jax_plan(monkeypatch, **QUICK)
    got = cs.plan_phase(torch, M, "cpu", device="cpu", **QUICK)
    assert {k: got[k] for k in want} == want
    assert got["text_plans"] == QUICK["n_docs"] * QUICK["n_rounds"] * (
        QUICK["warmup"] + QUICK["reps"])
    assert len(got["ops_per_s"]) == QUICK["reps"]
    assert set(got["plan_terms_s"]) == set(cs.PLAN_TERMS)
    assert got["plan_terms_s"]["index_merge"] > 0


def test_plan_phase_raises_when_a_site_never_engages(monkeypatch):
    """cfg19's engagement check: a stream whose range-index model was
    never consulted fails the phase rather than reporting a rate."""
    real = M.learned.stats_snapshot

    def no_range_hits():
        sites = real()
        sites["range_index"] = dict(sites["range_index"], hits=0)
        return sites
    monkeypatch.setattr(M.learned, "stats_snapshot", no_range_hits)
    with pytest.raises(AssertionError, match="range_index"):
        cs.plan_phase(torch, M, "cpu", device="cpu", n_docs=8, n_rounds=2,
                      warmup=0, reps=1)
