"""scripts/soak.py's document sessions through both packages, on the CPU:
general, conflict, lossy and table.

`chip_smoke.py` phase 19 runs copies of scripts/soak.py's sessions on the
card (`chip_smoke.soak_<profile>`, written over the port's namespace and
a device). Here each copy runs on the port's CPU backend, and the same
seed runs through the JAX package by scripts/soak.py itself, as
tests/test_soak_smoke.py runs it. Both must end in the same state, with
zero tolerance:

- every set of documents the session checks for convergence: each one's
  `save()` string and rendered `to_json`, recorded by wrapping each
  side's `_converged`;
- the obs counter delta of the session (`metrics_snapshot()["counters"]`
  under `obs.tracing()`, what soak.py's summary line prints);
- for service, sharded and residency, soak.py's `PROFILE_METRICS` entry
  and each checkpoint capture of a shard mesh
  (tests/test_torch_soak_sync.py, tests/test_torch_soak_tiers.py).

Both uuid factories are pinned to one counter. The JAX package's
`get_all_changes` makes a scratch document whose actor id draws a uuid
the port's does not (the port reads the history without one); that
scratch id appears in no output, so `jax_draws_like_the_port` runs it
with the pinned counter set aside, and every later object id matches.

`soak_isolated` is the autouse fixture of the three files: it pins and
resets both packages' uuid factories and fails a test that leaves a new
live thread behind, naming it (`live_threads_since`).
"""

import contextlib
import itertools
import os
import sys
import threading
import time

import pytest
import torch

import automerge_tpu as J
import automerge_tpu_torch as T
import chip_smoke as cs
from automerge_tpu import _uuid as j_uuid
from automerge_tpu_torch import _uuid as t_uuid

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

import soak  # noqa: E402

M = cs.port_modules()

#: the one process-wide planning pool (engine/pipeline.py `planner_pool`,
#: in both packages): started at first use and kept for the process
SHARED_POOLS = ("amtpu-plan",)


def live_threads_since(before, grace_s: float = 5.0) -> list:
    """Names of the threads alive now that were not in `before`, after
    giving each up to `grace_s` in all to finish; the shared planning
    pool's threads are not counted."""
    deadline = time.monotonic() + grace_s
    left = []
    for t in threading.enumerate():
        if t in before or t.name.startswith(SHARED_POOLS):
            continue
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            left.append(t.name)
    return left


def pin():
    for m in (j_uuid, t_uuid):
        c = itertools.count(1)
        m.set_factory(lambda c=c: f"00000000-0000-0000-0000-{next(c):012d}")


@contextlib.contextmanager
def threads_checked():
    """Raises when the block leaves a new live thread behind, naming it:
    a thread left on a test worker runs on through every file after it
    (the autouse fixture of each port test file whose code starts
    threads)."""
    before = set(threading.enumerate())
    yield
    left = live_threads_since(before)
    assert not left, f"threads left running: {left}"


@contextlib.contextmanager
def isolated():
    """Both uuid factories pinned, reset on the way out; raises when the
    block leaves a new live thread behind."""
    with threads_checked():
        pin()
        try:
            yield
        finally:
            j_uuid.reset()
            t_uuid.reset()


@pytest.fixture(autouse=True)
def soak_isolated():
    with isolated():
        yield


@contextlib.contextmanager
def jax_draws_like_the_port():
    """The JAX package's `get_all_changes` with its scratch document's
    actor id drawn off the pinned counter (see the module note)."""
    real = J.get_all_changes

    def get_all_changes(doc):
        factory = j_uuid._factory
        j_uuid.set_factory(lambda: "scratch")
        try:
            return real(doc)
        finally:
            j_uuid.set_factory(factory)
    J.get_all_changes = get_all_changes
    try:
        yield
    finally:
        J.get_all_changes = real


@contextlib.contextmanager
def recording(module, log: list):
    """`module._converged` recording each checked document's save() and
    rendered to_json into `log`, one list per check."""
    real = module._converged

    def converged(am, docs):
        log.append([(am.save(d), cs._render(am, d)) for d in docs])
        return real(am, docs)
    module._converged = converged
    try:
        yield
    finally:
        module._converged = real


def _run(obs, fn) -> tuple:
    """fn() under obs.tracing(): (its result, the counter delta)."""
    with obs.tracing():
        c0 = dict(obs.metrics_snapshot()["counters"])
        out = fn()
        c1 = obs.metrics_snapshot()["counters"]
    return out, {k: v - c0.get(k, 0) for k, v in c1.items()
                 if v - c0.get(k, 0)}


def jax_session(profile: str, seed: int, wrap=contextlib.nullcontext,
                **kw) -> dict:
    """scripts/soak.py's session_<profile>(seed) through the JAX package,
    inside `wrap()`: what it checked, its counters and its
    PROFILE_METRICS entry."""
    log = []
    pin()
    with jax_draws_like_the_port(), recording(soak, log), wrap():
        _, events = _run(J.obs, lambda: getattr(
            soak, f"session_{profile}")(seed, **kw))
    return {"converged": log, "events": events,
            "metrics": cs._nt(soak.PROFILE_METRICS.get(profile, {}))}


def port_session(profile: str, seed: int, wrap=contextlib.nullcontext,
                 **kw) -> dict:
    """chip_smoke's copy of the session on the port's CPU backend, inside
    `wrap()`."""
    fn = cs.SOAK_SESSIONS[profile]
    log = []
    pin()
    with recording(cs, log), wrap():
        out, events = _run(T.obs, lambda: fn(torch, M, "cpu", seed, **kw))
    return {"converged": log, "events": events,
            "metrics": cs._nt(out.get("metrics", {})), "out": out}


#: counters of the port's tracing that the JAX package has no twin of:
#: SyncHub.flush's fan-out, its messages and their changes
PORT_ONLY = ("sync.hub.fanout_msgs", "sync.hub.fanout_changes")


def assert_twins(jax: dict, port: dict, checks_docs: bool = True):
    assert bool(jax["converged"]) == checks_docs
    assert [[r for _, r in c] for c in port["converged"]] == \
        [[r for _, r in c] for c in jax["converged"]]
    assert [[s for s, _ in c] for c in port["converged"]] == \
        [[s for s, _ in c] for c in jax["converged"]]
    assert {k: v for k, v in port["events"].items()
            if k not in PORT_ONLY} == jax["events"]
    # a fan-out message carries at least one change
    fanout = [port["events"].get(k, 0) for k in PORT_ONLY]
    assert fanout[1] >= fanout[0]
    assert port["metrics"] == jax["metrics"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("profile", ["general", "conflict", "lossy",
                                     "table"])
def test_session_matches_the_jax_package(profile, seed):
    assert_twins(jax_session(profile, seed), port_session(profile, seed))


def test_shared_helpers_are_the_soaks():
    """The copies' shared helpers draw and compare as scripts/soak.py's
    do: the same values, edits and verdicts from one seed."""
    import numpy as np
    assert cs.KEYS == soak.KEYS
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    assert [cs._rand_value(a) for _ in range(40)] == \
        [soak._rand_value(b) for _ in range(40)]
    docs = {}
    for P, mod, opts in ((J, soak, {}), (T, cs, {"backend": M.am.backend
                                                 .backend_for("cpu")})):
        pin()
        rng = np.random.default_rng(9)
        doc = P.change(P.init({"actorId": "e", **opts}),
                       lambda d: d.__setitem__("t", P.Text("abc")))
        for _ in range(30):
            doc = mod._text_edit(P, doc, rng)
        other = P.change(doc, lambda d: d.__setitem__("k", 1))
        docs[P] = (str(P.to_json(doc)["t"]), P.save(doc),
                   mod._converged(P, [doc, doc]),
                   mod._converged(P, [doc, other])[0])
    assert docs[T] == docs[J]
    assert docs[T][2] == (True, None) and docs[T][3] is False
