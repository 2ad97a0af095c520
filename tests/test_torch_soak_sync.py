"""scripts/soak.py's sync sessions through both packages, on the CPU:
chaos, checkpoint and service (tests/test_torch_soak_docs.py says how a
twin is run and compared).

The service session's tick reads its clock for the admission deadline
(`ServiceConfig.tick_budget_ms`), so which tenants a tick sheds depends
on how fast the host admits, and with it every document of the session.
Both packages' service servers run it on `chip_smoke.TickClock`, a clock
that advances a fixed step at each read, as phase 19 does on the card;
the metrics' tick times then read that clock too.
"""

import contextlib
import importlib
import os
import sys

import pytest
import torch

import chip_smoke as cs
from test_torch_soak_docs import (M, assert_twins, isolated, jax_session,
                                  port_session, soak)

JS = importlib.import_module("automerge_tpu.service.server")


@pytest.fixture(autouse=True)
def soak_isolated():
    with isolated():
        yield


def clock(server):
    return lambda: cs.TickClock().installed(server)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("profile", ["chaos", "checkpoint"])
def test_session_matches_the_jax_package(profile, seed):
    assert_twins(jax_session(profile, seed), port_session(profile, seed))


@pytest.mark.parametrize("seed", [0, 1])
def test_service_session_matches_the_jax_package(seed):
    jax = jax_session("service", seed, wrap=clock(JS))
    port = port_session("service", seed, wrap=clock(M.service.server))
    assert_twins(jax, port)
    m = port["metrics"]
    assert m["killed"] >= 1 and m["evictions"] >= m["killed"]


def test_service_scrape_is_served_and_valid(monkeypatch):
    """`soak.py --service --scrape` at 12 clients: the live endpoint's
    page passes validate_prom and /describe parses, in both packages;
    the sessions agree less the page's counts (each package exports its
    own device families)."""
    monkeypatch.setattr(soak, "SCRAPE", True)
    kw = {"n_clients": 12}
    jax = jax_session("service", 3, wrap=clock(JS), **kw)
    port = port_session("service", 3, wrap=clock(M.service.server),
                        scrape=True, **kw)
    for side in (jax, port):
        assert side["metrics"].pop("scrape_ok") is True
        assert side["metrics"].pop("scrape_families") > 0
        assert side["metrics"].pop("scrape_samples") > 0
    assert_twins(jax, port)


#: the lineage bar's wall-clock readings (dwell and visibility times)
LINEAGE_TIMING = ("lineage_max_quarantine_dwell_ms",
                  "lineage_max_defer_dwell_ms", "lineage_visibility_p99_ms")


def test_service_lineage_acceptance_matches_the_jax_package():
    """soak.py's lineage bar (`_lineage_acceptance`) with every change
    sampled in both packages: the same share of complete
    origin-to-visibility chains on every surviving replica, the same
    chain and hop counts, less the dwell and visibility readings."""
    lineages = (importlib.import_module("automerge_tpu.obs.lineage"),
                M.lineage)
    for lin in lineages:
        lin.enable(rate=1, capacity=4096)
    try:
        jax = jax_session("service", 2, wrap=clock(JS))
        port = port_session("service", 2, wrap=clock(M.service.server))
    finally:
        for lin in lineages:
            lin.disable()
            lin.clear()
            lin._ledger = None
    for side in (jax, port):
        for k in LINEAGE_TIMING:
            side["metrics"].pop(k)
    assert_twins(jax, port)
    assert port["metrics"]["lineage_complete_ratio"] >= 0.99
    assert port["metrics"]["lineage_commit_population"] > 0


def test_tick_clock_is_restored():
    """The clock is in place only inside its block."""
    real = M.service.server.time
    with cs.TickClock(step_s=0.5).installed(M.service.server) as c:
        assert M.service.server.time.perf_counter() == 0.5
        assert M.service.server.time.perf_counter() == 1.0
    assert M.service.server.time is real and c.t == 1.0
    with contextlib.suppress(RuntimeError):
        with cs.TickClock().installed(M.service.server):
            raise RuntimeError
    assert M.service.server.time is real


def test_cpu_twins_agree_with_this_process():
    """chip_smoke.CpuTwins runs a session's CPU run in a spawned worker,
    as phases 13, 16, 17, 19 and 20 do beside the card's runs; its state
    equals this process's run of the seed. (A service session at scale
    also depends on the string-hash order of the hub's sets, which is
    why chip_smoke.py runs itself and its workers with
    PYTHONHASHSEED=0.)"""
    # the worker imports this chip_smoke by name from the path it
    # inherits, on which scripts/ (which holds the JAX package's own
    # chip_smoke.py) may come first
    root = os.path.dirname(os.path.abspath(cs.__file__))
    sys.path.insert(0, root)
    try:
        with cs.CpuTwins() as twins:
            got = twins.submit("soak_twin", "checkpoint", 1).result()
            chaos = twins.submit("soak_twin", "chaos", 2, item=0).result()
    finally:
        sys.path.remove(root)
    assert got[0] == cs.soak_twin(torch, M, "checkpoint", 1)[0]
    assert got[1] > 0
    assert chaos == cs.soak_twin(torch, M, "chaos", 2)[0]
