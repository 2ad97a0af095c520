"""The port's service tier (automerge_tpu_torch/service/) against the JAX
package's, on the CPU.

Every scenario runs twice: once through the JAX package on its default
backend, once through the port with ``ServiceConfig(device="cpu")`` and
every client DocSet and document bound to ``backend.backend_for("cpu")``.
Both packages' uuid factories are pinned before each run and reset after
each test, and the learned-index site counters of both are zeroed before
each run. Each run must pass the JAX test's own assertions, and the two
runs' results must be equal with zero tolerance: every envelope each
client sent and received (frames by their bytes), the documents
(`to_json`) and `save()` bytes, `metrics()` and `describe()` less the
timing keys, and the scrape page's families and values less the timing
and device-specific families named below.

Excluded by name, because they are wall-clock readings or measure each
package's own runtime:

- ``metrics()``: `TIMING_METRICS` (tick ms and its percentiles);
- ``describe()``: `TIMING_DESCRIBE` (the telemetry tick p99), the same
  metrics keys, the residency block's `page_in_p99_ms` and `spill_dir`
  (each run spills to a directory of its own), each lane's `device`
  name in the shard map (the JAX package names its CPU device
  "TFRT_CPU_0", the port "cpu"), and the lineage block's hop offsets,
  dwell and visibility readings (`TIMING_LINEAGE`; `_lineage_shape`
  keeps stages, sites and their order);
- the scrape page: `TIMING_FAMILIES` (the tick histogram and gauges, the
  lineage span and visibility histograms, the residency page-in p99)
  and `DEVICE_FAMILIES` (``amtpu_device_*`` compile, call and byte
  counters, the ``amtpu_mesh_*`` worker gauges and barrier-wait
  histogram, and ``amtpu_obs_*``, the trace ring's own spans);
- the lane executor's `RACY_EXEC` counters (thread timing).

Twins of:

- tests/test_service.py (all 32 tests);
- the SyncService parts of tests/test_telemetry.py (lag probes,
  describe, scrape, the loopback ``serve_metrics`` endpoint, metrics
  percentiles, public introspection);
- tests/test_shard.py:523-546 (rooms on shard lanes, every lane on the
  CPU);
- tests/test_residency.py:468-504 (``TestServiceIntegration``);
- tests/test_parallel_mesh.py:290-445 (``_service_session``,
  ``TestServiceTickPipeline``);
- tests/test_lineage.py:392-444 (the service postmortem and scrape);
- the service parts of tests/test_wire_format.py (``approx_msg_bytes``
  and the service-scale session).

Plus the device binding (``SyncService()`` without a card raises at its
first room or lane and never lands on the CPU; ``device="cpu"`` binds
every room, lane and mesh doc to the CPU), the import boundary (nothing
under ``automerge_tpu_torch/service`` imports ``jax`` or
``automerge_tpu``), ``obs.prom.ScrapeServer`` and the module-level
``lineage.postmortem``. A ``cuda`` test pipelines two lanes of one card
and holds the room saves to the sequential run's.
"""

import ast
import itertools
import json
import random
import socket
import struct
import urllib.error
import urllib.request
from collections import deque
from importlib import import_module
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import pytest
import torch

import automerge_tpu as J
import automerge_tpu_torch as T
from automerge_tpu import _uuid as j_uuid
from automerge_tpu_torch import _uuid as t_uuid
from test_torch_soak_docs import threads_checked

CPU = T.backend.backend_for("cpu")
ROOT_DIR = Path(__file__).resolve().parent.parent

#: wall-clock fields of metrics() (and of describe()["metrics"])
TIMING_METRICS = ("p50_tick_ms", "p99_tick_ms", "max_tick_ms")
#: wall-clock fields of describe()
TIMING_DESCRIBE = ("tick_p99_ms_telemetry",)
#: scrape families that carry wall-clock readings
TIMING_FAMILIES = ("amtpu_svc_span_seconds", "amtpu_svc_p50_tick_ms",
                   "amtpu_svc_p99_tick_ms", "amtpu_svc_max_tick_ms",
                   "amtpu_lineage_span_seconds",
                   "amtpu_lineage_visibility_ms",
                   "amtpu_residency_page_in_p99_ms")
#: scrape families that measure each package's own runtime
DEVICE_FAMILIES = ("amtpu_device_", "amtpu_mesh_", "amtpu_obs_")


def _pkg(am):
    base = am.__name__
    mod = lambda name: import_module(f"{base}.{name}")  # noqa: E731
    service = mod("service")
    sync = mod("sync")
    res = mod("resilience")
    port = am is T

    def config(**kw):
        return service.ServiceConfig(**kw, **({"device": "cpu"}
                                              if port else {}))

    return SimpleNamespace(
        am=am, port=port, name="port" if port else "jax", Text=am.Text,
        obs=mod("obs"), lineage=mod("obs.lineage"), prom=mod("obs.prom"),
        learned=mod("engine.learned_index"), wf=mod("engine.wire_format"),
        hub_mod=mod("sync.hub"), service=service,
        budget_mod=mod("service.budget"), parallel=mod("shard.parallel"),
        ServiceConfig=config, TenantBudget=service.TenantBudget,
        SyncService=lambda cfg=None: service.SyncService(cfg or config()),
        LIVE=service.LIVE, SUSPECT=service.SUSPECT, DEAD=service.DEAD,
        Connection=sync.Connection, SyncHub=sync.SyncHub,
        ClockMatrix=mod("sync.clock_index").ClockMatrix,
        DocSet=(lambda: sync.DocSet(backend=CPU)) if port else sync.DocSet,
        ResilientChannel=res.ResilientChannel,
        PeerDeadError=res.PeerDeadError,
        MAX_RETRIES=mod("resilience.channel").MAX_RETRIES,
        InboundGate=mod("resilience.inbound").InboundGate,
        QuarantineQueue=mod("resilience.quarantine").QuarantineQueue,
        init=lambda actor=None: am.init(
            ({"actorId": actor} if actor else {})
            | ({"backend": CPU} if port else {})))


JP, TP = _pkg(J), _pkg(T)


def pin(tag=0):
    """Pin both uuid factories to one counter. `tag` starts a fresh
    series: the packages draw throwaway uuids at different points (the
    JAX package's `get_all_changes` makes a scratch document), so a
    scenario that builds a second document re-pins before it."""
    for m in (j_uuid, t_uuid):
        c = itertools.count(1)
        m.set_factory(
            lambda c=c: f"00000000-0000-0000-{tag:04x}-{next(c):012d}")


@pytest.fixture(autouse=True)
def _isolated():
    """Pinned uuids, tracing and lineage off and no retained lineage
    ledger (describe() and the scrape carry it), both packages; teardown
    leaves both uuid factories at their defaults."""
    pin()
    for P in (JP, TP):
        P.obs.disable()
        P.obs.clear()
        P.lineage.disable()
        P.lineage._ledger = None
    yield
    for P in (JP, TP):
        P.obs.disable()
        P.lineage.disable()
    j_uuid.reset()
    t_uuid.reset()


@pytest.fixture(autouse=True)
def no_leaked_threads():
    """A test that leaves a new live thread behind fails, naming it."""
    with threads_checked():
        yield


def both(fn):
    """fn(P) for the JAX package, then the port, each from freshly pinned
    uuid counters and zeroed learned-index counters."""
    out = []
    for P in (JP, TP):
        pin()
        P.learned.reset_stats()
        out.append(fn(P))
    return out


def same(fn):
    j, t = both(fn)
    assert t == j
    return t


# --------------------------------------------------------------------------
# comparable forms
# --------------------------------------------------------------------------


def norm(obj):
    """Plain comparable data: frames by their bytes, tuples as lists."""
    if isinstance(obj, dict):
        return {k: norm(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [norm(v) for v in obj]
    if hasattr(obj, "data") and hasattr(obj, "n_ops"):
        return ["frame", bytes(obj.data)]
    return obj


def metrics_nt(m):
    return {k: v for k, v in m.items() if k not in TIMING_METRICS}


#: wall-clock fields of the lineage block (the ledger's dwell and
#: visibility readings); `_lineage_shape` keeps the dwell stages' names
TIMING_LINEAGE = ("visibility_p50_ms", "visibility_p99_ms")


def _lineage_shape(block):
    if block is None:
        return None
    out = {k: v for k, v in block.items()
           if k not in ("stuck", "max_dwell_ms") + TIMING_LINEAGE}
    out["dwell_stages"] = sorted(block.get("max_dwell_ms", {}))
    out["stuck"] = [
        {**{k: v for k, v in e.items()
            if k not in ("hops", "age_ms", "dwell_ms", "t0_ns")},
         "hops": [list(h[:2]) for h in e["hops"]]}
        for e in block.get("stuck", [])]
    return json.loads(json.dumps(out, default=str))


def describe_nt(d):
    d = json.loads(json.dumps(d, sort_keys=True, default=str))
    for k in TIMING_DESCRIBE:
        d.pop(k, None)
    d["metrics"] = metrics_nt(d["metrics"])
    for lane in d.get("shards", {}).get("lanes", {}).values():
        lane.pop("device", None)
    if "residency" in d:
        d["residency"].pop("page_in_p99_ms", None)
        d["residency"]["config"].pop("spill_dir", None)
    if "lineage" in d:
        d["lineage"] = _lineage_shape(d["lineage"])
    return d


def scrape_nt(page):
    """{(family sample, labels): value} of a scrape page, less the
    timing and device-specific families."""
    out = {}
    for line in page.splitlines():
        if not line or line.startswith("#"):
            continue
        key, _, value = line.rpartition(" ")
        name = key.split("{", 1)[0]
        if name.startswith(TIMING_FAMILIES) or name.startswith(
                DEVICE_FAMILIES):
            continue
        out[key] = value
    return out


def canon(P, doc):
    return None if doc is None else json.dumps(
        P.am.to_json(doc), sort_keys=True, default=str)


def _counters(P):
    return P.obs.metrics_snapshot()["counters"]


# --------------------------------------------------------------------------
# satellite 1: bounded retransmission -> typed peer death
# --------------------------------------------------------------------------


class TestChannelRetransmitCap:
    def test_cap_exhaustion_raises_typed_peer_dead(self):
        def run(P):
            sent = []
            chan = P.ResilientChannel(lambda env: sent.append(norm(env)),
                                      lambda p: None, max_retries=3)
            chan.send({"docId": "d", "clock": {}})
            with pytest.raises(P.PeerDeadError):
                for _ in range(500):
                    chan.tick()
            assert chan.dead and chan.stats["dead"]
            assert chan.in_flight == 0
            assert chan.stats["retransmits"] == 3
            with pytest.raises(P.PeerDeadError):
                chan.send({"docId": "d", "clock": {}})
            return sent, dict(chan.stats)
        same(run)

    def test_on_dead_callback_fires_instead_of_raise(self):
        def run(P):
            deaths = []
            chan = P.ResilientChannel(lambda env: None, lambda p: None,
                                      max_retries=2, on_dead=deaths.append)
            chan.send({"docId": "d", "clock": {}})
            for _ in range(500):
                chan.tick()
            assert deaths == [chan]
            assert chan.dead
            return dict(chan.stats)
        same(run)

    def test_default_cap_is_finite(self):
        def run(P):
            chan = P.ResilientChannel(lambda env: None, lambda p: None)
            assert chan._max_retries == P.MAX_RETRIES
            assert 0 < P.MAX_RETRIES < 10_000
            return P.MAX_RETRIES
        same(run)

    def test_acked_traffic_never_trips_the_cap(self):
        def run(P):
            a_to_b, b_to_a = deque(), deque()
            a = P.ResilientChannel(a_to_b.append, lambda p: None,
                                   max_retries=4)
            b = P.ResilientChannel(b_to_a.append, lambda p: None)
            for i in range(20):
                a.send({"docId": "d", "clock": {}, "n": i})
                for _ in range(12):
                    a.tick()
                if a_to_b:
                    a_to_b.popleft()
                while a_to_b:
                    b.on_wire(a_to_b.popleft())
                while b_to_a:
                    a.on_wire(b_to_a.popleft())
            assert not a.dead
            assert a.idle
            return dict(a.stats), dict(b.stats)
        same(run)

    def test_admit_gate_drops_unacked_and_redelivers(self):
        def run(P):
            wire, delivered, credit = deque(), [], [False]
            server = P.ResilientChannel(lambda env: None, delivered.append,
                                        admit=lambda env: credit[0])
            client = P.ResilientChannel(wire.append, lambda p: None)
            client.send({"docId": "d", "clock": {}})
            server.on_wire(wire.popleft())
            assert delivered == [] and server.stats["backpressured"] == 1
            assert client.in_flight == 1
            for _ in range(10):
                client.tick()
            credit[0] = True
            while wire:
                server.on_wire(wire.popleft())
            assert len(delivered) == 1
            return norm(delivered), dict(server.stats)
        same(run)


# --------------------------------------------------------------------------
# satellite 2: churn-storm memory bound
# --------------------------------------------------------------------------


class TestChurnStorm:
    def test_release_peer_recycles_slot_and_zeroes_rows(self):
        def run(P):
            m = P.ClockMatrix()
            m.update_ours("doc", {"a": 3})
            m.update_theirs("p1", "doc", {"a": 3})
            slots_before = m.peer_slots
            m.release_peer("p1")
            m.update_theirs("p2", "doc", {"a": 1})
            assert m.peer_slots == slots_before
            assert m.their_clock("p2", "doc") == {"a": 1}
            assert m.their_clock("p1", "doc") == {}
            return m.peer_slots
        same(run)

    def test_500_peer_churn_bounds_matrix_and_interner(self):
        """The JAX test's 500 cycles: the bound is on growth per cycle,
        so the twin keeps the count."""
        def run(P):
            ds = P.DocSet()
            ds.set_doc("doc", P.am.change(P.init("srv"),
                                          lambda d: d.__setitem__("k", 1)))
            hub = P.SyncHub(ds)
            hub.open()
            sent = []
            keep = [hub.add_peer(f"keep-{i}",
                                 lambda m, i=i: sent.append((i, norm(m))))
                    for i in range(3)]
            for i in range(500):
                pid = f"churn-{i}"
                hub.add_peer(pid, lambda m: None)
                hub._receive(pid, {"docId": "doc", "clock": {}})
                hub.flush()
                hub.remove_peer(pid)
            mat = hub._matrix
            assert mat.peer_slots <= 4
            assert len(mat._peers.idx) <= 4
            assert mat._theirs.shape[0] <= 4
            assert mat._active.shape[0] <= 4
            assert not any(pd[0].startswith("churn-")
                           for pd in hub._revealed)
            assert not any(pd[0].startswith("churn-")
                           for pd in hub._advertised)
            assert len(hub._peers) == len(keep)
            return mat.peer_slots, sent
        same(run)

    def test_readd_after_release_interns_fresh(self):
        def run(P):
            ds = P.DocSet()
            ds.set_doc("doc", P.am.change(P.init("srv"),
                                          lambda d: d.__setitem__("k", 1)))
            hub = P.SyncHub(ds)
            hub.open()
            hub.add_peer("p", lambda m: None)
            hub._receive("p", {"docId": "doc", "clock": {"srv": 1}})
            hub.remove_peer("p")
            hub.add_peer("p", lambda m: None)
            assert hub._matrix.their_clock("p", "doc") == {}
            return hub.peer_state("p")
        same(run)


# --------------------------------------------------------------------------
# satellite 3: attributed quarantine pressure eviction
# --------------------------------------------------------------------------


def _premature(P, actor, seq, key="x"):
    return {"actor": actor, "seq": seq, "deps": {"ghost": 9},
            "ops": [{"action": "set", "obj": P.am.ROOT_ID,
                     "key": key, "value": seq}]}


def _pressure_events(P):
    return [r[5] for r in P.obs.snapshot()
            if r[2] == "quar" and r[3] == "evict_pressure"]


class TestQuarantinePressure:
    def test_capacity_eviction_emits_attributed_pressure_event(self):
        def run(P):
            q = P.QuarantineQueue(capacity=2)
            with P.obs.tracing():
                q.park(_premature(P, "a", 1), sender="tenant-a")
                q.park(_premature(P, "b", 1), sender="tenant-b")
                q.park(_premature(P, "c", 1), sender="tenant-c")
                counters = _counters(P)
                recs = _pressure_events(P)
            assert counters.get("quar.evict_pressure") == 1
            assert len(recs) == 1
            assert recs[0]["tenant"] == "tenant-a"
            assert recs[0]["actor"] == "a"
            assert q.stats["evicted"] == 1
            return recs, dict(q.stats)
        same(run)

    def test_eviction_under_storm_attributes_the_flooder(self):
        def run(P):
            ds = P.DocSet()
            ds.set_doc("doc", P.init("srv"))
            gate = P.InboundGate(ds, capacity=4, global_capacity=8)
            with P.obs.tracing():
                for seq in range(2, 30):
                    gate.deliver("doc", [_premature(P, "flood", seq)],
                                 validated=True, sender="tenant-flood")
                recs = _pressure_events(P)
            assert recs
            assert all(r["tenant"] == "tenant-flood" for r in recs)
            assert gate._n_parked <= 8
            assert gate.stats["peak_parked"] <= 8
            assert gate.stats["peak_parked"] >= gate._n_parked
            return recs, dict(gate.stats), gate.quarantine_items()
        same(run)

    def test_drop_sender_reclaims_only_that_tenant(self):
        def run(P):
            q = P.QuarantineQueue(capacity=64)
            q.park(_premature(P, "a", 2), sender="t1")
            q.park(_premature(P, "a", 3), sender="t1")
            q.park(_premature(P, "b", 2), sender="t2")
            q.park(_premature(P, "c", 2))
            assert q.drop_sender("t1") == 2
            assert len(q) == 2
            assert q.drop_sender("t1") == 0
            return len(q), dict(q.stats)
        same(run)

    def test_gate_evict_sender_sweeps_all_docs(self):
        def run(P):
            ds = P.DocSet()
            ds.set_doc("d1", P.init("s1"))
            ds.set_doc("d2", P.init("s2"))
            gate = P.InboundGate(ds, capacity=16)
            gate.deliver("d1", [_premature(P, "a", 2)], validated=True,
                         sender="t")
            gate.deliver("d2", [_premature(P, "b", 2)], validated=True,
                         sender="t")
            gate.deliver("d2", [_premature(P, "c", 2)], validated=True,
                         sender="other")
            assert gate.evict_sender("t") == 2
            assert gate._n_parked == 1
            return gate.quarantine_items()
        same(run)

    def test_requeue_preserves_attribution(self):
        def run(P):
            ds = P.DocSet()
            ds.set_doc("doc", P.init("srv"))
            gate = P.InboundGate(ds, capacity=8)
            gate.deliver("doc", [_premature(P, "a", 3)], validated=True,
                         sender="t")
            doc = P.am.change(P.init("w"), lambda d: d.__setitem__("y", 1))
            gate.deliver("doc", P.am.get_all_changes(doc), validated=True,
                         sender="other")
            assert gate.evict_sender("t") == 1
            return P.am.save(ds.get_doc("doc")), dict(gate.stats)
        same(run)


# --------------------------------------------------------------------------
# the service tier
# --------------------------------------------------------------------------


class _Client:
    """Lossless queue-transport tenant client (tests/test_service.py
    `_Client`) over package `P`, logging every envelope it sends ("up")
    and receives ("down") in comparable form."""

    def __init__(self, P, svc, tid, room_id, base=None):
        self.P, self.svc, self.tid, self.room_id = P, svc, tid, room_id
        self.to_server: deque = deque()
        self.to_client: deque = deque()
        self.log: list = []
        self.ds = P.DocSet()
        if base is not None:
            self.ds.set_doc(room_id, P.am.apply_changes(
                P.init(f"c-{tid}"), base))
        self.sess = svc.connect(tid, room_id, self._down)
        self.chan = P.ResilientChannel(self._up, None)
        self.conn = P.Connection(self.ds, self.chan.send)
        self.chan._deliver = self.conn.receive_msg
        self.conn.open()

    def _down(self, env):
        self.log.append(("down", norm(env)))
        self.to_client.append(env)

    def _up(self, env):
        self.log.append(("up", norm(env)))
        self.to_server.append(env)

    def pump_up(self):
        while self.to_server:
            env = self.to_server.popleft()
            sess = self.svc.session(self.tid)
            if sess is not None:
                sess.on_wire(env)

    def pump_down(self):
        while self.to_client:
            self.chan.on_wire(self.to_client.popleft())
        self.chan.tick()

    def pump(self):
        self.pump_up()
        self.pump_down()

    def doc(self):
        return self.ds.get_doc(self.room_id)

    def edit(self, key, value):
        self.ds.set_doc(self.room_id, self.P.am.change(
            self.doc(), lambda d: d["m"].__setitem__(key, value)))


def _room_doc(P, actor="origin"):
    return P.am.change(P.init(actor), lambda d: (
        d.__setitem__("t", P.Text("start")), d.__setitem__("m", {})))


def _seed(P, svc, room_id="r", actor="origin", server=None):
    """Seed a room's server replica (actor `server`, by default
    "server-<room>"); returns the founding history every non-empty
    member shares."""
    pin(1 + len(svc._rooms))
    changes = P.am.get_all_changes(_room_doc(P, actor))
    svc.seed_doc(room_id, P.am.apply_changes(
        P.init(server or f"server-{room_id}"), changes))
    return changes


def _settle(svc, clients, max_ticks=300):
    for _ in range(max_ticks):
        for c in clients:
            c.pump()
        svc.tick()
        if svc.idle() and all(c.chan.idle and not c.to_server
                              and not c.to_client for c in clients):
            return
    raise AssertionError(f"service never quiesced: {svc.metrics()}")


def _same_doc(P, docs):
    dumps = [canon(P, d) for d in docs]
    return dumps.count(dumps[0]) == len(dumps)


def record(P, svc, clients=(), rooms=("r",)):
    """Everything a service run is held to: server and client docs and
    saves, every client's envelope log, metrics and describe (less
    timings), and the scrape page (less timing and device families)."""
    out = {"metrics": metrics_nt(svc.metrics()),
           "describe": describe_nt(svc.describe()),
           "scrape": scrape_nt(svc.scrape())}
    for room_id in rooms:
        doc = svc.room(room_id).doc_set.get_doc(room_id)
        out[f"server:{room_id}"] = (canon(P, doc), None if doc is None
                                    else P.am.save(doc))
    for c in clients:
        doc = c.doc()
        out[f"client:{c.tid}"] = (canon(P, doc), None if doc is None
                                  else P.am.save(doc), c.log)
    return out


class TestServiceBasics:
    def test_two_tenants_converge_through_ticks(self):
        def run(P):
            svc = P.SyncService()
            base = _seed(P, svc)
            a = _Client(P, svc, "a", "r", base)
            b = _Client(P, svc, "b", "r", base)
            a.edit("alpha", 1)
            b.edit("beta", 2)
            _settle(svc, [a, b])
            server = svc.room("r").doc_set.get_doc("r")
            assert _same_doc(P, [server, a.doc(), b.doc()])
            assert P.am.to_json(server)["m"] == {"alpha": 1, "beta": 2}
            return record(P, svc, [a, b])
        same(run)

    def test_grouped_admission_one_gate_delivery_per_doc_per_tick(self):
        def run(P):
            svc = P.SyncService()
            base = _seed(P, svc)
            clients = [_Client(P, svc, f"t{i}", "r", base)
                       for i in range(4)]
            _settle(svc, clients)
            for i, c in enumerate(clients):
                c.edit(f"k{i}", i)
                c.pump()
            gate = svc.room("r").gate
            with mock.patch.object(gate, "deliver",
                                   wraps=gate.deliver) as spy:
                svc.tick()
            deliveries = list(spy.call_args_list)
            assert len(deliveries) == 1
            args, kwargs = deliveries[0]
            assert len(args[1]) == 4
            assert sorted(set(kwargs["sender"])) == \
                [f"t{i}" for i in range(4)]
            _settle(svc, clients)
            assert _same_doc(P, [svc.room("r").doc_set.get_doc("r")]
                             + [c.doc() for c in clients])
            return norm(args[1]), kwargs["sender"], record(P, svc, clients)
        same(run)

    def test_metrics_surface(self):
        def run(P):
            svc = P.SyncService()
            base = _seed(P, svc)
            c = _Client(P, svc, "a", "r", base)
            _settle(svc, [c])
            m = svc.metrics()
            for key in ("ticks", "admitted_msgs", "shed_total",
                        "evictions", "p50_tick_ms", "p99_tick_ms",
                        "live_tenants", "peak_inbox", "peak_parked",
                        "max_starved_streak"):
                assert key in m
            assert m["live_tenants"] == 1 and m["rooms"] == 1
            return sorted(m), metrics_nt(m)
        same(run)


class TestBudgetsAndBackpressure:
    def test_budget_deferral_is_not_loss(self):
        def run(P):
            svc = P.SyncService(P.ServiceConfig(
                default_budget=P.TenantBudget(ops_per_tick=1,
                                              inbox_cap=64)))
            base = _seed(P, svc)
            c = _Client(P, svc, "a", "r", base)
            _settle(svc, [c])
            for i in range(6):
                c.edit(f"k{i}", i)
            c.pump()
            assert len(c.sess.inbox) == 6
            svc.tick()
            assert c.sess.stats["deferred"] > 0
            assert svc.stats["deferrals"] > 0
            _settle(svc, [c])
            server = svc.room("r").doc_set.get_doc("r")
            assert P.am.to_json(server)["m"]["k5"] == 5
            assert c.sess.stats["admitted_msgs"] >= 6
            return record(P, svc, [c])
        same(run)

    def test_oversized_first_message_still_admits(self):
        def run(P):
            svc = P.SyncService(P.ServiceConfig(
                default_budget=P.TenantBudget(ops_per_tick=2,
                                              bytes_per_tick=64)))
            base = _seed(P, svc)
            c = _Client(P, svc, "a", "r", base)
            _settle(svc, [c])
            doc = c.doc()
            for i in range(20):
                doc = P.am.change(doc, lambda d, i=i:
                                  d["m"].__setitem__(f"big{i}", i))
            c.ds.set_doc("r", doc)
            _settle(svc, [c])
            server = svc.room("r").doc_set.get_doc("r")
            assert P.am.to_json(server)["m"]["big19"] == 19
            return record(P, svc, [c])
        same(run)

    def test_inbox_credit_backpressures_instead_of_queueing(self):
        def run(P):
            svc = P.SyncService(P.ServiceConfig(
                default_budget=P.TenantBudget(ops_per_tick=1,
                                              inbox_cap=1)))
            base = _seed(P, svc)
            c = _Client(P, svc, "a", "r", base)
            _settle(svc, [c])
            for i in range(5):
                c.edit(f"k{i}", i)
            _settle(svc, [c])
            assert c.sess.channel.stats["backpressured"] > 0
            assert svc.stats["peak_inbox"] <= 1 + svc.config.recv_window
            server = svc.room("r").doc_set.get_doc("r")
            assert P.am.to_json(server)["m"] == {f"k{i}": i
                                                 for i in range(5)}
            return record(P, svc, [c])
        same(run)


class TestSheddingAndStarvation:
    def test_deadline_shed_degrades_and_recovers(self):
        """`tick_budget_ms=1e-6` (the JAX test's own setting): every
        tick's deadline has passed before the second tenant, so what
        sheds does not depend on either package's speed."""
        def run(P):
            svc = P.SyncService(P.ServiceConfig(
                tick_budget_ms=1e-6,
                default_budget=P.TenantBudget(ops_per_tick=4,
                                              inbox_cap=64)))
            base = _seed(P, svc)
            clients = [_Client(P, svc, f"t{i}", "r", base)
                       for i in range(5)]
            _settle(svc, clients, max_ticks=600)
            for i, c in enumerate(clients):
                c.edit(f"k{i}", i)
                c.pump()
            with P.obs.tracing():
                for _ in range(3):
                    svc.tick()
                assert _counters(P).get("svc.shed", 0) > 0
            assert svc.stats["shed_total"] > 0
            _settle(svc, clients, max_ticks=600)
            server = svc.room("r").doc_set.get_doc("r")
            assert P.am.to_json(server)["m"] == {f"k{i}": i
                                                 for i in range(5)}
            assert all(c.sess.stats["last_admit_tick"] > 0
                       for c in clients)
            return record(P, svc, clients)
        same(run)

    def test_low_priority_is_bounded_latency_not_never(self):
        def run(P):
            cfg = P.ServiceConfig(tick_budget_ms=1e-6,
                                  starvation_boost_ticks=3)
            svc = P.SyncService(cfg)
            base = _seed(P, svc)
            lo = _Client(P, svc, "lo", "r", base)
            lo.sess = svc.connect("lo", "r", lo._down,
                                  budget=P.TenantBudget(priority=-5))
            lo.conn.close()
            lo.chan = P.ResilientChannel(lo._up, None)
            lo.conn = P.Connection(lo.ds, lo.chan.send)
            lo.chan._deliver = lo.conn.receive_msg
            lo.conn.open()
            highs = [_Client(P, svc, f"hi{i}", "r", base)
                     for i in range(4)]
            _settle(svc, [lo] + highs, max_ticks=600)
            lo.edit("lo_key", 1)
            for i, c in enumerate(highs):
                c.edit(f"hi{i}", i)
            _settle(svc, [lo] + highs, max_ticks=600)
            assert svc.stats["max_starved_streak"] \
                <= 2 * cfg.starvation_boost_ticks
            server = svc.room("r").doc_set.get_doc("r")
            assert P.am.to_json(server)["m"]["lo_key"] == 1
            return record(P, svc, [lo] + highs)
        same(run)


class TestPeerHealthLadder:
    def _svc(self, P, **kw):
        cfg = P.ServiceConfig(**{"heartbeat_ticks": 3,
                                 "suspect_grace_ticks": 3,
                                 "max_retries": 1000, **kw})
        svc = P.SyncService(cfg)
        return svc, _seed(P, svc)

    def test_silent_owed_peer_escalates_suspect_dead_evicted(self):
        def run(P):
            svc, base = self._svc(P)
            c = _Client(P, svc, "ghost", "r", base)
            _settle(svc, [c])
            room = svc.room("r")
            room.doc_set.set_doc("r", P.am.change(
                room.doc_set.get_doc("r"),
                lambda d: d["m"].__setitem__("x", 1)))
            assert c.sess.channel.in_flight > 0
            states = []
            for _ in range(20):
                svc.tick()
                s = svc.session("ghost")
                if s is None:
                    break
                states.append(s.state)
            assert P.SUSPECT in states
            assert svc.session("ghost") is None
            assert svc.stats["evictions"] == 1
            assert svc.reclaimed("ghost")
            assert c.sess.state == P.DEAD
            return states, record(P, svc, [c])
        same(run)

    def test_idle_unowed_peer_is_never_suspected(self):
        def run(P):
            svc, base = self._svc(P)
            c = _Client(P, svc, "quiet", "r", base)
            _settle(svc, [c])
            for _ in range(30):
                svc.tick()
            assert svc.session("quiet").state == P.LIVE
            return record(P, svc, [c])
        same(run)

    def test_any_frame_recovers_a_suspect(self):
        def run(P):
            svc, base = self._svc(P)
            c = _Client(P, svc, "laggy", "r", base)
            _settle(svc, [c])
            room = svc.room("r")
            room.doc_set.set_doc("r", P.am.change(
                room.doc_set.get_doc("r"),
                lambda d: d["m"].__setitem__("x", 1)))
            ticks = 0
            while svc.session("laggy").state != P.SUSPECT:
                svc.tick()
                ticks += 1
            c.pump()
            c.pump()
            assert svc.session("laggy").state == P.LIVE
            _settle(svc, [c])
            assert svc.session("laggy") is not None
            return ticks, record(P, svc, [c])
        same(run)

    def test_retransmit_cap_is_the_dead_backstop(self):
        def run(P):
            svc, base = self._svc(P, heartbeat_ticks=10_000, max_retries=2)
            c = _Client(P, svc, "void", "r", base)
            _settle(svc, [c])
            room = svc.room("r")
            room.doc_set.set_doc("r", P.am.change(
                room.doc_set.get_doc("r"),
                lambda d: d["m"].__setitem__("x", 1)))
            ticks = 0
            for _ in range(200):
                svc.tick()
                ticks += 1
                if svc.session("void") is None:
                    break
            assert svc.session("void") is None
            assert svc.reclaimed("void")
            return ticks, record(P, svc, [c])
        same(run)

    def test_eviction_reclaims_quarantined_changes(self):
        def run(P):
            svc, base = self._svc(P)
            c = _Client(P, svc, "parker", "r", base)
            _settle(svc, [c])
            gate = svc.room("r").gate
            gate.deliver("r", [_premature(P, "a", 7)], validated=True,
                         sender="parker")
            assert gate._n_parked == 1
            svc.evict("parker", reason="test")
            assert gate._n_parked == 0
            assert svc.reclaimed("parker")
            return record(P, svc, [c])
        same(run)

    def test_matrix_slots_bounded_across_tenant_churn(self):
        """50 churn cycles, as the JAX test: the bound is on growth per
        cycle."""
        def run(P):
            svc, base = self._svc(P)
            stable = _Client(P, svc, "stable", "r", base)
            _settle(svc, [stable])
            for i in range(50):
                c = _Client(P, svc, f"churn-{i}", "r", base)
                _settle(svc, [stable, c])
                svc.disconnect(f"churn-{i}")
            mat = svc.room("r").hub._matrix
            assert mat.peer_slots <= 3
            return mat.peer_slots, record(P, svc, [stable])
        same(run)


class TestRejoin:
    def test_same_id_reconnect_evicts_stale_and_bootstraps(self):
        def run(P):
            svc = P.SyncService()
            base = _seed(P, svc)
            c1 = _Client(P, svc, "t", "r", base)
            c2 = _Client(P, svc, "peer", "r", base)
            c1.edit("pre", 1)
            _settle(svc, [c1, c2])
            c1b = _Client(P, svc, "t", "r")
            assert svc.stats["rejoins"] == 1
            assert svc.stats["evictions"] == 1
            _settle(svc, [c1b, c2])
            server = svc.room("r").doc_set.get_doc("r")
            assert c1b.doc() is not None
            assert _same_doc(P, [server, c1b.doc(), c2.doc()])
            return record(P, svc, [c1, c1b, c2])
        same(run)

    def test_join_storm_served_from_one_snapshot_encode(self):
        def run(P):
            svc = P.SyncService()
            doc = _room_doc(P)
            for i in range(12):
                doc = P.am.change(doc, lambda d, i=i:
                                  d["m"].__setitem__(f"h{i}", i))
            svc.seed_doc("r", doc)
            hub = svc.room("r").hub
            hub.snapshot_min_changes = 4
            with P.obs.tracing():
                storm = [_Client(P, svc, f"j{i}", "r") for i in range(8)]
                _settle(svc, storm)
                counters = _counters(P)
            assert counters.get("sync.snapshot_capture") == 1
            assert counters.get("sync.snapshot_serve_cached", 0) >= 7
            server = svc.room("r").doc_set.get_doc("r")
            docs = [server] + [c.doc() for c in storm]
            assert all(d is not None for d in docs)
            assert _same_doc(P, docs)
            assert len({P.am.save(d) for d in docs}) == 1
            return (counters["sync.snapshot_capture"],
                    counters["sync.snapshot_serve_cached"],
                    record(P, svc, storm))
        same(run)


class TestInboundSnapshot:
    def test_tenant_served_checkpoint_installs_not_parks(self):
        def run(P):
            svc = P.SyncService()
            doc = _room_doc(P)
            for i in range(16):
                doc = P.am.change(doc, lambda d, i=i:
                                  d["m"].__setitem__(f"h{i}", i))
            c = _Client(P, svc, "holder", "r")
            c.ds.set_doc("r", doc)
            P.hub_mod.shared_hub(c.ds).snapshot_min_changes = 4
            _settle(svc, [c])
            server_doc = svc.room("r").doc_set.get_doc("r")
            assert server_doc is not None
            assert P.am.save(server_doc) == P.am.save(c.doc())
            assert svc.room("r").gate._n_parked == 0
            for i in range(2):
                c.edit(f"tail{i}", i)
            svc2 = P.SyncService()
            c2 = _Client.__new__(_Client)
            c2.P, c2.svc, c2.tid, c2.room_id = P, svc2, "holder2", "r"
            c2.to_server, c2.to_client, c2.log = deque(), deque(), []
            c2.ds = c.ds
            svc2.connect("holder2", "r", c2._down)
            c2.chan = P.ResilientChannel(c2._up, None)
            c2.conn = P.Connection(c2.ds, c2.chan.send)
            c2.chan._deliver = c2.conn.receive_msg
            with P.obs.tracing():
                c2.conn.open()
                _settle(svc2, [c2])
                counters = _counters(P)
            assert counters.get("sync.snapshot_serve_cached", 0) >= 1
            server2 = svc2.room("r").doc_set.get_doc("r")
            assert server2 is not None
            assert P.am.save(server2) == P.am.save(c.doc())
            assert svc2.room("r").gate._n_parked == 0
            return record(P, svc, [c]), record(P, svc2, [c2])
        same(run)


class TestFailureIsolation:
    def test_malformed_payload_counts_against_its_sender_only(self):
        def run(P):
            svc = P.SyncService()
            base = _seed(P, svc)
            good = _Client(P, svc, "good", "r", base)
            bad = _Client(P, svc, "bad", "r", base)
            _settle(svc, [good, bad])
            bad.chan.send({"docId": "r", "changes": ["not a change"]})
            good.edit("ok", 1)
            _settle(svc, [good, bad])
            assert svc.session("bad").stats["protocol_errors"] == 1
            assert svc.session("good").stats["protocol_errors"] == 0
            assert svc.session("bad") is not None
            server = svc.room("r").doc_set.get_doc("r")
            assert P.am.to_json(server)["m"]["ok"] == 1
            bad.edit("still_works", 2)
            _settle(svc, [good, bad])
            assert P.am.to_json(svc.room("r").doc_set.get_doc("r"))[
                "m"]["still_works"] == 2
            return record(P, svc, [good, bad])
        same(run)

    def test_rooms_isolate_tenants(self):
        def run(P):
            svc = P.SyncService()
            base1 = _seed(P, svc, "r1", "o1")
            base2 = _seed(P, svc, "r2", "o2")
            a = _Client(P, svc, "a", "r1", base1)
            b = _Client(P, svc, "b", "r2", base2)
            a.edit("only_r1", 1)
            _settle(svc, [a, b])
            assert "only_r1" not in P.am.to_json(
                svc.room("r2").doc_set.get_doc("r2"))["m"]
            assert b.doc() is not None
            assert "only_r1" not in P.am.to_json(b.doc())["m"]
            return record(P, svc, [a, b], rooms=("r1", "r2"))
        same(run)


# --------------------------------------------------------------------------
# tests/test_telemetry.py: lag probes, describe, scrape, percentiles
# --------------------------------------------------------------------------


def _seed_t(P, svc):
    """tests/test_telemetry.py `_seed`: the server replica's actor is
    "server"."""
    return _seed(P, svc, server="server")


class TestReplicationLagProbes:
    def test_withheld_acks_report_wire_lag_then_recover(self):
        def run(P):
            svc = P.SyncService()
            base = _seed_t(P, svc)
            a = _Client(P, svc, "a", "r", base)
            b = _Client(P, svc, "b", "r", base)
            _settle(svc, [a, b])
            a.ds.set_doc("r", P.am.change(
                a.doc(), lambda d: d["m"].__setitem__("k", 1)))
            for _ in range(4):
                a.pump()
                b.pump_up()
                svc.tick()
            lag = svc.replication_lag()
            assert lag["b"]["ops"] >= 1, lag
            assert lag["b"]["wire_ops"] >= 1, lag
            first_ticks = lag["b"]["ticks"]
            assert first_ticks >= 1
            svc.tick()
            assert svc.replication_lag()["b"]["ticks"] > first_ticks
            assert lag["a"]["ops"] == 0
            m = svc.metrics()
            assert m["max_lag_ops"] >= 1 and m["lagging_tenants"] == 1
            assert m["peak_lag_ops"] >= 1 and m["peak_lag_ticks"] >= 1
            mid = metrics_nt(m)
            _settle(svc, [a, b])
            svc.probe_lag()
            lag2 = svc.replication_lag()
            assert lag2["b"]["ops"] == 0 and lag2["b"]["ticks"] == 0
            assert svc.metrics()["peak_lag_ops"] >= 1
            return lag, mid, lag2, record(P, svc, [a, b])
        same(run)

    def test_lag_counts_matrix_deficit_for_unsent_changes(self):
        def run(P):
            svc = P.SyncService()
            base = _seed_t(P, svc)
            a = _Client(P, svc, "a", "r", base)
            _settle(svc, [a])
            room = svc.room("r")
            doc = room.doc_set.get_doc("r")
            with room.hub.batched():
                room.doc_set.set_doc("r", P.am.change(
                    doc, lambda d: d["m"].__setitem__("x", 1)))
                table = room.hub.replication_lag()
                assert table["a"]["ops"] >= 1
                assert table["a"]["docs"].get("r", 0) >= 1
            _settle(svc, [a])
            return table, record(P, svc, [a])
        same(run)

    def test_probe_disabled_by_config(self):
        def run(P):
            svc = P.SyncService(P.ServiceConfig(lag_probe_ticks=0))
            base = _seed_t(P, svc)
            a = _Client(P, svc, "a", "r", base)
            for _ in range(3):
                a.pump()
                svc.tick()
            assert svc.stats["peak_lag_ops"] == 0
            return record(P, svc, [a])
        same(run)


class TestDescribeAndScrape:
    def test_describe_round_trips_with_tracing_off(self):
        def run(P):
            assert not P.obs.ENABLED
            svc = P.SyncService(P.ServiceConfig(event_log=8))
            base = _seed_t(P, svc)
            a = _Client(P, svc, "a", "r", base)
            _settle(svc, [a])
            svc.evict("a", reason="test")
            dump = json.loads(json.dumps(svc.describe(), default=str))
            assert dump["schema"] == "amtpu-postmortem-v1"
            assert dump["metrics"]["evictions"] == 1
            assert "a" not in dump["tenants"]
            assert dump["rooms"]["r"]["quarantine"]["parked"] == 0
            kinds = [e["event"] for e in dump["events"]]
            assert "join" in kinds and "evict" in kinds
            assert "tick_p99_ms_telemetry" in dump
            assert "lag" in dump and "config" in dump
            return describe_nt(dump)
        same(run)

    def test_describe_tenant_entry_carries_ladder_and_occupancy(self):
        def run(P):
            svc = P.SyncService()
            base = _seed_t(P, svc)
            a = _Client(P, svc, "a", "r", base)
            _settle(svc, [a])
            entry = svc.describe()["tenants"]["a"]
            for key in ("state", "starved_streak", "inbox", "inbox_cap",
                        "in_flight", "recv_buffered", "lag_ops",
                        "lag_ticks", "stats", "channel"):
                assert key in entry, key
            assert entry["state"] == "live"
            assert entry["inbox_cap"] == \
                svc.config.default_budget.inbox_cap
            return entry
        same(run)

    def test_event_ring_is_bounded(self):
        def run(P):
            svc = P.SyncService(P.ServiceConfig(event_log=4))
            for i in range(10):
                svc._note("shed", msgs=i)
            assert len(svc.describe()["events"]) == 4
            assert svc.describe()["events"][-1]["msgs"] == 9
            return svc.describe()["events"]
        same(run)

    def test_scrape_page_validates_and_carries_lag_series(self):
        def run(P):
            svc = P.SyncService()
            base = _seed_t(P, svc)
            a = _Client(P, svc, "a", "r", base)
            b = _Client(P, svc, "b", "r", base)
            _settle(svc, [a, b])
            a.ds.set_doc("r", P.am.change(
                a.doc(), lambda d: d["m"].__setitem__("k", 1)))
            for _ in range(3):
                a.pump()
                b.pump_up()
                svc.tick()
            page = svc.scrape()
            counts = P.prom.validate_prom(page)
            assert counts["families"] > 10
            assert "amtpu_svc_replication_lag_ops{" in page
            assert 'tenant="b"' in page
            assert "amtpu_svc_span_seconds_bucket" in page
            mid = scrape_nt(page)
            _settle(svc, [a, b])
            return mid, record(P, svc, [a, b])
        same(run)

    def test_scrape_bounds_lag_series_to_config(self):
        def run(P):
            svc = P.SyncService(P.ServiceConfig(prom_lag_series=2))
            base = _seed_t(P, svc)
            clients = [_Client(P, svc, f"t{i}", "r", base)
                       for i in range(5)]
            _settle(svc, clients)
            page = svc.scrape()
            n = sum(1 for line in page.splitlines()
                    if line.startswith("amtpu_svc_replication_lag_ops{"))
            assert n <= 2
            return n, scrape_nt(page)
        same(run)

    def test_http_endpoint_serves_metrics_and_describe(self):
        """Loopback only: the endpoint binds 127.0.0.1."""
        def run(P):
            svc = P.SyncService()
            base = _seed_t(P, svc)
            a = _Client(P, svc, "a", "r", base)
            _settle(svc, [a])
            srv = svc.serve_metrics()
            try:
                assert srv.host == "127.0.0.1"
                body = urllib.request.urlopen(
                    srv.url + "/metrics", timeout=10).read().decode()
                P.prom.validate_prom(body)
                dump = json.loads(urllib.request.urlopen(
                    srv.url + "/describe", timeout=10).read())
                assert dump["schema"] == "amtpu-postmortem-v1"
                with pytest.raises(urllib.error.HTTPError):
                    urllib.request.urlopen(srv.url + "/nope", timeout=10)
            finally:
                srv.close()
            return scrape_nt(body), describe_nt(dump)
        same(run)

    def test_aborted_scrape_is_quiet(self, capfd):
        def run(P):
            svc = P.SyncService()
            base = _seed_t(P, svc)
            a = _Client(P, svc, "a", "r", base)
            _settle(svc, [a])
            srv = svc.serve_metrics()
            try:
                for _ in range(5):
                    s = socket.create_connection((srv.host, srv.port),
                                                 timeout=5)
                    s.sendall(b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n")
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                 struct.pack("ii", 1, 0))
                    s.close()
                body = urllib.request.urlopen(
                    srv.url + "/metrics", timeout=10).read().decode()
                P.prom.validate_prom(body)
            finally:
                srv.close()
            err = capfd.readouterr().err
            assert "Traceback" not in err, err
            return scrape_nt(body)
        same(run)

    def test_obs_telemetry_rides_along_when_tracing(self):
        def run(P):
            svc = P.SyncService()
            base = _seed_t(P, svc)
            a = _Client(P, svc, "a", "r", base)
            with P.obs.tracing():
                P.obs.clear()
                _settle(svc, [a])
                page = svc.scrape()
            P.prom.validate_prom(page)
            assert "amtpu_obs_" in page
            return scrape_nt(page)
        same(run)


class TestMetricsPercentiles:
    def test_nearest_rank_indexing(self):
        def run(P):
            svc = P.SyncService()
            svc._tick_ms.extend(float(i + 1) for i in range(100))
            m = svc.metrics()
            assert m["p50_tick_ms"] == 50.0
            assert m["p99_tick_ms"] == 99.0
            assert m["max_tick_ms"] == 100.0
            return m
        same(run)

    def test_single_sample_and_empty(self):
        def run(P):
            svc = P.SyncService()
            assert svc.metrics()["p99_tick_ms"] == 0.0
            svc._tick_ms.append(7.0)
            m = svc.metrics()
            assert m["p50_tick_ms"] == m["p99_tick_ms"] == 7.0
            return m
        same(run)

    def test_tick_history_is_bounded(self):
        def run(P):
            svc = P.SyncService(P.ServiceConfig(tick_ring=16))
            for i in range(100):
                svc._tick_ms.append(float(i))
            assert len(svc._tick_ms) == 16
            return list(svc._tick_ms)
        same(run)


class TestPublicIntrospection:
    def test_hub_peer_state_lifecycle(self):
        def run(P):
            ds = P.DocSet()
            doc = P.am.change(P.init("o"), lambda d: d.__setitem__("m", {}))
            ds.set_doc("d", doc)
            hub = P.SyncHub(ds)
            hub.open()
            hub.add_peer("p", lambda msg: None)
            hub.note_clock("p", "d", {})
            st = hub.peer_state("p")
            assert st["present"] and st["matrix_slot"]
            assert st["revealed_docs"] == 1
            hub.remove_peer("p")
            st2 = hub.peer_state("p")
            assert not st2["present"] and not st2["matrix_slot"]
            assert st2["revealed_docs"] == st2["session_docs"] == 0
            return st, st2
        same(run)

    def test_gate_quarantine_items_snapshot(self):
        def run(P):
            ds = P.DocSet()
            gate = P.InboundGate(ds)
            premature = {"actor": "x", "seq": 5, "deps": {"ghost": 3},
                         "ops": [], "message": ""}
            gate.deliver("doc", [premature], validated=True, sender="tEn")
            items = gate.quarantine_items()
            assert ("doc", "x", 5, "tEn") in items
            assert gate.quarantine_items("doc") == items
            assert gate.quarantine_items("other") == []
            assert gate.evict_sender("tEn") == 1
            assert gate.quarantine_items() == []
            return items
        same(run)

    def test_reclaimed_uses_public_surface(self):
        def run(P):
            svc = P.SyncService()
            base = _seed_t(P, svc)
            c = _Client(P, svc, "a", "r", base)
            svc.tick()
            svc.evict("a", reason="test")
            assert svc.reclaimed("a")
            st = svc.room("r").hub.peer_state("a")
            assert not st["present"] and not st["matrix_slot"]
            assert all(s != "a" for *_, s
                       in svc.room("r").gate.quarantine_items())
            return st, record(P, svc, [c])
        same(run)


# --------------------------------------------------------------------------
# tests/test_shard.py:523-546: rooms on shard lanes
# --------------------------------------------------------------------------


def test_service_rooms_map_onto_shard_lanes():
    def run(P):
        hash_shard = import_module(
            P.am.__name__ + ".shard.placement").hash_shard
        svc = P.SyncService(P.ServiceConfig(shard_lanes=2))
        for r in range(6):
            svc.room(f"room-{r}")
        smap = svc.shard_map()
        assert smap["n_lanes"] == 2
        placed = [r for lane in smap["lanes"].values()
                  for r in lane["rooms"]]
        assert sorted(placed) == [f"room-{r}" for r in range(6)]
        for lane_idx, lane in smap["lanes"].items():
            for room in lane["rooms"]:
                assert hash_shard(room, 2) == lane_idx
        assert svc.metrics()["shard_lanes"] == 2
        assert "shards" in svc.describe()
        if P.port:
            assert {lane["device"] for lane in smap["lanes"].values()} \
                == {"cpu"}
        return describe_nt(svc.describe())["shards"]
    same(run)


def test_service_unsharded_default_is_unchanged():
    def run(P):
        svc = P.SyncService()
        svc.room("r")
        assert svc.shard_map() == {}
        assert svc.metrics()["shard_lanes"] == 0
        assert "shards" not in svc.describe()
        return metrics_nt(svc.metrics())
    same(run)


# --------------------------------------------------------------------------
# tests/test_residency.py:468-504: service integration
# --------------------------------------------------------------------------


def _doc_stream(doc_id, n):
    from test_residency import doc_stream
    return doc_stream(doc_id, n)


class TestServiceIntegration:
    def test_budget_zero_keeps_tier_off(self):
        def run(P):
            svc = P.SyncService()
            assert svc.residency is None
            with pytest.raises(RuntimeError):
                svc.mesh_deliver({"d": []})
            return svc.doc_mesh
        same(run)

    def test_mesh_deliver_drains_on_tick(self, tmp_path):
        def run(P):
            svc = P.SyncService(P.ServiceConfig(
                residency_budget_bytes=10 * 1024 * 1024,
                residency_cold_after=1,
                residency_spill_dir=str(tmp_path / P.name)))
            svc.mesh_deliver({"d": _doc_stream("d", 2)})
            assert svc.doc_mesh.doc("d") is None
            svc.tick()
            lane = svc.doc_mesh.lane_of("d")
            with lane.device_ctx():
                assert lane.docs["d"].text() == "xx"
            if P.port:
                assert str(lane.device) == "cpu"
            svc.residency.demote("d")
            svc.tick()
            svc.tick()
            assert svc.residency.tier_of("d") == "cold"
            d = svc.describe()
            assert d["residency"]["tier_counts"]["cold"] == 1
            page = svc.scrape()
            assert "amtpu_residency_docs" in page
            assert "amtpu_residency_events_total" in page
            return describe_nt(d), scrape_nt(page)
        same(run)

    def test_shard_lanes_are_shared_with_mesh(self, tmp_path):
        def run(P):
            svc = P.SyncService(P.ServiceConfig(
                shard_lanes=2, residency_budget_bytes=10 * 1024 * 1024,
                residency_spill_dir=str(tmp_path / P.name)))
            assert svc.doc_mesh.lanes == svc._shard_lanes
            return len(svc.doc_mesh.lanes)
        same(run)


# --------------------------------------------------------------------------
# tests/test_parallel_mesh.py:290-445: service tick pipelining
# --------------------------------------------------------------------------


#: executor counters that depend on thread timing (how much pre-decode
#: fit inside a barrier), not on the session: left out of the comparison
RACY_EXEC = ("rounds_overlapped", "predecoded_batches")


def _service_session(P, monkeypatch, flag, n_rooms=4, steps=24, **cfg_kw):
    monkeypatch.setenv("AMTPU_PARALLEL_LANES", flag)
    monkeypatch.setenv("AMTPU_TICK_PIPELINE", flag)
    svc = P.SyncService(P.ServiceConfig(shard_lanes=4, **cfg_kw))
    rng = random.Random(31)
    rooms = [f"pr-{i}" for i in range(n_rooms)]
    clients = []
    for room_id in rooms:
        base = _seed(P, svc, room_id)
        clients.append(_Client(P, svc, f"{room_id}-t0", room_id,
                               base=base))
    for step in range(steps):
        c = rng.choice(clients)
        c.edit(f"k{rng.randrange(6)}", f"v{step}")
        if step % 3 == 0:
            for cl in clients:
                cl.pump()
            svc.tick()
    _settle(svc, clients)
    state = {r: canon(P, svc.room(r).doc_set.get_doc(r)) for r in rooms}
    saves = {r: P.am.save(svc.room(r).doc_set.get_doc(r)) for r in rooms}
    lane_stats = [dict(lane.stats) for lane in svc._shard_lanes]
    ex = svc._mesh_executor()
    ex_stats = dict(ex.stats) if ex is not None else None
    svc.close()
    return state, lane_stats, ex_stats, saves


class TestServiceTickPipeline:
    def test_tick_parity_pipelined_vs_sequential(self, monkeypatch):
        def run(P):
            seq = _service_session(P, monkeypatch, "0")
            par = _service_session(P, monkeypatch, "1")
            assert par[0] == seq[0], "room docs diverged"
            assert par[1] == seq[1], "lane stats diverged"
            assert par[3] == seq[3], "room saves diverged"
            assert seq[2] is None
            assert par[2] is not None and par[2]["errors"] == 0
            assert par[2]["barriers"] > 0 and par[2]["completed"] > 0
            ex = {k: v for k, v in par[2].items() if k not in RACY_EXEC}
            return seq[0], seq[1], seq[3], ex
        same(run)

    def test_executor_shared_with_residency_mesh(self, monkeypatch,
                                                 tmp_path):
        def run(P):
            monkeypatch.setenv("AMTPU_PARALLEL_LANES", "1")
            svc = P.SyncService(P.ServiceConfig(
                shard_lanes=4, residency_budget_bytes=1 << 30,
                residency_spill_dir=str(tmp_path / P.name)))
            try:
                assert svc.doc_mesh is not None
                assert svc._mesh_executor() is svc.doc_mesh.executor()
                assert svc._tick_executor is None
                return svc._mesh_executor().n_workers
            finally:
                svc.close()
        same(run)

    def test_tick_overlap_predecodes_mesh_backlog(self, monkeypatch,
                                                  tmp_path):
        from test_shard import text_change

        def run(P):
            monkeypatch.setenv("AMTPU_PARALLEL_LANES", "1")
            monkeypatch.setenv("AMTPU_TICK_PIPELINE", "1")
            monkeypatch.setenv("AMTPU_STACKED_MIN_OPS", "1")
            svc = P.SyncService(P.ServiceConfig(
                shard_lanes=4, residency_budget_bytes=1 << 30,
                residency_spill_dir=str(tmp_path / P.name)))
            try:
                clients = []
                for i in range(4):
                    base = _seed(P, svc, f"ov-{i}")
                    clients.append(_Client(P, svc, f"ov-{i}-t0",
                                           f"ov-{i}", base=base))
                svc.mesh_deliver({"bulk": [text_change("ba", 1, "xx",
                                                       obj="bulk")]})
                svc.tick()
                seq = 1
                for step in range(8):
                    for j, c in enumerate(clients):
                        c.edit("k", f"v{step}-{j}")
                    seq += 1
                    svc.mesh_deliver({"bulk": [text_change(
                        "ba", seq, "yy", start_ctr=(seq - 1) * 2 + 1,
                        after=f"ba:{(seq - 1) * 2}", obj="bulk")]})
                    for c in clients:
                        c.pump()
                    svc.tick()
                ex = svc._mesh_executor()
                assert ex is not None
                assert ex.stats["predecoded_batches"] > 0
                assert ex.stats["rounds_overlapped"] > 0
                lane = svc.doc_mesh.lane_of("bulk")
                with lane.device_ctx():
                    text = lane.docs["bulk"].text()
                assert text == "xx" + "yy" * (seq - 1)
                return text, svc.doc_mesh.capture("bulk"), {
                    r: canon(P, svc.room(r).doc_set.get_doc(r))
                    for r in sorted(svc._rooms)}
            finally:
                svc.close()
        same(run)

    def test_scrape_exposes_mesh_families(self, monkeypatch):
        def run(P):
            monkeypatch.setenv("AMTPU_PARALLEL_LANES", "1")
            monkeypatch.setenv("AMTPU_TICK_PIPELINE", "1")
            svc = P.SyncService(P.ServiceConfig(shard_lanes=4))
            try:
                clients = []
                for i in range(4):
                    base = _seed(P, svc, f"sc-{i}")
                    clients.append(_Client(P, svc, f"sc-{i}-t0",
                                           f"sc-{i}", base=base))
                for step in range(6):
                    for j, c in enumerate(clients):
                        c.edit("k", f"v{step}-{j}")
                    for c in clients:
                        c.pump()
                    svc.tick()
                assert svc._tick_executor is not None
                page = svc.scrape()
                assert "amtpu_mesh_workers" in page
                assert "amtpu_mesh_barriers_total" in page
                return scrape_nt(page)
            finally:
                svc.close()
        same(run)

    def test_one_card_lanes_tick_sequentially_by_default(self,
                                                         monkeypatch):
        """The port counts devices, not lanes: four lanes on one device
        tick sequentially unless AMTPU_TICK_PIPELINE=1 (the JAX
        package's four lanes on four virtual devices fan out)."""
        monkeypatch.delenv("AMTPU_PARALLEL_LANES", raising=False)
        monkeypatch.delenv("AMTPU_TICK_PIPELINE", raising=False)
        svc = TP.SyncService(TP.ServiceConfig(shard_lanes=4))
        assert TP.parallel.lane_devices(svc._shard_lanes) == 1
        assert svc._mesh_executor() is None
        monkeypatch.setenv("AMTPU_TICK_PIPELINE", "1")
        try:
            assert svc._mesh_executor() is not None
        finally:
            svc.close()
        jsvc = JP.SyncService(JP.ServiceConfig(shard_lanes=4))
        monkeypatch.delenv("AMTPU_TICK_PIPELINE")
        try:
            assert jsvc._mesh_executor() is not None
        finally:
            jsvc.close()


# --------------------------------------------------------------------------
# tests/test_lineage.py:392-444
# --------------------------------------------------------------------------


def test_service_postmortem_names_the_quarantine_hop():
    def run(P):
        led = P.lineage.enable(rate=1, capacity=256)
        led.clear()
        svc = P.SyncService(P.ServiceConfig())
        doc = P.am.change(P.init("server-pm"),
                          lambda d: d.__setitem__("t", P.Text("x")))
        svc.seed_doc("room-pm", doc)
        room = svc.room("room-pm")
        obj_id = next(op["obj"] for c in P.am.get_all_changes(doc)
                      for op in c["ops"] if op["action"] == "makeText")
        stuck = {"actor": "ghost", "seq": 2, "deps": {"never": 9},
                 "ops": [{"action": "set", "obj": obj_id, "key": "ghost:1",
                          "value": "!"}]}
        led.record("ghost", 2, "origin", site="ghost")
        room.gate.deliver("room-pm", [stuck], sender="t-ghost")
        assert room.gate.quarantined("room-pm") == 1
        dump = json.loads(json.dumps(svc.describe(), default=str))
        lin = dump["lineage"]
        assert lin["schema"] == "amtpu-lineage-v1"
        entry = next(e for e in lin["stuck"]
                     if e["actor"] == "ghost" and e["seq"] == 2)
        assert entry["mid_flight"] is True
        assert entry["stuck_at"] == "quar/park"
        assert entry["hops"][-1][0] == "quar/park"
        assert lin["stats"]["hops_recorded"] >= 2
        # the module-level wrapper the service calls
        assert any(e["stuck_at"] == "quar/park"
                   for e in P.lineage.postmortem(k=8)["stuck"])
        P.lineage.disable()
        return describe_nt(dump)
    same(run)


def test_service_scrape_includes_lineage_families():
    def run(P):
        led = P.lineage.enable(rate=1, capacity=64)
        led.clear()
        led.record("a", 1, "origin", site="a", t_ns=10)
        led.record("a", 1, "commit", site="svc:r", t_ns=2_000_010)
        svc = P.SyncService(P.ServiceConfig())
        page = svc.scrape()
        P.prom.validate_prom(page)
        assert "amtpu_lineage_visibility_ms" in page
        P.lineage.disable()
        return scrape_nt(page)
    same(run)


def test_lineage_postmortem_is_none_without_a_ledger():
    def run(P):
        P.lineage.disable()
        P.lineage._ledger = None
        assert P.lineage.postmortem() is None
        svc = P.SyncService()
        assert "lineage" not in svc.describe()
        return P.lineage.postmortem(k=3)
    same(run)


# --------------------------------------------------------------------------
# tests/test_wire_format.py: the service parts
# --------------------------------------------------------------------------


def test_approx_msg_bytes_counts_frames():
    from test_torch_wire_format import _valid_frame_bytes

    def run(P):
        frame = P.wf.WireFrame(_valid_frame_bytes())
        approx = P.budget_mod.approx_msg_bytes
        with_frame = approx({"docId": "d", "clock": {}, "wire": frame})
        assert with_frame > frame.nbytes
        bare = approx({"docId": "d", "clock": {}})
        assert bare < frame.nbytes
        return with_frame, bare
    same(run)


def test_service_session_over_frames():
    """tests/test_wire_format.py `_service_session` (its binary leg, the
    port's only wire): 6 tenants, 3 rounds of 40-char bulk edits, grouped
    tick admission and hub fan-out. Sizes are the JAX test's: frames
    take the wire only past the op gate."""
    def run(P):
        svc = P.SyncService(P.ServiceConfig(default_budget=P.TenantBudget(
            ops_per_tick=4096, bytes_per_tick=1 << 20, inbox_cap=64)))
        doc0 = P.am.change(P.init("origin"),
                           lambda d: d.__setitem__("t", P.Text("seed")))
        base = P.am.get_all_changes(doc0)
        pin(9)
        svc.seed_doc("room", P.am.apply_changes(P.init("server"), base))
        clients = [_Client(P, svc, f"t{i}", "room") for i in range(6)]
        for i, c in enumerate(clients):
            c.ds.set_doc("room", P.am.apply_changes(P.init(f"c-{i}"),
                                                    base))
        _settle(svc, clients, max_ticks=400)
        rng = random.Random(42)
        for _r in range(3):
            for c in clients:
                text = "".join(chr(97 + rng.randrange(26))
                               for _ in range(40))
                c.ds.set_doc("room", P.am.change(
                    c.doc(), lambda d: d["t"].insert_at(0, *list(text))))
                c.pump()
            svc.tick()
        _settle(svc, clients, max_ticks=400)
        server_doc = svc.room("room").doc_set.get_doc("room")
        docs = [server_doc] + [c.doc() for c in clients]
        assert len({canon(P, d) for d in docs}) == 1
        frames = sum(1 for c in clients for _d, env in c.log
                     if isinstance(env.get("payload"), dict)
                     and env["payload"].get("wire") is not None)
        assert frames > 0, "no frame took the wire"
        return ([P.am.save(d) for d in docs],
                P.am.to_json(server_doc)["t"],
                svc.stats["admitted_ops"],
                record(P, svc, clients, rooms=("room",)))
    same(run)


# --------------------------------------------------------------------------
# the device binding and the import boundary
# --------------------------------------------------------------------------


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_service_without_a_card_raises_at_its_first_room(no_card):
    svc = T.service.SyncService()          # nothing device-bound yet
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.room("r")
    assert svc._rooms == {}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.seed_doc("r", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.connect("t", "r", lambda env: None)


def test_service_lanes_and_mesh_without_a_card_raise(no_card):
    for kw in ({"shard_lanes": 2}, {"shard_lanes": -1},
               {"residency_budget_bytes": 1 << 20}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.service.SyncService(T.service.ServiceConfig(**kw))


def test_cpu_binding_puts_every_room_lane_and_mesh_doc_on_the_cpu(
        tmp_path):
    svc = TP.SyncService(TP.ServiceConfig(
        shard_lanes=2, residency_budget_bytes=1 << 30,
        residency_spill_dir=str(tmp_path)))
    base = _seed(TP, svc)
    c = _Client(TP, svc, "a", "r", base)
    c.edit("k", 1)
    svc.mesh_deliver({"d": _doc_stream("d", 2)})
    _settle(svc, [c])
    assert {str(lane.device) for lane in svc._shard_lanes} == {"cpu"}
    assert svc.room("r").doc_set.backend.device == "cpu"
    core = T.frontend.get_backend_state(
        svc.room("r").doc_set.get_doc("r"))._core
    assert str(core.device) == "cpu"
    lane = svc.doc_mesh.lane_of("d")
    assert lane.docs["d"].device.type == "cpu"
    # devices are written as their names: plain JSON, no default=
    json.dumps(svc.describe())
    json.dumps(svc.shard_map())
    svc.close()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("module", [
    "service/__init__.py", "service/budget.py", "service/server.py",
    "federation/__init__.py", "federation/causal.py",
    "federation/fabric.py", "federation/link.py", "federation/placement.py",
    "ops/scan.py", "obs/prom.py", "obs/lineage.py",
    "engine/learned_index.py"])
def test_module_imports_neither_jax_nor_the_jax_package(module):
    path = ROOT_DIR / "automerge_tpu_torch" / module
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "automerge_tpu"), (module, name)


def test_service_and_federation_import_clean_in_a_fresh_process():
    import subprocess
    import sys
    code = ("import sys, automerge_tpu_torch.service, "
            "automerge_tpu_torch.federation, automerge_tpu_torch.ops.scan;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'automerge_tpu')];"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT_DIR,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_exports_match_the_jax_package():
    for name in ("service", "federation"):
        jm = import_module(f"automerge_tpu.{name}")
        tm = import_module(f"automerge_tpu_torch.{name}")
        want = {k for k in vars(jm) if not k.startswith("_")
                and not isinstance(vars(jm)[k], type(json))}
        got = {k for k in vars(tm) if not k.startswith("_")
               and not isinstance(vars(tm)[k], type(json))}
        assert got == want, name
        assert getattr(tm, "__all__", None) == getattr(jm, "__all__", None)


# --------------------------------------------------------------------------
# on the card: lanes of one card pipelined against the sequential tick
# --------------------------------------------------------------------------


@pytest.mark.cuda
def test_pipelined_lanes_on_one_card_equal_the_sequential_run(
        monkeypatch):
    """Two lanes (two streams of the card) with AMTPU_TICK_PIPELINE=1:
    each lane's grouped delivery runs on its stream, joined both ways
    with the tick's stream and no host synchronize, so the hub's fan-out
    reads committed documents; the saves equal the sequential run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    P = SimpleNamespace(**vars(TP))
    P.ServiceConfig = lambda **kw: T.service.ServiceConfig(**kw)
    P.SyncService = lambda cfg=None: T.service.SyncService(
        cfg or P.ServiceConfig())
    P.DocSet = T.sync.DocSet
    P.init = lambda actor=None: T.init({"actorId": actor} if actor else {})

    def session(flag):
        pin()
        monkeypatch.setenv("AMTPU_TICK_PIPELINE", flag)
        monkeypatch.setenv("AMTPU_PARALLEL_LANES", flag)
        svc = P.SyncService(P.ServiceConfig(shard_lanes=2))
        rooms = [f"cu-{i}" for i in range(4)]
        clients = []
        for room_id in rooms:
            base = _seed(P, svc, room_id)
            clients += [_Client(P, svc, f"{room_id}-t{j}", room_id, base)
                        for j in range(2)]
        assert len({svc.room(r).lane.index for r in rooms}) == 2
        _settle(svc, clients)
        for step in range(6):
            for j, c in enumerate(clients):
                c.ds.set_doc(c.room_id, P.am.change(
                    c.doc(), lambda d: d["t"].insert_at(
                        0, *f"{step}-{j}-" * 8)))
                c.pump()
            svc.tick()
        _settle(svc, clients)
        ex = svc._mesh_executor()
        fanned = ex is not None and ex.stats["barriers"] > 0
        out = {r: P.am.save(svc.room(r).doc_set.get_doc(r)) for r in rooms}
        assert all(str(T.frontend.get_backend_state(
            svc.room(r).doc_set.get_doc(r))._core.device).startswith("cuda")
            for r in rooms)
        svc.close()
        return out, fanned

    seq, seq_fanned = session("0")
    par, par_fanned = session("1")
    assert not seq_fanned and par_fanned
    assert par == seq
