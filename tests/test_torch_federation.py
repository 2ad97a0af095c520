"""The port's federation tier (automerge_tpu_torch/federation/) against the
JAX package's, on the CPU.

Every scenario runs twice: through the JAX package, whose regions are
``SyncService(ServiceConfig(region=...))`` on its default backend, and
through the port, whose regions are the same services with
``device="cpu"`` and whose documents are bound to
``backend.backend_for("cpu")``. Both packages' uuid factories are pinned
before each run and reset after each test. Each run must pass the JAX
test's own assertions, and the two runs must agree with zero tolerance:
every region's room documents (`to_json`, `save()` bytes and the
canonical replay save), the rounds each fabric took to quiesce, every
link's ladder, counters and transitions (`describe()`), the group
clocks, the WAN chaos links' statistics, and each service's `describe()`
and scrape page less the timing and device-specific fields that
tests/test_torch_service.py names (`describe_nt`, `scrape_nt`).

Twins of tests/test_federation.py, less the two group-token wire tests
that tests/test_torch_wire_format.py holds already
(`test_group_token_rides_the_manifest`,
`test_group_token_validation_is_typed`); plus the `GroupClock` surface
(`table()` after mints and observations, its stats) and the device
binding of a federated region (without a card a region's first room
raises; it never lands on the CPU).
"""

import itertools
import json
from importlib import import_module
from types import SimpleNamespace

import pytest
import torch

import automerge_tpu as J
import automerge_tpu_torch as T
from automerge_tpu import _uuid as j_uuid
from automerge_tpu_torch import _uuid as t_uuid
from test_torch_service import describe_nt, scrape_nt

CPU = T.backend.backend_for("cpu")


def _pkg(am):
    mod = lambda name: import_module(f"{am.__name__}.{name}")  # noqa: E731
    service = mod("service")
    fed = mod("federation")
    res = mod("resilience")
    port = am is T

    def config(**kw):
        return service.ServiceConfig(**kw, **({"device": "cpu"}
                                              if port else {}))

    return SimpleNamespace(
        am=am, port=port, fed=fed, res=res, lineage=mod("obs.lineage"),
        prom=mod("obs.prom"), learned=mod("engine.learned_index"),
        ServiceConfig=config,
        SyncService=service.SyncService,
        FederatedRegion=fed.FederatedRegion, GroupClock=fed.GroupClock,
        RegionPlacement=fed.RegionPlacement,
        connect_regions=fed.connect_regions,
        init=lambda actor=None: am.init(
            ({"actorId": actor} if actor else {})
            | ({"backend": CPU} if port else {})))


JP, TP = _pkg(J), _pkg(T)


def pin():
    for m in (j_uuid, t_uuid):
        c = itertools.count(1)
        m.set_factory(lambda c=c: f"00000000-0000-0000-0000-{next(c):012d}")


@pytest.fixture(autouse=True)
def _isolated():
    """Pinned uuids and no lineage ledger in either package; teardown
    leaves both uuid factories at their defaults. (Each run's
    describe() and scrape carry process-wide state — the learned-index
    counters, a retained lineage ledger — which earlier test files of
    the same process may have left behind.)"""
    pin()
    for P in (JP, TP):
        P.lineage.disable()
        P.lineage._ledger = None
    yield
    for P in (JP, TP):
        P.lineage.disable()
        P.lineage.clear()
    j_uuid.reset()
    t_uuid.reset()


def same(fn):
    out = []
    for P in (JP, TP):
        pin()
        P.learned.reset_stats()
        out.append(fn(P))
    j, t = out
    assert t == j
    return t


# ---------------------------------------------------------------------------
# helpers (tests/test_federation.py's, over package P)
# ---------------------------------------------------------------------------

def _mk_fabric(P, names=("us", "eu", "ap"), profile="cross_region", seed=3,
               **region_kw):
    regions = {n: P.FederatedRegion(P.SyncService(P.ServiceConfig(region=n)),
                                    n, **region_kw) for n in names}
    chaos = {}
    s = seed
    names = list(names)
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            a, b = names[i], names[j]
            _, _, fwd, rev = P.connect_regions(
                regions[a], regions[b], profile=profile, seed=s)
            chaos[(a, b)] = (fwd, rev)
            s += 10
    return regions, chaos


def _seed_room(P, regions, room_id="room0"):
    doc = P.am.change(P.init(f"{room_id}-origin"),
                      lambda d: d.__setitem__("k", 0))
    base = P.am.get_all_changes(doc)
    for r in regions.values():
        r.svc.seed_doc(room_id, P.am.apply_changes(
            P.init(f"srv-{r.name}-{room_id}"), base))


def _pump(regions, n=1):
    for _ in range(n):
        for r in regions.values():
            r.pump()
            r.svc.tick()


def _edit(P, regions, region, room_id, key, val):
    ds = regions[region].svc.room(room_id).doc_set
    ds.set_doc(room_id, P.am.change(ds.get_doc(room_id),
                                    lambda d: d.__setitem__(key, val)))


def _settle(regions, max_rounds=800):
    for i in range(max_rounds):
        _pump(regions)
        if i > 5 and all(r.idle() for r in regions.values()):
            return i
    raise AssertionError(
        f"fabric failed to quiesce in {max_rounds} rounds: "
        f"{ {n: r.lag_table() for n, r in regions.items()} }")


def _canonical_save(P, doc):
    chs = sorted(P.am.get_all_changes(doc),
                 key=lambda c: (c["actor"], c["seq"]))
    return P.am.save(P.am.apply_changes(P.init("canon-probe"), chs))


def _histories(P, doc):
    return sorted(json.dumps(c, sort_keys=True)
                  for c in P.am.get_all_changes(doc))


def _assert_converged(P, regions, room_id="room0"):
    docs = {n: r.svc.room(room_id).doc_set.get_doc(room_id)
            for n, r in regions.items()}
    assert all(d is not None for d in docs.values()), docs
    saves = {n: _canonical_save(P, d) for n, d in docs.items()}
    assert len(set(saves.values())) == 1, \
        f"saves diverged: { {n: len(s) for n, s in saves.items()} }"
    hists = {n: _histories(P, d) for n, d in docs.items()}
    ref = next(iter(hists.values()))
    assert all(h == ref for h in hists.values()), "histories diverged"
    return next(iter(saves.values()))


def _residual_lag(regions):
    return sum(entry["lag_tokens"] for r in regions.values()
               for entry in r.lag_table().values())


def fabric_state(P, regions, chaos=(), rooms=("room0",)):
    """Everything a fabric run is held to (see the module note)."""
    out = {}
    for n, r in sorted(regions.items()):
        for room_id in rooms:
            doc = r.svc.room(room_id).doc_set.get_doc(room_id)
            out[f"{n}:{room_id}"] = (
                json.dumps(P.am.to_json(doc), sort_keys=True),
                P.am.save(doc))
        out[f"{n}:fed"] = json.loads(json.dumps(r.describe(), default=str))
        out[f"{n}:clock"] = r.clock.table()
        out[f"{n}:describe"] = describe_nt(r.svc.describe())
        out[f"{n}:scrape"] = scrape_nt(r.svc.scrape())
    for key, (fwd, rev) in sorted(dict(chaos).items()):
        out[f"chaos:{key}"] = (dict(fwd.stats), dict(rev.stats))
    return out


# ---------------------------------------------------------------------------
# GroupClock: O(groups) causal metadata
# ---------------------------------------------------------------------------

def test_group_clock_mints_monotone_per_room():
    def run(P):
        gc = P.GroupClock("us")
        assert gc.mint("a") == ["us", "a", 1]
        assert gc.mint("a") == ["us", "a", 2]
        assert gc.mint("b") == ["us", "b", 1]
        assert gc.head("a") == 2 and gc.head("b") == 1
        assert gc.head("never") == 0
        return gc.table(), gc.stats
    same(run)


def test_group_clock_observe_is_idempotent_max_merge():
    def run(P):
        gc = P.GroupClock("eu")
        got = [gc.observe("a", "us", 3), gc.observe("a", "us", 3),
               gc.observe("a", "us", 1), gc.observe("a", "us", 7)]
        assert got == [True, False, False, True]
        assert gc.seen("a", "us") == 7
        assert gc.stats == {"minted": 0, "observed": 2, "stale": 2}
        return gc.table()
    same(run)


def test_group_clock_state_is_o_groups_not_o_peers():
    def run(P):
        gc = P.GroupClock("hub")
        for i in range(1000):
            gc.observe(f"room-{i % 3}", ("us", "eu")[i % 2], i + 1)
            gc.mint(f"room-{i % 3}")
        table = gc.table()
        assert len(table) == 3
        assert all(set(v) <= {"us", "eu", "hub"} for v in table.values())
        return table, gc.stats
    same(run)


def test_group_clock_rejects_bad_region():
    def run(P):
        for bad in ("", None, 3):
            with pytest.raises(ValueError):
                P.GroupClock(bad)
        return True
    same(run)


def test_group_clock_table_names_own_mints_and_observed_origins():
    """The describe() feed: own mints under this region's name, every
    observed origin beside them, per room; seen() of an unobserved pair
    is 0."""
    def run(P):
        gc = P.GroupClock("ap")
        gc.mint("x")
        gc.mint("x")
        gc.observe("x", "us", 4)
        gc.observe("y", "eu", 1)
        gc.observe("y", "eu", 1)
        assert gc.table() == {"x": {"ap": 2, "us": 4}, "y": {"eu": 1}}
        assert gc.seen("x", "eu") == 0 and gc.seen("y", "eu") == 1
        assert gc.stats == {"minted": 2, "observed": 2, "stale": 1}
        return gc.table()
    same(run)


# ---------------------------------------------------------------------------
# WAN chaos profiles
# ---------------------------------------------------------------------------

def test_wan_profiles_are_named_and_asymmetric():
    def run(P):
        assert set(P.res.WAN_PROFILES) == {"wan", "wan_partitioned",
                                           "cross_region"}
        out = {}
        for name in P.res.WAN_PROFILES:
            fwd = P.res.wan_profile(name, "fwd")
            rev = P.res.wan_profile(name, "rev")
            assert fwd != rev
            assert fwd["bandwidth"] > rev["bandwidth"]
            out[name] = (fwd, rev)
        with pytest.raises(KeyError):
            P.res.wan_profile("lan")
        return out
    same(run)


def test_wan_pair_is_deterministic():
    def run(P):
        def once():
            got = []
            fwd, _rev = P.res.wan_pair(got.append, lambda m: None,
                                       profile="wan", seed=42)
            for i in range(200):
                fwd.send({"i": i})
                fwd.pump()
            fwd.drain(200)
            return got, dict(fwd.stats)
        a_msgs, a_stats = once()
        b_msgs, b_stats = once()
        assert a_msgs == b_msgs and a_stats == b_stats
        assert a_stats["dropped"] > 0 or a_stats["delayed"] > 0
        return a_msgs, a_stats
    same(run)


def test_bandwidth_cap_throttles_without_dropping():
    def run(P):
        got = []
        link = P.res.ChaosLink(got.append, seed=1, bandwidth=64)
        for _ in range(8):
            link.send({"payload": "x" * 100})
        rounds = 0
        while not link.idle and rounds < 100:
            link.pump()
            rounds += 1
        assert len(got) == 8
        assert link.stats["throttled"] > 0
        assert rounds >= 8
        return rounds, dict(link.stats)
    same(run)


def test_bandwidth_cap_first_frame_always_passes():
    def run(P):
        got = []
        link = P.res.ChaosLink(got.append, seed=1, bandwidth=1)
        link.send({"payload": "y" * 1000})
        link.pump()
        assert len(got) == 1
        return dict(link.stats)
    same(run)


# ---------------------------------------------------------------------------
# RegionPlacement
# ---------------------------------------------------------------------------

def test_region_placement_deterministic_and_movable():
    def run(P):
        p = P.RegionPlacement(["us", "eu", "ap"])
        q = P.RegionPlacement(["us", "eu", "ap"])
        rooms = [f"room-{i}" for i in range(30)]
        homes = [p.home(r) for r in rooms]
        assert homes == [q.home(r) for r in rooms]
        spread = p.spread(rooms)
        assert sum(spread.values()) == 30 and len(spread) == 3
        victim = rooms[0]
        before, epoch0 = p.home(victim), p.epoch
        target = next(n for n in ("us", "eu", "ap") if n != before)
        p.move(victim, target)
        assert p.home(victim) == target
        assert p.table() == {victim: target}
        assert p.epoch == epoch0 + 1
        p.move(victim, before)
        assert p.table() == {}
        return homes, spread, p.epoch
    same(run)


def test_region_placement_rejects_unknowns():
    def run(P):
        with pytest.raises(ValueError):
            P.RegionPlacement([])
        with pytest.raises(ValueError):
            P.RegionPlacement(["us", "us"])
        with pytest.raises(ValueError):
            P.RegionPlacement(["us"], overrides={"r": "mars"})
        p = P.RegionPlacement(["us", "eu"])
        with pytest.raises(ValueError):
            p.move("r", "mars")
        return True
    same(run)


# ---------------------------------------------------------------------------
# federation: convergence, partition, heal
# ---------------------------------------------------------------------------

def test_two_regions_converge_over_wan_chaos():
    def run(P):
        regions, chaos = _mk_fabric(P, ("us", "eu"), seed=7)
        _seed_room(P, regions)
        _edit(P, regions, "us", "room0", "from_us", 1)
        _edit(P, regions, "eu", "room0", "from_eu", 2)
        rounds = _settle(regions)
        canon = _assert_converged(P, regions)
        assert _residual_lag(regions) == 0
        assert regions["eu"].clock.seen("room0", "us") > 0
        assert regions["us"].clock.seen("room0", "eu") > 0
        return rounds, canon, fabric_state(P, regions, chaos)
    same(run)


def test_remote_region_can_introduce_a_room():
    def run(P):
        regions, chaos = _mk_fabric(P, ("us", "eu"), seed=11)
        _pump(regions, 3)
        doc = P.am.change(P.init("late-room"),
                          lambda d: d.__setitem__("v", 9))
        regions["eu"].svc.seed_doc("late", doc)
        rounds = _settle(regions)
        got = regions["us"].svc.room("late").doc_set.get_doc("late")
        assert got is not None and P.am.to_json(got)["v"] == 9
        return rounds, fabric_state(P, regions, chaos, rooms=("late",))
    same(run)


def test_three_region_partition_heal_byte_identical():
    def run(P):
        regions, chaos = _mk_fabric(P, seed=3)
        _seed_room(P, regions)
        _pump(regions, 30)
        fwd, rev = chaos[("us", "eu")]
        fwd.partition()
        rev.partition()
        for k in range(5):
            for n in regions:
                _edit(P, regions, n, "room0", f"{n}{k}", k)
            _pump(regions, 8)
        _pump(regions, 120)
        us_eu = regions["us"].links["eu"]
        eu_us = regions["eu"].links["us"]
        assert us_eu.state == "partitioned" and eu_us.state == "partitioned"
        assert us_eu.transitions.get("ok->partitioned") == 1
        page = regions["us"].svc.scrape()
        assert 'amtpu_region_link_up{peer="eu",region="us"} 0' in page
        events = [e for e in regions["us"].svc._events
                  if e["event"] == "fed_state"]
        assert any(e["to"] == "partitioned" and e["link"] == "us->eu"
                   for e in events)
        mid = fabric_state(P, regions, chaos)
        fwd.heal()
        rev.heal()
        rounds = _settle(regions)
        canon = _assert_converged(P, regions)
        assert _residual_lag(regions) == 0
        assert us_eu.transitions.get("partitioned->healing") == 1
        assert us_eu.transitions.get("healing->ok") == 1
        assert us_eu.chan.stats["revives"] >= 1
        assert eu_us.chan.stats["revives"] >= 1
        assert us_eu.chan.epoch >= 1 and eu_us.chan.epoch >= 1
        return mid, rounds, canon, fabric_state(P, regions, chaos)
    same(run)


def test_partition_buffers_are_two_tier_and_bounded():
    def run(P):
        regions, chaos = _mk_fabric(P, ("us", "eu"), seed=19, max_buffer=4)
        _seed_room(P, regions)
        _pump(regions, 30)
        fwd, rev = chaos[("us", "eu")]
        fwd.partition()
        rev.partition()
        _edit(P, regions, "us", "room0", "tripwire", 1)
        _pump(regions, 120)
        link = regions["us"].links["eu"]
        assert link.state == "partitioned"
        for k in range(12):
            _edit(P, regions, "us", "room0", f"burst{k}", k)
            _pump(regions, 1)
        assert len(link._buf_data) <= 4
        assert link.stats["buffer_dropped"] > 0
        assert len(link._buf_adverts) <= 1
        mid = (len(link._buf_data), len(link._buf_adverts),
               dict(link.stats))
        fwd.heal()
        rev.heal()
        rounds = _settle(regions)
        canon = _assert_converged(P, regions)
        assert _residual_lag(regions) == 0
        return mid, rounds, canon, fabric_state(P, regions, chaos)
    same(run)


def test_region_killed_and_rejoined_bootstraps_from_snapshot():
    def run(P):
        regions, chaos = _mk_fabric(P, ("us", "eu"), seed=23)
        _seed_room(P, regions)
        regions["us"].svc.room("room0").hub.snapshot_min_changes = 4
        for k in range(8):
            _edit(P, regions, "us", "room0", f"pre{k}", k)
        _settle(regions)
        _assert_converged(P, regions)
        fwd, rev = chaos[("us", "eu")]
        fwd.partition()
        rev.partition()
        _edit(P, regions, "us", "room0", "during_cut", 1)
        _pump(regions, 120)
        assert regions["us"].links["eu"].state == "partitioned"
        regions.pop("eu")
        fresh = P.FederatedRegion(
            P.SyncService(P.ServiceConfig(region="eu")), "eu")
        fresh_link = fresh.link_to("us", seed=77)
        fwd._deliver = fresh_link.on_raw
        fresh_link.attach_transport(rev)
        regions["eu"] = fresh
        fresh.svc.room("room0")
        fwd.heal()
        rev.heal()
        rounds = _settle(regions)
        canon = _assert_converged(P, regions)
        doc = fresh.svc.room("room0").doc_set.get_doc("room0")
        assert len(P.am.get_all_changes(doc)) >= 9
        if P.port:
            core = P.am.frontend.get_backend_state(doc)._core
            assert str(core.device) == "cpu"
        return rounds, canon, fabric_state(P, regions, chaos)
    same(run)


# ---------------------------------------------------------------------------
# observability: scrape, describe, lineage across regions
# ---------------------------------------------------------------------------

def test_scrape_exports_region_families_prom_clean():
    def run(P):
        regions, chaos = _mk_fabric(P, seed=31)
        _seed_room(P, regions)
        _edit(P, regions, "us", "room0", "x", 1)
        _settle(regions)
        page = regions["us"].svc.scrape()
        report = P.prom.validate_prom(page)
        assert not report.get("errors"), report
        for fam in ("amtpu_region_lag_tokens", "amtpu_region_link_up",
                    "amtpu_region_link_state",
                    "amtpu_region_shipped_total",
                    "amtpu_region_group_tokens_minted_total"):
            assert fam in page, fam
        assert 'peer="eu"' in page and 'peer="ap"' in page
        assert 'amtpu_region_lag_tokens{peer="eu",region="us"} 0' in page
        return scrape_nt(page), fabric_state(P, regions, chaos)
    same(run)


def test_describe_carries_the_federation_block():
    def run(P):
        regions, chaos = _mk_fabric(
            P, ("us", "eu"), seed=37,
            placement=P.RegionPlacement(["us", "eu"]))
        _seed_room(P, regions)
        _edit(P, regions, "us", "room0", "minted", 1)
        _settle(regions)
        dump = regions["us"].svc.describe()
        json.dumps(dump)                   # no default=: plain JSON
        fed = dump["federation"]
        assert fed["region"] == "us"
        assert fed["links"]["eu"]["state"] == "ok"
        assert fed["links"]["eu"]["lag_tokens"] == 0
        assert fed["group_clock"]["minted"] >= 1
        assert "placement_epoch" in fed
        return describe_nt(dump), fabric_state(P, regions, chaos)
    same(run)


def _chain_shape(chain):
    return {"actor": chain["actor"], "seq": chain["seq"],
            "hops": [list(h[:2]) for h in chain["hops"]]}


def test_lineage_chain_spans_three_regions_with_dwell():
    def run(P):
        P.lineage.enable(rate=1, capacity=2048)
        regions, chaos = _mk_fabric(P, seed=41)
        _seed_room(P, regions)
        _pump(regions, 20)
        _edit(P, regions, "us", "room0", "traced", 1)
        _settle(regions)
        _assert_converged(P, regions)
        led = P.lineage.ledger()
        spanning = []
        for chain in led.chains():
            stages = [h[0] for h in chain["hops"]]
            if "fed/ship" in stages and "fed/recv" in stages \
                    and chain["actor"].startswith("srv-us"):
                spanning.append(chain)
        assert spanning, "no chain crossed a region boundary"
        best = max(spanning, key=lambda c: len(c["hops"]))
        ship_sites = {h[1] for h in best["hops"] if h[0] == "fed/ship"}
        recv_sites = {h[1] for h in best["hops"] if h[0] == "fed/recv"}
        assert ship_sites & {"us->eu", "us->ap"}, ship_sites
        assert recv_sites & {"us->eu", "us->ap"}, recv_sites
        assert all("->" in s for s in ship_sites | recv_sites)
        commit_sites = {h[1] for h in best["hops"] if h[0] == "commit"}
        assert commit_sites & {"svc:eu/room0", "svc:ap/room0"}, \
            commit_sites
        ts = [h[2] for h in best["hops"]]
        assert all(b >= a for a, b in zip(ts, ts[1:]))
        agg = led.telemetry.span_aggregates()
        fed_dwells = sorted(k for k in agg if k[0] == "lineage"
                            and k[1].startswith("dwell:fed/"))
        assert fed_dwells, sorted(agg)
        return ([_chain_shape(c) for c in led.chains()], fed_dwells,
                fabric_state(P, regions, chaos))
    same(run)


def test_stuck_postmortem_names_the_partitioned_link():
    def run(P):
        P.lineage.enable(rate=1, capacity=2048)
        regions, chaos = _mk_fabric(P, seed=43)
        _seed_room(P, regions)
        _pump(regions, 20)
        for pair in (("us", "eu"), ("us", "ap")):
            key = pair if pair in chaos else (pair[1], pair[0])
            for edge in chaos[key]:
                edge.partition()
        _edit(P, regions, "us", "room0", "tripwire", 1)
        _pump(regions, 120)
        assert regions["us"].links["eu"].state == "partitioned"
        assert regions["us"].links["ap"].state == "partitioned"
        _edit(P, regions, "us", "room0", "wedged", 1)
        _pump(regions, 10)
        dump = regions["us"].svc.describe()
        stuck = dump["lineage"]["stuck"]
        assert stuck, "nothing mid-flight despite a cut fabric"
        assert stuck[0]["mid_flight"] is True
        buffered = [s for s in stuck if s["stuck_at"] == "fed/buffer"]
        assert buffered, [s["stuck_at"] for s in stuck]
        assert buffered[0]["stuck_site"] in ("us->eu", "us->ap")
        assert all(len(h) >= 3 for h in buffered[0]["hops"])
        return describe_nt(dump), fabric_state(P, regions, chaos)
    same(run)


# ---------------------------------------------------------------------------
# the device binding
# ---------------------------------------------------------------------------

def test_federated_region_without_a_card_raises_at_its_first_room(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = T.federation.FederatedRegion(
        T.service.SyncService(T.service.ServiceConfig(region="us")))
    b = T.federation.FederatedRegion(
        T.service.SyncService(T.service.ServiceConfig(region="eu")))
    T.federation.connect_regions(a, b, seed=1)
    assert a.pump() == 0 and a.svc._rooms == {}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        a.svc.room("room0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        b._deliver_msg("us", "room0", {"docId": "room0", "clock": {}})
    assert b.svc._rooms == {}
