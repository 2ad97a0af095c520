"""The port's resilience tier (automerge_tpu_torch/resilience/) against
the JAX package's, on the CPU.

Each scenario of tests/test_resilience.py runs through both packages —
the JAX package on its default backend, the port with its DocSets and
documents on `backend.backend_for("cpu")` — and must pass the JAX test's
own assertions in each, with equal results: the typed rejection and the
untouched document and clock for every malformed-message fuzz case, the
quarantine's bounds, stats and releases, the chaos link's and the retry
channel's behaviour, revive epochs, idempotent hub redelivery on both
backends, and graduation under redelivery. Tolerance is zero.

The fault schedules are the JAX package's draw for draw: `ChaosLink` and
`ResilientChannel` take numpy's `default_rng(seed)` in both packages, so
the same seed drops, duplicates, delays and reorders the same messages
and jitters the same retransmits (held for three seeds).
"""

import copy
import json

import pytest

import automerge_tpu as J

from test_torch_sync import (  # noqa: F401  (pinned_uuids: a fixture)
    CPU, JP, TP, norm, pinned_uuids, same,
)


def _mkdoc(P, key="x", value=1, actor="alice", backend=None):
    """tests/test_resilience.py `_mkdoc`: one change on a fresh doc (the
    port's on the CPU backend unless `backend` names another)."""
    am = P.am
    if backend is None:
        doc = P.init(actor)
    else:
        doc = P.Frontend.init({"actorId": actor, "backend": backend})
    return am.change(doc, lambda d: d.__setitem__(key, value))


def _fingerprint(P, doc_set, doc_id="doc"):
    doc = doc_set.get_doc(doc_id)
    if doc is None:
        return None
    state = P.Frontend.get_backend_state(doc)
    return (json.dumps(P.am.to_json(doc), sort_keys=True),
            json.dumps(dict(state.clock), sort_keys=True))


def _raises(P, exc, fn):
    """Call fn; it must raise `exc` (of package P). -> the message."""
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


# ---------------------------------------------------------------------------
# wire-message fuzz: typed rejection, untouched state
# ---------------------------------------------------------------------------

GOOD_CHANGE = {"actor": "bob", "seq": 1, "deps": {},
               "ops": [{"action": "set", "obj": J.ROOT_ID,
                        "key": "y", "value": 2}]}

MALFORMED_MSGS = [
    "not a dict",
    None,
    {},
    {"docId": 7, "clock": {}},
    {"docId": ""},
    {"docId": "doc", "clock": "later"},
    {"docId": "doc", "clock": {3: 1}},
    {"docId": "doc", "clock": {"a": "one"}},
    {"docId": "doc", "clock": {"a": -2}},
    {"docId": "doc", "changes": {"actor": "a"}},
    {"docId": "doc", "changes": ["ch"]},
    {"docId": "doc", "changes": [{}]},
    {"docId": "doc", "changes": [{"actor": "a", "seq": 0, "deps": {},
                                  "ops": []}]},
    {"docId": "doc", "changes": [{"actor": "a", "seq": "1", "deps": {},
                                  "ops": []}]},
    {"docId": "doc", "changes": [{"actor": "a", "seq": 1,
                                  "ops": []}]},
    {"docId": "doc", "changes": [{"actor": "a", "seq": 1, "deps": [],
                                  "ops": []}]},
    {"docId": "doc", "changes": [{"actor": "a", "seq": 1,
                                  "deps": {}}]},
    {"docId": "doc", "changes": [{"actor": "a", "seq": 1, "deps": {},
                                  "ops": ["op"]}]},
    {"docId": "doc", "changes": [{"actor": "a", "seq": 1, "deps": {},
                                  "ops": [{"obj": "o"}]}]},
    {"docId": "doc", "changes": [{"actor": "a", "seq": 1, "deps": {},
                                  "ops": [{"action": "frobnicate",
                                           "obj": "o", "key": "k"}]}]},
    {"docId": "doc", "changes": [{"actor": "a", "seq": 1, "deps": {},
                                  "ops": [{"action": "set",
                                           "key": "k", "value": 1}]}]},
    {"docId": "doc", "changes": [{"actor": "a", "seq": 1, "deps": {},
                                  "ops": [{"action": "set",
                                           "obj": J.ROOT_ID,
                                           "key": "k"}]}]},
    {"docId": "doc", "changes": [{"actor": "a", "seq": 1, "deps": {},
                                  "ops": [{"action": "ins",
                                           "obj": "o", "key": "_head"}]}]},
    {"docId": "doc", "changes": [{"actor": "a", "seq": 1, "deps": {},
                                  "ops": [{"action": "inc",
                                           "obj": J.ROOT_ID, "key": "k",
                                           "value": "fast"}]}]},
    {"docId": "doc", "changes": [{"actor": "a", "seq": 1, "deps": {},
                                  "ops": [{"action": "link",
                                           "obj": J.ROOT_ID, "key": "k",
                                           "value": 9}]}]},
]


@pytest.mark.parametrize("msg", MALFORMED_MSGS,
                         ids=range(len(MALFORMED_MSGS)))
def test_hub_rejects_typed_and_state_untouched(msg):
    def run(P):
        ds = P.DocSet()
        ds.set_doc("doc", _mkdoc(P))
        hub = P.SyncHub(ds)
        handle = hub.add_peer("p", lambda m: None)
        hub.open()
        before = _fingerprint(P, ds)
        why = _raises(P, P.res.ProtocolError,
                      lambda: handle.receive_msg(copy.deepcopy(msg)))
        assert _fingerprint(P, ds) == before
        return why, before
    same(run)


@pytest.mark.parametrize("closed", [False, True])
def test_connection_rejects_typed_both_lifecycles(closed):
    def run(P):
        ds = P.DocSet()
        ds.set_doc("doc", _mkdoc(P))
        conn = P.Connection(ds, lambda m: None)
        conn.open()
        if closed:
            conn.close()
        before = _fingerprint(P, ds)
        whys = []
        for msg in ({"clock": {}},
                    {"docId": "doc",
                     "changes": [{"actor": "a", "seq": 1, "deps": {},
                                  "ops": [{"action": "set",
                                           "obj": J.ROOT_ID,
                                           "key": "k"}]}]}):
            whys.append(_raises(P, P.res.ProtocolError,
                                lambda: conn.receive_msg(msg)))
        assert _fingerprint(P, ds) == before
        return whys
    same(run)


def test_corrected_redelivery_applies_after_rejection():
    def run(P):
        ds = P.DocSet()
        ds.set_doc("doc", _mkdoc(P))
        truncated = dict(GOOD_CHANGE, ops=[{"action": "set",
                                            "obj": J.ROOT_ID, "key": "y"}])
        why = _raises(P, P.res.ProtocolError,
                      lambda: ds.deliver("doc", [truncated]))
        ds.deliver("doc", [copy.deepcopy(GOOD_CHANGE)])
        assert P.am.to_json(ds.get_doc("doc")) == {"x": 1, "y": 2}
        return why, P.am.save(ds.get_doc("doc"))
    same(run)


def test_backend_apply_changes_raises_protocol_error():
    def run(P):
        oracle = P.am.backend.facade
        dev = P.device_backend
        inits = [oracle.init, (lambda: dev.init("cpu")) if P.port
                 else dev.init]
        whys = []
        for make_state in inits:
            state = make_state()
            for bad in ([{"actor": "a"}],
                        [{"actor": "a", "seq": 1, "deps": {},
                          "ops": [{"action": "set", "key": "k",
                                   "value": 1}]}],
                        [{"actor": "a", "seq": 1, "ops": []}],
                        ["nope"], "nope", {"actor": "a"}):
                apply = oracle.apply_changes if make_state is inits[0] \
                    else dev.apply_changes
                whys.append(_raises(P, P.res.ProtocolError,
                                    lambda: apply(state, bad)))
        return whys
    same(run)


def test_semantic_rejection_is_wrapped_at_the_gate():
    def run(P):
        ds = P.DocSet()
        ds.set_doc("doc", _mkdoc(P))
        before = _fingerprint(P, ds)
        ghost = {"actor": "bob", "seq": 1, "deps": {},
                 "ops": [{"action": "set", "obj": "no-such-object",
                          "key": "k", "value": 1}]}
        why = _raises(P, P.res.ProtocolError,
                      lambda: ds.deliver("doc", [ghost]))
        assert _fingerprint(P, ds) == before
        return why
    same(run)


# ---------------------------------------------------------------------------
# quarantine: bounds, eviction stats, release
# ---------------------------------------------------------------------------


def test_quarantine_bounded_with_fifo_eviction_stats():
    def run(P):
        q = P.res.QuarantineQueue(capacity=3)
        evicted = []
        for seq in range(1, 6):
            evicted.append(q.park({"actor": "a", "seq": seq, "deps": {},
                                   "ops": []}, sender=f"s{seq % 2}"))
        assert len(q) == 3
        assert q.stats["parked"] == 5 and q.stats["evicted"] == 2
        assert q.stats["peak"] == 3
        entries = q.entries()
        assert [c["seq"] for c in q.drain()] == [3, 4, 5]
        return evicted, entries, q.stats
    same(run)
    with pytest.raises(ValueError):
        TP.res.QuarantineQueue(capacity=0)
    assert TP.res.DEFAULT_CAPACITY == JP.res.DEFAULT_CAPACITY


def test_quarantine_drop_sender_and_drain_oldest():
    def run(P):
        q = P.res.QuarantineQueue(capacity=8)
        for seq in range(1, 6):
            q.park({"actor": "a", "seq": seq, "deps": {}, "ops": []},
                   sender="x" if seq % 2 else "y")
        dropped = q.drop_sender("x")
        oldest = q.drain_oldest()
        items = q.drain_items()
        return dropped, oldest, items, q.stats, q.drain_oldest()
    same(run)


def test_reparking_a_duplicate_does_not_consume_capacity():
    def run(P):
        q = P.res.QuarantineQueue(capacity=2)
        c = {"actor": "a", "seq": 9, "deps": {}, "ops": []}
        q.park(c)
        q.park(dict(c))
        assert len(q) == 1 and q.stats["parked"] == 1
        return q.stats
    same(run)


def _three_changes(P):
    src = P.init("w")
    for i in range(3):
        src = P.am.change(src, lambda d, i=i: d.__setitem__(f"k{i}", i))
    return P.am.get_all_changes(src)


def test_premature_changes_park_then_release_in_order():
    def run(P):
        c1, c2, c3 = _three_changes(P)
        ds = P.DocSet()
        gate = P.inbound.inbound_gate(ds)
        ds.deliver("doc", [c3])
        ds.deliver("doc", [c2])
        assert ds.get_doc("doc") is None
        assert gate.quarantined("doc") == 2
        items = gate.quarantine_items()
        ds.deliver("doc", [c1])
        assert gate.quarantined("doc") == 0
        assert P.am.to_json(ds.get_doc("doc")) == {"k0": 0, "k1": 1, "k2": 2}
        stats = gate.quarantine_stats("doc")
        assert stats["released"] == 2 and stats["parked"] == 2
        return items, stats, gate.stats, P.am.save(ds.get_doc("doc"))
    same(run)


def test_poisoned_batch_does_not_lose_quarantined_changes():
    def run(P):
        am = P.am
        src = am.change(P.init("w"), lambda d: d.__setitem__("a", 1))
        src = am.change(src, lambda d: d.__setitem__("b", 2))
        c1, c2 = am.get_all_changes(src)
        ds = P.DocSet()
        gate = P.inbound.inbound_gate(ds)
        ds.deliver("doc", [c2])
        assert gate.quarantined("doc") == 1
        bad = {"actor": "z", "seq": 1, "deps": {},
               "ops": [{"action": "set", "obj": "no-such-object",
                        "key": "k", "value": 1}]}
        why = _raises(P, P.res.ProtocolError,
                      lambda: ds.deliver("doc", [c1, bad]))
        assert am.to_json(ds.get_doc("doc")) == {"a": 1, "b": 2}
        assert gate.quarantined("doc") == 0
        return why, gate.stats, am.save(ds.get_doc("doc"))
    same(run)


def test_cobatched_poison_does_not_drop_valid_changes():
    def run(P):
        am = P.am
        src = am.change(P.init("w"), lambda d: d.__setitem__("a", 1))
        (good,) = am.get_all_changes(src)
        poison = {"actor": "z", "seq": 1, "deps": {},
                  "ops": [{"action": "set", "obj": "no-such-object",
                           "key": "k", "value": 1}]}
        ds = P.DocSet()
        w1 = _raises(P, P.res.ProtocolError, lambda: ds.deliver(
            "doc", [copy.deepcopy(good), copy.deepcopy(poison)]))
        assert am.to_json(ds.get_doc("doc")) == {"a": 1}
        dep = {"actor": "y", "seq": 1, "deps": {"z": 1},
               "ops": [{"action": "set", "obj": J.ROOT_ID,
                        "key": "d", "value": 4}]}
        w2 = _raises(P, P.res.ProtocolError, lambda: ds.deliver(
            "doc", [copy.deepcopy(dep), copy.deepcopy(poison)]))
        assert P.inbound.inbound_gate(ds).quarantined("doc") == 1
        return w1, w2
    same(run)


def test_reentrant_delivery_is_not_stranded():
    def run(P):
        am = P.am
        src = am.change(P.init("w"), lambda d: d.__setitem__("a", 1))
        src = am.change(src, lambda d: d.__setitem__("b", 2))
        c1, c2 = am.get_all_changes(src)
        ds = P.DocSet()
        relayed = []

        def relay(doc_id, doc):
            if not relayed:
                relayed.append(True)
                ds.deliver(doc_id, [c2])

        ds.register_handler(relay)
        ds.deliver("doc", [c1])
        assert am.to_json(ds.get_doc("doc")) == {"a": 1, "b": 2}
        assert P.inbound.inbound_gate(ds).quarantined("doc") == 0
        return am.save(ds.get_doc("doc"))
    same(run)


def test_release_absorbs_remote_poison_without_crashing_local_path():
    def run(P):
        am = P.am
        src = am.change(P.init("w"), lambda d: d.__setitem__("a", 1))
        first = am.get_all_changes(src)
        ds = P.DocSet()
        ds.set_doc("doc", _mkdoc(P))
        conn = P.Connection(ds, lambda m: None)
        conn.open()
        poison = {"actor": "z", "seq": 1, "deps": {"w": 1},
                  "ops": [{"action": "set", "obj": "no-such-object",
                           "key": "k", "value": 1}]}
        conn.receive_msg({"docId": "doc", "clock": {"z": 1},
                          "changes": [poison]})
        gate = P.inbound.inbound_gate(ds)
        assert gate.quarantined("doc") == 1
        ds.set_doc("doc", am.apply_changes(ds.get_doc("doc"), first))
        assert am.to_json(ds.get_doc("doc"))["a"] == 1
        assert gate.quarantined("doc") == 0
        assert gate.stats["parked_rejected"] == 1
        return gate.stats, am.save(ds.get_doc("doc"))
    same(run)


def test_aggregate_quarantine_bound_across_attacker_docids():
    def run(P):
        ds = P.DocSet()
        gate = P.inbound.InboundGate(ds, capacity=8, global_capacity=32)
        ds._inbound_gate = gate
        hub = P.SyncHub(ds)
        handle = hub.add_peer("evil", lambda m: None)
        hub.open()
        for i in range(200):
            handle.receive_msg({"docId": f"doc-{i}", "clock": {"g": 2},
                                "changes": [{"actor": "g", "seq": 2,
                                             "deps": {}, "ops": []}]})
        assert gate._n_parked <= 32
        assert sum(gate.quarantined(f"doc-{i}") for i in range(200)) <= 32
        assert gate.stats["global_evicted"] >= 200 - 32
        assert len(gate._quarantine) <= 32 + P.inbound._MAX_IDLE_QUEUES
        return gate.stats, sorted(gate._quarantine), gate.quarantine_stats()
    same(run)


def test_parked_poison_not_blamed_on_later_valid_sender():
    def run(P):
        am = P.am
        src = am.change(P.init("w"), lambda d: d.__setitem__("a", 1))
        first = am.get_all_changes(src)
        poison = {"actor": "z", "seq": 1, "deps": {"w": 1},
                  "ops": [{"action": "set", "obj": "no-such-object",
                           "key": "k", "value": 1}]}
        ds = P.DocSet()
        gate = P.inbound.inbound_gate(ds)
        ds.deliver("doc", [poison])
        assert gate.quarantined("doc") == 1
        ds.deliver("doc", first)
        assert am.to_json(ds.get_doc("doc")) == {"a": 1}
        assert gate.quarantined("doc") == 0
        assert gate.stats["parked_rejected"] == 1
        return gate.stats
    same(run)


def test_handler_exception_is_not_reported_as_rejection():
    def run(P):
        am = P.am
        src = am.change(P.init("w"), lambda d: d.__setitem__("a", 1))
        (c1,) = am.get_all_changes(src)
        ds = P.DocSet()

        def angry(doc_id, doc):
            raise ValueError("handler blew up")

        ds.register_handler(angry)
        with pytest.raises(ValueError, match="handler blew up") as exc:
            ds.deliver("doc", [c1])
        assert not isinstance(exc.value, P.res.ProtocolError)
        assert am.to_json(ds.get_doc("doc")) == {"a": 1}
        return am.save(ds.get_doc("doc"))
    same(run)


def test_local_merge_releases_parked_changes():
    def run(P):
        am = P.am
        src = am.change(P.init("w"), lambda d: d.__setitem__("a", 1))
        first = am.get_all_changes(src)
        src = am.change(src, lambda d: d.__setitem__("b", 2))
        second = [c for c in am.get_all_changes(src) if c["seq"] == 2]
        ds = P.DocSet()
        ds.set_doc("doc", _mkdoc(P))
        conn = P.Connection(ds, lambda m: None)
        conn.open()
        conn.receive_msg({"docId": "doc", "clock": {"w": 2},
                          "changes": second})
        assert am.to_json(ds.get_doc("doc")).get("b") is None
        ds.set_doc("doc", am.apply_changes(ds.get_doc("doc"), first))
        assert am.to_json(ds.get_doc("doc")) == {"x": 1, "a": 1, "b": 2}
        assert P.inbound.inbound_gate(ds).quarantined("doc") == 0
        return am.save(ds.get_doc("doc"))
    same(run)


def test_evict_sender_reclaims_parked_changes():
    def run(P):
        ds = P.DocSet()
        gate = P.inbound.inbound_gate(ds)
        for i, s in enumerate(("a", "b", "a")):
            gate.deliver(f"d{i}", [{"actor": "g", "seq": 2, "deps": {},
                                    "ops": []}], sender=s)
        n = gate.evict_sender("a")
        return n, gate.quarantine_items(), gate._n_parked
    same(run)


# ---------------------------------------------------------------------------
# chaos transport: determinism + fault injection
# ---------------------------------------------------------------------------


def _chaos_trace(P, seed):
    got = []
    link = P.res.ChaosLink(got.append, seed=seed, drop=0.3, dup=0.25,
                           reorder=0.4, delay=0.3)
    for i in range(80):
        link.send({"n": i})
        if i % 3 == 0:
            link.pump()
    link.drain()
    return got, dict(link.stats)


def test_chaos_deterministic_in_seed():
    def run(P):
        t1, s1 = _chaos_trace(P, 42)
        t2, s2 = _chaos_trace(P, 42)
        t3, _ = _chaos_trace(P, 43)
        assert t1 == t2 and s1 == s2 and t1 != t3
        return t1, s1, t3
    same(run)


def test_chaos_faults_actually_fire():
    def run(P):
        _, stats = _chaos_trace(P, 7)
        assert stats["dropped"] > 0 and stats["duplicated"] > 0
        assert stats["reordered"] > 0 and stats["delayed"] > 0
        assert stats["delivered"] + stats["dropped"] \
            == stats["sent"] + stats["duplicated"]
        return stats
    same(run)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fault_schedules_equal_the_jax_packages(seed):
    """The same seed gives the same fault schedule in both packages: the
    chaos link's drops, duplicates, delays and reorders (every WAN
    profile, bandwidth caps included) and the retry channel's
    retransmit jitter, message for message."""
    def run(P):
        out = []
        for name in sorted(P.res.WAN_PROFILES):
            got = []
            fwd, rev = P.res.wan_pair(got.append, got.append, profile=name,
                                      seed=seed)
            for i in range(120):
                fwd.send({"n": i, "pad": "x" * (i * 97 % 3000)})
                rev.send({"m": i})
                if i % 4 == 0:
                    fwd.pump()
                    rev.pump()
            fwd.drain(256)
            rev.drain(256)
            out.append((name, got, fwd.stats, rev.stats))
        wire = []
        ch = P.res.ResilientChannel(wire.append, lambda m: None, seed=seed,
                                    base_rto=1, max_rto=32)
        for i in range(6):
            ch.send({"n": i})
        for _ in range(60):
            ch.tick()
        out.append(([(e["seq"], e["ack"]) for e in wire],
                    sorted((s, e["due"], e["rto"], e["tries"])
                           for s, e in ch._unacked.items()),
                    ch.stats))
        return out
    same(run)
    assert TP.res.WAN_PROFILES == JP.res.WAN_PROFILES
    assert TP.res.wan_profile("wan", "rev") == JP.res.wan_profile("wan",
                                                                  "rev")
    with pytest.raises(KeyError, match="unknown WAN profile"):
        TP.res.wan_profile("wna")


def test_chaos_partition_drops_in_flight_and_new_frames():
    def run(P):
        got = []
        link = P.res.ChaosLink(got.append, seed=0)
        link.send({"n": 1})
        link.partition()
        link.send({"n": 2})
        link.drain()
        assert got == [] and link.stats["partition_dropped"] == 2
        link.heal()
        link.send({"n": 3})
        link.drain()
        assert got == [{"n": 3}]
        return link.stats
    same(run)


def test_codec_enforces_json_wire_format():
    for P in (JP, TP):
        link = P.res.ChaosLink(lambda m: None, seed=0)
        with pytest.raises(TypeError):
            link.send({"bad": {1, 2}})
    import numpy as np
    link = TP.res.ChaosLink(lambda m: None, seed=0)
    with pytest.raises(TypeError):
        link.send({"clock": {"a": np.int64(3)}})


def test_codec_rebuilds_frames_from_their_bytes():
    """A frame crosses the codec as base64 of its bytes and arrives as a
    fresh WireFrame per copy (the JAX codec's contract)."""
    from test_torch_wire_format import _valid_frame_bytes
    data = _valid_frame_bytes()
    got = []
    link = TP.res.ChaosLink(got.append, seed=0, dup=1.0)
    frame = TP.wf.WireFrame(data)
    link.send({"docId": "d", "clock": {}, "wire": frame})
    link.drain()
    assert len(got) == 2
    assert all(m["wire"].data == data and m["wire"] is not frame
               for m in got)
    assert got[0]["wire"] is not got[1]["wire"]


# ---------------------------------------------------------------------------
# resilient channel: retry, dedup, ordering
# ---------------------------------------------------------------------------


def _duplex(P, seed, **faults):
    parts = {}
    la = P.res.ChaosLink(lambda env: parts["b"].on_wire(env), seed=seed,
                         **faults)
    lb = P.res.ChaosLink(lambda env: parts["a"].on_wire(env), seed=seed + 1,
                         **faults)
    got_a, got_b = [], []
    parts["a"] = P.res.ResilientChannel(la.send, got_a.append,
                                        seed=seed + 2)
    parts["b"] = P.res.ResilientChannel(lb.send, got_b.append,
                                        seed=seed + 3)
    return parts["a"], parts["b"], la, lb, got_a, got_b


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_exactly_once_in_order_over_lossy_link(seed):
    def run(P):
        a, b, la, lb, got_a, got_b = _duplex(
            P, seed, drop=0.35, dup=0.3, reorder=0.4, delay=0.3)
        for i in range(30):
            a.send({"n": i})
            if i % 2:
                b.send({"m": i})
            la.pump()
            lb.pump()
            a.tick()
            b.tick()
        for _ in range(200):
            la.pump()
            lb.pump()
            a.tick()
            b.tick()
            if a.idle and b.idle and la.idle and lb.idle:
                break
        assert got_b == [{"n": i} for i in range(30)]
        assert got_a == [{"m": i} for i in range(30) if i % 2]
        assert a.idle and b.idle
        return a.stats, b.stats, la.stats, lb.stats
    same(run)


def test_retransmits_across_partition():
    def run(P):
        a, b, la, lb, got_a, got_b = _duplex(P, 5)
        la.partition()
        a.send({"n": 1})
        for _ in range(8):
            la.pump()
            lb.pump()
            a.tick()
            b.tick()
        assert got_b == [] and a.in_flight == 1
        la.heal()
        for _ in range(64):
            la.pump()
            lb.pump()
            a.tick()
            b.tick()
            if a.idle:
                break
        assert got_b == [{"n": 1}] and a.stats["retransmits"] >= 1
        assert a.idle
        return a.stats
    same(run)


def test_raising_deliver_keeps_channel_consistent():
    def run(P):
        wire, got = [], []

        def picky(payload):
            if payload.get("n") == 1:
                raise P.res.ProtocolError("rejected payload")
            got.append(payload)

        ch = P.res.ResilientChannel(wire.append, picky)
        with pytest.raises(P.res.ProtocolError):
            ch.on_wire({"kind": "data", "seq": 1, "ack": 0,
                        "payload": {"n": 1}})
        acks = [e for e in wire if e["kind"] == "ack"]
        assert acks and acks[-1]["ack"] == 1
        ch.on_wire({"kind": "data", "seq": 1, "ack": 0, "payload": {"n": 1}})
        assert ch.stats["dup_dropped"] == 1
        ch.on_wire({"kind": "data", "seq": 2, "ack": 0, "payload": {"n": 2}})
        assert got == [{"n": 2}] and ch.stats["deliver_errors"] == 1
        assert ch.idle
        return wire, ch.stats
    same(run)


def test_synchronous_loopback_retransmit_does_not_crash_tick():
    def run(P):
        parts, got = {}, []
        drop_first = [True]

        def a_to_b(env):
            if env["kind"] == "data" and env["seq"] == 1 and drop_first[0]:
                drop_first[0] = False
                return
            parts["b"].on_wire(env)

        parts["a"] = P.res.ResilientChannel(a_to_b, lambda m: None, seed=1)
        parts["b"] = P.res.ResilientChannel(
            lambda env: parts["a"].on_wire(env), got.append, seed=2)
        for i in range(1, 4):
            parts["a"].send({"n": i})
        for _ in range(8):
            parts["a"].tick()
            if parts["a"].idle:
                break
        assert got == [{"n": 1}, {"n": 2}, {"n": 3}]
        assert parts["a"].idle
        return parts["a"].stats
    same(run)


def test_receive_window_bounds_reorder_buffer():
    def run(P):
        got = []
        ch = P.res.ResilientChannel(lambda e: None, got.append,
                                    recv_window=4)
        for seq in range(2, 50):
            ch.on_wire({"kind": "data", "seq": seq, "ack": 0,
                        "payload": {"n": seq}})
        assert len(ch._recv_buf) <= 4 and ch.buffered <= 4
        assert ch.stats["window_dropped"] == 45
        ch.on_wire({"kind": "data", "seq": 1, "ack": 0, "payload": {"n": 1}})
        assert got == [{"n": n} for n in range(1, 5)]
        return ch.stats
    same(run)


def test_malformed_envelope_raises_protocol_error():
    def run(P):
        ch = P.res.ResilientChannel(lambda e: None, lambda m: None)
        whys = []
        for env in ("x", {}, {"kind": "data", "seq": 1},
                    {"kind": "data", "seq": 1, "ack": 0},
                    {"kind": "warp", "seq": 1, "ack": 0},
                    {"kind": "data", "seq": "1", "ack": 0, "payload": {}},
                    {"kind": "ack", "seq": 0, "ack": 0, "epoch": -1}):
            whys.append(_raises(P, P.res.ProtocolError,
                                lambda: ch.on_wire(env)))
        return whys
    same(run)


def test_payload_wire_bytes_and_pending_payloads():
    from test_torch_wire_format import _valid_frame_bytes
    data = _valid_frame_bytes()

    def run(P):
        frame = P.wf.WireFrame(data)
        msgs = [{"docId": "d", "clock": {"a": 1}},
                {"docId": "d", "clock": {}, "wire": frame},
                {"docId": "d", "changes": [{"actor": "a", "seq": 1}]},
                ["x", 1.5, None], "plain"]
        sizes = [P.res.channel.payload_wire_bytes(m) for m in msgs]
        ch = P.res.ResilientChannel(lambda e: None, None)
        for m in msgs[:3]:
            ch.send(m)
        return sizes, [norm(p) for p in ch.pending_payloads()], ch.stats
    same(run)


# ---------------------------------------------------------------------------
# revive epochs
# ---------------------------------------------------------------------------


def test_dead_channel_refuses_send_until_revived():
    def run(P):
        deaths = []
        ch = P.res.ResilientChannel(lambda env: None, lambda m: None,
                                    max_retries=2, base_rto=1,
                                    on_dead=deaths.append)
        ch.send({"n": 1})
        for _ in range(32):
            ch.tick()
            if ch.dead:
                break
        assert ch.dead and deaths == [ch] and ch.in_flight == 0
        with pytest.raises(P.res.PeerDeadError):
            ch.send({"n": 2})
        ch.revive()
        assert not ch.dead and ch.epoch == 1 and ch.stats["revives"] == 1
        wire = []
        ch._send_raw = wire.append
        ch.send({"n": 2})
        assert wire[-1]["seq"] == 1 and wire[-1]["epoch"] == 1
        return wire, ch.stats
    same(run)
    assert issubclass(TP.res.PeerDeadError, TP.res.ProtocolError)


def test_dead_channel_without_callback_raises_typed():
    def run(P):
        ch = P.res.ResilientChannel(lambda env: None, lambda m: None,
                                    max_retries=1, base_rto=1)
        ch.send({"n": 1})
        with pytest.raises(P.res.PeerDeadError) as info:
            for _ in range(32):
                ch.tick()
        return str(info.value), ch.stats
    same(run)


def test_stale_pre_epoch_frames_drop_unacked_after_revive():
    def run(P):
        got, wire = [], []
        ch = P.res.ResilientChannel(wire.append, got.append)
        ch.on_wire({"kind": "data", "seq": 1, "ack": 0,
                    "payload": {"old": 1}})
        ch.revive()
        n_acks = sum(1 for e in wire if e["kind"] == "ack")
        ch.on_wire({"kind": "data", "seq": 2, "ack": 0,
                    "payload": {"old": 2}})
        assert got == [{"old": 1}]
        assert ch.stats["stale_epoch_dropped"] == 1
        assert sum(1 for e in wire if e["kind"] == "ack") == n_acks
        ch.on_wire({"kind": "data", "seq": 1, "ack": 0, "epoch": 1,
                    "payload": {"new": 1}})
        assert got == [{"old": 1}, {"new": 1}]
        return wire, ch.stats
    same(run)


def test_stale_acks_from_old_epoch_are_ignored():
    def run(P):
        ch = P.res.ResilientChannel(lambda env: None, lambda m: None)
        ch.revive()
        ch.send({"n": 1})
        ch.on_wire({"kind": "ack", "seq": 0, "ack": 1})
        assert ch.in_flight == 1 and ch.stats["stale_acks"] == 1
        ch.on_wire({"kind": "ack", "seq": 0, "ack": 1, "aepoch": 1})
        assert ch.in_flight == 0 and ch.idle
        return ch.stats
    same(run)


def test_coordinated_revive_recovers_duplex_after_death():
    def run(P):
        parts = {}
        la = P.res.ChaosLink(lambda env: parts["b"].on_wire(env), seed=11)
        lb = P.res.ChaosLink(lambda env: parts["a"].on_wire(env), seed=12)
        got_b = []
        parts["a"] = a = P.res.ResilientChannel(
            la.send, lambda m: None, seed=13, max_retries=3, base_rto=1,
            max_rto=2)
        parts["b"] = b = P.res.ResilientChannel(lb.send, got_b.append,
                                                seed=14)
        la.partition()
        a.send({"n": 1})
        dead = False
        for _ in range(256):
            la.pump()
            lb.pump()
            try:
                a.tick()
            except P.res.PeerDeadError:
                dead = True
                break
            b.tick()
        assert dead and a.dead
        la.heal()
        a.revive()
        b.revive()
        a.send({"n": 1})
        a.send({"n": 2})
        for _ in range(128):
            la.pump()
            lb.pump()
            a.tick()
            b.tick()
            if a.idle and b.idle and la.idle and lb.idle:
                break
        assert got_b == [{"n": 1}, {"n": 2}]
        assert a.idle and b.idle and a.epoch == 1 and b._peer_epoch == 1
        return a.stats, b.stats
    same(run)


# ---------------------------------------------------------------------------
# hub idempotency under duplicate + reordered redelivery (both backends)
# ---------------------------------------------------------------------------


def _backend_doc(P, kind, actor):
    if kind == "oracle":
        ns = P.am.backend.facade.Backend
    else:
        ns = CPU if P.port else P.device_backend.DeviceBackend
    return P.Frontend.init({"actorId": actor, "backend": ns})


def _hub_with_doc(P, kind):
    ds = P.DocSet()
    ds.set_doc("doc", _backend_doc(P, kind, "h"))
    hub = P.SyncHub(ds)
    box = []
    handle = hub.add_peer("p", box.append)
    hub.open()
    return ds, hub, handle, box


def _batches(P, kind):
    am = P.am
    src = am.change(_backend_doc(P, kind, "w"),
                    lambda d: d.__setitem__("a", 1))
    b1 = am.get_all_changes(src)
    src = am.change(src, lambda d: d.__setitem__("b", 2))
    b2 = [c for c in am.get_all_changes(src) if c["seq"] == 2]
    return b1, b2


@pytest.mark.parametrize("kind", ["oracle", "device"])
def test_duplicate_batch_is_idempotent(kind):
    def run(P):
        ds, hub, handle, box = _hub_with_doc(P, kind)
        b1, _ = _batches(P, kind)
        msg = {"docId": "doc", "clock": {"w": 1}, "changes": b1}
        handle.receive_msg(copy.deepcopy(msg))
        first = _fingerprint(P, ds)
        assert json.loads(first[1]) == {"w": 1}
        for _ in range(3):
            handle.receive_msg(copy.deepcopy(msg))
        assert _fingerprint(P, ds) == first
        return first, [norm(m) for m in box], P.am.save(ds.get_doc("doc"))
    same(run)


@pytest.mark.parametrize("kind", ["oracle", "device"])
def test_reordered_batches_converge(kind):
    def run(P):
        ds, hub, handle, box = _hub_with_doc(P, kind)
        b1, b2 = _batches(P, kind)
        handle.receive_msg({"docId": "doc", "clock": {"w": 2},
                            "changes": copy.deepcopy(b2)})
        assert "b" not in P.am.to_json(ds.get_doc("doc"))
        handle.receive_msg({"docId": "doc", "clock": {"w": 2},
                            "changes": copy.deepcopy(b1)})
        snap = P.am.to_json(ds.get_doc("doc"))
        assert snap["a"] == 1 and snap["b"] == 2
        final = _fingerprint(P, ds)
        handle.receive_msg({"docId": "doc", "clock": {"w": 2},
                            "changes": copy.deepcopy(b2)})
        assert _fingerprint(P, ds) == final
        return final, [norm(m) for m in box]
    same(run)


@pytest.mark.parametrize("kind", ["oracle", "device"])
def test_inconsistent_seq_reuse_is_protocol_error(kind):
    def run(P):
        ds, hub, handle, _ = _hub_with_doc(P, kind)
        b1, _ = _batches(P, kind)
        handle.receive_msg({"docId": "doc", "clock": {"w": 1},
                            "changes": copy.deepcopy(b1)})
        before = _fingerprint(P, ds)
        forged = copy.deepcopy(b1)
        forged[0]["ops"][0]["value"] = 999
        why = _raises(P, P.res.ProtocolError, lambda: handle.receive_msg(
            {"docId": "doc", "clock": {"w": 1}, "changes": forged}))
        assert _fingerprint(P, ds) == before
        return why
    same(run)


def test_wire_path_rejects_unknown_actions_before_graduation():
    def run(P):
        dev = P.device_backend
        dev.GRADUATION_STATS.clear()
        ds = P.DocSet()
        ds.set_doc("doc", _backend_doc(P, "device", "h"))
        b1, _ = _batches(P, "device")
        ds.deliver("doc", copy.deepcopy(b1))
        before = _fingerprint(P, ds)
        bad = [{"actor": "z", "seq": 1, "deps": {},
                "ops": [{"action": "frobnicate", "obj": J.ROOT_ID,
                         "key": "k"}]}]
        whys = []
        for _ in range(2):
            whys.append(_raises(P, P.res.ProtocolError,
                                lambda: ds.deliver("doc",
                                                   copy.deepcopy(bad))))
            assert _fingerprint(P, ds) == before
        assert dev.GRADUATION_STATS == {}
        state = P.Frontend.get_backend_state(ds.get_doc("doc"))
        assert isinstance(state, dev.DeviceBackendState)
        ds.deliver("doc", copy.deepcopy(b1))
        assert _fingerprint(P, ds) == before
        return whys, before
    same(run)


def test_direct_api_graduation_is_idempotent_under_redelivery():
    def run(P):
        am, dev = P.am, P.device_backend
        dev.GRADUATION_STATS.clear()
        doc = am.change(_backend_doc(P, "device", "h"),
                        lambda d: d.__setitem__("x", 1))
        bad = [{"actor": "z", "seq": 1, "deps": {},
                "ops": [{"action": "frobnicate", "obj": J.ROOT_ID,
                         "key": "k"}]}]
        for n in (1, 2):
            with pytest.raises(ValueError, match="Unknown operation type"):
                am.apply_changes(doc, copy.deepcopy(bad))
            assert dev.GRADUATION_STATS == {"out_of_scope": n}
            assert am.to_json(doc) == {"x": 1}
        doc = am.change(doc, lambda d: d.__setitem__("y", 2))
        assert am.to_json(doc) == {"x": 1, "y": 2}
        return am.save(doc)
    same(run)
