"""The port's sync tier (automerge_tpu_torch/sync/) against the JAX
package's, on the CPU.

Every scenario runs twice: once through the JAX package on its default
backend, once through the port with every DocSet bound to
`backend.backend_for("cpu")` and every document made with an explicit
actor on that backend. Both packages' uuid factories are pinned and reset
before each run. Tolerance is zero: the messages each side sent (frames
compared by their bytes), the documents (`to_json`) and `save()` bytes
must be equal, and each run must pass the JAX test's own assertions.

- Twins of tests/test_sync.py (DocSet, WatchableDoc, Connection over an
  in-memory network), tests/test_sync_hub.py (ClockMatrix, SyncHub,
  hub-backed Connections, churn, late messages, lossy reconnect) and
  tests/test_connection_traces.py (exact message traces).
- The device binding: a DocSet creates and restores documents on its
  backend's device; `DocSet()` without a card raises at its first
  document and never falls back to the CPU.
- Twins of tests/test_checkpoint.py's snapshot-bootstrapped sync
  (`test_sync_snapshot_*`, the DocSet half of
  `test_corrupt_bundle_falls_back_to_full_replay`) and of
  `Checkpoint.to_base64` / `from_base64`.
- Twins of tests/test_lineage.py `test_flow_events_pair_up_and_validate`
  and `test_three_peer_chaos_identical_sampling`, and the module-level
  lineage wrappers the sync tier calls.
"""

import itertools
import json
import random
from types import SimpleNamespace
from unittest import mock

import pytest
import torch

import automerge_tpu as J
import automerge_tpu_torch as T
from automerge_tpu import _uuid as j_uuid
from automerge_tpu_torch import _uuid as t_uuid

CPU = T.backend.backend_for("cpu")


def _pkg(am):
    from importlib import import_module
    base = am.__name__
    sync = import_module(base + ".sync")
    hub = import_module(base + ".sync.hub")
    res = import_module(base + ".resilience")
    inbound = import_module(base + ".resilience.inbound")
    wf = import_module(base + ".engine.wire_format")
    ckpt = import_module(base + ".checkpoint")
    lineage = import_module(base + ".obs.lineage")
    obs = import_module(base + ".obs")
    dev = import_module(base + ".backend.device")
    default = import_module(base + ".backend.default")
    port = am is T
    return SimpleNamespace(
        am=am, port=port, Frontend=am.frontend, sync=sync, hub_mod=hub,
        res=res, inbound=inbound, wf=wf, ckpt=ckpt, lineage=lineage,
        obs=obs, device_backend=dev, default=default,
        ClockMatrix=sync.ClockMatrix, Connection=sync.Connection,
        SyncHub=sync.SyncHub, WatchableDoc=sync.WatchableDoc,
        DocSet=(lambda: sync.DocSet(backend=CPU)) if port else sync.DocSet,
        init=lambda actor=None: am.init(
            ({"actorId": actor} if actor else {})
            | ({"backend": CPU} if port else {})),
        where=lambda actor=None: (
            ({"backend": CPU} | ({"actorId": actor} if actor else {}))
            if port else actor))


JP, TP = _pkg(J), _pkg(T)


def pin():
    for m in (j_uuid, t_uuid):
        c = itertools.count(1)
        m.set_factory(lambda c=c: f"00000000-0000-0000-0000-{next(c):012d}")


@pytest.fixture(autouse=True)
def pinned_uuids():
    pin()
    yield
    j_uuid.reset()
    t_uuid.reset()


def both(fn):
    """fn(P) for the JAX package, then the port, each from freshly pinned
    uuid counters; -> (jax result, port result)."""
    out = []
    for P in (JP, TP):
        pin()
        out.append(fn(P))
    return out


def same(fn):
    """Run `fn` on both packages and require equal results."""
    j, t = both(fn)
    assert t == j
    return t


def norm(msg):
    """A sync message as comparable plain data: frames by their bytes
    (and a checkpoint by its base64 text, which it already is)."""
    if not isinstance(msg, dict):
        return msg
    out = {}
    for k, v in msg.items():
        if k == "wire" and v is not None and hasattr(v, "data"):
            v = ("frame", bytes(v.data))
        out[k] = v
    return out


def canon(P, doc):
    return None if doc is None else json.dumps(
        P.am.to_json(doc), sort_keys=True, default=str)


def set_(key, value):
    def cb(doc):
        doc[key] = value
    return cb


# --------------------------------------------------------------------------
# tests/test_sync.py
# --------------------------------------------------------------------------


class Network:
    """In-memory message fabric between connections, with manual
    delivery (tests/test_sync.py `Network`), recording every message."""

    def __init__(self, P):
        self.P = P
        self.queues = {}
        self.conns = {}
        self.sent = []

    def connect(self, name_a, docset_a, name_b, docset_b):
        C = self.P.Connection
        conn_a = C(docset_a, lambda m: self._enqueue(name_a, name_b, m))
        conn_b = C(docset_b, lambda m: self._enqueue(name_b, name_a, m))
        self.conns[name_a] = conn_a
        self.conns[name_b] = conn_b
        conn_a.open()
        conn_b.open()
        return conn_a, conn_b

    def _enqueue(self, sender, receiver, msg):
        self.sent.append((sender, norm(msg)))
        self.queues.setdefault(receiver, []).append(msg)

    def deliver(self, receiver, count=None):
        queue = self.queues.get(receiver, [])
        n = len(queue) if count is None else count
        for _ in range(n):
            self.conns[receiver].receive_msg(queue.pop(0))

    def deliver_all(self):
        while any(self.queues.values()):
            for receiver in list(self.queues.keys()):
                self.deliver(receiver)

    def drop(self, receiver, count=1):
        for _ in range(count):
            self.queues.get(receiver, []).pop(0)


def test_docset_set_get_remove():
    def run(P):
        ds = P.DocSet()
        doc = P.init("actor-1")
        ds.set_doc("doc1", doc)
        assert ds.get_doc("doc1") is doc
        assert ds.doc_ids == ["doc1"]
        ds.remove_doc("doc1")
        assert ds.get_doc("doc1") is None
        return ds.doc_ids
    same(run)


def test_docset_handlers_notified():
    def run(P):
        ds = P.DocSet()
        seen = []
        ds.register_handler(lambda doc_id, doc: seen.append(doc_id))
        ds.set_doc("a", P.init())
        assert seen == ["a"]
        ds.unregister_handler(ds._handlers[0])
        ds.set_doc("b", P.init())
        assert seen == ["a"]
        return seen
    same(run)


def test_docset_apply_changes_creates_doc():
    def run(P):
        src = P.am.change(P.init("actor-1"), set_("x", 1))
        ds = P.DocSet()
        doc = ds.apply_changes("doc1", P.am.get_all_changes(src))
        assert P.am.to_json(doc) == {"x": 1}
        return canon(P, doc), P.am.save(doc)
    same(run)


def test_watchable_doc_handler_on_set():
    def run(P):
        wd = P.WatchableDoc(P.init("actor-1"))
        seen = []
        wd.register_handler(lambda doc: seen.append(P.am.to_json(doc)))
        src = P.am.change(P.init("actor-2"), set_("x", 1))
        wd.apply_changes(P.am.get_all_changes(src))
        assert seen == [{"x": 1}]
        assert P.am.to_json(wd.get()) == {"x": 1}
        return seen, P.am.save(wd.get())
    same(run)
    with pytest.raises(ValueError):
        TP.WatchableDoc(None)


def test_connection_doc_transfer():
    def run(P):
        ds_a, ds_b = P.DocSet(), P.DocSet()
        ds_a.set_doc("birds", P.am.change(P.init("actor-1"),
                                          set_("bird", "magpie")))
        net = Network(P)
        net.connect("a", ds_a, "b", ds_b)
        net.deliver_all()
        assert P.am.to_json(ds_b.get_doc("birds")) == {"bird": "magpie"}
        return net.sent, P.am.save(ds_b.get_doc("birds"))
    same(run)


def test_connection_bidirectional_concurrent_changes():
    def run(P):
        am = P.am
        ds_a, ds_b = P.DocSet(), P.DocSet()
        ds_a.set_doc("doc", am.change(P.init("actor-1"), set_("x", 0)))
        net = Network(P)
        net.connect("a", ds_a, "b", ds_b)
        net.deliver_all()
        ds_a.set_doc("doc", am.change(ds_a.get_doc("doc"), set_("a", 1)))
        ds_b.set_doc("doc", am.change(
            am.set_actor_id(ds_b.get_doc("doc"), "actor-2"), set_("b", 2)))
        net.deliver_all()
        assert am.to_json(ds_a.get_doc("doc")) == \
            am.to_json(ds_b.get_doc("doc")) == {"x": 0, "a": 1, "b": 2}
        return (net.sent, am.save(ds_a.get_doc("doc")),
                am.save(ds_b.get_doc("doc")))
    same(run)


def test_connection_sync_terminates():
    def run(P):
        ds_a, ds_b = P.DocSet(), P.DocSet()
        ds_a.set_doc("doc", P.am.change(P.init("actor-1"), set_("x", 1)))
        net = Network(P)
        net.connect("a", ds_a, "b", ds_b)
        net.deliver_all()
        n_msgs = len(net.sent)
        ds_a.set_doc("doc", ds_a.get_doc("doc"))
        net.deliver_all()
        assert len(net.sent) == n_msgs
        return net.sent
    same(run)


def test_connection_dropped_advertisement_tolerated():
    def run(P):
        am = P.am
        ds_a, ds_b = P.DocSet(), P.DocSet()
        base = am.change(P.init("actor-1"), set_("x", 1))
        other = am.change(am.set_actor_id(am.merge(P.init("tmp"), base),
                                          "actor-2"), set_("b", 2))
        ds_a.set_doc("doc", am.change(base, set_("a", 1)))
        ds_b.set_doc("doc", other)
        net = Network(P)
        net.connect("a", ds_a, "b", ds_b)
        net.drop("a", 1)
        net.deliver_all()
        assert am.to_json(ds_a.get_doc("doc")) == \
            am.to_json(ds_b.get_doc("doc")) == {"x": 1, "a": 1, "b": 2}
        return net.sent, am.save(ds_a.get_doc("doc"))
    same(run)


def test_connection_three_node_chain():
    def run(P):
        ds_a, ds_b, ds_c = P.DocSet(), P.DocSet(), P.DocSet()
        ds_a.set_doc("doc", P.am.change(P.init("actor-1"),
                                        set_("from", "a")))
        net = Network(P)
        net.connect("a", ds_a, "b", ds_b)
        conn_b2 = P.Connection(ds_b, lambda m: net._enqueue("b2", "c", m))
        conn_c = P.Connection(ds_c, lambda m: net._enqueue("c", "b2", m))
        net.conns["b2"], net.conns["c"] = conn_b2, conn_c
        conn_b2.open()
        conn_c.open()
        net.deliver_all()
        assert P.am.to_json(ds_c.get_doc("doc")) == {"from": "a"}
        return net.sent, P.am.save(ds_c.get_doc("doc"))
    same(run)


def test_connection_old_state_raises():
    def run(P):
        am = P.am
        ds_a = P.DocSet()
        d1 = am.change(P.init("actor-1"), set_("x", 1))
        ds_a.set_doc("doc", d1)
        net = Network(P)
        net.connect("a", ds_a, "b", P.DocSet())
        net.deliver_all()
        ds_a.set_doc("doc", am.change(d1, set_("y", 2)))
        net.deliver_all()
        with pytest.raises(ValueError, match="old state"):
            ds_a.set_doc("doc", d1)
        return net.sent
    same(run)


# --------------------------------------------------------------------------
# tests/test_connection_traces.py: exact message traces
# --------------------------------------------------------------------------


class Spy:
    def __init__(self):
        self.sent = []

    def __call__(self, msg):
        self.sent.append(msg)


def _wire(P):
    ds_a, ds_b = P.DocSet(), P.DocSet()
    spy_a, spy_b = Spy(), Spy()
    return (ds_a, ds_b, P.Connection(ds_a, spy_a), P.Connection(ds_b, spy_b),
            spy_a, spy_b)


def _deliver_all(spy, conn, start=0):
    i = start
    while i < len(spy.sent):
        conn.receive_msg(spy.sent[i])
        i += 1
    return i


def _traces(*spies):
    return [[norm(m) for m in s.sent] for s in spies]


def _exchange(spy_a, conn_a, spy_b, conn_b, marks, rounds=4):
    a_mark, b_mark = marks
    for _ in range(rounds):
        a_mark = _deliver_all(spy_a, conn_b, a_mark)
        b_mark = _deliver_all(spy_b, conn_a, b_mark)
    return a_mark, b_mark


def test_trace_doc_transfer():
    def run(P):
        ds_a, ds_b, conn_a, conn_b, spy_a, spy_b = _wire(P)
        ds_a.set_doc("doc1", P.am.change(P.init("alice"), set_("x", 1)))
        conn_a.open()
        conn_b.open()
        assert len(spy_a.sent) == 1
        assert spy_a.sent[0]["clock"] == {"alice": 1}
        assert "changes" not in spy_a.sent[0]
        a_mark = _deliver_all(spy_a, conn_b)
        assert spy_b.sent == [{"docId": "doc1", "clock": {}}]
        _deliver_all(spy_b, conn_a)
        assert len(spy_a.sent) == 2
        assert len(spy_a.sent[1]["changes"]) == 1
        _deliver_all(spy_a, conn_b, a_mark)
        assert P.am.to_json(ds_b.get_doc("doc1")) == {"x": 1}
        return _traces(spy_a, spy_b)
    same(run)


def test_trace_no_redundant_messages_when_in_sync():
    def run(P):
        ds_a, ds_b, conn_a, conn_b, spy_a, spy_b = _wire(P)
        ds_a.set_doc("d", P.am.change(P.init("alice"), set_("x", 1)))
        conn_a.open()
        conn_b.open()
        marks = _exchange(spy_a, conn_a, spy_b, conn_b, (0, 0))
        total = len(spy_a.sent) + len(spy_b.sent)
        _exchange(spy_a, conn_a, spy_b, conn_b, marks, rounds=1)
        assert len(spy_a.sent) + len(spy_b.sent) == total
        return _traces(spy_a, spy_b)
    same(run)


def test_trace_concurrent_changes_both_directions():
    def run(P):
        am = P.am
        ds_a, ds_b, conn_a, conn_b, spy_a, spy_b = _wire(P)
        ds_a.set_doc("d", am.change(P.init("alice"), set_("x", 0)))
        conn_a.open()
        conn_b.open()
        marks = _exchange(spy_a, conn_a, spy_b, conn_b, (0, 0))
        ds_b.set_doc("d", am.change(am.set_actor_id(ds_b.get_doc("d"), "bob"),
                                    set_("from_b", 2)))
        ds_a.set_doc("d", am.change(ds_a.get_doc("d"), set_("from_a", 1)))
        _exchange(spy_a, conn_a, spy_b, conn_b, marks)
        assert am.to_json(ds_a.get_doc("d")) == am.to_json(
            ds_b.get_doc("d")) == {"x": 0, "from_a": 1, "from_b": 2}
        return _traces(spy_a, spy_b), am.save(ds_b.get_doc("d"))
    same(run)


def test_trace_dropped_message_recovered_by_next_round():
    def run(P):
        am = P.am
        ds_a, ds_b, conn_a, conn_b, spy_a, spy_b = _wire(P)
        ds_a.set_doc("d", am.change(P.init("alice"), set_("x", 1)))
        conn_a.open()
        conn_b.open()
        a_mark = len(spy_a.sent)           # A's advertisement is lost
        ds_a.set_doc("d", am.change(ds_a.get_doc("d"), set_("y", 2)))
        _exchange(spy_a, conn_a, spy_b, conn_b, (a_mark, 0))
        assert am.to_json(ds_b.get_doc("d")) == {"x": 1, "y": 2}
        return _traces(spy_a, spy_b)
    same(run)


def test_trace_multi_doc_multiplexing():
    def run(P):
        ds_a, ds_b, conn_a, conn_b, spy_a, spy_b = _wire(P)
        for i in range(3):
            ds_a.set_doc(f"doc{i}", P.am.change(P.init(f"alice{i}"),
                                                set_("n", i)))
        conn_a.open()
        conn_b.open()
        _exchange(spy_a, conn_a, spy_b, conn_b, (0, 0))
        for i in range(3):
            assert P.am.to_json(ds_b.get_doc(f"doc{i}")) == {"n": i}
        return _traces(spy_a, spy_b)
    same(run)


def test_trace_bulk_text_edits_ride_equal_frames(monkeypatch):
    """Bulk text edits cross as one dict prefix plus one AMTPUWIRE1
    frame per (doc, clock) group: the port mints the JAX package's bytes
    and both receivers commit the same document."""
    monkeypatch.setenv("AMTPU_WIRE_MIN_OPS", "8")

    def run(P):
        am = P.am
        ds_a, ds_b, conn_a, conn_b, spy_a, spy_b = _wire(P)
        ds_a.set_doc("d", am.change(P.init("author"),
                                    set_("t", am.Text("seed"))))
        conn_a.open()
        conn_b.open()
        marks = _exchange(spy_a, conn_a, spy_b, conn_b, (0, 0))
        for k in range(3):
            ds_a.set_doc("d", am.change(ds_a.get_doc("d"), lambda d, k=k:
                                        d["t"].insert_at(0, *(f"{k}" * 12))))
            marks = _exchange(spy_a, conn_a, spy_b, conn_b, marks)
        assert sum(m.get("wire") is not None for m in spy_a.sent) == 3
        return _traces(spy_a, spy_b), am.save(ds_b.get_doc("d"))
    same(run)


# --------------------------------------------------------------------------
# tests/test_sync_hub.py
# --------------------------------------------------------------------------


class Pipe:
    def __init__(self):
        self.a_to_b: list = []
        self.b_to_a: list = []
        self.log: list = []

    def pump(self, b_receive, a_receive) -> int:
        n = 0
        while self.a_to_b or self.b_to_a:
            while self.a_to_b:
                m = self.a_to_b.pop(0)
                self.log.append(("ab", norm(m)))
                b_receive(m)
                n += 1
            while self.b_to_a:
                m = self.b_to_a.pop(0)
                self.log.append(("ba", norm(m)))
                a_receive(m)
                n += 1
        return n


def test_clock_matrix_pending_is_batched():
    def run(P):
        m = P.ClockMatrix()
        for d in range(3):
            m.update_ours(f"doc{d}", {"alice": 2, "bob": 1})
        for p in range(4):
            for d in range(3):
                m.set_active(f"peer{p}", f"doc{d}")
                m.update_theirs(f"peer{p}", f"doc{d}",
                                {"alice": 2, "bob": 1})
        assert m.pending() == []
        m.update_ours("doc1", {"alice": 3})
        got = sorted(m.pending())
        assert got == [(f"peer{p}", "doc1") for p in range(4)]
        m.update_theirs("peer2", "doc1", {"alice": 3})
        assert ("peer2", "doc1") not in m.pending()
        lag = m.lag_table()
        m.release_peer("peer0")
        return got, lag, m.our_clock("doc1"), m.their_clock("peer1", "doc1"),\
            m.peer_slots, m.has_peer("peer0")
    same(run)


def test_clock_matrix_values_are_python_ints():
    """Clocks leave the matrix as plain ints (JSON-encodable), never numpy
    scalars."""
    m = TP.ClockMatrix()
    m.update_ours("d", {"a": 3})
    m.set_active("p", "d")
    m.update_theirs("p", "d", {"a": 1})
    for clock in (m.our_clock("d"), m.their_clock("p", "d")):
        assert all(type(v) is int for v in clock.values())
    lag = m.lag_table()
    assert type(lag["p"]["ops"]) is int and lag["p"]["docs"] == {"d": 2}
    json.dumps([m.our_clock("d"), lag])


def test_hub_broadcasts_one_change_to_all_peers():
    def run(P):
        am = P.am
        ds = P.DocSet()
        hub = P.SyncHub(ds)
        outboxes = {p: [] for p in ("p1", "p2", "p3")}
        handles = {p: hub.add_peer(p, outboxes[p].append) for p in outboxes}
        hub.open()
        ds.set_doc("doc1", am.change(P.init("alice"), set_("x", 1)))
        for p, box in outboxes.items():
            assert [m for m in box if m.get("changes")] == []
            assert any(m["docId"] == "doc1" for m in box), (p, box)
        for p, h in handles.items():
            h.receive_msg({"docId": "doc1", "clock": {}})
        for box in outboxes.values():
            assert len([m for m in box if m.get("changes")]) == 1
        ds.set_doc("doc1", am.change(ds.get_doc("doc1"), set_("y", 2)))
        for box in outboxes.values():
            assert len([m for m in box if m.get("changes")]) == 2
        return {p: [norm(m) for m in box] for p, box in outboxes.items()}
    same(run)


def test_hub_uses_one_batched_comparison_per_change():
    def run(P):
        ds = P.DocSet()
        hub = P.SyncHub(ds)
        for p in range(5):
            hub.add_peer(f"p{p}", lambda m: None)
        hub.open()
        with mock.patch.object(P.ClockMatrix, "pending",
                               wraps=hub._matrix.pending) as spy:
            ds.set_doc("doc1", P.am.change(P.init("alice"), set_("x", 1)))
            assert spy.call_count == 1
            return spy.call_count
    same(run)


def test_n_connections_share_one_hub_and_one_diff():
    def run(P):
        am = P.am
        ds = P.DocSet()
        boxes = [[] for _ in range(3)]
        conns = [P.Connection(ds, boxes[i].append) for i in range(3)]
        for c in conns:
            c.open()
        assert len({id(c._hub) for c in conns}) == 1
        hub = conns[0]._hub
        ds.set_doc("doc", am.change(P.init("alice"), set_("x", 1)))
        for c in conns:
            c.receive_msg({"docId": "doc", "clock": {}})
        for box in boxes:
            assert sum(1 for m in box if m.get("changes")) == 1
        with mock.patch.object(P.ClockMatrix, "pending",
                               wraps=hub._matrix.pending) as pend, \
             mock.patch.object(P.hub_mod.Backend, "get_missing_changes",
                               wraps=P.hub_mod.Backend.get_missing_changes
                               ) as gmc:
            ds.set_doc("doc", am.change(ds.get_doc("doc"), set_("y", 2)))
            assert pend.call_count == 1
            assert gmc.call_count == 1
        for box in boxes:
            assert sum(1 for m in box if m.get("changes")) == 2
        return [[norm(m) for m in box] for box in boxes]
    same(run)


def test_hub_interoperates_with_plain_connection():
    def run(P):
        am = P.am
        ds_hub, ds_peer = P.DocSet(), P.DocSet()
        hub = P.SyncHub(ds_hub)
        pipe = Pipe()
        peer_handle = hub.add_peer("peer", pipe.a_to_b.append)
        conn = P.Connection(ds_peer, pipe.b_to_a.append)
        hub.open()
        conn.open()
        ds_hub.set_doc("doc1", am.change(P.init("alice"), set_("x", 1)))
        pipe.pump(conn.receive_msg, peer_handle.receive_msg)
        assert am.to_json(ds_peer.get_doc("doc1")) == {"x": 1}
        ds_peer.set_doc("doc1", am.change(ds_peer.get_doc("doc1"),
                                          set_("y", 2)))
        pipe.pump(conn.receive_msg, peer_handle.receive_msg)
        assert am.to_json(ds_hub.get_doc("doc1")) == {"x": 1, "y": 2}
        return pipe.log, am.save(ds_hub.get_doc("doc1"))
    same(run)


def test_hub_to_hub_multi_doc_convergence():
    def run(P):
        am = P.am
        ds_a, ds_b = P.DocSet(), P.DocSet()
        hub_a, hub_b = P.SyncHub(ds_a), P.SyncHub(ds_b)
        pipe = Pipe()
        pa = hub_a.add_peer("b", pipe.a_to_b.append)
        pb = hub_b.add_peer("a", pipe.b_to_a.append)
        hub_a.open()
        hub_b.open()
        for i in range(3):
            ds_a.set_doc(f"doc{i}", am.change(P.init(f"actor{i}"),
                                              set_("n", i)))
        pipe.pump(pb.receive_msg, pa.receive_msg)
        for i in range(3):
            assert am.to_json(ds_b.get_doc(f"doc{i}")) == {"n": i}
        ds_a.set_doc("doc0", am.change(ds_a.get_doc("doc0"), set_("a", 1)))
        ds_b.set_doc("doc1", am.change(ds_b.get_doc("doc1"), set_("b", 2)))
        pipe.pump(pb.receive_msg, pa.receive_msg)
        for d in ("doc0", "doc1"):
            assert am.to_json(ds_a.get_doc(d)) == am.to_json(ds_b.get_doc(d))
        return pipe.log, [am.save(ds_b.get_doc(f"doc{i}")) for i in range(3)]
    same(run)


def test_no_speculative_changes_for_unrevealed_doc():
    def run(P):
        am = P.am
        ds = P.DocSet()
        hub = P.SyncHub(ds)
        box = []
        h = hub.add_peer("p", box.append)
        hub.open()
        ds.set_doc("A", am.change(P.init("alice"), set_("a", 1)))
        h.receive_msg({"docId": "A", "clock": {}})
        assert [m["docId"] for m in box if m.get("changes")] == ["A"]
        log = [norm(m) for m in box]
        box.clear()
        ds.set_doc("B", am.change(P.init("bob"), set_("b", 2)))
        assert [m for m in box if m.get("changes")] == []
        assert any(m["docId"] == "B" and "changes" not in m for m in box)
        return log + [norm(m) for m in box]
    same(run)


def test_readded_peer_syncs_fresh():
    def run(P):
        ds = P.DocSet()
        hub = P.SyncHub(ds)
        box = []
        h = hub.add_peer("q", box.append)
        hub.open()
        ds.set_doc("D", P.am.change(P.init("alice"), set_("x", 1)))
        h.receive_msg({"docId": "D", "clock": {}})
        assert any(m.get("changes") for m in box)
        hub.remove_peer("q")
        box2 = []
        h2 = hub.add_peer("q", box2.append)
        h2.receive_msg({"docId": "D", "clock": {}})
        assert any(m.get("changes") for m in box2)
        return [norm(m) for m in box + box2]
    same(run)


def test_readded_peer_rerequests_doc_from_prior_session():
    def run(P):
        am = P.am
        ds = P.DocSet()
        hub = P.SyncHub(ds)
        box = []
        h = hub.add_peer("q", box.append)
        hub.open()
        src = am.change(P.init("w"), set_("x", 1))
        h.receive_msg({"docId": "D", "clock": {"w": 1},
                       "changes": am.get_all_changes(src)})
        assert am.to_json(ds.get_doc("D")) == {"x": 1}
        ds.remove_doc("D")
        hub.remove_peer("q")
        box2 = []
        h2 = hub.add_peer("q", box2.append)
        h2.receive_msg({"docId": "D", "clock": {"w": 1}})
        assert [m for m in box2 if m["docId"] == "D" and m["clock"] == {}]
        h2.receive_msg({"docId": "D", "clock": {"w": 1},
                        "changes": am.get_all_changes(src)})
        assert am.to_json(ds.get_doc("D")) == {"x": 1}
        return [norm(m) for m in box + box2], am.save(ds.get_doc("D"))
    same(run)


def test_same_session_removed_doc_still_not_rerequested():
    def run(P):
        am = P.am
        ds = P.DocSet()
        hub = P.SyncHub(ds)
        box = []
        h = hub.add_peer("p", box.append)
        hub.open()
        src = am.change(P.init("w"), set_("x", 1))
        h.receive_msg({"docId": "D", "clock": {"w": 1},
                       "changes": am.get_all_changes(src)})
        ds.remove_doc("D")
        box.clear()
        h.receive_msg({"docId": "D", "clock": {"w": 1}})
        assert [m for m in box if m["docId"] == "D"] == []
        return [norm(m) for m in box]
    same(run)


def test_late_message_for_removed_peer_absorbed_without_send():
    def run(P):
        am = P.am
        ds = P.DocSet()
        hub = P.SyncHub(ds)
        box = []
        h = hub.add_peer("p", box.append)
        hub.open()
        hub.remove_peer("p")
        box.clear()
        src = am.change(P.init("w"), set_("x", 1))
        h.receive_msg({"docId": "D", "clock": {"w": 1},
                       "changes": am.get_all_changes(src)})
        h.receive_msg({"docId": "D", "clock": {"w": 1}})
        assert box == []
        assert am.to_json(ds.get_doc("D")) == {"x": 1}
        return am.save(ds.get_doc("D"))
    same(run)


def test_removed_doc_neither_crashes_nor_resurrects():
    def run(P):
        am = P.am
        ds = P.DocSet()
        hub = P.SyncHub(ds)
        box = []
        h = hub.add_peer("p", box.append)
        hub.open()
        ds.set_doc("D", am.change(P.init("alice"), set_("x", 1)))
        h.receive_msg({"docId": "D", "clock": {}})
        ds.remove_doc("D")
        box.clear()
        ds.set_doc("E", am.change(P.init("bob"), set_("y", 2)))
        assert any(m["docId"] == "E" for m in box)
        log = [norm(m) for m in box]
        box.clear()
        h.receive_msg({"docId": "D", "clock": {"alice": 1}})
        assert [m for m in box if m["docId"] == "D"] == []
        return log
    same(run)


def test_unrevealed_and_removed_pairs_never_enter_pending():
    def run(P):
        am = P.am
        ds = P.DocSet()
        hub = P.SyncHub(ds)
        h = hub.add_peer("p", lambda m: None)
        hub.open()
        ds.set_doc("A", am.change(P.init("alice"), set_("a", 1)))
        ds.set_doc("B", am.change(P.init("bob"), set_("b", 2)))
        h.receive_msg({"docId": "A", "clock": {}})
        assert hub._matrix.pending() == []
        hub.remove_peer("p")
        ds.set_doc("A", am.change(ds.get_doc("A"), set_("a2", 3)))
        assert hub._matrix.pending() == []
        return hub.peer_state("p"), hub.replication_lag()
    same(run)


def test_covered_clock_pair_leaves_pending():
    def run(P):
        am = P.am
        ds = P.DocSet()
        hub = P.SyncHub(ds)
        h = hub.add_peer("p", lambda m: None)
        hub.open()
        a = am.change(P.init("alice"), set_("x", 1))
        b = am.change(am.merge(P.init("bob"), a), set_("y", 2))
        ds.set_doc("D", b)
        h.receive_msg({"docId": "D", "clock": {"bob": 1}})
        assert ("p", "D") not in hub._matrix.pending()
        return hub._matrix.their_clock("p", "D")
    same(run)


def test_missing_changes_fast_cover_path():
    def run(P):
        am = P.am
        d = am.change(P.init("alice"), set_("x", 1))
        d = am.change(d, set_("y", 2))
        state = P.Frontend.get_backend_state(d)
        db = P.device_backend
        assert db.get_missing_changes(state, dict(state.clock)) == []
        missing = db.get_missing_changes(state, {"alice": 1})
        assert len(missing) == 1 and missing[0]["seq"] == 2
        assert len(db.get_missing_changes(state, {})) == 2
        return missing
    same(run)


def test_connection_close_unhooks_hub_from_docset():
    def run(P):
        am = P.am
        ds = P.DocSet()
        d1 = am.change(P.init("alice"), set_("x", 1))
        ds.set_doc("doc", d1)
        c = P.Connection(ds, lambda m: None)
        c.open()
        assert len(ds._handlers) == 1
        d2 = am.change(d1, set_("y", 2))
        ds.set_doc("doc", d2)
        c.close()
        assert ds._handlers == [] and ds._sync_hub is None
        ds.set_doc("doc", d1)
        ds.set_doc("doc", d2)
        c.open()
        assert len(ds._handlers) == 1
        c.close()
        return canon(P, ds.get_doc("doc"))
    same(run)


def test_closed_connection_absorbs_late_messages_without_sending():
    def run(P):
        am = P.am
        ds_a, ds_b = P.DocSet(), P.DocSet()
        out_a, out_b = [], []
        ca = P.Connection(ds_a, out_a.append)
        cb = P.Connection(ds_b, out_b.append)
        ds_a.set_doc("doc", am.change(P.init("alice"), set_("x", 1)))
        ca.open()
        cb.open()
        while out_a or out_b:
            while out_a:
                cb.receive_msg(out_a.pop(0))
            while out_b:
                ca.receive_msg(out_b.pop(0))
        ds_a.set_doc("doc", am.change(ds_a.get_doc("doc"), set_("y", 2)))
        late = [m for m in out_a if m.get("changes")]
        assert late
        cb.close()
        n_sent = len(out_b)
        cb.receive_msg(late[0])
        assert len(out_b) == n_sent and ds_b._sync_hub is None
        assert am.to_json(ds_b.get_doc("doc")) == {"x": 1, "y": 2}
        return norm(late[0]), am.save(ds_b.get_doc("doc"))
    same(run)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_lossy_network_recovers_on_reconnect(seed):
    def run(P):
        am = P.am
        rng = random.Random(41_000 + seed)
        sets = [P.DocSet() for _ in range(3)]
        queues = {(i, j): [] for i in range(3) for j in range(3) if i != j}
        conns = {}
        log = []

        def connect(i, j):
            conns[(i, j)] = P.Connection(sets[i], queues[(i, j)].append)
            conns[(i, j)].open()

        for pair in queues:
            connect(*pair)

        def pump(drop_p, rounds=15):
            for _ in range(rounds):
                moved = False
                for (i, j), q in queues.items():
                    while q:
                        msg = q.pop(0)
                        if rng.random() < drop_p:
                            continue
                        log.append(((i, j), norm(msg)))
                        conns[(j, i)].receive_msg(msg)
                        moved = True
                if not moved:
                    break

        sets[0].set_doc("d", am.change(P.init("seed"), set_("x", 0)))
        for step in range(6):
            i = rng.randrange(3)
            cur = sets[i].get_doc("d")
            if cur is not None:
                sets[i].set_doc("d", am.change(
                    am.set_actor_id(cur, f"n{i}s{step}"),
                    lambda d, step=step, i=i: d.__setitem__(f"k{step}", i)))
            pump(drop_p=0.3, rounds=2)
        for pair in list(conns):
            conns[pair].close()
            connect(*pair)
        for _ in range(5):
            pump(drop_p=0.0)
        states = [am.to_json(s.get_doc("d")) for s in sets
                  if s.get_doc("d") is not None]
        assert len(states) >= 2 and all(s == states[0] for s in states)
        return log, [canon(P, s.get_doc("d")) for s in sets]
    same(run)


# --------------------------------------------------------------------------
# the device binding
# --------------------------------------------------------------------------


def test_docset_creates_and_restores_on_its_backend():
    ds = TP.DocSet()
    src = T.change(TP.init("w"), set_("t", T.Text("abc")))
    doc = ds.apply_changes("d", T.get_all_changes(src))
    core = T.frontend.get_backend_state(doc)._core
    assert str(core.device) == "cpu" and ds.backend is CPU
    ck = T.checkpoint_doc(doc)
    boot = TP.DocSet()
    got = boot.bootstrap_doc("d", ck)
    assert str(T.frontend.get_backend_state(got)._core.device) == "cpu"
    assert T.save(got) == T.save(doc)
    assert T.sync.DocSet().backend is T.backend.DeviceBackend


def test_default_docset_raises_at_its_first_document_without_a_card():
    """`DocSet()` binds the card; without one, the first document it has
    to make (or restore) raises — nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default binding works")
    src = T.change(TP.init("w"), set_("x", 1))
    changes = T.get_all_changes(src)
    ds = T.DocSet()
    ds.set_doc("mine", src)                 # holding a doc needs no device
    with pytest.raises(Exception, match="CUDA"):
        ds.apply_changes("d", changes)
    assert ds.get_doc("d") is None
    hub = T.SyncHub(T.DocSet())
    peer = hub.add_peer("p", lambda m: None)
    hub.open()
    with pytest.raises(Exception, match="CUDA"):
        peer.receive_msg({"docId": "d", "clock": {"w": 1},
                          "changes": changes})
    with pytest.raises(Exception, match="CUDA"):
        T.DocSet().bootstrap_doc("d", T.checkpoint_doc(src))


# --------------------------------------------------------------------------
# snapshot bootstrap (tests/test_checkpoint.py twins)
# --------------------------------------------------------------------------


def _history_doc(P, n=12):
    am = P.am
    doc = am.change(P.init("w"), set_("t", am.Text("")))
    for i in range(n):
        doc = am.change(doc, lambda d, i=i: d["t"].insert_at(0, str(i % 10)))
    return doc


def _hub_join(P, src, threshold, corrupt=False, log=None):
    """A hub holding `src` and one fresh joiner over a plain Connection
    (tests/test_checkpoint.py `_hub_join`); -> the joiner's DocSet."""
    ds_a = P.DocSet()
    ds_a.set_doc("doc", src)
    hub = P.SyncHub(ds_a)
    hub.snapshot_min_changes = threshold
    ds_b = P.DocSet()
    a_to_b, b_to_a = [], []

    def tamper(m):
        if corrupt and m.get("checkpoint"):
            raw = bytearray(P.ckpt.Checkpoint.from_base64(
                m["checkpoint"]).data)
            raw[len(raw) // 2] ^= 0xFF
            m = dict(m, checkpoint=P.ckpt.Checkpoint(bytes(raw)).to_base64())
        a_to_b.append(m)

    pb = hub.add_peer("b", tamper)
    hub.open()
    conn_b = P.Connection(ds_b, b_to_a.append)
    conn_b.open()
    for _ in range(20):
        if not a_to_b and not b_to_a:
            break
        while a_to_b:
            m = a_to_b.pop(0)
            if log is not None:
                log.append(("ab", norm(m)))
            conn_b.receive_msg(m)
        while b_to_a:
            m = b_to_a.pop(0)
            if log is not None:
                log.append(("ba", norm(m)))
            pb.receive_msg(m)
    return ds_b


def test_sync_snapshot_bootstrap():
    def run(P):
        src = _history_doc(P)
        log = []
        ds_b = _hub_join(P, src, threshold=4, log=log)
        got = ds_b.get_doc("doc")
        assert P.am.save(got) == P.am.save(src)
        assert any("checkpoint" in m for _, m in log)
        return log, P.am.save(got)
    same(run)


def test_sync_snapshot_corrupt_falls_back_to_full_history():
    def run(P):
        src = _history_doc(P)
        log = []
        ds_b = _hub_join(P, src, threshold=4, corrupt=True, log=log)
        got = ds_b.get_doc("doc")
        assert P.am.save(got) == P.am.save(src)
        assert any(m.get("noSnapshot") for _, m in log)
        return log, P.am.save(got)
    same(run)


def test_sync_snapshot_disabled_by_zero_threshold():
    def run(P):
        src = _history_doc(P)
        log = []
        ds_b = _hub_join(P, src, threshold=0, log=log)
        assert not any("checkpoint" in m for _, m in log)
        assert P.am.save(ds_b.get_doc("doc")) == P.am.save(src)
        return log
    same(run)


def test_corrupt_bundle_docset_falls_back_to_full_replay():
    """The DocSet half of tests/test_checkpoint.py
    `test_corrupt_bundle_falls_back_to_full_replay`: bootstrap_doc with
    the full log replays it; without one, the CheckpointError surfaces."""
    def run(P):
        am = P.am
        src = _history_doc(P, 6)
        raw = bytearray(am.checkpoint_doc(src).data)
        raw[len(raw) // 2] ^= 0xFF
        bad = P.ckpt.Checkpoint(bytes(raw))
        with pytest.raises(P.res.CheckpointError):
            P.DocSet().bootstrap_doc("d", bad)
        ds = P.DocSet()
        got = ds.bootstrap_doc("d", bad,
                               fallback_changes=am.get_all_changes(src))
        assert am.save(got) == am.save(src)
        return am.save(got)
    same(run)


def test_checkpoint_base64_round_trip_is_byte_equal():
    def run(P):
        ck = P.am.checkpoint_doc(_history_doc(P, 5))
        text = ck.to_base64()
        back = P.ckpt.Checkpoint.from_base64(text)
        assert back.data == ck.data
        with pytest.raises(P.res.CheckpointError, match="base64"):
            P.ckpt.Checkpoint.from_base64("not base64!")
        return text
    same(run)


def test_snapshot_cache_serves_bytes_after_later_rounds(monkeypatch):
    """The hub caches a captured bundle as immutable bytes, never table
    references: later rounds on the served document leave the cached
    bundle servable, and a later joiner gets it plus the tail."""
    monkeypatch.setenv("AMTPU_WIRE_MIN_OPS", "1")

    def run(P):
        am = P.am
        server = P.DocSet()
        server.set_doc("doc", _history_doc(P, 10))
        hub = P.SyncHub(server)
        hub.snapshot_min_changes = 8
        saves = []
        for i in range(3):
            peer = P.DocSet()
            q_s, q_c = [], []
            pid = f"peer{i}"
            ph = hub.add_peer(pid, q_s.append)
            if i == 0:
                hub.open()
            c_conn = P.Connection(peer, q_c.append)
            c_conn.open()
            for _ in range(40):
                if not q_s and not q_c:
                    break
                while q_s:
                    c_conn.receive_msg(q_s.pop(0))
                while q_c:
                    ph.receive_msg(q_c.pop(0))
            assert am.save(peer.get_doc("doc")) == \
                am.save(server.get_doc("doc"))
            saves.append(am.save(peer.get_doc("doc")))
            c_conn.close()
            hub.remove_peer(pid)
            server.set_doc("doc", am.change(server.get_doc("doc"), lambda d,
                                            i=i: d["t"].insert_at(0, "t")))
        return saves, hub._ckpt_cache["doc"][2]
    same(run)


# --------------------------------------------------------------------------
# lineage (tests/test_lineage.py twins and the module-level wrappers)
# --------------------------------------------------------------------------


@pytest.fixture
def lineage_on():
    for P in (JP, TP):
        P.lineage.enable(rate=1, capacity=4096)
        P.lineage.clear()
    yield
    for P in (JP, TP):
        P.lineage.disable()
        P.lineage.clear()


def test_lineage_module_wrappers(lineage_on):
    def run(P):
        lin = P.lineage
        ds = P.DocSet()
        ds._lineage_site = "site-x"
        assert lin.site_of(ds) == "site-x"
        assert lin.site_of(P.DocSet()).startswith("ds-")
        assert lin.sampled("a", 1)
        lin.hop("a", 1, "origin", site="a")
        ctx = lin.context_for([{"actor": "a", "seq": 1}])
        assert ctx and ctx[0][:2] == ["a", 1]
        lin.adopt([["b", 2, 5, "site-b"]])
        lin.adopt_clock({"a": 1}, site="site-y", doc="d")
        lin.disable()
        assert lin.context_for([{"actor": "a", "seq": 1}]) is not None
        return sorted((c["actor"], c["seq"]) for c in lin._ledger.chains())
    same(run)


def test_flow_events_pair_up_and_validate(lineage_on):
    """tests/test_lineage.py `test_flow_events_pair_up_and_validate` on
    both packages: a two-DocSet Connection flow under obs.tracing()
    exports flow events that pair up and validate; a dangling start
    fails validation. Both record the same chains, seen at the same
    sites, with the same flow count."""
    def run(P):
        am, obs = P.am, P.obs
        export = __import__(P.am.__name__ + ".obs.export",
                            fromlist=["to_chrome_trace"])
        with obs.tracing():
            obs.clear()
            a, b = P.DocSet(), P.DocSet()
            a._lineage_site, b._lineage_site = "A", "B"
            qa, qb = [], []
            ca, cb = P.Connection(a, qa.append), P.Connection(b, qb.append)
            a.set_doc("d", am.change(P.init("flow-author"),
                                     set_("t", am.Text("x"))))
            ca.open()
            cb.open()

            def pump():
                for _ in range(40):
                    if not qa and not qb:
                        break
                    while qa:
                        cb.receive_msg(qa.pop(0))
                    while qb:
                        ca.receive_msg(qb.pop(0))
            pump()
            a.set_doc("d", am.change(a.get_doc("d"),
                                     lambda d: d["t"].insert_at(0, "Q")))
            pump()
            trace = export.to_chrome_trace(obs.snapshot(),
                                           t0_ns=obs.recorder().t0_ns)
        res = export.validate_chrome_trace(trace, require_flows=True)
        assert res["n_flows"] >= 1
        broken = dict(trace)
        broken["traceEvents"] = [e for e in trace["traceEvents"]
                                 if e.get("ph") != "f"]
        with pytest.raises(export.TraceValidationError):
            export.validate_chrome_trace(broken)
        led = P.lineage._ledger
        assert am.save(b.get_doc("d")) == am.save(a.get_doc("d"))
        return res["n_flows"], sorted(
            (c["actor"], c["seq"], tuple(sorted(led.visible_sites(c))))
            for c in led.chains())
    same(run)


@pytest.mark.parametrize("seed", range(3))
def test_three_peer_chaos_identical_sampling(seed):
    """tests/test_lineage.py `test_three_peer_chaos_identical_sampling`
    on both packages: three replicas over seeded chaotic channels; at
    convergence every sampled chain is visible on every other replica,
    the sampled subset is the pure-function subset of the history, no
    chain has a duplicate hop, and both packages sample the same chains,
    see them at the same sites, and drive the same fault schedules."""
    def run(P):
        am, lin = P.am, P.lineage
        rng = random.Random(1000 + seed)
        led = lin.enable(rate=4, capacity=2048)
        led.clear()
        try:
            names = ["P0", "P1", "P2"]
            sets = {}
            links = {}
            for n in names:
                ds = P.DocSet()
                ds._lineage_site = n
                sets[n] = ds
            doc0 = am.change(P.init("seed-origin"),
                             set_("t", am.Text("base")))
            base = am.get_all_changes(doc0)
            for n in names:
                sets[n].set_doc("d", am.apply_changes(P.init(f"rep-{n}"),
                                                      base))
            chaos = dict(drop=0.08, dup=0.08, reorder=0.15)
            for i, a in enumerate(names):
                for b in names[i + 1:]:
                    la = P.res.ChaosLink(None, seed=seed * 31 + i, **chaos)
                    lb = P.res.ChaosLink(None, seed=seed * 31 + i + 7,
                                         **chaos)
                    ch_a = P.res.ResilientChannel(la.send, None, seed=1,
                                                  label=f"{a}->{b}")
                    ch_b = P.res.ResilientChannel(lb.send, None, seed=2,
                                                  label=f"{b}->{a}")
                    la._deliver = ch_b.on_wire
                    lb._deliver = ch_a.on_wire
                    ca = P.Connection(sets[a], ch_a.send)
                    cb = P.Connection(sets[b], ch_b.send)
                    ch_a._deliver = ca.receive_msg
                    ch_b._deliver = cb.receive_msg
                    ca.open()
                    cb.open()
                    links[(a, b)] = (la, lb, ch_a, ch_b)

            def pump(rounds=60):
                for _ in range(rounds):
                    busy = False
                    for la, lb, ch_a, ch_b in links.values():
                        la.pump()
                        lb.pump()
                        ch_a.tick()
                        ch_b.tick()
                        busy = busy or not (la.idle and lb.idle
                                            and ch_a.idle and ch_b.idle)
                    if not busy:
                        return
            pump()
            for r in range(4):
                n = names[r % 3]
                text = "".join(chr(97 + rng.randrange(26))
                               for _ in range(20))
                sets[n].set_doc("d", am.change(
                    sets[n].get_doc("d"),
                    lambda d, t=text: d["t"].insert_at(0, *list(t))))
                pump()
            pump(200)
            saves = {n: am.save(sets[n].get_doc("d")) for n in names}
            assert len(set(saves.values())) == 1, "mesh diverged"
            history = am.get_all_changes(sets["P0"].get_doc("d"))
            expected = {(c["actor"], c["seq"]) for c in history
                        if led.sampled(c["actor"], c["seq"])}
            assert expected
            chains = {(c["actor"], c["seq"]): c for c in led.chains()}
            assert expected <= set(chains)
            seen = []
            for key in sorted(expected):
                c = chains[key]
                vis = led.visible_sites(c)
                others = {n for n in names
                          if c["origin_site"] != f"rep-{n}"
                          and not c["origin_site"].startswith("seed")}
                assert not {n for n in others if n not in vis}
                hop_keys = [(h[0], h[1], h[3]) for h in c["hops"]]
                assert len(hop_keys) == len(set(hop_keys))
                seen.append((key, tuple(sorted(vis)), c["origin_site"]))
            stats = [(dict(la.stats), dict(lb.stats), dict(ch_a.stats),
                      dict(ch_b.stats))
                     for la, lb, ch_a, ch_b in links.values()]
            return saves, seen, stats
        finally:
            lin.disable()
            lin.clear()
    same(run)


# --------------------------------------------------------------------------
# on a card only (`cuda` marker)
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_session(backend):
    """Two DocSets on `backend` synced over Connections, with bulk text
    edits riding the binary wire; then a frame the backend rejects in
    the gate's fast lane. -> (message log, saves, text, rejected-save)."""
    am = T
    a, b = T.DocSet(backend=backend), T.DocSet(backend=backend)
    qa, qb = [], []
    ca, cb = T.Connection(a, qa.append), T.Connection(b, qb.append)
    ca.open()
    cb.open()
    log = []

    def pump():
        while qa or qb:
            while qa:
                m = qa.pop(0)
                log.append(("a", norm(m)))
                cb.receive_msg(m)
            while qb:
                m = qb.pop(0)
                log.append(("b", norm(m)))
                ca.receive_msg(m)
    where = {"actorId": "author"}
    if backend is not None:
        where["backend"] = backend
    doc = am.change(am.init(where), set_("t", am.Text("x" * 300)))
    a.set_doc("d", doc)
    pump()
    b.set_doc("d", am.set_actor_id(b.get_doc("d"), "peer-b"))
    for k in range(4):
        ds = a if k % 2 == 0 else b
        ds.set_doc("d", am.change(ds.get_doc("d"), lambda d, k=k: d["t"]
                                  .insert_at(7 * k, *(str(k) * 70))))
        pump()
    before = am.save(b.get_doc("d"))
    state = T.frontend.get_backend_state(b.get_doc("d"))
    obj = T.get_object_id(b.get_doc("d")["t"])
    bad = [{"actor": "zz", "seq": 1, "deps": dict(state.clock), "ops": [
        {"action": "ins", "obj": obj, "key": "nobody:9", "elem": e}
        for e in range(1, 70)]}]
    frame = TP.wf.WireFrame(TP.wf.encode_changes(bad))
    with pytest.raises(T.ProtocolError):
        TP.inbound.inbound_gate(b).deliver_wire("d", [(frame, "p")])
    after = T.frontend.get_backend_state(b.get_doc("d"))
    assert dict(after.clock) == dict(state.clock)
    return (log, am.save(a.get_doc("d")), am.save(b.get_doc("d")),
            str(b.get_doc("d")["t"]), before)


@pytest.mark.cuda
def test_card_docsets_sync_like_the_cpu_backend(card):
    """DocSet() binds the card: documents it makes and restores live
    there, the sync session sends the CPU backend's messages and commits
    its bytes, and a fast-lane rejection on the card leaves the document
    and clock untouched (the device core restores before raising)."""
    from automerge_tpu_torch.ops import scan_kernels as S
    pin()
    S.reset_launches()
    on_card = _card_session(None)
    assert S.launches["multi_scan"] >= 1
    pin()
    on_cpu = _card_session(CPU)
    assert on_card == on_cpu
    assert on_card[2] == on_card[4]
    ds = T.DocSet()
    got = ds.bootstrap_doc("d", T.checkpoint_doc(
        T.change(T.init({"actorId": "w"}), set_("t", T.Text("abc")))))
    assert T.frontend.get_backend_state(got)._core.device.type == "cuda"
