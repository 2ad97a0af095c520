"""A sync server's rooms (`portbench` family `sync_rounds`, cell
`rooms_100x10.typing_rounds`) on the CPU at a small size: the generator
writes what a frontend mints and declares the clock a Connection
declares, the plain reference (`portbench/reference/sync.py`) gives a
hand-worked pair of rooms, the port's SyncService runs the rounds with
every check at 0, a planted fault fails its own check and no other, and
the service's and the hub's spans are recorded, nested and read by the
cell's readers.
"""

import copy
import json
import time
from types import SimpleNamespace

import pytest
import torch

import automerge_tpu_torch as am
from automerge_tpu_torch import _uuid, obs
from automerge_tpu_torch.backend import facade as port_oracle
from portbench import control, drive, harness, spec
from portbench.families import sync_rounds
from portbench.reference.sync import SyncReference, elem_of, text_ops

CELL = "rooms_100x10.typing_rounds"
SMALL = {"rooms": 3, "peers_per_room": 4}
CPU = torch.device("cpu")
CHECKS = ("wrong_texts", "missed_deliveries", "wrong_deliveries",
          "unacked_frames", "lagging_peers", "shed_or_evicted",
          "graduated_rooms")
READERS = ("svc.admit_ms_per_round.sync", "svc.deliver_ms_per_round.sync",
           "svc.chan_ms_per_round.sync", "hub.flush_ms_per_round.sync",
           "hub.frame_ms_per_round.sync")
SHARED = ("device.idle_pct.merge", "multi_scan.roofline_pct.merge")


@pytest.fixture(autouse=True)
def _tracing_off():
    obs.disable()
    yield
    obs.disable()


def small_cell(**size):
    c = spec.cell(CELL)
    c.config.update(SMALL, **size)
    return c


def rooms(seed, **size):
    c = small_cell()
    return sync_rounds.Rooms(dict(c.config, **size), c.traffic, seed)


def server(cls=sync_rounds.Server, seed=2**31 + 5, **size):
    c = small_cell(**size)
    return cls(drive.program(), CPU, c.config, c.traffic, seed)


def run_rounds(runner, n=3):
    """Set up (the join and the warm rounds), n rounds, and the checks."""
    runner.setup(0.0)
    for _ in range(n):
        runner.unit()
        runner.attempted += 1
    runner.release()
    return runner.check()


# --- the generator ---

def test_generator_writes_what_a_frontend_mints():
    """The base and a round's change of each peer, minted by the port's
    frontend on its oracle with the generator's ids, are the generator's
    change dicts, and each peer's clock after its change is the clock
    the generator declares for it."""
    gen = rooms(7, rooms=1)
    a0 = gen.actors[0]
    ids = iter([gen.text_id])
    _uuid.set_factory(lambda: next(ids))
    try:
        made = am.change(am.init({"actorId": a0,
                                  "backend": port_oracle.Backend}),
                         lambda d: d.__setitem__("t", am.Text()))
    finally:
        _uuid.reset()
    base = am.get_all_changes(made)
    for i, actor in enumerate(gen.actors):
        peer = made if i == 0 else am.apply_changes(
            am.init({"actorId": actor, "backend": port_oracle.Backend}),
            base[:1])
        typed = am.change(peer, lambda d, i=i: d["t"].insert_at(
            0, *[chr(gen.base_codes[i])] * gen.chars))
        base += am.get_changes(peer, typed)
    assert base == gen.base_changes()
    want = gen.round(0)[gen.room_ids[0]]
    for i, actor in enumerate(gen.actors):
        peer = am.apply_changes(am.init({"actorId": actor,
                                         "backend": port_oracle.Backend}),
                                base)
        run = "".join(v["value"] for v in want[i][0]["ops"][1::2])
        # the base runs stand in descending actor order
        at = (sorted(gen.actors, reverse=True).index(actor) + 1) * gen.chars
        typed = am.change(peer, lambda d: d["t"].insert_at(at, *run))
        assert am.get_changes(peer, typed) == [want[i][0]], i
        assert am.frontend.get_backend_state(typed).clock == want[i][1]


def test_a_round_is_8000_ops_at_the_cells_size():
    c = spec.cell(CELL)
    gen = sync_rounds.Rooms(c.config, c.traffic, 2**40 + 3)
    assert gen.n_ops == 8000
    r = gen.round(5)
    assert len(r) == 100 and all(len(v) == 10 for v in r.values())
    assert sum(len(ch["ops"]) for v in r.values() for ch, _ in v) == 8000
    assert len(set(gen.actors + gen.servers + [gen.text_id, gen.origin])) \
        == 112


def test_a_message_is_what_a_connection_sends():
    """The thin client's message: the change as split_outgoing leaves an
    8-op change (below the frame threshold, so dict changes) and the
    clock; a fresh dict each round."""
    runner = server()
    runner.gen = rooms(1)
    runner.n_made = 0
    msgs = runner.make_round()
    want = runner.gen.round(0)
    flat = [(rid, c, k) for rid, v in want.items() for c, k in v]
    assert [m["docId"] for m in msgs] == [rid for rid, _, _ in flat]
    assert [m["changes"] for m in msgs] == [[c] for _, c, _ in flat]
    assert [m["clock"] for m in msgs] == [k for _, _, k in flat]
    assert all("wire" not in m for m in msgs)


# --- the reference ---

def _hand_room(text_id, a, b, first, second):
    """Two peers `a` < `b`: a makes the text and types `first` from the
    head, b types `second` from the head concurrently."""
    return [
        {"actor": a, "seq": 1, "deps": {}, "ops": [
            {"action": "makeText", "obj": text_id},
            {"action": "link", "obj": "root", "key": "t",
             "value": text_id}]},
        {"actor": a, "seq": 2, "deps": {}, "ops": [
            {"action": "ins", "obj": text_id, "key": "_head", "elem": 1},
            {"action": "set", "obj": text_id, "key": f"{a}:1",
             "value": first}]},
        {"actor": b, "seq": 1, "deps": {a: 1}, "ops": [
            {"action": "ins", "obj": text_id, "key": "_head", "elem": 1},
            {"action": "set", "obj": text_id, "key": f"{b}:1",
             "value": second}]}]


def test_reference_on_a_hand_worked_pair_of_rooms():
    """Room r1: "a" types x, "b" types y, concurrently from the head: b's
    element (1, b) is the greater, so the text is "yx". Each then types
    after its own char: a's "1" lands at the end, b's "2" between y and
    x: "y2x1". Room r2 from the same base: a deletes b's y and types "3"
    after its own x; b, which declares a clock a round behind on a,
    types nothing but is owed both of a's changes."""
    T = "text"
    base = _hand_room(T, "a", "b", "x", "y")
    ref = SyncReference(T, base, ["r1", "r2"])
    assert ref.texts() == {"r1": "yx", "r2": "yx"}
    a1 = {"actor": "a", "seq": 3, "deps": {"b": 1}, "ops": [
        {"action": "ins", "obj": T, "key": "a:1", "elem": 2},
        {"action": "set", "obj": T, "key": "a:2", "value": "1"}]}
    b1 = {"actor": "b", "seq": 2, "deps": {"a": 2}, "ops": [
        {"action": "ins", "obj": T, "key": "b:1", "elem": 2},
        {"action": "set", "obj": T, "key": "b:2", "value": "2"}]}
    a2 = {"actor": "a", "seq": 3, "deps": {"b": 1}, "ops": [
        {"action": "del", "obj": T, "key": "b:1"},
        {"action": "ins", "obj": T, "key": "a:1", "elem": 2},
        {"action": "set", "obj": T, "key": "a:2", "value": "3"}]}
    ref.round({"r1": [(a1, {"a": 3, "b": 1}), (b1, {"a": 2, "b": 2})],
               "r2": [(a2, {"a": 3, "b": 1})]})
    assert ref.texts() == {"r1": "y2x1", "r2": "x3"}
    assert ref.owed == {("r1", "a"): {("b", 2)}, ("r1", "b"): {("a", 3)},
                        ("r2", "a"): set()}
    # b in r2 declares it holds a's seq 1 only: owed a's seq 2 and 3
    assert ref.rooms["r2"].owed("b", {"a": 1, "b": 1}) == {("a", 2),
                                                            ("a", 3)}
    assert ref.rooms["r2"].owed("a", {}) == {("b", 1)}


def test_reference_ops_and_element_ids():
    assert elem_of("0f3a-b:12") == (12, "0f3a-b")
    ops = text_ops(_hand_room("T", "a", "b", "x", "y")[2], "T")
    assert ops == [("ins", (1, "b"), None), ("set", (1, "b"), ord("y"))]


def test_reference_imports_nothing_of_the_program_or_jax():
    import ast
    import pathlib
    src = pathlib.Path(spec.HERE, "reference", "sync.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "bisect"}, names


# --- the runner ---

def test_three_rounds_on_the_cpu_with_every_check_at_0():
    runner = server()
    checks, failed = run_rounds(runner)
    assert checks == {k: (0, 0) for k in CHECKS}
    assert failed == 0
    assert runner.n_rounds == runner.WARM + 3
    assert runner.n_ops == 3 * 3 * 4 * 8
    assert runner.counters["unsettled_rounds"] == 0
    # one tick takes a round in; the clients' acks close it
    assert runner.counters["ticks"] == 3


def test_the_cell_runs_correct_through_the_harness():
    res = harness.run_cell(drive.program(), torch, small_cell(), 2**33 + 9,
                           0.5, False, CPU, time.time_ns())
    assert res["correct"], res["checks"]
    assert res["checks"] == {k: {"value": 0, "limit": 0} for k in CHECKS}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "merge_ops_per_s"}
    json.dumps(res)


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_control_fails_on_wrong_texts_alone(seed):
    c = small_cell()
    res = control.run_control(c, seed, units=3)
    assert not res["correct"] and res["failed"] == 3
    assert {k for k, v in res["checks"].items() if v["value"]} == \
        {"wrong_texts"}


def first_fanout(runner, alter):
    """Route the first fan-out message the hub of the first room sends
    its first peer after set-up through `alter` (-> the message to send,
    or None to lose it before the channel)."""
    rid = runner.gen.room_ids[0]
    peer = runner.svc.room(rid).hub._peers[f"{rid}/0"]
    send, seen = peer.send_msg, []

    def routed(msg):
        if not seen and (msg.get("changes") or msg.get("wire")):
            seen.append(msg)
            msg = alter(msg)
            if msg is None:
                return
        send(msg)
    peer.send_msg = routed


class DropOneFrame(sync_rounds.Server):
    """The hub of the first room loses the first fan-out it sends its
    first peer after set-up, before the channel: nothing re-sends it."""

    def setup(self, seconds):
        super().setup(seconds)
        first_fanout(self, lambda msg: None)


def with_one_value_changed(msg):
    """A copy of a fan-out message whose last change types one char in
    upper case (the traffic types a-z): each change keeps its actor, seq
    and deps; a frame is encoded anew from its changes."""
    from automerge_tpu_torch.engine.wire_format import split_outgoing
    changes = copy.deepcopy(list(msg.get("changes") or ()))
    if msg.get("wire") is not None:
        changes += copy.deepcopy(msg["wire"].changes())
    op = changes[-1]["ops"][-1]
    assert op["action"] == "set"
    op["value"] = op["value"].upper()
    prefix, frame = split_outgoing(changes)
    out = {k: v for k, v in msg.items() if k not in ("changes", "wire")}
    if prefix:
        out["changes"] = prefix
    if frame is not None:
        out["wire"] = frame
    return out


class AlterOneValue(sync_rounds.Server):
    """The hub of the first room sends its first peer, in the first
    fan-out after set-up, one typed char changed: every change arrives
    under its own (actor, seq), one with a wrong value."""

    def setup(self, seconds):
        super().setup(seconds)
        first_fanout(self, with_one_value_changed)


class FlipOneChar(sync_rounds.Server):
    """One room's text reads with one char flipped."""

    def release(self):
        super().release()
        rid = self.gen.room_ids[1]
        t = self.texts[rid]
        self.texts[rid] = ("b" if t[0] != "b" else "c") + t[1:]


class NeverAck(sync_rounds.Server):
    """The server's channel of one session acknowledges nothing after
    set-up, neither by an ack nor on its data frames."""
    SETTLE_TICKS = 6

    def setup(self, seconds):
        super().setup(seconds)
        chan = self.svc.session(f"{self.gen.room_ids[0]}/1").channel
        send, frozen = chan._send_raw, chan._recv_high

        def no_ack(env):
            if env["kind"] == "data":
                send(dict(env, ack=frozen))
        chan._send_raw = no_ack


class ForceShed(sync_rounds.Server):
    """A tick budget of a nanosecond: each tick admits its first tenant
    and sheds the rest to the next."""

    def setup(self, seconds):
        super().setup(seconds)
        self.svc.config.tick_budget_ms = 1e-6


class Graduated(sync_rounds.Server):
    """One room's document is swapped, after set-up, for a replica on
    the host oracle backend holding the same changes."""

    def setup(self, seconds):
        super().setup(seconds)
        rid = self.gen.room_ids[2]
        ds = self.svc.room(rid).doc_set
        doc = ds.get_doc(rid)
        ds.set_doc(rid, am.apply_changes(
            am.init({"actorId": self.gen.servers[2],
                     "backend": port_oracle.Backend}),
            am.get_all_changes(doc)))


@pytest.mark.parametrize("fault, caught", [
    (DropOneFrame, "missed_deliveries"),
    (AlterOneValue, "wrong_deliveries"),
    (FlipOneChar, "wrong_texts"),
    (NeverAck, "unacked_frames"),
    (ForceShed, "shed_or_evicted"),
    (Graduated, "graduated_rooms"),
], ids=["drop_fanout_frame", "alter_fanout_value", "flip_char", "never_ack",
        "force_shed", "graduated_room"])
def test_a_planted_fault_fails_its_own_check_alone(fault, caught):
    runner = server(fault)
    checks, failed = run_rounds(runner)
    assert {k for k, (v, _) in checks.items() if v} == {caught}
    assert failed == 3


def test_a_value_changed_in_a_fanout_frame_fails_wrong_deliveries_alone():
    """At the cell's 10 peers a room a fan-out carries the 9 others'
    72 ops as a wire frame: one char changed inside the frame is one
    wrong delivery, and nothing else fails."""
    runner = server(AlterOneValue, rooms=2, peers_per_room=10)
    checks, failed = run_rounds(runner)
    frames = [p for p in runner.got[f"{runner.gen.room_ids[0]}/0"]
              if p.get("wire") is not None]
    assert frames and not any(p.get("changes") for p in frames)
    assert checks == dict({k: (0, 0) for k in CHECKS},
                          wrong_deliveries=(1, 0))
    assert failed == 3


def test_a_dropped_frame_misses_the_other_peers_changes():
    checks, _ = run_rounds(server(DropOneFrame))
    # the lost frame held the round's changes of the room's 3 other peers
    assert checks["missed_deliveries"] == (3, 0)


def test_duplicates_are_no_check():
    """A shed round reaches a peer in pieces: what it is owed arrives,
    and nothing twice (the hub keeps the greater of the believed and
    the declared clock)."""
    runner = server(ForceShed)
    checks, _ = run_rounds(runner)
    assert checks["missed_deliveries"] == (0, 0)
    for tid, got in runner.got.items():
        seen = [(c["actor"], c["seq"]) for c in sync_rounds.received(got)]
        assert len(seen) == len(set(seen)), tid


# --- the spans and their readers ---

@pytest.fixture(scope="module")
def traced_rounds():
    """Two traced rounds of the small cell on the CPU: the window's
    spans, the ring's records and the runner."""
    runner = server(seed=2**31 + 3)
    runner.setup(0.0)
    runner.spans.clear()
    with obs.tracing():
        obs.clear()
        runner.unit()
        runner.unit()
        snap = obs.metrics_snapshot()
        recs = [(f"{r[2]}/{r[3]}", r[0], r[0] + r[1], r[4], r[5])
                for r in obs.snapshot() if r[1] >= 0]
    obs.disable()
    return runner, snap, recs


def _inside(child, parent):
    return (parent[1] <= child[1] and child[2] <= parent[2]
            and child[3] == parent[3])


def test_the_tick_spans_nest(traced_rounds):
    _r, snap, recs = traced_rounds
    ticks = [r for r in recs if r[0] == "svc/tick"]
    assert len(ticks) == 2
    for name in ("svc/admit", "svc/deliver", "svc/chan"):
        kids = [r for r in recs if r[0] == name]
        assert len(kids) == 2, name
        assert all(any(_inside(k, t) for t in ticks) for k in kids), name
    for t in ticks:
        inner = sorted((k for k in recs if _inside(k, t) and k[0] in (
            "svc/admit", "svc/deliver", "svc/chan")), key=lambda k: k[1])
        assert [k[0] for k in inner] == ["svc/admit", "svc/deliver",
                                         "svc/chan"]
    admits = [r for r in recs if r[0] == "svc/admit"]
    assert [a[4] for a in admits] == [{"tenants": 12, "frames": 12}] * 2
    # the room's backend apply runs inside the grouped delivery
    delivers = [r for r in recs if r[0] == "svc/deliver"]
    applies = [r for r in recs if r[0] == "backend/distribute"]
    assert len(applies) == 2 * 3
    assert all(any(_inside(a, d) for d in delivers) for a in applies)


def test_the_hub_spans_nest(traced_rounds):
    _r, snap, recs = traced_rounds
    flushes = [r for r in recs if r[0] == "hub/flush"]
    frames = [r for r in recs if r[0] == "hub/frame"]
    ticks = [r for r in recs if r[0] == "svc/tick"]
    # one flush a room a tick; one frame a peer (each declared its own
    # clock, so each has its own group)
    assert len(flushes) == 2 * 3 and len(frames) == 2 * 3 * 4
    assert all(any(_inside(f, h) for h in flushes) for f in frames)
    assert all(any(_inside(h, t) for t in ticks) for h in flushes)
    assert all(h[4] == {"peers": 4, "pairs": 4} for h in flushes)
    c = snap["counters"]
    assert c["sync.hub.fanout_msgs"] == 2 * 3 * 4
    assert c["sync.hub.fanout_changes"] == 2 * 3 * 4 * 3


def test_each_new_reader_reads_the_recording(traced_rounds):
    runner, snap, _recs = traced_rounds
    c = small_cell()
    reading = harness.Reading(c, runner, 1.0, 1.0)
    reading.obs_spans = snap["spans"]
    reading.device = SimpleNamespace(busy_s=0.25, window_s=1.0)
    assert sorted(m["name"] for m in c.per_layer) == sorted(READERS + SHARED)
    for name in READERS:
        value = spec.reader(name)(reading)
        assert value is not None and value > 0, name
    assert spec.reader("svc.deliver_ms_per_round.sync")(reading) == \
        pytest.approx(snap["spans"]["svc.deliver"]["total_ns"] / 1e6 / 2)
    assert spec.reader("device.idle_pct.merge")(reading) == 75.0


def test_readers_read_nothing_from_a_program_without_the_spans(
        traced_rounds):
    runner, snap, _recs = traced_rounds
    reading = harness.Reading(small_cell(), runner, 1.0, 1.0)
    reading.obs_spans = {k: v for k, v in snap["spans"].items()
                         if k.split(".")[0] not in ("svc", "hub")
                         or k == "svc.tick"}
    for name in READERS:
        assert spec.reader(name)(reading) is None, name


def test_off_path_reads_no_clock(monkeypatch):
    runner = server()
    runner.setup(0.0)
    calls = []
    real = obs.now

    def counted():
        calls.append(1)
        return real()

    monkeypatch.setattr(obs, "now", counted)
    assert not obs.ENABLED
    runner.unit()
    assert calls == []
