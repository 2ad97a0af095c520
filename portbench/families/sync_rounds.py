"""Family `sync_rounds`: a sync server whose rooms each hold one shared
Text document, typed in by the room's collaborators over Automerge 0.14's
sync protocol (src/connection.js: `{docId, clock, changes}` messages) and
served by the port's `SyncService` (benchmarks/run_all.py
config11_service).

The generator: every room starts from one base document, docset_build's
(`Population`, `typing_run`): a root map whose `t` is a Text holding
`peers_per_room` concurrent runs of `doc_chars` chars from the head, one
by each of the room's actors (the first actor made the text in its seq
1 and typed its run in seq 2). In round r each peer of each room types
a `run`-char run after its own last char: one change of 2 * run ops,
whose deps are every other peer's previous change, as a frontend mints
it after it merged the round before. Actor and object ids are UUID-form
strings drawn from the seed; the seed draws the letters too.

The runner: set-up mints the base as change dicts, captures one
checkpoint bundle of it and restores it as every room's server document
(under the room's own server actor) on the runner's device; it connects
every peer as a tenant session, settles the join handshake (each peer
answers the server's advertisement with its clock) and a few warm
rounds, and makes the window's rounds ahead. A peer is a thin client:
the port's `ResilientChannel` over a lossless queue each way. In a round
every peer sends its change in the message the port's `Connection` sends
(the change as `split_outgoing` leaves it, and the clock the peer
declares: every change of the rounds before, plus its own); the server
ticks until it and every channel are idle and every queue is empty. A
client keeps what it receives, undecoded, and acks it through its
channel; nothing on the client side applies a change in the window.

After the window the runner reads every room's text, the channels'
un-acked frames, the replication lag, the degradation counters and the
room documents' backend states; `check()` decodes what each client
received, in full, holds every change delivered to the change its peer
sent (as canonical JSON), and holds the rest to `reference/sync.py`.
"""

from __future__ import annotations

import collections
import gc
import json
import sys
import time

from portbench.drive import Runner, now, rng_for
from portbench.families.board_merge import uuid_from
from portbench.families.docset_build import HEAD, Population, typing_run
from portbench.reference.sync import SyncReference

ROOT_ID = "00000000-0000-0000-0000-000000000000"


def op_dicts(ops, text_id: str) -> list:
    """docset_build's op tuples as the op dicts a frontend mints."""
    out = []
    for op in ops:
        ctr, actor = op[1]
        if op[0] == "ins":
            parent = op[2]
            out.append({"action": "ins", "obj": text_id,
                        "key": "_head" if parent is HEAD
                        else f"{parent[1]}:{parent[0]}", "elem": ctr})
        else:
            out.append({"action": "set", "obj": text_id,
                        "key": f"{actor}:{ctr}", "value": chr(op[2])})
    return out


class Rooms:
    """The rooms' base document and their rounds, as plain data."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        self.n_rooms = int(config["rooms"])
        self.n_peers = int(config["peers_per_room"])
        self.chars = int(config["doc_chars"])
        self.run = int(traffic["run"])
        self.seed = seed
        rng = rng_for(seed, 1)
        names = [uuid_from(rng) for _ in range(self.n_peers + 2
                                              + self.n_rooms)]
        self.actors = names[:self.n_peers]
        self.text_id, self.origin = names[self.n_peers:self.n_peers + 2]
        self.servers = names[self.n_peers + 2:]
        self.room_ids = [f"room-{g:03d}" for g in range(self.n_rooms)]
        pop = Population({"docs": 1, "doc_actors": self.n_peers,
                          "doc_chars": self.chars}, seed)
        self.base_codes = pop.codes[0]
        self.base_seqs = [2] + [1] * (self.n_peers - 1)

    @property
    def n_ops(self) -> int:
        """The ops of one round, every room's."""
        return self.n_rooms * self.n_peers * 2 * self.run

    def seq(self, i: int, r: int) -> int:
        """Peer i's seq in round r (round -1: its base change)."""
        return self.base_seqs[i] + 1 + r

    def clock(self, r: int) -> dict:
        """A room's clock after round r (round -1: the base)."""
        return {a: self.seq(i, r) for i, a in enumerate(self.actors)}

    def base_changes(self) -> list:
        """The base document: the text made by the first actor, then
        each actor's run from the head, all concurrent."""
        a0 = self.actors[0]
        out = [{"actor": a0, "seq": 1, "deps": {}, "ops": [
            {"action": "makeText", "obj": self.text_id},
            {"action": "link", "obj": ROOT_ID, "key": "t",
             "value": self.text_id}]}]
        for i, actor in enumerate(self.actors):
            ops = typing_run(actor, 1, HEAD,
                             [self.base_codes[i]] * self.chars)
            out.append({"actor": actor, "seq": self.base_seqs[i],
                        "deps": {} if i == 0 else {a0: 1},
                        "ops": op_dicts(ops, self.text_id)})
        return out

    def round(self, r: int) -> dict:
        """Round r: {room: [(change, declared clock) of each peer]}, as new
        dicts on each call."""
        c0 = self.chars + self.run * r + 1
        codes = rng_for(self.seed, 3, r).integers(
            97, 123, size=(self.n_rooms, self.n_peers, self.run))
        prev = self.clock(r - 1)
        out = {}
        for g, rid in enumerate(self.room_ids):
            sent = []
            for i, actor in enumerate(self.actors):
                change = {"actor": actor, "seq": self.seq(i, r),
                          "deps": {a: s for a, s in prev.items()
                                   if a != actor},
                          "ops": op_dicts(typing_run(
                              actor, c0, (c0 - 1, actor), codes[g, i]),
                              self.text_id)}
                clock = dict(prev)
                clock[actor] = change["seq"]
                sent.append((change, clock))
            out[rid] = sent
        return out


class ThinClient:
    """A collaborator as the server sees it: a `ResilientChannel` over a
    lossless queue each way. It keeps every payload it receives, as it
    arrived, and acks it through its channel."""

    __slots__ = ("tid", "room_id", "to_server", "to_client", "chan", "got")

    def __init__(self, res, svc, tid: str, room_id: str):
        self.tid, self.room_id = tid, room_id
        self.to_server = collections.deque()
        self.to_client = collections.deque()
        self.got: list = []
        svc.connect(tid, room_id, self.to_client.append)
        self.chan = res.ResilientChannel(self.to_server.append,
                                         self.got.append)

    def pump(self, svc):
        """Deliver what is in flight: the server's envelopes to this
        client (its acks join the other queue), then this client's to
        the server; then one round of the client's channel timers."""
        q, on_wire = self.to_client, self.chan.on_wire
        while q:
            on_wire(q.popleft())
        q = self.to_server
        sess = svc.session(self.tid)
        while q:
            env = q.popleft()
            if sess is not None:
                sess.on_wire(env)
        self.chan.tick()

    @property
    def quiet(self) -> bool:
        return self.chan.idle and not self.to_server and not self.to_client


class HostShare:
    """What the host gave the process over the window, printed beside
    its rounds: the process's CPU seconds and the garbage collector's
    pauses."""

    def __init__(self):
        self.gc_s, self.gc_n, self._t = 0.0, [0, 0, 0], 0
        gc.callbacks.append(self._gc)
        self.cpu0 = time.process_time()

    def _gc(self, phase: str, info: dict):
        if phase == "start":
            self._t = now()
        else:
            self.gc_s += (now() - self._t) / 1e9
            self.gc_n[info["generation"]] += 1

    def close(self) -> str:
        gc.callbacks.remove(self._gc)
        return (f"cpu {time.process_time() - self.cpu0:.2f} s, gc "
                f"{self.gc_n} collections {self.gc_s:.3f} s")


def received(payloads) -> list:
    """Every change in payloads the server sent, as change dicts: the
    dict prefix as it arrived, each frame decoded afresh from its
    bytes."""
    from automerge_tpu_torch.engine.wire_format import WireFrame
    out = []
    for p in payloads:
        out.extend(p.get("changes") or ())
        wire = p.get("wire")
        if wire is not None:
            out.extend(WireFrame(getattr(wire, "data", wire)).changes())
    return out


def canonical(change: dict) -> str:
    return json.dumps(change, sort_keys=True, separators=(",", ":"))


class Server(Runner):
    WARM = 2            # rounds after the join, before the window
    MAX_AHEAD = 128     # rounds made before the window, at most
    SETTLE_TICKS = 64   # ticks a round may take to quiesce, at most

    def setup(self, seconds: float):
        import automerge_tpu_torch as am
        from automerge_tpu_torch import resilience, service
        from automerge_tpu_torch.backend import device as backend
        self.am, self.backend = am, backend
        gen = self.gen = Rooms(self.config, self.traffic, self.seed)
        be = backend.backend_for(self.device)
        base = am.apply_changes(am.init({"actorId": gen.origin,
                                         "backend": be}),
                                gen.base_changes())
        bundle = am.checkpoint_doc(base)
        del base
        budget = self.config["service"]
        self.svc = service.SyncService(service.ServiceConfig(
            device=self.device, default_budget=service.TenantBudget(
                ops_per_tick=int(budget["ops_per_tick"]),
                inbox_cap=int(budget["inbox_cap"]))))
        for g, rid in enumerate(gen.room_ids):
            self.svc.seed_doc(rid, am.restore(
                bundle, {"actorId": gen.servers[g], "backend": be}))
        del bundle
        self.clients = [ThinClient(resilience, self.svc, f"{rid}/{i}", rid)
                        for rid in gen.room_ids for i in range(gen.n_peers)]
        self.counters.update(inline_rounds=0, unsettled_rounds=0, ticks=0)
        self.n_made = 0
        # the join: each peer answers the server's advertisement with the
        # clock it holds (the base's), as a Connection does
        base_clock = gen.clock(-1)
        for c in self.clients:
            c.chan.send({"docId": c.room_id, "clock": dict(base_clock)})
        self.settle()
        for _ in range(self.WARM):
            self.unit(self.make_round(), keep=False)
        warm_s = min(b - a for n, a, b in self.spans if n == "round") / 1e9
        self.spans.clear()
        self.counters["ticks"] = 0
        # the rounds the window takes, made before it: a fifth more than
        # the fastest warm round's pace fills it, at most MAX_AHEAD (more
        # are made inline, and counted)
        n = min(int(1.2 * seconds / max(warm_s, 1e-3)) + 4, self.MAX_AHEAD)
        self.queue = collections.deque(self.make_round() for _ in range(n))

    def window(self, seconds: float) -> tuple:
        host = HostShare()
        t0, t1 = super().window(seconds)
        self.host = f"window {(t1 - t0) / 1e9:.2f} s: {host.close()}"
        return t0, t1

    def make_round(self) -> list:
        """The next round's messages, one a client in client order."""
        from automerge_tpu_torch.engine.wire_format import split_outgoing
        r, self.n_made = self.n_made, self.n_made + 1
        out = []
        for rid, sent in self.gen.round(r).items():
            for change, clock in sent:
                prefix, frame = split_outgoing([change])
                msg = {"docId": rid, "clock": clock}
                if prefix:
                    msg["changes"] = prefix
                if frame is not None:
                    msg["wire"] = frame
                out.append(msg)
        return out

    def settle(self) -> int:
        """Pump every client and tick until the service and every channel
        are idle and every queue is empty; -> the ticks it took."""
        svc, clients = self.svc, self.clients
        for n in range(self.SETTLE_TICKS + 1):
            t0 = now()
            for c in clients:
                c.pump(svc)
            self.span("round/pump", t0, now())
            if svc.idle() and all(c.quiet for c in clients):
                return n
            if n < self.SETTLE_TICKS:
                svc.tick()
                self.counters["ticks"] += 1
        self.counters["unsettled_rounds"] += 1
        return n

    def unit(self, msgs: list = None, keep: bool = True):
        if msgs is None:
            if self.queue:
                msgs = self.queue.popleft()
            else:
                self.counters["inline_rounds"] += 1
                msgs = self.make_round()
        ops0 = self.svc.stats["admitted_ops"]
        t0 = now()
        for c, msg in zip(self.clients, msgs):
            c.chan.send(msg)
        t1 = now()
        self.settle()
        t2 = now()
        self.span("round/send", t0, t1)
        self.span("round", t0, t2)
        if keep:
            self.n_ops += self.svc.stats["admitted_ops"] - ops0

    def release(self):
        """What the checks read, taken after the window and outside every
        span; then the service goes."""
        am, svc, gen = self.am, self.svc, self.gen
        self.n_rounds = self.n_made - len(self.queue)
        docs = {rid: svc.room(rid).doc_set.get_doc(rid)
                for rid in gen.room_ids}
        self.texts = {rid: am.to_json(d)["t"] for rid, d in docs.items()}
        self.graduated = sum(
            not isinstance(am.frontend.get_backend_state(d),
                           self.backend.DeviceBackendState)
            for d in docs.values())
        self.unacked = sum(c.chan.in_flight for c in self.clients)
        svc.probe_lag()
        m = svc.metrics()
        self.lagging = m["lagging_tenants"]
        quarantined = sum(svc.room(rid).gate.quarantined(rid)
                          for rid in gen.room_ids)
        self.shed = m["shed_total"] + m["evictions"] + quarantined
        self.got = {c.tid: c.got for c in self.clients}
        rounds = [(b - a) / 1e6 for n, a, b in self.spans if n == "round"]
        if rounds:
            print(f"portbench: round ms first {rounds[0]:.1f}, median "
                  f"{sorted(rounds)[len(rounds) // 2]:.1f}, last "
                  f"{rounds[-1]:.1f}; each {[round(r) for r in rounds]}",
                  file=sys.stderr)
        if hasattr(self, "host"):
            print(f"portbench: {self.host}", file=sys.stderr)
        print(f"portbench: service p50 tick {m['p50_tick_ms']} ms, p99 "
              f"{m['p99_tick_ms']} ms, max {m['max_tick_ms']} ms, ticks "
              f"{m['ticks']}, deferrals {m['deferrals']}, shed "
              f"{m['shed_total']}, evictions {m['evictions']}, quarantined "
              f"{quarantined}, peak inbox {m['peak_inbox']}",
              file=sys.stderr)
        del docs, self.svc, self.clients, self.queue

    def check(self) -> tuple:
        gen = self.gen
        ref = SyncReference(gen.text_id, gen.base_changes(), gen.room_ids)
        base = {(c["actor"], c["seq"]): canonical(c)
                for c in gen.base_changes()}
        sent = {rid: dict(base) for rid in gen.room_ids}
        for r in range(self.n_rounds):
            peers = gen.round(r)
            ref.round(peers)
            for rid, changes in peers.items():
                held = sent[rid]
                for c, _ in changes:
                    held[(c["actor"], c["seq"])] = canonical(c)
        wrong = sum(self.texts[rid] != text
                    for rid, text in ref.texts().items())
        missed = altered = dup = 0
        for (rid, actor), want in ref.owed.items():
            tid = f"{rid}/{gen.actors.index(actor)}"
            held, got = sent[rid], collections.Counter()
            for c in received(self.got[tid]):
                key = (c.get("actor"), c.get("seq"))
                got[key] += 1
                altered += held.get(key) != canonical(c)
            missed += len(want - set(got))
            dup += sum(n - 1 for n in got.values()) + len(set(got) - want)
        print(f"portbench: {self.n_rounds} rounds checked, duplicate or "
              f"unowed deliveries {dup}", file=sys.stderr)
        checks = {"wrong_texts": (wrong, 0),
                  "missed_deliveries": (missed, 0),
                  "wrong_deliveries": (altered, 0),
                  "unacked_frames": (self.unacked, 0),
                  "lagging_peers": (self.lagging, 0),
                  "shed_or_evicted": (self.shed, 0),
                  "graduated_rooms": (self.graduated, 0)}
        # the state is read once after the window: a failed check fails
        # every round of it
        failed = self.attempted if any(v for v, _ in checks.values()) \
            else 0
        return checks, failed


class Control(Server):
    """The reference in the program's place, with one acknowledged change
    lost to the read: the last room's text reads as it was before the
    last round (the later rounds build on the change, as they would on a
    server that lost only the read). Every owed change reaches its peer
    as its peer sent it, every frame is acked, and no room leaves the
    device tier."""

    def setup(self, seconds: float):
        gen = self.gen = Rooms(self.config, self.traffic, self.seed)
        self.ref = SyncReference(gen.text_id, gen.base_changes(),
                                 gen.room_ids)
        self.sent: dict = {}            # (room, actor, seq) -> change
        self.n_made = 0
        for _ in range(self.WARM):
            self.unit()

    def unit(self):
        self.stale = self.ref.rooms[self.gen.room_ids[-1]].text()
        peers = self.gen.round(self.n_made)
        self.ref.round(peers)
        for rid, changes in peers.items():
            for c, _ in changes:
                self.sent[(rid, c["actor"], c["seq"])] = c
        self.n_made += 1
        self.n_ops += self.gen.n_ops

    def release(self):
        gen = self.gen
        self.n_rounds = self.n_made
        self.texts = dict(self.ref.texts())
        self.texts[gen.room_ids[-1]] = self.stale
        self.got = {f"{rid}/{gen.actors.index(actor)}": [{"changes": [
            self.sent[(rid, a, s)] for a, s in sorted(owed)]}]
            for (rid, actor), owed in self.ref.owed.items()}
        self.unacked = self.lagging = self.shed = self.graduated = 0


RUNNER, CONTROL = Server, Control
