"""One region's endpoint of an inter-region replication link.

A :class:`RegionLink` carries the unchanged ``{docId, clock, changes?}``
sync protocol between two regions' room hubs over a WAN-profile chaos
transport, and owns everything the distance implies:

- a :class:`~automerge_tpu_torch.resilience.channel.ResilientChannel` for
  exactly-once delivery, with a TIGHT retransmit budget so a vanished
  peer region is declared dead in bounded rounds (dead-link detection);
- the typed degradation ladder (INTERNALS §20.3): ``ok`` →
  ``lagged`` (pending cross-region group tokens above threshold) →
  ``partitioned`` (channel dead; outbound traffic buffers, bounded) →
  ``healing`` (probe answered; channel revived into a fresh epoch,
  hub peers re-attached, buffers drained) → ``ok``.  Every transition
  is counted here and evented on the owning service's black-box ring.
- the reconnect protocol: raw ``probe``/``hello`` control frames that
  BYPASS the channel (a dead channel can't carry its own resurrection),
  carrying the revived channel epoch so both ends agree which frames
  are stale history (``ResilientChannel.revive`` semantics).

Buffering during a partition is two-tier, because the two message
classes fail differently: clock-only advertisements dedup into a dict
keyed ``(room, docId)`` — the LAST advert wins and is never dropped,
since a lost advert is a room the remote might never learn about —
while payload-bearing envelopes fill a bounded drop-oldest deque
(counted).  Dropped payloads are safe: the heal-time hub peer
re-attachment re-advertises every doc, and advertisement IS a clock
reveal, so the delta recomputes from truth rather than from history.
"""

from __future__ import annotations

from .. import obs
from ..obs import lineage
from ..resilience.channel import ResilientChannel
from ..resilience.errors import PeerDeadError, ProtocolError

#: The degradation ladder's rungs, mildest first.
OK = "ok"
LAGGED = "lagged"
PARTITIONED = "partitioned"
HEALING = "healing"
LADDER = (OK, LAGGED, PARTITIONED, HEALING)

#: Raw control frames that bypass the reliability channel.
CONTROL_KINDS = ("probe", "probe_ack", "hello", "hello_ack")


class RegionLink:
    """This region's endpoint toward ONE remote region."""

    __slots__ = ("region", "remote", "label", "chan", "out", "state",
                 "lag_threshold", "probe_every", "max_buffer",
                 "_probe_countdown", "_buf_adverts", "_buf_data",
                 "_last_reveal", "stats", "transitions")

    def __init__(self, region, remote: str, *, seed: int = 0,
                 lag_threshold: int = 32, probe_every: int = 4,
                 max_buffer: int = 512, max_retries: int = 6,
                 base_rto: int = 2, max_rto: int = 16):
        self.region = region
        self.remote = remote
        #: directed label — `fed/ship` and `fed/buffer` lineage hops and
        #: the ladder events carry it, so a stuck chain's postmortem
        #: names WHICH region link it is parked on
        self.label = f"{region.name}->{remote}"
        self.out = None               # outbound ChaosLink (wired later)
        self.state = OK
        self.lag_threshold = lag_threshold
        self.probe_every = probe_every
        self.max_buffer = max_buffer
        self._probe_countdown = probe_every
        self._buf_adverts: dict = {}  # (room, docId) -> (room, msg)
        self._buf_data: list = []     # bounded, drop-oldest
        #: last GENUINE clock the remote stated per (room, docId) — what
        #: heal re-injects after the hub-peer wipe. The hub's believed
        #: clocks advance OPTIMISTICALLY at send time and frames can die
        #: in the partition buffer, so believed state is not safe to
        #: carry across a heal; the remote's own clock statements are.
        self._last_reveal: dict = {}
        self.stats = {"shipped": 0, "delivered": 0, "buffered": 0,
                      "buffer_dropped": 0, "probes": 0, "hellos": 0,
                      "reconnects": 0, "protocol_errors": 0}
        self.transitions: dict = {}
        self.chan = ResilientChannel(
            self._send_env, self._deliver, seed=seed,
            base_rto=base_rto, max_rto=max_rto, max_retries=max_retries,
            on_dead=self._on_chan_dead, label=f"fed:{self.label}")

    # -- wiring ---------------------------------------------------------

    def attach_transport(self, chaos_link):
        """Install the outbound chaos edge (its `deliver` must be the
        REMOTE link's :meth:`on_raw`)."""
        self.out = chaos_link

    def _send_env(self, env):
        self.out.send(env)

    def _send_ctl(self, frame: dict):
        # raw, un-sequenced, best-effort: control frames repeat until
        # answered, so chaos loss only delays the ladder, never wedges it
        self.out.send(frame)

    # -- ladder ---------------------------------------------------------

    def _to(self, state: str, **why):
        if state == self.state:
            return
        key = f"{self.state}->{state}"
        self.transitions[key] = self.transitions.get(key, 0) + 1
        self.state = state
        self.region.svc._note("fed_state", link=self.label, to=state,
                              **why)
        if obs.enabled():
            obs.event("fed", "state",
                      {"link": self.label, "to": state, **why})

    def _on_chan_dead(self, _chan):
        self._to(PARTITIONED, reason="channel_dead")
        self._probe_countdown = 0      # probe on the very next pump

    def lag(self) -> int:
        """Cross-region replication lag in GROUP TOKENS: envelopes
        carrying an ordering token the remote has not durably received —
        un-acked in the channel window plus partition-buffered.  Reaches
        exactly zero at quiescence (a minted-head comparison would not:
        mints the encode path declined to ship are wasted, not owed)."""
        pend = sum(1 for p in self.chan.pending_payloads()
                   if isinstance(p, dict) and p.get("gtok"))
        return pend + len(self._buf_data)

    # -- outbound (the hub's send_msg for peer `region:<remote>`) -------

    def ship(self, room_id: str, msg: dict):
        if self.state in (PARTITIONED, HEALING):
            return self._buffer(room_id, msg)
        env = self._envelope(room_id, msg)
        if lineage.ENABLED:
            for actor, seq in lineage.payload_keys(msg):
                lineage.hop(actor, seq, "fed/ship", site=self.label)
        try:
            self.chan.send(env)
            self.stats["shipped"] += 1
        except PeerDeadError:
            # raced the death declaration; the on_dead hook already
            # moved the ladder — keep the message
            self._buffer(room_id, msg)

    def _envelope(self, room_id: str, msg: dict) -> dict:
        env = {"fed": "msg", "room": room_id, "msg": msg}
        gtok = None
        wire = msg.get("wire")
        if wire is not None:
            # the frame manifest already carries the token minted at
            # encode time (one mint per (doc, clock) group); mirror it
            # on the envelope so the receiver observes in O(1), no decode
            gtok = getattr(wire, "group", None)
        if gtok is None and (msg.get("changes") or msg.get("wire")
                             or msg.get("checkpoint")):
            gtok = self.region.clock.mint(room_id)
        if gtok:
            env["gtok"] = list(gtok)
        return env

    def _buffer(self, room_id: str, msg: dict):
        self.stats["buffered"] += 1
        if not (msg.get("changes") or msg.get("wire")
                or msg.get("checkpoint")):
            # clock-only advert: last-wins dedup, NEVER dropped (a lost
            # advert could be a room the remote never learns about)
            self._buf_adverts[(room_id, msg["docId"])] = (room_id, msg)
            return
        if lineage.ENABLED:
            for actor, seq in lineage.payload_keys(msg):
                lineage.hop(actor, seq, "fed/buffer", site=self.label)
        if len(self._buf_data) >= self.max_buffer:
            self._buf_data.pop(0)
            self.stats["buffer_dropped"] += 1
        self._buf_data.append((room_id, msg))

    # -- inbound --------------------------------------------------------

    def on_raw(self, obj):
        """The transport delivery point: raw control frames (no channel
        ``kind``) dispatch to the reconnect protocol; everything else is
        a channel envelope."""
        if isinstance(obj, dict) and "kind" not in obj \
                and obj.get("fed") in CONTROL_KINDS:
            return self._control(obj)
        try:
            self.chan.on_wire(obj)
        except ProtocolError:
            self.stats["protocol_errors"] += 1

    def _deliver(self, payload):
        # exactly-once, in-order release from the channel
        if not isinstance(payload, dict) or payload.get("fed") != "msg":
            self.stats["protocol_errors"] += 1
            return
        room_id, msg = payload.get("room"), payload.get("msg")
        gtok = payload.get("gtok")
        if gtok:
            origin, g_room, tok = gtok
            self.region.clock.observe(g_room, origin, tok)
        if isinstance(msg, dict) and isinstance(msg.get("clock"), dict):
            self._last_reveal[(room_id, msg.get("docId"))] = \
                dict(msg["clock"])
        if lineage.ENABLED:
            for actor, seq in lineage.payload_keys(msg):
                lineage.hop(actor, seq, "fed/recv",
                            site=f"{self.remote}->{self.region.name}")
        self.stats["delivered"] += 1
        self.region._deliver_msg(self.remote, room_id, msg)

    # -- reconnect protocol ---------------------------------------------

    def _control(self, frame: dict):
        kind = frame["fed"]
        if kind == "probe":
            self._send_ctl({"fed": "probe_ack", "n": frame.get("n", 0)})
        elif kind == "probe_ack":
            if self.state == PARTITIONED:
                # the remote answered: revive into a fresh epoch and
                # offer it; stale pre-partition frames (either way) now
                # fail the epoch gate instead of corrupting the window
                self.chan.revive()
                # a new epoch may mean a new remote INCARNATION (killed
                # and rejoined empty): every pre-revive reveal is void —
                # a stale clock can claim state the fresh peer does not
                # hold, which would withhold its bootstrap delta forever
                self._last_reveal.clear()
                self.stats["reconnects"] += 1
                self._to(HEALING, reason="probe_answered")
                self._send_ctl({"fed": "hello",
                                "epoch": self.chan.epoch})
        elif kind == "hello":
            self.stats["hellos"] += 1
            revived = self._align(frame.get("epoch", 0))
            self._send_ctl({"fed": "hello_ack",
                            "epoch": self.chan.epoch})
            self._heal(force=revived)
        elif kind == "hello_ack":
            revived = self._align(frame.get("epoch", 0))
            self._heal(force=revived)

    def _align(self, peer_epoch: int) -> bool:
        """Adopt the remote's offered epoch: revive if this side is dead
        or behind, and accept their frames from `peer_epoch` on.
        Idempotent — a chaos-duplicated hello must not re-revive.
        Returns True when it DID revive (the send window was cleared, so
        the caller must run the heal re-advertisement even if this
        side's ladder never left ``ok`` — an asymmetric partition kills
        only the direction with traffic)."""
        ch = self.chan
        revived = False
        if ch.dead or ch.epoch < peer_epoch:
            ch.revive()
            self._last_reveal.clear()   # pre-revive reveals are void
            revived = True
            if ch.epoch < peer_epoch:
                ch.epoch = peer_epoch
        if ch._peer_epoch < peer_epoch:
            ch._peer_epoch = peer_epoch
            ch._recv_high = 0
            ch._recv_buf.clear()
        return revived

    def _heal(self, force: bool = False):
        """Both ends agreed on fresh epochs: re-attach the hub peers
        (re-advertisement recomputes every delta from truth — including
        snapshot bootstrap for a region that lost everything) and drain
        the partition buffers."""
        if self.state == OK and not force:
            return
        if self.state != HEALING:
            self._to(HEALING, reason="hello")
        adverts = list(self._buf_adverts.values())
        data = list(self._buf_data)
        self._buf_adverts.clear()
        self._buf_data.clear()
        self._to(OK, reason="healed")
        self.region._reattach_peer(self.remote)
        for room_id, msg in adverts + data:
            self.ship(room_id, msg)

    # -- driving --------------------------------------------------------

    def pump(self) -> int:
        """One round: move the outbound chaos edge, run the channel's
        retransmit timers, probe while partitioned, update the lag rung."""
        n = self.out.pump() if self.out is not None else 0
        if not self.chan.dead:
            self.chan.tick()
        if self.state == PARTITIONED:
            self._probe_countdown -= 1
            if self._probe_countdown <= 0:
                self._probe_countdown = self.probe_every
                self.stats["probes"] += 1
                self._send_ctl({"fed": "probe", "n": self.stats["probes"]})
        elif self.state == HEALING:
            # control frames ride the RAW edge (no retransmit channel):
            # a chaos-dropped hello/hello_ack must not strand the
            # handshake — keep re-offering our epoch until the heal
            # completes (idempotent: _align dedups a duplicate hello)
            self._probe_countdown -= 1
            if self._probe_countdown <= 0:
                self._probe_countdown = self.probe_every
                self.stats["hellos"] += 1
                self._send_ctl({"fed": "hello", "epoch": self.chan.epoch})
        elif self.state in (OK, LAGGED):
            lag = self.lag()
            if self.state == OK and lag > self.lag_threshold:
                self._to(LAGGED, lag=lag)
            elif self.state == LAGGED and lag <= self.lag_threshold:
                self._to(OK, lag=lag)
        return n

    def idle(self) -> bool:
        return (self.state == OK and self.chan.idle
                and not self._buf_adverts and not self._buf_data
                and (self.out is None or self.out.idle))

    def describe(self) -> dict:
        ch = self.chan.stats
        return {"remote": self.remote, "state": self.state,
                "lag_tokens": self.lag(),
                "buffered_adverts": len(self._buf_adverts),
                "buffered_data": len(self._buf_data),
                "transitions": dict(self.transitions),
                "stats": dict(self.stats),
                "channel": {"dead": ch["dead"], "epoch": self.chan.epoch,
                            "revives": ch["revives"],
                            "sent": ch["sent"],
                            "retransmits": ch["retransmits"],
                            "stale_epoch_dropped":
                                ch["stale_epoch_dropped"],
                            "stale_acks": ch["stale_acks"]}}
