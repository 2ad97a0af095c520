"""Reliable, ordered, exactly-once message delivery over a lossy link.

``ResilientChannel`` is one endpoint of a full-duplex reliability layer
between a sync peer and its transport. It restores exactly the guarantees
the ``{docId, clock, changes?}`` protocol was written against — lossless,
ordered, duplicate-free delivery — without changing a byte of that protocol:
payloads ride inside ``{"kind": "data", "seq": n, "ack": m, "payload": …}``
envelopes, and the peer protocol never sees the envelope.

Mechanics (time is modeled as explicit ``tick()`` rounds, so everything is
deterministic and thread-free):

- **send**: each payload gets the next sequence number and is retained until
  cumulatively acked. Retransmit timers back off exponentially
  (``base_rto * 2^attempts``, capped at ``max_rto``) with deterministic
  seeded jitter so two channels sharing a link don't retransmit in lockstep.
- **receive** (``on_wire``): envelopes are validated (malformed ones raise
  :class:`~.errors.ProtocolError`), deduped against everything already
  delivered or buffered, reassembled into sequence order, and released to
  the ``deliver`` callback strictly in-order. Every data envelope triggers a
  cumulative ack; acks also piggyback on outgoing data.
- **exactly-once**: a payload is handed to ``deliver`` exactly once no
  matter how often the link duplicates or the sender retransmits it.
"""

from __future__ import annotations

import operator

import numpy as np

from .. import obs
from ..obs import lineage
from .errors import PeerDeadError, ProtocolError

ENVELOPE_KINDS = ("data", "ack")


def validate_envelope(env) -> dict:
    if not isinstance(env, dict):
        raise ProtocolError(f"channel envelope must be an object, got "
                            f"{type(env).__name__}")
    kind = env.get("kind")
    if kind not in ENVELOPE_KINDS:
        raise ProtocolError(f"channel envelope kind must be one of "
                            f"{ENVELOPE_KINDS}, got {kind!r}")
    for field in ("seq", "ack"):
        try:
            if operator.index(env.get(field)) < 0:
                raise ProtocolError(
                    f"channel envelope `{field}` must be >= 0")
        except TypeError:
            raise ProtocolError(
                f"channel envelope `{field}` must be an integer, got "
                f"{env.get(field)!r}") from None
    for field in ("epoch", "aepoch"):
        # optional reconnect-epoch fields (revive()): absent == 0, so a
        # pre-epoch peer's envelopes stay byte-identical and valid
        if field in env:
            try:
                if operator.index(env[field]) < 0:
                    raise ProtocolError(
                        f"channel envelope `{field}` must be >= 0")
            except TypeError:
                raise ProtocolError(
                    f"channel envelope `{field}` must be an integer, got "
                    f"{env[field]!r}") from None
    if kind == "data" and "payload" not in env:
        raise ProtocolError("truncated data envelope: missing `payload`")
    return env


#: Receive-window size: out-of-order payloads buffer only within
#: ``recv_high + 1 .. recv_high + RECV_WINDOW``. A peer streaming frames
#: with an unfilled gap (hostile, or just a huge seq jump) cannot grow the
#: reorder buffer without bound — frames beyond the window drop un-acked,
#: so a legitimate sender's retransmit timer redelivers them once the
#: in-order release drains the window.
RECV_WINDOW = 1024

def payload_wire_bytes(payload) -> int:
    """Wire-byte size of one channel payload: exact for binary frames
    (the ``wire`` field's encoded length IS the wire form), JSON-ish
    estimate for dict-shaped parts (the same accounting
    ``service.budget.approx_msg_bytes`` uses). Computed ONCE at send and
    stored with the un-acked entry, so retransmissions charge the stored
    size — never re-measuring, mirroring the never-re-encode contract."""
    nbytes = getattr(payload, "nbytes", None)
    if isinstance(nbytes, int) and not isinstance(payload, np.ndarray):
        return nbytes
    if isinstance(payload, dict):
        return 2 + sum(len(str(k)) + 4 + payload_wire_bytes(v)
                       for k, v in payload.items())
    if isinstance(payload, (list, tuple)):
        return 2 + sum(2 + payload_wire_bytes(v) for v in payload)
    if isinstance(payload, str):
        return 2 + len(payload)
    return 8


#: Default retransmit budget PER ENVELOPE. With exponential backoff this
#: spans hundreds of rounds of sustained silence — far beyond any fault
#: the chaos profiles inject against a live peer — so a legitimate slow
#: or partitioned peer never trips it, while a vanished peer stops
#: costing timer work and send-window memory in bounded time. The
#: service tier configures a tighter cap (its heartbeat path usually
#: declares death first; this is the backstop).
MAX_RETRIES = 64


class ResilientChannel:
    def __init__(self, send_raw, deliver, *, seed: int = 0,
                 base_rto: int = 2, max_rto: int = 16,
                 recv_window: int = RECV_WINDOW,
                 max_retries: int = MAX_RETRIES,
                 on_dead=None, admit=None, label: str = None):
        self._send_raw = send_raw
        self._deliver = deliver
        #: lineage site label for chan/* hops (the service names tenant
        #: channels after the tenant); None -> anonymous hops
        self.label = label
        self._rng = np.random.default_rng(seed)
        self._base_rto = base_rto
        self._max_rto = max_rto
        self._recv_window = recv_window
        self._max_retries = max_retries
        self._on_dead = on_dead
        self._admit = admit           # credit gate: un-acked drop when falsy
        self._round = 0
        self._next_seq = 1
        self._unacked: dict = {}      # seq -> {"payload","due","rto","tries"}
        self._recv_high = 0           # highest contiguously delivered seq
        self._recv_buf: dict = {}     # out-of-order seq -> payload
        self.dead = False
        #: reconnect epochs (revive(), INTERNALS §20.2): `epoch` scopes
        #: OUR seq numbering, `_peer_epoch` the highest sender epoch we
        #: accept data under. Both start at 0 and the fields are omitted
        #: from envelopes while 0, so a never-revived channel is
        #: wire-identical to the pre-epoch protocol.
        self.epoch = 0
        self._peer_epoch = 0
        self.stats = {"sent": 0, "retransmits": 0, "acks_sent": 0,
                      "dup_dropped": 0, "held_out_of_order": 0,
                      "window_dropped": 0, "delivered": 0,
                      "deliver_errors": 0, "backpressured": 0,
                      "bytes_sent": 0, "bytes_resent": 0,
                      "dead": False, "revives": 0,
                      "stale_epoch_dropped": 0, "stale_acks": 0}

    def _stamp(self, env: dict) -> dict:
        """Attach the reconnect-epoch fields when nonzero: `epoch` scopes
        this envelope's seq numbering, `aepoch` names the peer epoch its
        cumulative ack refers to. Omitted at 0 (the common case), so a
        never-revived channel's wire bytes are unchanged."""
        if self.epoch:
            env["epoch"] = self.epoch
        if self._peer_epoch:
            env["aepoch"] = self._peer_epoch
        return env

    def revive(self):
        """Re-establish a channel declared dead by retransmit-cap
        exhaustion (the partition-heal reconnect path, INTERNALS §20.2):
        a FRESH seq/ack epoch — seq numbering restarts at 1, the send
        window and reorder buffer reset, and both epoch counters bump so
        (a) stale acks from the old epoch cannot delete new-epoch window
        entries and (b) stale pre-epoch data frames still floating in
        the network drop instead of replaying into the reset receive
        window. Correctness does NOT depend on resending the cleared
        window: the sync layer above re-advertises on reconnect (hub
        peer remove/re-add), and the clock exchange re-extracts anything
        the partition ate — the proven lossy-link recovery contract.
        Both endpoints must revive for a reconnect cycle (the federation
        hello handshake coordinates this); `revive()` on a live channel
        is allowed and simply starts the next epoch."""
        self.epoch += 1
        self._peer_epoch += 1
        self._next_seq = 1
        self._unacked.clear()
        self._recv_high = 0
        self._recv_buf.clear()
        self.dead = False
        self.stats["dead"] = False
        self.stats["revives"] += 1
        if obs.ENABLED:
            obs.event("chan", "revive", args={"epoch": self.epoch})

    # -- outbound -------------------------------------------------------

    def send(self, payload):
        """Queue + transmit one payload. The payload object (its binary
        frames included) is CACHED in the send window as-is: a
        retransmission resends the stored object/bytes verbatim — frames
        are never re-encoded on retry, and the per-payload wire size is
        measured once here (``bytes_sent``/``bytes_resent`` let the
        bench report wire bytes per op for the dict-vs-binary A/B)."""
        if self.dead:
            raise PeerDeadError(
                "channel is dead (retransmit cap exhausted); revive() "
                "it after the partition heals, or reconnect with a "
                "fresh channel")
        seq = self._next_seq
        self._next_seq += 1
        nbytes = payload_wire_bytes(payload)
        self._unacked[seq] = {"payload": payload, "nbytes": nbytes,
                              "due": self._round + self._base_rto,
                              "rto": self._base_rto, "tries": 0}
        self.stats["sent"] += 1
        self.stats["bytes_sent"] += nbytes
        if lineage.ENABLED:
            # extra=seq: one send hop per envelope carrying the change —
            # a dup-delivered envelope dedups, a distinct envelope
            # (e.g. a re-extracted resend on a fresh channel) records
            for a, s in lineage.payload_keys(payload):
                lineage.hop(a, s, "chan/send", site=self.label, extra=seq)
        self._send_raw(self._stamp({"kind": "data", "seq": seq,
                                    "ack": self._recv_high,
                                    "payload": payload}))

    def tick(self):
        """Advance one time round; retransmit overdue unacked envelopes
        with exponential backoff + deterministic jitter. An envelope that
        exhausts ``max_retries`` declares the PEER dead: retransmission
        stops, the send window is dropped (bounded-memory reclaim), and
        the death surfaces through ``on_dead`` when installed, else as a
        typed :class:`PeerDeadError` — never a silent retry-forever."""
        if self.dead:
            return
        self._round += 1
        for seq in sorted(self._unacked):
            # a synchronous transport can ack DURING this loop (the
            # retransmit below fills the receiver's gap, whose inline
            # cumulative ack re-enters on_wire and deletes later seqs) —
            # re-check membership instead of indexing the snapshot
            entry = self._unacked.get(seq)
            if entry is None or entry["due"] > self._round:
                continue
            if entry["tries"] >= self._max_retries:
                self._declare_dead(seq, entry["tries"])
                return
            entry["tries"] += 1
            entry["rto"] = min(entry["rto"] * 2, self._max_rto)
            jitter = int(self._rng.integers(0, max(2, entry["rto"] // 2)))
            entry["due"] = self._round + entry["rto"] + jitter
            self.stats["retransmits"] += 1
            # stored bytes: the size measured at send time, the payload
            # object cached at send time — no re-encode, no re-measure
            self.stats["bytes_resent"] += entry["nbytes"]
            if obs.ENABLED:
                obs.event("chan", "retransmit",
                          args={"seq": seq, "rto": entry["rto"]})
            if lineage.ENABLED:
                # a retransmission adds a DISTINCT chan/retransmit hop
                # per attempt (extra carries the attempt number) — never
                # a duplicate chain, never a deduped-away repeat
                for a, s in lineage.payload_keys(entry["payload"]):
                    lineage.hop(a, s, "chan/retransmit", site=self.label,
                                extra=(seq, entry["tries"]))
            self._send_raw(self._stamp({"kind": "data", "seq": seq,
                                        "ack": self._recv_high,
                                        "payload": entry["payload"]}))

    def _declare_dead(self, seq: int, tries: int):
        self.dead = True
        self.stats["dead"] = True
        self._unacked.clear()         # no resurrection: reclaim the window
        if obs.ENABLED:
            obs.event("chan", "dead", args={"seq": seq, "tries": tries})
        if self._on_dead is not None:
            self._on_dead(self)
        else:
            raise PeerDeadError(
                f"peer unresponsive: envelope seq={seq} retransmitted "
                f"{tries} times without an ack")

    # -- inbound --------------------------------------------------------

    def on_wire(self, env):
        env = validate_envelope(env)
        # cumulative ack (piggybacked on data, or a pure ack frame) —
        # applied only when it refers to OUR current send epoch: a stale
        # ack from before a revive() must not delete new-epoch window
        # entries that happen to share seq numbers
        ack = env["ack"]
        if ack and env.get("aepoch", 0) != self.epoch:
            self.stats["stale_acks"] += 1
            ack = 0
        if ack:
            for seq in [s for s in self._unacked if s <= ack]:
                del self._unacked[seq]
        if env["kind"] == "ack":
            return
        epoch = env.get("epoch", 0)
        if epoch < self._peer_epoch:
            # pre-epoch data still floating in the network after a
            # reconnect: its seq numbering belongs to the dead epoch's
            # space — deliverable-looking against the reset receive
            # window, so it MUST drop (un-acked; nobody retransmits a
            # dead epoch) rather than dedup by seq
            self.stats["stale_epoch_dropped"] += 1
            if obs.ENABLED:
                obs.event("chan", "stale_epoch_drop",
                          args={"seq": env["seq"], "epoch": epoch})
            return
        if epoch > self._peer_epoch:
            # the peer revived ahead of us (its hello raced this data
            # frame): adopt its new epoch — the old epoch's receive
            # state is dead bookkeeping now
            self._peer_epoch = epoch
            self._recv_high = 0
            self._recv_buf.clear()
        seq = env["seq"]
        if seq <= self._recv_high or seq in self._recv_buf:
            self.stats["dup_dropped"] += 1
            if obs.ENABLED:
                obs.event("chan", "dup_drop", args={"seq": seq})
        elif seq > self._recv_high + self._recv_window:
            # beyond the reorder window: drop UN-acked (the bounded-memory
            # guarantee; a real sender retransmits once the window opens)
            self.stats["window_dropped"] += 1
            if obs.ENABLED:
                obs.event("chan", "window_drop", args={"seq": seq})
            return
        elif self._admit is not None and not self._admit(env):
            # credit-based flow control (the service tier's backpressure
            # path): no credit -> the frame drops UN-acked, so the
            # sender's own retransmit timer redelivers it once credit
            # frees — the over-budget peer slows down instead of growing
            # an unbounded server-side queue
            self.stats["backpressured"] += 1
            if obs.ENABLED:
                obs.event("chan", "backpressure", args={"seq": seq})
            return
        else:
            self._recv_buf[seq] = env["payload"]
            if seq != self._recv_high + 1:
                self.stats["held_out_of_order"] += 1
        # release everything now contiguous, strictly in order. A RAISING
        # deliver callback still consumes its payload (the attempt is the
        # exactly-once event; redelivering identical bytes to a consumer
        # that rejected them would fail identically forever) — but it must
        # not corrupt channel state: later payloads still release, the
        # cumulative ack still goes out, and the first error re-raises to
        # the caller only after the channel is consistent.
        deliver_err = None
        while self._recv_high + 1 in self._recv_buf:
            self._recv_high += 1
            payload = self._recv_buf.pop(self._recv_high)
            self.stats["delivered"] += 1
            try:
                self._deliver(payload)
            except Exception as exc:
                if deliver_err is None:
                    deliver_err = exc
                self.stats["deliver_errors"] += 1
                if obs.ENABLED:
                    obs.event("chan", "deliver_error",
                              args={"seq": self._recv_high})
        self.stats["acks_sent"] += 1
        self._send_raw(self._stamp({"kind": "ack", "seq": 0,
                                    "ack": self._recv_high}))
        if deliver_err is not None:
            raise deliver_err

    # -- introspection --------------------------------------------------

    @property
    def idle(self) -> bool:
        """Nothing awaiting ack and nothing buffered out-of-order."""
        return not self._unacked and not self._recv_buf

    @property
    def in_flight(self) -> int:
        return len(self._unacked)

    @property
    def buffered(self) -> int:
        """Frames held in the out-of-order reorder buffer (bounded by
        the receive window) — credit-occupancy introspection."""
        return len(self._recv_buf)

    def pending_payloads(self) -> list:
        """The payloads of every un-acked outbound frame, send order —
        what the peer has NOT durably received yet. The service tier's
        lag probe counts the change batches in here as the wire
        component of replication lag (the hub's believed clocks advance
        optimistically at send time, so the matrix alone can't see
        in-flight loss)."""
        return [self._unacked[s]["payload"] for s in sorted(self._unacked)]
