"""Deterministic, seed-driven fault injection for sync transports.

A ``ChaosLink`` is one *directed* edge between a sender (anything with a
``send_msg``-shaped callback) and a receiver callback. Every fault decision
is drawn from one seeded generator in call order, so a session driven by a
fixed schedule of ``send``/``pump`` calls replays bit-identically from its
seed, so a failing chaos run is reproduced from its seed alone. The
generator is numpy's ``default_rng(seed)``, as in the JAX package, so one
seed gives the same fault schedule in both packages.

Fault model (per message, in this order):

- **partition**: while partitioned, every send is dropped outright (the
  TCP-connection-reset model: in-flight and new frames die; recovery is the
  layer above's job — `ResilientChannel` retransmit or peer reconnect).
  ``heal()`` restores the link.
- **drop**: lost with probability ``drop``.
- **duplicate**: enqueued twice with probability ``dup`` (each copy is an
  independent decode, so receiver-side aliasing can't mask dedup bugs).
- **delay**: each enqueued copy is due ``1..max_delay`` pump rounds late
  with probability ``delay``.
- **reorder**: with probability ``reorder`` the copy is inserted at a
  random position in the queue instead of the tail.

Every message is round-tripped through JSON (``codec=True``), which both
isolates the receiver from sender-side mutation and enforces the wire-format
invariant that sync messages are plain JSON — a tuple or numpy scalar
leaking into a message surfaces here, not in production. Binary change
frames (engine/wire_format.py) are the one non-JSON payload the wire
grammar defines: the codec carries them as base64 of their exact encoded
bytes and rebuilds a FRESH ``WireFrame`` per delivered copy, so every
receiver decodes its own frame from raw bytes — exactly the real-socket
semantics, and a duplicated copy cannot share a decode cache with the
original.
"""

from __future__ import annotations

import base64
import json

import numpy as np

from .. import obs

_WIRE_KEY = "__amtpu_wire_b64__"


def _codec_default(obj):
    from ..engine.wire_format import WireFrame
    if isinstance(obj, WireFrame):
        return {_WIRE_KEY: base64.b64encode(obj.data).decode("ascii")}
    raise TypeError(f"Object of type {type(obj).__name__} is not JSON "
                    "serializable")


def _codec_hook(d):
    if _WIRE_KEY in d and len(d) == 1:
        from ..engine.wire_format import WireFrame
        return WireFrame(base64.b64decode(d[_WIRE_KEY]))
    return d


class ChaosLink:
    def __init__(self, deliver, *, seed: int = 0, rng=None,
                 drop: float = 0.0, dup: float = 0.0, reorder: float = 0.0,
                 delay: float = 0.0, max_delay: int = 3,
                 bandwidth: int = 0, codec: bool = True):
        self._deliver = deliver
        self._rng = rng if rng is not None else np.random.default_rng(seed)
        self.drop = drop
        self.dup = dup
        self.reorder = reorder
        self.delay = delay
        self.max_delay = max_delay
        #: per-direction bandwidth cap: at most this many payload wire
        #: bytes delivered per pump round (0 = unlimited). Frames past
        #: the budget HOLD to later rounds (never drop — a WAN's queue,
        #: not its loss), counted in ``throttled``. Asymmetric
        #: cross-region paths set different caps per direction (the WAN
        #: profiles below).
        self.bandwidth = bandwidth
        self.codec = codec
        self.partitioned = False
        self._queue: list = []        # [due_round, payload]
        self._round = 0
        self.stats = {"sent": 0, "delivered": 0, "dropped": 0,
                      "partition_dropped": 0, "duplicated": 0,
                      "reordered": 0, "delayed": 0, "throttled": 0}

    # -- fault schedule -------------------------------------------------

    def partition(self):
        """Sever the link: in-flight frames die, new sends are dropped."""
        self.partitioned = True
        self.stats["partition_dropped"] += len(self._queue)
        if obs.ENABLED:
            obs.event("chaos", "partition",
                      args={"in_flight_dropped": len(self._queue)})
        self._queue.clear()

    def heal(self):
        self.partitioned = False

    # -- transport face -------------------------------------------------

    def send(self, msg):
        self.stats["sent"] += 1
        wire = json.dumps(msg, default=_codec_default) \
            if self.codec else msg
        if self.partitioned:
            self.stats["partition_dropped"] += 1
            if obs.ENABLED:
                obs.event("chaos", "partition_drop")
            return
        if self.drop and self._rng.random() < self.drop:
            self.stats["dropped"] += 1
            if obs.ENABLED:
                obs.event("chaos", "drop")
            return
        copies = 1
        if self.dup and self._rng.random() < self.dup:
            copies = 2
            self.stats["duplicated"] += 1
            if obs.ENABLED:
                obs.event("chaos", "dup")
        for _ in range(copies):
            payload = (json.loads(wire, object_hook=_codec_hook)
                       if self.codec else msg)
            due = self._round
            if self.delay and self._rng.random() < self.delay:
                due += int(self._rng.integers(1, self.max_delay + 1))
                self.stats["delayed"] += 1
                if obs.ENABLED:
                    obs.event("chaos", "delay",
                              args={"rounds": due - self._round})
            entry = [due, payload]
            if self.reorder and self._queue \
                    and self._rng.random() < self.reorder:
                at = int(self._rng.integers(0, len(self._queue)))
                self._queue.insert(at, entry)
                self.stats["reordered"] += 1
                if obs.ENABLED:
                    obs.event("chaos", "reorder")
            else:
                self._queue.append(entry)

    def pump(self) -> int:
        """Advance one round and deliver every due frame — up to the
        bandwidth cap when one is set; over-budget frames hold (queue
        order preserved) and count as ``throttled``. Returns the number
        delivered."""
        self._round += 1
        budget = self.bandwidth or None
        due, held = [], []
        for entry in self._queue:
            if entry[0] >= self._round:
                held.append(entry)
                continue
            if budget is not None:
                if budget <= 0:
                    self.stats["throttled"] += 1
                    held.append(entry)
                    continue
                from .channel import payload_wire_bytes
                budget -= payload_wire_bytes(entry[1])
            due.append(entry)
        self._queue = held
        for _, payload in due:
            self._deliver(payload)
        self.stats["delivered"] += len(due)
        return len(due)

    def drain(self, max_rounds: int = 64) -> int:
        """Pump until the queue is empty (bounded); returns total
        delivered. Faults still apply to anything sent re-entrantly."""
        total = 0
        for _ in range(max_rounds):
            if not self._queue:
                break
            total += self.pump()
        return total

    @property
    def idle(self) -> bool:
        return not self._queue


#: Named seeded WAN profiles: per-direction fault kwargs for
#: a cross-region path, deliberately ASYMMETRIC — real WANs are (a fat
#: egress pipe toward a thin return path, jitter that differs by
#: direction). ``fwd`` is the a->b direction of :func:`wan_pair`,
#: ``rev`` the b->a direction. Delay units are pump rounds (the
#: federation pumps once per service tick, so `max_delay=20` models a
#: high-RTT path ~20 ticks deep); ``bandwidth`` is payload wire bytes
#: per round. ONE definition (the JAX package's, value for value), so
#: every caller and test runs the same fault model.
WAN_PROFILES = {
    # steady high-RTT inter-region path: mild loss, deep delay, fat
    # forward / thin return bandwidth
    "wan": {
        "fwd": dict(drop=0.02, dup=0.01, reorder=0.10, delay=0.6,
                    max_delay=12, bandwidth=96 * 1024),
        "rev": dict(drop=0.03, dup=0.01, reorder=0.15, delay=0.7,
                    max_delay=20, bandwidth=32 * 1024),
    },
    # a flapping path trending toward partition: heavy loss + jitter
    # (the explicit partition()/heal() windows ride on top)
    "wan_partitioned": {
        "fwd": dict(drop=0.15, dup=0.02, reorder=0.20, delay=0.8,
                    max_delay=24, bandwidth=48 * 1024),
        "rev": dict(drop=0.20, dup=0.02, reorder=0.25, delay=0.8,
                    max_delay=32, bandwidth=16 * 1024),
    },
    # the federation default: moderate chaos both ways, asymmetric
    # delay/bandwidth — survivable by retransmission without tripping
    # the retry cap against a live peer
    "cross_region": {
        "fwd": dict(drop=0.05, dup=0.02, reorder=0.15, delay=0.5,
                    max_delay=8, bandwidth=64 * 1024),
        "rev": dict(drop=0.08, dup=0.02, reorder=0.20, delay=0.6,
                    max_delay=14, bandwidth=24 * 1024),
    },
}


def wan_profile(name: str, direction: str = "fwd") -> dict:
    """One direction's ChaosLink kwargs from a named WAN profile (typed
    KeyError on an unknown name — a misspelled profile must not silently
    run lossless)."""
    prof = WAN_PROFILES.get(name)
    if prof is None:
        raise KeyError(f"unknown WAN profile {name!r}; known: "
                       f"{sorted(WAN_PROFILES)}")
    return dict(prof[direction])


def wan_pair(deliver_fwd, deliver_rev, *, profile: str = "cross_region",
             seed: int = 0):
    """A seeded directed ChaosLink pair for one inter-region path:
    ``(fwd, rev)`` where `fwd` carries a->b under the profile's ``fwd``
    kwargs and `rev` carries b->a under ``rev``. The two links draw from
    independent seeded generators (seed, seed+1), so one direction's
    fault schedule replays bit-identically regardless of the other's
    traffic order."""
    fwd = ChaosLink(deliver_fwd, seed=seed, **wan_profile(profile, "fwd"))
    rev = ChaosLink(deliver_rev, seed=seed + 1,
                    **wan_profile(profile, "rev"))
    return fwd, rev
