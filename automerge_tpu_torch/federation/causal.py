"""Per-replication-group causal metadata for the federation tier.

Okapi's core economy argument, applied across regions: causal ordering
metadata should cost O(replication groups), not O(peers).  Inside a
region the sync tier already tracks per-peer clocks (the ClockMatrix) —
that stays intra-region.  BETWEEN regions, each room is one replication
group, and one monotone ordering token per (room, origin-region) is all
a receiver needs to order that group's cross-region shipments: the
token rides the ``AMTPUWIRE1`` manifest (``engine.wire_format``,
``group`` field) and mints ONCE per (doc, clock) encode group in
``SyncHub.flush`` — the same sharing discipline as the frame encode
itself, so N peer regions cost zero extra mints.

The per-change causal structure (deps hashes) still travels inside the
changes; the group token is the cheap ORDER observation — a receiver
learns "origin region R has shipped group token T for room X" in O(1)
without decoding the frame, which is what the cross-region lag gauges
and the heal-and-drain ladder read.
"""

from __future__ import annotations


class GroupClock:
    """One region's view of per-(room, origin-region) ordering tokens.

    - ``mint(room)`` — next outbound token for a room this region
      originates changes for.  Destination-independent: one mint serves
      every peer region of the group (O(groups), not O(peers)).
    - ``observe(room, origin, token)`` — max-merge an inbound token.
      Returns True when it ADVANCED the view (fresh information), False
      for duplicates/stale reorderings (the chaos tier duplicates and
      reorders freely; observation is idempotent).

    State is two flat dicts bounded by (rooms minted) + (room, origin)
    pairs observed — no per-peer, per-doc, or per-change growth.
    """

    __slots__ = ("region", "_heads", "_seen", "stats")

    def __init__(self, region: str):
        if not region or not isinstance(region, str):
            raise ValueError(f"region must be a non-empty string, "
                             f"got {region!r}")
        self.region = region
        self._heads: dict = {}   # room -> last minted token
        self._seen: dict = {}    # (room, origin) -> highest observed
        self.stats = {"minted": 0, "observed": 0, "stale": 0}

    def mint(self, room: str) -> list:
        """Next ordering token for `room`: the ``[origin, room, token]``
        triple the wire manifest carries (``validate_group_token``)."""
        tok = self._heads.get(room, 0) + 1
        self._heads[room] = tok
        self.stats["minted"] += 1
        return [self.region, room, tok]

    def observe(self, room: str, origin: str, token: int) -> bool:
        """Max-merge one inbound token; True iff it advanced the view."""
        key = (room, origin)
        if token > self._seen.get(key, 0):
            self._seen[key] = token
            self.stats["observed"] += 1
            return True
        self.stats["stale"] += 1
        return False

    def head(self, room: str) -> int:
        """This region's own mint head for a room (0 = never minted)."""
        return self._heads.get(room, 0)

    def seen(self, room: str, origin: str) -> int:
        """Highest token observed from `origin` for `room`."""
        return self._seen.get((room, origin), 0)

    def table(self) -> dict:
        """Dumpable view: ``{room: {origin: highest_token}}`` with this
        region's own mints under its own name — the describe() feed."""
        out: dict = {}
        for room, tok in self._heads.items():
            out.setdefault(room, {})[self.region] = tok
        for (room, origin), tok in self._seen.items():
            out.setdefault(room, {})[origin] = tok
        return out
