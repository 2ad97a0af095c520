"""Bounded parking lot for causally-premature changes.

A change whose dependencies the local document does not yet cover cannot be
applied; the backends queue such changes internally, but that queue is
unbounded — a misbehaving or malicious peer could grow it without limit by
streaming changes that reference deps it never sends. The inbound gate parks
premature changes here instead: bounded capacity, FIFO eviction, and
eviction statistics so operators can see loss happening (an evicted change
is gone until the transport layer re-requests or re-sends it — the
`ResilientChannel` retransmit path, or a peer reconnect).

Each parked change may carry a *sender* (the transport peer / service
tenant that delivered it). Capacity evictions then emit an attributed
``quar/evict_pressure`` obs event naming the tenant whose change was
lost — pressure loss is per-tenant observable, never silent — and a dead
peer's parked changes are reclaimable in one sweep (`drop_sender`, the
service tier's eviction path).
"""

from __future__ import annotations

from collections import OrderedDict

from .. import obs

#: Default per-document bound, sized for real reordering windows (a few
#: hundred in-flight changes on a lossy multi-path mesh). DocIds are
#: peer-chosen, so this alone is not the hostile-peer memory bound — the
#: inbound gate adds an aggregate cap across all docs
#: (``inbound.GLOBAL_CAPACITY``) with largest-queue-first eviction.
DEFAULT_CAPACITY = 1024


class QuarantineQueue:
    """FIFO of premature changes keyed ``(actor, seq)``, bounded."""

    __slots__ = ("capacity", "_items", "stats")

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"quarantine capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = capacity
        # (actor, seq) -> (change, sender): attribution lives IN the
        # entry, so no second structure can drift out of sync with it
        self._items: OrderedDict = OrderedDict()
        self.stats = {"parked": 0, "evicted": 0, "released": 0, "peak": 0}

    def __len__(self) -> int:
        return len(self._items)

    def park(self, change: dict, requeue: bool = False, sender=None):
        """Admit one premature change; evicts the oldest entry on overflow.

        Returns the evicted change, or None. Re-parking the same
        ``(actor, seq)`` replaces the stored change in place (redelivered
        duplicates must not consume capacity). ``requeue`` marks a change
        coming back after an unsuccessful drain — it re-enters without
        counting as a fresh park in the stats. ``sender`` attributes the
        parked change to the transport peer that delivered it."""
        key = (change["actor"], change["seq"])
        if key in self._items:
            # replace in place; a sender-less redelivery keeps the
            # original attribution
            old_sender = self._items[key][1]
            self._items[key] = (change,
                                sender if sender is not None else old_sender)
            return None
        evicted = None
        if len(self._items) >= self.capacity:
            evicted = self._evict_oldest("capacity")
        self._items[key] = (change, sender)
        if not requeue:
            self.stats["parked"] += 1
            if obs.ENABLED:
                obs.event("quar", "park",
                          args={"actor": key[0], "seq": key[1]})
        if len(self._items) > self.stats["peak"]:
            self.stats["peak"] = len(self._items)
        return evicted

    def _evict_oldest(self, reason: str):
        ev_key, (evicted, ev_sender) = self._items.popitem(last=False)
        self.stats["evicted"] += 1
        if obs.ENABLED:
            obs.event("quar", "evict", args={"reason": reason})
            # the attributed pressure event: capacity loss names the
            # TENANT whose change was dropped, so an operator can see
            # which peer is losing data under storm, not just that
            # "something" was evicted
            obs.event("quar", "evict_pressure",
                      args={"tenant": ev_sender, "reason": reason,
                            "actor": ev_key[0], "seq": ev_key[1]})
        return evicted

    def drain_oldest(self):
        """Evict and return the single oldest entry (the inbound gate's
        aggregate-bound eviction), or None when empty."""
        if not self._items:
            return None
        return self._evict_oldest("aggregate")

    def drop_sender(self, sender) -> int:
        """Drop every parked change attributed to `sender` (dead-peer
        reclamation — the service eviction path). Returns the count; the
        drops count as evictions in the stats."""
        keys = [k for k, (_, s) in self._items.items() if s == sender]
        for key in keys:
            del self._items[key]
        self.stats["evicted"] += len(keys)
        return len(keys)

    def entries(self) -> list:
        """Non-destructive snapshot of the parked population:
        [(actor, seq, sender)] in admission order — the public face of
        ``_items`` for introspection (service reclamation checks, the
        postmortem dump)."""
        return [(a, s, sender)
                for (a, s), (_, sender) in list(self._items.items())]

    def drain_items(self) -> list:
        """Remove and return every parked ``(change, sender)`` pair in
        admission order. The caller re-parks whatever is still premature
        (passing the sender back through); ``released`` is credited by
        the inbound gate for drained changes that actually applied, so
        re-parking does not inflate it."""
        items = list(self._items.values())
        self._items.clear()
        return items

    def drain(self) -> list:
        """Remove and return every parked change (admission order)."""
        return [change for change, _ in self.drain_items()]
