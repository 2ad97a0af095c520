"""Batched vector-clock index for multi-peer, multi-doc sync.

The reference diffs one (peer, doc) pair at a time with a per-actor clock
walk (`getMissingChanges`, the reference's backend/op_set.js:388-395, driven
per peer by src/connection.js:58-74). Here the whole doc-set's clocks and
every peer's believed clocks intern into dense int64 matrices, so "who needs
what" for N peers x M docs x A actors is ONE numpy comparison — the
framework's device-adjacent answer to SURVEY §5's "trivially vectorizable"
note. Change extraction then touches only the (peer, doc) pairs the
comparison flagged.

The matrices stay host numpy in the port, as in the JAX package: every
flush reads the comparison's answer on the host, so a device copy would
add one device-to-host fetch per flush and save nothing at these sizes.
"""

from __future__ import annotations

import numpy as np


class _Interner:
    """Key -> dense slot, with slot recycling: a removed key's slot goes
    to a free list and is handed to the next NEW key, so the dense axis
    is bounded by the PEAK live population, not the lifetime total —
    500 add/remove churn cycles on a 3-peer hub cost 3 slots, not 500
    (the churn-storm memory bound)."""

    __slots__ = ("idx", "items", "free")

    def __init__(self):
        self.idx: dict = {}
        self.items: list = []
        self.free: list = []

    def __call__(self, key) -> int:
        i = self.idx.get(key)
        if i is None:
            if self.free:
                i = self.free.pop()
                self.items[i] = key
            else:
                i = len(self.items)
                self.items.append(key)
            self.idx[key] = i
        return i

    def remove(self, key):
        """Free a key's slot for reuse; returns the slot (or None). The
        caller must zero the matrix rows it indexed — the next occupant
        inherits the slot, never the data."""
        i = self.idx.pop(key, None)
        if i is not None:
            self.items[i] = None
            self.free.append(i)
        return i

    def __len__(self):
        return len(self.items)


def _grow(arr: np.ndarray, shape: tuple) -> np.ndarray:
    if arr.shape == shape:
        return arr
    out = np.zeros(shape, arr.dtype)
    if arr.size:
        out[tuple(slice(0, s) for s in arr.shape)] = arr
    return out


class ClockMatrix:
    """Dense (docs x actors) local clocks + (peers x docs x actors) believed
    peer clocks; `pending()` compares them all at once."""

    def __init__(self):
        self._docs = _Interner()
        self._actors = _Interner()
        self._peers = _Interner()
        self._ours = np.zeros((0, 0), np.int64)
        self._theirs = np.zeros((0, 0, 0), np.int64)
        self._active = np.zeros((0, 0), bool)   # (peer, doc) servable pairs

    def _sync_shapes(self):
        d, a, p = len(self._docs), len(self._actors), len(self._peers)
        self._ours = _grow(self._ours, (d, a))
        self._theirs = _grow(self._theirs, (p, d, a))
        self._active = _grow(self._active, (p, d))

    def update_ours(self, doc_id: str, clock: dict):
        di = self._docs(doc_id)
        cols = [self._actors(actor) for actor in clock]
        self._sync_shapes()
        row = self._ours[di]
        for actor, ci in zip(clock, cols):
            if clock[actor] > row[ci]:
                row[ci] = clock[actor]

    def update_theirs(self, peer_id: str, doc_id: str, clock: dict):
        pi = self._peers(peer_id)
        di = self._docs(doc_id)
        cols = [self._actors(actor) for actor in clock]
        self._sync_shapes()
        row = self._theirs[pi, di]
        for actor, ci in zip(clock, cols):
            if clock[actor] > row[ci]:
                row[ci] = clock[actor]

    def known_peer_doc(self, peer_id: str, doc_id: str) -> bool:
        return peer_id in self._peers.idx and doc_id in self._docs.idx

    def our_clock(self, doc_id: str) -> dict:
        di = self._docs.idx.get(doc_id)
        if di is None or di >= self._ours.shape[0]:
            return {}
        row = self._ours[di]
        return {self._actors.items[i]: int(s)
                for i, s in enumerate(row) if s > 0}

    def their_clock(self, peer_id: str, doc_id: str) -> dict:
        if not self.known_peer_doc(peer_id, doc_id):
            return {}
        self._sync_shapes()
        row = self._theirs[self._peers.idx[peer_id], self._docs.idx[doc_id]]
        return {self._actors.items[i]: int(s)
                for i, s in enumerate(row) if s > 0}

    def set_active(self, peer_id: str, doc_id: str, flag: bool = True):
        """Mark a (peer, doc) pair servable: only active pairs can appear
        in `pending()`. Keeps unrevealed/removed pairs out of the
        comparison entirely (otherwise they would be re-flagged forever)."""
        pi = self._peers(peer_id)
        di = self._docs(doc_id)
        self._sync_shapes()
        self._active[pi, di] = flag

    def reset_peer(self, peer_id: str):
        """Forget a peer's believed clocks and deactivate its pairs (it may
        reconnect fresh later; update_theirs is monotone max, so zeroing is
        the only way back)."""
        pi = self._peers.idx.get(peer_id)
        if pi is not None and pi < self._theirs.shape[0]:
            self._theirs[pi] = 0
        if pi is not None and pi < self._active.shape[0]:
            self._active[pi] = False

    def release_peer(self, peer_id: str):
        """reset_peer + recycle the peer's matrix slot (the churn bound:
        add/remove N peers holds the peer axis at the PEAK concurrent
        count — a removed peer costs nothing once released; a same-id
        reconnect interns fresh, possibly into a recycled slot whose rows
        were zeroed here)."""
        self.reset_peer(peer_id)
        self._peers.remove(peer_id)

    @property
    def peer_slots(self) -> int:
        """Width of the dense peer axis (live + recycled-free slots) —
        what the churn-storm regression test bounds."""
        return len(self._peers)

    def has_peer(self, peer_id: str) -> bool:
        """Whether the peer currently occupies a matrix slot (public
        introspection — `release_peer` is what makes this False)."""
        return peer_id in self._peers.idx

    def lag_table(self) -> dict:
        """Replication lag of every interned peer against our local
        clocks, from ONE vectorized comparison (Okapi's cheap causal
        metadata, PAPERS.md): {peer_id: {"ops": total change deficit,
        "docs": {doc_id: deficit}}} counting only ACTIVE (revealed)
        pairs. A deficit is the summed per-actor seq shortfall — the
        number of changes this hub still believes the peer is missing.
        Believed clocks advance optimistically at send time, so this
        term alone covers not-yet-extracted changes; the service tier
        adds the un-acked wire component (INTERNALS §14.2)."""
        self._sync_shapes()
        live = [(i, p) for i, p in enumerate(self._peers.items)
                if p is not None]
        out = {p: {"ops": 0, "docs": {}} for _, p in live}
        if not self._theirs.size or not live:
            return out
        deficit = self._ours[None, :, :] - self._theirs
        np.clip(deficit, 0, None, out=deficit)
        deficit *= self._active[:, :, None]
        per_pair = deficit.sum(axis=2)               # (peers, docs)
        for pi, di in zip(*np.nonzero(per_pair)):
            peer = self._peers.items[pi]
            doc = self._docs.items[di]
            if peer is None or doc is None:
                continue
            n = int(per_pair[pi, di])
            out[peer]["docs"][doc] = n
            out[peer]["ops"] += n
        return out

    def pending(self) -> list:
        """All ACTIVE (peer_id, doc_id) pairs where the peer is missing
        changes: ONE vectorized comparison over every peer, doc, actor."""
        self._sync_shapes()
        if not self._theirs.size:
            return []
        needy = (self._theirs < self._ours[None]).any(axis=2) & self._active
        return [(self._peers.items[p], self._docs.items[d])
                for p, d in zip(*np.nonzero(needy))]
