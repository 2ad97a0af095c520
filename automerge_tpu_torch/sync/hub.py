"""Multi-peer sync hub: N peers served from one DocSet with batched diffing.

The reference instantiates one `Connection` per peer, each re-diffing every
doc against that peer on every local change (src/connection.js:58-88 driven
by the DocSet handler). A `SyncHub` keeps every peer's believed clocks in
one `ClockMatrix`; a local change triggers ONE vectorized comparison across
(peers x docs x actors) and change extraction runs only for the flagged
pairs. Wire behavior per peer is identical to `Connection` — plain
``{docId, clock, changes?}`` messages, changes only after a peer reveals a
clock for the doc, advertisements otherwise — so a hub peer can talk to a
plain `Connection` (or another hub) on the far side.
"""

from __future__ import annotations

import logging
import os
from contextlib import contextmanager

from ..backend import default as Backend
from .. import frontend as Frontend
from .. import obs
from ..obs import lineage
from .._common import less_or_equal
from ..resilience.inbound import absorb_msg, inbound_gate
from ..resilience.validation import validate_msg
from .clock_index import ClockMatrix

logger = logging.getLogger("automerge_tpu_torch.sync")


class HubPeer:
    """One peer's endpoint on a SyncHub (the Connection-compatible face)."""

    def __init__(self, hub: "SyncHub", peer_id: str, send_msg):
        self._hub = hub
        self.peer_id = peer_id
        self.send_msg = send_msg

    def receive_msg(self, msg: dict):
        return self._hub._receive(self.peer_id, msg)


def shared_hub(doc_set) -> "SyncHub":
    """The one hub every hub-backed `Connection` on a DocSet shares (cached
    on the doc-set instance): N connections cost one ClockMatrix and one
    batched comparison per local change, not N independent diff loops."""
    hub = getattr(doc_set, "_sync_hub", None)
    if hub is None:
        hub = SyncHub(doc_set)
        doc_set._sync_hub = hub
        hub.open()
    return hub


class SyncHub:
    #: A joining peer whose believed clock is empty and who is missing at
    #: least this many changes gets a checkpoint bundle + op-log tail
    #: instead of the full change history (snapshot bootstrap,
    #: INTERNALS §8). 0 disables snapshot bootstrap entirely.
    try:
        snapshot_min_changes = int(
            os.environ.get("AMTPU_SNAPSHOT_MIN_CHANGES", "64") or 0)
    except ValueError:   # malformed env must not break the import
        snapshot_min_changes = 64

    def __init__(self, doc_set):
        self._doc_set = doc_set
        self._peers: dict = {}
        self._matrix = ClockMatrix()
        self._advertised: dict = {}   # (peer, doc) -> clock last advertised
        self._revealed: set = set()   # (peer, doc) pairs that sent us a clock
        self._session_docs: set = set()  # (peer, doc): docs this peer's
        # SESSION has seen us hold — scopes the don't-re-request-removed-
        # docs guard to one add_peer..remove_peer lifetime (the reference
        # keeps the equivalent ourClock per Connection instance, so a
        # reconnected peer starts fresh)
        self._n_auto_ids = 0
        self._ckpt_cache: dict = {}   # doc -> [Checkpoint, history_len, b64]
        self._defer_depth = 0         # batched(): >0 defers flush()
        self._flush_wanted = False
        self._no_snapshot: set = set()   # (peer, doc): peer declined a
        # bundle this session (corrupt restore or policy) — serve plain
        # changes for the rest of the add_peer..remove_peer lifetime
        #: federation hook (INTERNALS §20.3): when installed (a callable
        #: returning ``[origin_region, room, token]``), every frame this
        #: hub's flush mints carries one per-replication-group ordering
        #: token in its manifest — minted ONCE per (doc, clock) encode
        #: group, destination-independent, so the one-encode-per-fanout
        #: discipline is untouched. None (the default) leaves frames
        #: byte-identical to the unfederated wire.
        self.group_mint = None

    # -- lifecycle ------------------------------------------------------

    def auto_peer_id(self) -> str:
        """A fresh peer id for anonymous (Connection-face) peers."""
        self._n_auto_ids += 1
        return f"_conn-{self._n_auto_ids}"

    def add_peer(self, peer_id: str, send_msg) -> HubPeer:
        if peer_id in self._peers:
            raise ValueError(f"duplicate peer id: {peer_id}")
        peer = HubPeer(self, peer_id, send_msg)
        self._peers[peer_id] = peer
        for doc_id in self._doc_set.doc_ids:
            self._session_docs.add((peer_id, doc_id))
            self._advertise(peer_id, doc_id)
        return peer

    def remove_peer(self, peer_id: str):
        """Drop a peer; a later add_peer with the same id starts fresh.
        The peer's ClockMatrix slot is RELEASED (recycled), so add/remove
        churn bounds the matrix at the peak concurrent peer count."""
        self._peers.pop(peer_id, None)
        self._matrix.release_peer(peer_id)
        self._revealed = {pd for pd in self._revealed if pd[0] != peer_id}
        self._advertised = {pd: c for pd, c in self._advertised.items()
                            if pd[0] != peer_id}
        self._session_docs = {pd for pd in self._session_docs
                              if pd[0] != peer_id}
        self._no_snapshot = {pd for pd in self._no_snapshot
                             if pd[0] != peer_id}

    def has_peers(self) -> bool:
        return bool(self._peers)

    # -- public introspection (the telemetry tier reads ONLY these) -----

    def peer_state(self, peer_id: str) -> dict:
        """One peer's hub-side state, without reaching into internals:
        {"present": registered peer, "matrix_slot": occupies a
        ClockMatrix slot, "revealed_docs"/"advertised_docs"/
        "session_docs": bookkeeping set sizes}. After `remove_peer`
        every field is falsy/zero — the reclamation contract
        `SyncService.reclaimed` checks."""
        return {
            "present": peer_id in self._peers,
            "matrix_slot": self._matrix.has_peer(peer_id),
            "revealed_docs": sum(1 for p, _ in self._revealed
                                 if p == peer_id),
            "advertised_docs": sum(1 for p, _ in self._advertised
                                   if p == peer_id),
            "session_docs": sum(1 for p, _ in self._session_docs
                                if p == peer_id),
        }

    def replication_lag(self) -> dict:
        """Per-peer replication lag derived from the ClockMatrix in one
        vectorized comparison: {peer_id: {"ops", "docs"}} restricted to
        currently registered peers (a released slot's residue never
        reports). See ClockMatrix.lag_table for the deficit
        definition."""
        table = self._matrix.lag_table()
        return {p: table.get(p, {"ops": 0, "docs": {}})
                for p in self._peers}

    def open(self):
        self._doc_set.register_handler(self.doc_changed)
        for doc_id in self._doc_set.doc_ids:
            self.doc_changed(doc_id, self._doc_set.get_doc(doc_id))

    def close(self):
        self._doc_set.unregister_handler(self.doc_changed)

    # -- outbound -------------------------------------------------------

    def _state(self, doc_id: str):
        doc = self._doc_set.get_doc(doc_id)
        if doc is None:
            return None
        state = Frontend.get_backend_state(doc)
        if state is None:
            raise TypeError(
                "This object cannot be used for network sync. Are you "
                "trying to sync a snapshot from the history?")
        return state

    def _advertise(self, peer_id: str, doc_id: str):
        if peer_id not in self._peers:
            return
        state = self._state(doc_id)
        if state is None:
            return
        clock = dict(state.clock)
        if self._advertised.get((peer_id, doc_id)) == clock:
            return
        self._advertised[(peer_id, doc_id)] = clock
        self._peers[peer_id].send_msg({"docId": doc_id, "clock": clock})

    def doc_changed(self, doc_id: str, doc):
        state = self._state(doc_id)
        if not less_or_equal(self._matrix.our_clock(doc_id), state.clock):
            raise ValueError("Cannot pass an old state object to a connection")
        for peer_id in self._peers:
            self._session_docs.add((peer_id, doc_id))
        self._matrix.update_ours(doc_id, state.clock)
        # quarantined changes whose deps this update satisfied apply now
        # (the gate's re-entrancy guard makes this a no-op when the update
        # itself came from a gate drain)
        inbound_gate(self._doc_set).release(doc_id)
        self.flush()
        # peers that have never revealed a clock for this doc get an
        # advertisement instead of speculative changes (Connection's
        # unknown-peer behavior)
        for peer_id in self._peers:
            if (peer_id, doc_id) not in self._revealed:
                self._advertise(peer_id, doc_id)

    @contextmanager
    def batched(self):
        """Defer every flush() inside the block to ONE flush at exit (the
        service tick's cross-tenant amortization: N tenant deliveries +
        clock reveals in a tick trigger a single vectorized comparison
        and one change extraction per (doc, clock) group, not N flush
        loops). Nests; only the outermost exit flushes."""
        self._defer_depth += 1
        try:
            yield self
        finally:
            self._defer_depth -= 1
            if not self._defer_depth and self._flush_wanted:
                self._flush_wanted = False
                self.flush()

    def flush(self):
        """One batched comparison; send changes for every flagged pair.

        Change extraction is shared: flagged pairs with the same
        (doc, believed clock) — the common case when one local change
        fans out to N caught-up peers — run `get_missing_changes` once.
        The frame ENCODE is shared the same way: one
        ``split_outgoing`` per (doc, clock) group mints one
        ``AMTPUWIRE1`` frame serving every peer of the group — and the
        channel layer retransmits those exact bytes, never re-encoding
        (INTERNALS §17). The port always mints frames for in-scope
        payloads (the JAX package's default wire)."""
        if self._defer_depth:
            self._flush_wanted = True
            return
        from ..engine.wire_format import split_outgoing
        t_flush = obs.now() if obs.ENABLED else 0
        extracted: dict = {}
        encoded: dict = {}
        contexts: dict = {}   # same (doc, clock) key -> trace context
        pending = self._matrix.pending()
        n_msgs = n_changes = 0
        for peer_id, doc_id in pending:
            if peer_id not in self._peers:
                continue
            if (peer_id, doc_id) not in self._revealed:
                continue  # never send changes unsolicited (advertise path)
            state = self._state(doc_id)
            if state is None:
                # doc removed locally; clocks remain for history, but a
                # cached checkpoint bundle (megabytes) must not outlive it
                self._ckpt_cache.pop(doc_id, None)
                continue
            their = self._matrix.their_clock(peer_id, doc_id)
            key = (doc_id, tuple(sorted(their.items())))
            if key in extracted:
                changes = extracted[key]
            else:
                changes = extracted[key] = Backend.get_missing_changes(
                    state, their)
            clock = dict(state.clock)
            if not changes:
                # the peer's raw clock is behind ours but transitively
                # covers it: record the cover so this pair stops being
                # re-flagged (and re-diffed) on every flush
                self._matrix.update_theirs(peer_id, doc_id, clock)
                self._advertise(peer_id, doc_id)
                continue
            self._matrix.update_theirs(peer_id, doc_id, clock)
            self._advertised[(peer_id, doc_id)] = clock
            ctx = None
            if lineage.ENABLED:
                # one context derivation per (doc, clock) group — the
                # same sharing discipline as the extraction/encode — and
                # one hub/flush hop per (sampled change, peer): the hop
                # chain shows which peers this flush fanned out to
                if key in contexts:
                    ctx = contexts[key]
                else:
                    ctx = contexts[key] = lineage.context_for(changes)
                lineage.hop_delivery(changes, "hub/flush", site=peer_id,
                                     doc=doc_id)
            msg = {"docId": doc_id, "clock": clock, "changes": changes}
            if ctx:
                msg["trace"] = ctx
            parts = encoded.get(key)
            if parts is None:
                t_frame = obs.now() if obs.ENABLED else 0
                gtok = self.group_mint() \
                    if self.group_mint is not None else None
                parts = encoded[key] = split_outgoing(changes, trace=ctx,
                                                      group=gtok)
                if t_frame:
                    obs.span("hub", "frame", t_frame,
                             args={"changes": len(changes)})
            prefix, frame = parts
            if frame is not None:
                # the frame manifest carries the full context (prefix
                # changes included); no msg-level field
                msg = {"docId": doc_id, "clock": clock}
                if prefix:
                    msg["changes"] = prefix
                msg["wire"] = frame
            if (self.snapshot_min_changes and not their
                    and len(changes) >= self.snapshot_min_changes
                    and (peer_id, doc_id) not in self._no_snapshot):
                # snapshot bootstrap: a joining peer (empty believed
                # clock) missing a long history gets a checkpoint bundle
                # + the op-log tail past its frontier instead of the
                # whole log. A failed capture just serves plain changes.
                # The tail rides the binary wire too (one cached encode
                # serves the whole join storm, like the bundle itself).
                snap = self._doc_checkpoint(doc_id, state)
                if snap is not None:
                    ck_b64, tail, tail_parts = snap
                    msg = {"docId": doc_id, "clock": clock,
                           "checkpoint": ck_b64}
                    if tail_parts is not None \
                            and tail_parts[1] is not None:
                        if tail_parts[0]:
                            msg["changes"] = tail_parts[0]
                        msg["wire"] = tail_parts[1]
                    else:
                        msg["changes"] = tail
                        if lineage.ENABLED:
                            tail_ctx = lineage.context_for(tail)
                            if tail_ctx:
                                msg["trace"] = tail_ctx
            self._peers[peer_id].send_msg(msg)
            n_msgs += 1
            n_changes += len(changes)
        if t_flush:
            obs.span("hub", "flush", t_flush,
                     args={"peers": len(self._peers), "pairs": len(pending)})
            obs.counter("sync", "hub.fanout_msgs", n_msgs)
            obs.counter("sync", "hub.fanout_changes", n_changes)

    def _doc_checkpoint(self, doc_id: str, state):
        """(base64 bundle, tail changes) for a doc, cached per doc and
        recaptured once the tail past the cached frontier itself exceeds
        the snapshot threshold. None when capture fails (the caller falls
        back to plain change extraction).

        Both the capture AND its base64 encode are cached, so a join
        storm — N peers bootstrapping the same doc in one flush window —
        costs ONE snapshot encode serving all N (the coalescing the
        service tier's rejoin path leans on; `sync/snapshot_*` obs
        events make the capture-vs-served ratio visible)."""
        from ..checkpoint import Checkpoint, capture_state
        cached = self._ckpt_cache.get(doc_id)
        if cached is not None:
            # the entry may carry a 4th slot (the cached tail-frame
            # encode) once a tail has been served — unpack the fixed
            # prefix only
            ck, cap_len = cached[0], cached[1]
            stale = (state.history_len - cap_len >= self.snapshot_min_changes
                     or not less_or_equal(ck.clock, dict(state.clock)))
            if stale:
                cached = None
        if cached is None:
            # capture_state encodes synchronously: the cache holds bundle
            # bytes, never table references, so a cached entry stays
            # servable after later (in-place) rounds on the document
            try:
                ck = Checkpoint(capture_state(state))
            except Exception:
                logger.warning("checkpoint capture failed for doc %r; "
                               "serving plain changes", doc_id,
                               exc_info=True)
                return None
            cached = [ck, state.history_len, ck.to_base64()]
            self._ckpt_cache[doc_id] = cached
            if obs.ENABLED:
                obs.event("sync", "snapshot_capture", args={"doc": doc_id})
        elif obs.ENABLED:
            obs.event("sync", "snapshot_serve_cached", args={"doc": doc_id})
        ck, _, ck_b64 = cached[:3]
        tail = Backend.get_missing_changes(state, ck.clock)
        # tail frame cache, keyed by history length: the join-storm
        # coalescing extends to the binary encode of the tail
        tail_parts = None
        if tail:
            if len(cached) > 3 and cached[3][0] == state.history_len:
                tail_parts = cached[3][1]
            else:
                from ..engine.wire_format import split_outgoing
                tail_ctx = lineage.context_for(tail) \
                    if lineage.ENABLED else None
                tail_parts = split_outgoing(tail, trace=tail_ctx)
                entry = (state.history_len, tail_parts)
                if len(cached) > 3:
                    cached[3] = entry
                else:
                    cached.append(entry)
        return ck_b64, tail, tail_parts

    # -- inbound --------------------------------------------------------

    def note_clock(self, peer_id: str, doc_id: str, clock: dict):
        """Clock-reveal bookkeeping ALONE — no doc requests, no change
        application, no flush. The service tier's grouped admission
        strips `changes` out of tenant messages for batched per-doc
        delivery and records the revealed clock here (exactly the clock
        branch of `_receive`)."""
        if peer_id not in self._peers:
            return
        self._revealed.add((peer_id, doc_id))
        self._matrix.set_active(peer_id, doc_id)
        self._matrix.update_theirs(peer_id, doc_id, clock)

    def _receive(self, peer_id: str, msg: dict, validated: bool = False):
        if not validated:
            # typed rejection (ProtocolError) of anything off-schema BEFORE
            # any state is touched — a malformed message must not advance
            # believed clocks, document state, or the doc clock
            msg = validate_msg(msg)
        doc_id = msg["docId"]
        if lineage.ENABLED and msg.get("trace"):
            # adopt the sender's origin context BEFORE any application,
            # so the commit hops this delivery triggers stitch onto the
            # right origin timestamps (frame-borne context is adopted by
            # the gate's deliver_wire)
            lineage.adopt(msg["trace"])
        if peer_id not in self._peers:
            # late in-flight message for a removed peer (shared contract
            # with the closed-Connection path)
            return absorb_msg(self._doc_set, msg)
        if msg.get("clock") is not None:
            # an empty clock still registers the peer for this doc
            self._revealed.add((peer_id, doc_id))
            self._matrix.set_active(peer_id, doc_id)
            self._matrix.update_theirs(peer_id, doc_id, msg["clock"])
        if msg.get("noSnapshot"):
            # the peer could not use our checkpoint bundle (corrupt in
            # transit, or a policy refusal): our believed clock for it was
            # already advanced optimistically at send time, so re-extract
            # from the TRUE clock it just told us and resend plain changes
            self._no_snapshot.add((peer_id, doc_id))
            state = self._state(doc_id)
            if state is not None:
                changes = Backend.get_missing_changes(
                    state, msg.get("clock") or {})
                clock = dict(state.clock)
                self._matrix.update_theirs(peer_id, doc_id, clock)
                self._advertised[(peer_id, doc_id)] = clock
                if changes:
                    self._peers[peer_id].send_msg(
                        {"docId": doc_id, "clock": clock,
                         "changes": changes})
            return self._doc_set.get_doc(doc_id)
        if msg.get("checkpoint") is not None:
            return self._receive_snapshot(peer_id, doc_id, msg)
        if msg.get("wire") is not None:
            # binary frame (+ optional dict prefix): the gate's wire
            # fast lane hands the decoded batch straight to the backend
            # when admissible; otherwise the same validated +
            # quarantined dict path runs on the materialized changes
            from ..engine.wire_format import as_frame
            return inbound_gate(self._doc_set).deliver_wire(
                doc_id, [(as_frame(msg["wire"]), peer_id)],
                changes=msg.get("changes") or (), sender=peer_id,
                validated=True)
        if msg.get("changes"):
            # validated + quarantined application: premature changes park
            # in the bounded per-doc quarantine (attributed to this peer
            # for pressure-eviction observability and dead-peer
            # reclamation); duplicates dedup idempotently in the backend
            # admission layer
            return inbound_gate(self._doc_set).deliver(
                doc_id, msg["changes"], validated=True, sender=peer_id)
        if self._doc_set.get_doc(doc_id) is not None:
            self._matrix.update_ours(
                doc_id, Frontend.get_backend_state(
                    self._doc_set.get_doc(doc_id)).clock)
            self.flush()
        elif (peer_id, doc_id) not in self._session_docs \
                and msg.get("clock"):
            # the peer has a document this peer session never saw us hold:
            # request it with an empty clock (docs we deliberately removed
            # during the session are NOT re-requested — Connection's
            # `doc_id not in our_clock` guard — but a reconnected peer
            # starts a fresh session and may re-offer them)
            self._peers[peer_id].send_msg({"docId": doc_id, "clock": {}})
        return self._doc_set.get_doc(doc_id)

    def _receive_snapshot(self, peer_id: str, doc_id: str, msg: dict):
        """An inbound checkpoint bundle + tail (snapshot bootstrap).

        A verified bundle installs the document directly (no history
        replay); a corrupt or hash-mismatched one raises the typed
        ``CheckpointError`` inside, is logged, and degrades to a
        ``noSnapshot`` re-request — the peer then serves the full log,
        i.e. the full-replay fallback."""
        from ..checkpoint import Checkpoint, CheckpointError
        from ..engine.wire_format import as_frame
        wire = msg.get("wire")
        if self._doc_set.get_doc(doc_id) is not None:
            # we already hold state for this doc (a race with another
            # peer's bootstrap): take only the tail, through the gate
            if wire is not None:
                return inbound_gate(self._doc_set).deliver_wire(
                    doc_id, [(as_frame(wire), peer_id)],
                    changes=msg.get("changes") or (), sender=peer_id,
                    validated=True)
            if msg.get("changes"):
                return inbound_gate(self._doc_set).deliver(
                    doc_id, msg["changes"], validated=True, sender=peer_id)
            return self._doc_set.get_doc(doc_id)
        try:
            ck = Checkpoint.from_base64(msg["checkpoint"])
            return self._doc_set.bootstrap_doc(
                doc_id, ck, msg.get("changes") or [], validated=True,
                wire=None if wire is None else as_frame(wire))
        except CheckpointError as exc:
            logger.warning("snapshot bootstrap for doc %r failed (%s); "
                           "requesting full history", doc_id, exc)
        if peer_id in self._peers:
            self._peers[peer_id].send_msg(
                {"docId": doc_id, "clock": {}, "noSnapshot": True})
        return self._doc_set.get_doc(doc_id)
