"""Per-peer vector-clock sync protocol, multiplexing many docs per connection.

Counterpart of the reference's src/connection.js. Messages are plain JSON
``{docId, clock, changes?}`` — byte-compatible with the reference protocol —
and transport is user-supplied (``send_msg`` callback out, ``receive_msg`` in).

Unlike the reference — where every Connection re-diffs every doc against its
peer on each local change (src/connection.js:58-88 driven per connection by
the DocSet handler) — a Connection here is a thin per-peer face over its
DocSet's ONE shared `SyncHub`: N connections on a doc-set cost a single
vectorized clock comparison (`ClockMatrix.pending`) per local change, and
peers with identical believed clocks share one change extraction
(`SyncHub.flush`). Wire behavior per peer matches the reference protocol:
changes flow only after the peer reveals a clock for a doc, advertisements
otherwise, unknown advertised docs are requested with an empty clock, and
handing the doc-set a stale snapshot raises (src/connection.js:79-86).
"""

from __future__ import annotations

from ..resilience.inbound import absorb_msg
from ..resilience.validation import validate_msg
from .hub import shared_hub


class Connection:
    """One peer endpoint on the doc-set's shared hub.

    The public surface mirrors the reference Connection: ``open``/``close``
    for lifecycle, ``receive_msg`` for inbound messages (returns the updated
    document, like src/connection.js:91-107); outbound messages go through
    the ``send_msg`` callback passed to the constructor.
    """

    def __init__(self, doc_set, send_msg):
        self._doc_set = doc_set
        self._send_msg = send_msg
        self._hub = None
        self._peer_id = None
        self._closed = False

    def _ensure_peer(self):
        if self._hub is None:
            self._hub = shared_hub(self._doc_set)
            self._peer_id = self._hub.auto_peer_id()
            self._hub.add_peer(self._peer_id, self._send_msg)
        return self._hub

    def open(self):
        """Join the doc-set's hub: advertises every current doc to the peer
        and subscribes to future local changes. Reopens a closed
        connection with fresh peer state."""
        self._closed = False
        self._ensure_peer()

    def close(self):
        """Leave the hub. When the last connection leaves, the hub itself
        unhooks from the DocSet (so a peer-less doc-set accepts snapshot
        set_doc again and pays no sync bookkeeping); a later open()
        rejoins with fresh peer state."""
        if self._hub is not None:
            self._hub.remove_peer(self._peer_id)
            if not self._hub.has_peers():
                self._hub.close()
                if getattr(self._doc_set, "_sync_hub", None) is self._hub:
                    self._doc_set._sync_hub = None
            self._hub = None
            self._peer_id = None
        self._closed = True

    def receive_msg(self, msg: dict):
        msg = validate_msg(msg)   # ProtocolError on anything off-schema
        if self._closed:
            # a late in-flight message after close(): absorb inbound
            # changes — through the SAME validated + quarantined gate as
            # the open path — but never rejoin the hub or write to the
            # (likely torn-down) transport
            return absorb_msg(self._doc_set, msg)
        return self._ensure_peer()._receive(self._peer_id, msg,
                                            validated=True)
