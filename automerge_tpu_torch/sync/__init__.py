"""Sync tier: documents replicated through the ``{docId, clock,
changes?}`` protocol (the reference's src/connection.js, doc_set.js and
watchable_doc.js), with one shared `SyncHub` per DocSet batching every
peer's clock comparison into one `ClockMatrix.pending` call."""

from .connection import Connection  # noqa: F401
from .clock_index import ClockMatrix  # noqa: F401
from .doc_set import DocSet  # noqa: F401
from .hub import HubPeer, SyncHub  # noqa: F401
from .watchable_doc import WatchableDoc  # noqa: F401
