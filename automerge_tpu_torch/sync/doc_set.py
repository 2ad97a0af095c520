"""Keyed collection of documents with change handlers.

Counterpart of the reference's src/doc_set.js. A DocSet is the unit the
sync protocol multiplexes over one connection, and the unit the device
engine batches over (many documents merged in one call).

A DocSet is bound to one backend namespace: the documents it creates (a
delivery for a doc it does not hold) and restores (snapshot bootstrap)
start on that namespace's device. ``DocSet()`` binds ``backend.default``,
the device backend on the CUDA card, and raises at its first document
when there is none; ``DocSet(backend=backend.backend_for("cpu"))`` runs
the engines' plain PyTorch versions on the CPU. Applying changes to a
document it holds follows that document's own lineage and device.
"""

from __future__ import annotations

from ..backend import default as Backend
from .. import frontend as Frontend


class DocSet:
    def __init__(self, backend=None):
        #: the backend namespace new and restored documents start on
        self.backend = backend if backend is not None else Backend.Backend
        self._docs: dict = {}
        self._handlers: list = []

    @property
    def doc_ids(self):
        return list(self._docs.keys())

    def get_doc(self, doc_id: str):
        return self._docs.get(doc_id)

    def remove_doc(self, doc_id: str):
        self._docs.pop(doc_id, None)

    def set_doc(self, doc_id: str, doc):
        self._docs[doc_id] = doc
        for handler in list(self._handlers):
            handler(doc_id, doc)

    def apply_changes(self, doc_id: str, changes):
        """Raw application — trusted (in-process) callers only. Network
        deliveries go through :meth:`deliver`, which validates and
        quarantines first; this method is what the inbound gate itself
        calls once a batch is admitted."""
        doc = self._applied_doc(doc_id, changes)
        self.set_doc(doc_id, doc)
        return doc

    def _applied_doc(self, doc_id: str, changes):
        """The doc with `changes` applied, WITHOUT committing it — the
        inbound gate uses this to separate backend rejection (state
        untouched, wrapped as ProtocolError) from exceptions raised by
        change handlers after the commit (which must propagate as-is:
        the document did change)."""
        doc = self._docs.get(doc_id)
        if doc is None:
            doc = Frontend.init({"backend": self.backend})
        old_state = Frontend.get_backend_state(doc)
        new_state, patch = Backend.apply_changes(old_state, changes)
        patch["state"] = new_state
        return Frontend.apply_patch(doc, patch)

    def deliver(self, doc_id: str, changes):
        """Validated + quarantined inbound application (the network path).

        Malformed changes raise ``ProtocolError`` leaving document state
        and clock untouched; causally-premature changes park in the
        bounded per-doc quarantine and apply automatically once their
        deps arrive. Returns the (possibly unchanged) document."""
        from ..resilience.inbound import inbound_gate
        return inbound_gate(self).deliver(doc_id, changes)

    def checkpoint_doc(self, doc_id: str):
        """An integrity-checked columnar snapshot bundle of one document
        (``automerge_tpu_torch.checkpoint.Checkpoint``) — what the
        snapshot bootstrap hands a joining peer instead of full
        history."""
        from ..checkpoint import checkpoint_doc
        doc = self._docs.get(doc_id)
        if doc is None:
            raise KeyError(f"no document {doc_id!r} in this doc set")
        return checkpoint_doc(doc)

    def bootstrap_doc(self, doc_id: str, checkpoint, changes=None,
                      fallback_changes=None, validated: bool = False,
                      wire=None):
        """Install a document from a checkpoint + op-log tail (snapshot
        bootstrap), on this DocSet's backend. The bundle is
        integrity-verified before any state is installed; a corrupt
        bundle raises ``CheckpointError`` — or, when
        ``fallback_changes`` carries the full log, degrades to full log
        replay instead. The tail then applies through the validated +
        quarantined inbound gate like any network delivery; ``wire``
        carries the tail's binary frame when the peer served it on the
        binary wire (the dict ``changes`` are then the prefix)."""
        from ..checkpoint import restore_doc_or_replay
        from ..resilience.inbound import inbound_gate
        doc = restore_doc_or_replay(checkpoint, fallback_changes,
                                    {"backend": self.backend})
        self.set_doc(doc_id, doc)
        from ..obs import lineage
        if lineage.ENABLED:
            # snapshot-bootstrap visibility: every sampled chain the
            # restored clock covers became visible on this replica
            # INSIDE the bundle (it never re-crossed the wire) — the
            # ckpt/adopt hop keeps those chains complete here
            state = Frontend.get_backend_state(doc)
            if state is not None:
                lineage.adopt_clock(dict(state.clock),
                                    site=lineage.site_of(self),
                                    doc=doc_id)
        gate = inbound_gate(self)
        if wire is not None:
            gate.deliver_wire(doc_id, [(wire, None)],
                              changes=changes or (), validated=validated)
        elif changes:
            gate.deliver(doc_id, changes, validated=validated)
        else:
            gate.release(doc_id)   # parked changes the snapshot satisfied
        return self.get_doc(doc_id)

    def register_handler(self, handler):
        if handler not in self._handlers:
            self._handlers.append(handler)

    def unregister_handler(self, handler):
        if handler in self._handlers:
            self._handlers.remove(handler)
