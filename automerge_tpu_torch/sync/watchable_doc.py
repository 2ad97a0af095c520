"""Single-document observable (counterpart of the reference's
src/watchable_doc.js). It applies changes to the document's own lineage,
so it needs no backend binding of its own."""

from __future__ import annotations

from ..backend import default as Backend
from .. import frontend as Frontend


class WatchableDoc:
    def __init__(self, doc):
        if doc is None:
            raise ValueError("doc argument is required")
        self._doc = doc
        self._handlers: list = []

    def get(self):
        return self._doc

    def set(self, doc):
        self._doc = doc
        for handler in list(self._handlers):
            handler(doc)

    def apply_changes(self, changes):
        old_state = Frontend.get_backend_state(self._doc)
        new_state, patch = Backend.apply_changes(old_state, changes)
        patch["state"] = new_state
        new_doc = Frontend.apply_patch(self._doc, patch)
        self.set(new_doc)
        return new_doc

    def register_handler(self, handler):
        if handler not in self._handlers:
            self._handlers.append(handler)

    def unregister_handler(self, handler):
        if handler in self._handlers:
            self._handlers.remove(handler)
