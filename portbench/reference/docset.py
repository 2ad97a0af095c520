"""The document set's texts, replayed from the generated changes."""

from __future__ import annotations

from .rga import RgaText


class DocSetReference:
    def __init__(self, initial: dict):
        """`initial`: {doc id: [Change]}, the set-up's build."""
        self.docs = {}
        for obj, changes in initial.items():
            t = RgaText()
            for c in changes:
                t.apply(c.ops)
            self.docs[obj] = t

    def apply(self, round_changes: dict) -> dict:
        """Apply one round; returns {doc id: text} of the documents it
        touched."""
        out = {}
        for obj, changes in round_changes.items():
            t = self.docs[obj]
            for c in changes:
                t.apply(c.ops)
            out[obj] = t.text()
        return out

    def texts(self) -> dict:
        return {obj: t.text() for obj, t in self.docs.items()}
