"""A plain RGA list: the text CRDT's semantics, element by element.

An element is (counter, actor); one element is greater than another by
counter, then by actor id. An insert goes right after its parent,
past every element greater than itself (those are later concurrent
inserts after the same parent, and their descendants, which are greater
still). A delete hides an element; a set gives it its character. An
element with no value is not part of the text.
"""

from __future__ import annotations

HEAD = None


class RgaText:
    def __init__(self):
        self.order: list = []       # every element, tombstones included
        self.chars: list = []       # its character, "" while hidden

    def insert(self, elem, parent, at: int = -1) -> int:
        """Insert `elem` after `parent`; `at` may give the parent's index
        when the caller knows it. Returns the new element's index."""
        if parent is HEAD:
            i = 0
        else:
            i = (at if at >= 0 else self.order.index(parent)) + 1
        n = len(self.order)
        while i < n and self.order[i] > elem:
            i += 1
        self.order.insert(i, elem)
        self.chars.insert(i, "")
        return i

    def apply(self, ops) -> None:
        """Apply one change's ops: ("ins", elem, parent), ("set", elem,
        code point), ("del", elem)."""
        last, last_i = object(), -1
        for op in ops:
            if op[0] == "ins":
                last_i = self.insert(op[1], op[2],
                                     last_i if op[2] == last else -1)
                last = op[1]
            elif op[0] == "set":
                i = last_i if op[1] == last else self.order.index(op[1])
                self.chars[i] = chr(op[2])
            else:
                self.chars[self.order.index(op[1])] = ""

    def text(self) -> str:
        return "".join(self.chars)
