"""Indexable (order-statistic) skip list: visible elemId <-> list index.

Capability counterpart of the reference's immutable skip list
(reference backend/skip_list.js:1-343): a probabilistic ordered index
mapping element IDs to list positions and back in expected O(log n), with the
same injectable level-randomness determinism hook the reference tests rely on
(skip_list.js:114-117).

Design differs deliberately: the reference builds a persistent
(immutable-on-update) structure because its whole backend state is persistent;
here the backend uses an append-only command log with replay-on-fork (see
``automerge_tpu.backend.facade``), so the index is a plain mutable structure —
cheaper by a constant factor and friendlier to the columnar device encoding
that replaces it on the hot path (segmented prefix scans in the device engine).

Every node stores forward and backward links *with hop widths* at each of its
levels, so both ``key_of(index)`` (position lookup) and ``index_of(key)``
(rank query) run in expected O(log n).
"""

from __future__ import annotations

import random
from typing import Any, Iterator, Optional

_MAX_LEVEL = 32
_HEAD = object()  # sentinel key for the head tower


class _Node:
    __slots__ = ("key", "value", "level", "nxt", "nxt_w", "prv", "prv_w")

    def __init__(self, key, value, level):
        self.key = key
        self.value = value
        self.level = level
        self.nxt = [None] * level      # successor key per level (None = tail)
        self.nxt_w = [1] * level       # element-count distance to successor
        self.prv = [_HEAD] * level     # predecessor key per level
        self.prv_w = [1] * level       # element-count distance from predecessor


class SkipList:
    """Mutable order-statistic skip list keyed by elemId strings."""

    def __init__(self, random_source=None, level_source=None):
        # random_source: () -> float in [0, 1); level_source: iterator of ints
        # (explicit level injection, used by deterministic tests).
        self._random = random_source or random.random
        self._levels = iter(level_source) if level_source is not None else None
        self._head = _Node(_HEAD, None, 1)
        self._head.nxt = [None]
        self._head.nxt_w = [1]
        self._nodes: dict[Any, _Node] = {}
        self._length = 0

    # -- level policy: geometric with p=0.75 of stopping, like the reference
    # (skip_list.js:7-21) --
    def _random_level(self) -> int:
        if self._levels is not None:
            return max(1, next(self._levels))
        level = 1
        while level < _MAX_LEVEL and self._random() >= 0.75:
            level += 1
        return level

    def __len__(self) -> int:
        return self._length

    @property
    def length(self) -> int:
        return self._length

    def __contains__(self, key) -> bool:
        return key in self._nodes

    def _node(self, key) -> _Node:
        if key is _HEAD:
            return self._head
        return self._nodes[key]

    def _predecessors(self, index: int):
        """Per-level predecessors of position `index`, with their positions.

        Returns (preds, pred_pos) lists of length head.level; preds[l] is the
        rightmost node at level l whose position is < index (head pos = -1).
        """
        head_level = self._head.level
        preds = [self._head] * head_level
        pred_pos = [-1] * head_level
        cur, cur_pos = self._head, -1
        for level in range(head_level - 1, -1, -1):
            while cur.nxt[level] is not None and cur_pos + cur.nxt_w[level] < index:
                cur_pos += cur.nxt_w[level]
                cur = self._nodes[cur.nxt[level]]
            preds[level] = cur
            pred_pos[level] = cur_pos
        return preds, pred_pos

    def insert_index(self, index: int, key, value=None) -> "SkipList":
        if not isinstance(index, int) or index < 0 or index > self._length:
            raise IndexError(f"insert index {index} out of bounds for length {self._length}")
        if key in self._nodes:
            raise ValueError(f"duplicate skip list key {key}")
        level = self._random_level()

        # Grow the head tower first so every level has a predecessor.
        while self._head.level < level:
            self._head.nxt.append(None)
            self._head.nxt_w.append(self._length + 1)
            self._head.level += 1

        preds, pred_pos = self._predecessors(index)
        node = _Node(key, value, level)
        self._nodes[key] = node

        for l in range(level):
            pred = preds[l]
            succ_key = pred.nxt[l]
            succ_pos = pred_pos[l] + pred.nxt_w[l]  # position of succ (or length for tail)
            node.nxt[l] = succ_key
            node.nxt_w[l] = succ_pos - index + 1
            node.prv[l] = pred.key
            node.prv_w[l] = index - pred_pos[l]
            pred.nxt[l] = key
            pred.nxt_w[l] = index - pred_pos[l]
            if succ_key is not None:
                succ = self._nodes[succ_key]
                succ.prv[l] = key
                succ.prv_w[l] = succ_pos - index + 1
        for l in range(level, self._head.level):
            preds[l].nxt_w[l] += 1
            succ_key = preds[l].nxt[l]
            if succ_key is not None:
                self._nodes[succ_key].prv_w[l] += 1

        self._length += 1
        return self

    def insert_after(self, pred_key, key, value=None) -> "SkipList":
        """Insert `key` immediately after `pred_key` (None = head)."""
        if pred_key is None:
            return self.insert_index(0, key, value)
        return self.insert_index(self.index_of(pred_key) + 1, key, value)

    def remove_index(self, index: int) -> "SkipList":
        if not isinstance(index, int) or index < 0 or index >= self._length:
            raise IndexError(f"remove index {index} out of bounds for length {self._length}")
        preds, _ = self._predecessors(index)
        target = self._nodes[preds[0].nxt[0]]

        for l in range(target.level):
            pred = preds[l]
            succ_key = target.nxt[l]
            pred.nxt[l] = succ_key
            pred.nxt_w[l] = pred.nxt_w[l] + target.nxt_w[l] - 1
            if succ_key is not None:
                succ = self._nodes[succ_key]
                succ.prv[l] = pred.key
                succ.prv_w[l] = pred.nxt_w[l]
        for l in range(target.level, self._head.level):
            preds[l].nxt_w[l] -= 1
            succ_key = preds[l].nxt[l]
            if succ_key is not None:
                self._nodes[succ_key].prv_w[l] -= 1

        del self._nodes[target.key]
        self._length -= 1
        return self

    def remove_key(self, key) -> "SkipList":
        return self.remove_index(self.index_of(key))

    def index_of(self, key) -> int:
        """Rank of `key` among visible elements, or -1 if absent.

        Walks backward toward the head, always jumping at the current node's
        top level and summing hop widths (the same rank-query strategy as the
        reference's predecessor walk, skip_list.js:124-166).
        """
        node = self._nodes.get(key)
        if node is None:
            return -1
        total = 0
        while node.key is not _HEAD:
            top = node.level - 1
            total += node.prv_w[top]
            node = self._node(node.prv[top])
        return total - 1

    def key_of(self, index: int):
        if not isinstance(index, int) or index < 0 or index >= self._length:
            return None
        cur, cur_pos = self._head, -1
        for level in range(self._head.level - 1, -1, -1):
            while cur.nxt[level] is not None and cur_pos + cur.nxt_w[level] <= index:
                cur_pos += cur.nxt_w[level]
                cur = self._nodes[cur.nxt[level]]
                if cur_pos == index:
                    return cur.key
        return cur.key if cur_pos == index else None

    def get_value(self, key):
        node = self._nodes.get(key)
        return node.value if node else None

    def set_value(self, key, value) -> "SkipList":
        self._nodes[key].value = value
        return self

    def __iter__(self) -> Iterator:
        key = self._head.nxt[0]
        while key is not None:
            node = self._nodes[key]
            yield key
            key = node.nxt[0]

    def items(self):
        key = self._head.nxt[0]
        while key is not None:
            node = self._nodes[key]
            yield key, node.value
            key = node.nxt[0]
