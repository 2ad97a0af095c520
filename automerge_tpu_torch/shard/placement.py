"""Deterministic document placement across the shard mesh.

The placement table answers ONE question — which shard owns a document —
and answers it the same way on every host, every run, every process:
the default placement is a content hash of the doc id (SHA-1, truncated;
``hash()`` is salted per process and would scatter a population
differently on every restart), and every deviation from the hash is an
EXPLICIT table entry, so the full ownership map is always dumpable and
diffable (``table()``), never implicit in migration history.

Moves bump ``epoch`` — a cheap fence consumers use to notice that a
cached route may be stale (the router re-resolves per delivery anyway;
the epoch exists for introspection and tests).
"""

from __future__ import annotations

import hashlib


def hash_shard(doc_id: str, n_shards: int) -> int:
    """The default owner of `doc_id` on an `n_shards` mesh: stable across
    processes and platforms (unlike the salted builtin ``hash``)."""
    digest = hashlib.sha1(doc_id.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") % n_shards


class PlacementTable:
    """Hash-by-doc placement with an explicit override table."""

    __slots__ = ("n_shards", "epoch", "_overrides")

    def __init__(self, n_shards: int, overrides: dict = None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        self.epoch = 0
        self._overrides: dict = dict(overrides or {})
        for doc_id, shard in self._overrides.items():
            self._check(doc_id, shard)

    def _check(self, doc_id: str, shard: int):
        if not 0 <= shard < self.n_shards:
            raise ValueError(
                f"shard {shard} for {doc_id!r} outside [0, {self.n_shards})")

    def shard_of(self, doc_id: str) -> int:
        s = self._overrides.get(doc_id)
        return hash_shard(doc_id, self.n_shards) if s is None else s

    def move(self, doc_id: str, shard: int):
        """Record an explicit ownership change (the migration commit
        point). Moving a doc back to its hash home drops the override —
        the table never accretes entries that restate the hash."""
        self._check(doc_id, shard)
        if shard == hash_shard(doc_id, self.n_shards):
            self._overrides.pop(doc_id, None)
        else:
            self._overrides[doc_id] = shard
        self.epoch += 1

    def table(self) -> dict:
        """The explicit (non-hash) entries: {doc_id: shard}."""
        return dict(self._overrides)

    def spread(self, doc_ids) -> list:
        """Per-shard doc counts for a population (capacity planning /
        tests of hash balance)."""
        counts = [0] * self.n_shards
        for doc_id in doc_ids:
            counts[self.shard_of(doc_id)] += 1
        return counts
