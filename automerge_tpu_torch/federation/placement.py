"""Region-aware room placement: which region is a room's write home.

Layered on the shard tier's :class:`~automerge_tpu_torch.shard.placement
.PlacementTable` — the same deterministic content-hash default and
explicit-override discipline (every deviation from the hash is a
dumpable table entry; moves bump an epoch fence) — but mapping rooms to
NAMED REGIONS instead of doc ids to shard indices.  Placement is
advisory for writes (the degradation ladder's first rung is
local-writes-always-accepted, so any region admits writes during a
partition); it decides which region a load balancer should prefer and
which region's mint stream a room's group tokens normally ride.
"""

from __future__ import annotations

from ..shard.placement import PlacementTable


class RegionPlacement:
    """Deterministic room -> region-name map with explicit overrides."""

    __slots__ = ("regions", "_table")

    def __init__(self, regions, overrides: dict = None):
        regions = list(regions)
        if not regions:
            raise ValueError("need at least one region")
        if len(set(regions)) != len(regions):
            raise ValueError(f"duplicate region names: {regions}")
        self.regions = regions
        idx = {}
        for room, region in (overrides or {}).items():
            try:
                idx[room] = regions.index(region)
            except ValueError:
                raise ValueError(
                    f"override {room!r} -> {region!r}: unknown region "
                    f"(have {regions})") from None
        self._table = PlacementTable(len(regions), overrides=idx)

    @property
    def epoch(self) -> int:
        """Move fence: bumps on every explicit home change."""
        return self._table.epoch

    def home(self, room: str) -> str:
        """The room's write-home region (hash default, override-aware)."""
        return self.regions[self._table.shard_of(room)]

    def move(self, room: str, region: str):
        """Re-home a room (an explicit table entry; moving back to the
        hash home drops the entry, same as the shard tier)."""
        try:
            self._table.move(room, self.regions.index(region))
        except ValueError as exc:
            if "outside" in str(exc):
                raise
            raise ValueError(f"unknown region {region!r} "
                             f"(have {self.regions})") from None

    def table(self) -> dict:
        """Explicit overrides only: ``{room: region}`` (the hash default
        is implied for everything absent — dumpable and diffable)."""
        return {room: self.regions[i]
                for room, i in self._table.table().items()}

    def spread(self, rooms) -> dict:
        """``{region: room_count}`` for a room population — the balance
        check a rollout asserts before and after moves."""
        counts = self._table.spread(rooms)
        return {self.regions[i]: c for i, c in enumerate(counts)}
