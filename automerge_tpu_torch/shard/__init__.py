"""Sharded serving tier: the live document population partitioned
across lanes (INTERNALS §15).

- :mod:`.placement` — deterministic hash-by-doc placement with an
  explicit override table (every non-hash route is a dumpable entry).
- :mod:`.lane` — one shard's execution lane: a device, a CUDA stream on
  it, its resident engine docs, and the stacked commit programs that
  serve them.
- :mod:`.parallel` — the per-lane worker threads and their round
  barrier.
- :mod:`.set` — the tier: routing, the per-doc causal quarantine gate,
  and checkpoint-bundle hot-doc migration with its quarantine handshake.
- :mod:`.rebalance` — the telemetry-window rebalance policy.
"""

from .lane import ShardLane  # noqa: F401
from .placement import PlacementTable, hash_shard  # noqa: F401
from .rebalance import Rebalancer  # noqa: F401
from .set import ShardedDocSet  # noqa: F401

__all__ = ["PlacementTable", "hash_shard", "ShardLane", "ShardedDocSet",
           "Rebalancer"]
