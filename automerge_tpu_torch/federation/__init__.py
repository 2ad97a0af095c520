"""Geo-distributed federation: partition-tolerant inter-service
replication with O(groups) causal metadata (INTERNALS §20). The port of
the JAX package's ``federation/``: every region is a port
:class:`~automerge_tpu_torch.service.SyncService`, whose rooms live on
its ``ServiceConfig.device`` (None: the CUDA card).

- ``causal`` — :class:`GroupClock`: one ordering token per (room,
  origin-region) replication group, riding the ``AMTPUWIRE1`` manifest.
- ``link`` — :class:`RegionLink`: resilient channel + WAN chaos +
  degradation ladder + probe/hello reconnect per region pair.
- ``fabric`` — :class:`FederatedRegion` / :func:`connect_regions`: the
  per-service attachment wiring room hubs into the fabric and exporting
  the ``amtpu_region_*`` observability families.
- ``placement`` — :class:`RegionPlacement`: deterministic room ->
  write-home-region map on the shard tier's placement table.
"""

from .causal import GroupClock  # noqa: F401
from .fabric import FederatedRegion, connect_regions  # noqa: F401
from .link import (  # noqa: F401
    HEALING, LADDER, LAGGED, OK, PARTITIONED, RegionLink,
)
from .placement import RegionPlacement  # noqa: F401

__all__ = [
    "FederatedRegion", "GroupClock", "RegionLink", "RegionPlacement",
    "connect_regions", "LADDER", "OK", "LAGGED", "PARTITIONED",
    "HEALING",
]
