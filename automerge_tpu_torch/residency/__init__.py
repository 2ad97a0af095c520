"""Device-residency tiering: millions of docs on bounded HBM.

The tier ladder (INTERNALS §22): hot docs live device-resident in shard
lanes; warm docs demote to host-side AMTPUCKPT1 checkpoint bundles
(`BundleStore`); cold bundles age to one spill file each on disk.
Demand paging rides sync traffic through `ShardedDocSet.deliver_round`,
admission hints (router park / quarantine release) prefetch, and
eviction is the learned working-set model of `policy.py` driven by the
same telemetry windows the rebalance policy reads.
"""

from .manager import ResidencyManager
from .policy import LruModel, ResidencyConfig, WorkingSetModel, make_model
from .store import BundleStore

__all__ = [
    "ResidencyManager",
    "ResidencyConfig",
    "BundleStore",
    "WorkingSetModel",
    "LruModel",
    "make_model",
]
