"""Telemetry-driven hot-doc rebalancing (INTERNALS §15.3).

The policy reads exactly one signal: the per-shard admitted-ops window
series the lanes feed into the tier's rolling
:class:`~..obs.telemetry.Telemetry` store (``shard`` /
``lane<i>_admitted_ops`` — the bounded window ring, NOT lifetime
totals, so a shard that was hot an hour ago and idle since does not
stay "hot" forever). When the hottest lane's recent window load exceeds
``ratio`` x the coldest lane's (and a ``min_ops`` floor, so a near-idle
mesh never migrates on noise), the hot lane's hottest resident doc
moves to the cold lane via the checkpoint-bundle protocol
(`ShardedDocSet.migrate`). A ``cooldown`` of serving rounds follows
every move — the window series needs time to reflect the new placement
before the next decision, or a single hot doc ping-pongs.
"""

from __future__ import annotations


class Rebalancer:
    """Window-load rebalance policy over a :class:`~.set.ShardedDocSet`."""

    def __init__(self, sharded, ratio: float = 4.0, min_ops: int = 512,
                 cooldown: int = 4):
        self.sharded = sharded
        self.ratio = ratio
        self.min_ops = min_ops
        self.cooldown = cooldown
        self._cooling = 0
        self.stats = {"decisions": 0, "migrations": 0, "deferred": 0}

    def window_loads(self) -> list:
        """Per-lane admitted-ops totals over the retained telemetry
        windows (the policy's entire input)."""
        tel = self.sharded.telemetry
        return [sum(v for _, v in tel.series(
                    "shard", f"lane{lane.index}_admitted_ops"))
                for lane in self.sharded.lanes]

    def maybe_rebalance(self):
        """One policy decision at a commit boundary; returns the
        (doc_id, src, dst) it migrated, or None."""
        self.stats["decisions"] += 1
        if self._cooling > 0:
            self._cooling -= 1
            return None
        sharded = self.sharded
        if sharded.n_shards < 2:
            return None
        loads = self.window_loads()
        hot = max(range(len(loads)), key=loads.__getitem__)
        cold = min(range(len(loads)), key=loads.__getitem__)
        if sharded.residency is not None:
            # budget-aware placement (INTERNALS §22): among the lanes
            # tied for the coldest window, land the migrant where the
            # device footprint is lightest — a rebalance should relieve
            # ops pressure without concentrating bytes
            cold = min(
                (i for i in range(len(loads)) if loads[i] == loads[cold]),
                key=lambda i: (
                    sharded.lanes[i].device_footprint()["device_bytes"], i))
        if hot == cold or loads[hot] < self.min_ops \
                or loads[hot] < self.ratio * max(loads[cold], 1):
            return None
        pick = sharded.lanes[hot].hottest_doc()
        if pick is None:
            return None
        doc_id, _ops = pick
        if len(sharded.lanes[hot].docs) < 2:
            # moving a lane's only doc just relabels the imbalance
            return None
        # arm the cooldown BEFORE migrating: migrate() replays penned
        # deliveries through deliver_round, which re-enters this policy
        # at its end — an unarmed cooldown there could fire a second
        # migration inside the same commit boundary (the exact
        # ping-pong the cooldown exists to prevent)
        self._cooling = self.cooldown
        if sharded.migrate(doc_id, cold):
            self.stats["migrations"] += 1
            return (doc_id, hot, cold)
        self._cooling = 0
        self.stats["deferred"] += 1
        return None
