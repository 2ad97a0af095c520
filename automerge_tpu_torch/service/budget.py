"""Bounded-everything configuration for the sync service tier.

Every resource the service holds per tenant is named here with an explicit
cap — admission work per tick (ops / bytes), queued-but-unadmitted messages
(the inbox, which the channel's credit gate enforces at the ack path), the
channel's reorder window and retransmit budget, and the per-room quarantine
bounds. There is deliberately no "unbounded" value: a missing bound is how
one hot tenant becomes a global outage (Okapi's fault model — degradation
must stay per-tenant).
"""

from __future__ import annotations

from ..resilience.quarantine import DEFAULT_CAPACITY


class TenantBudget:
    """Per-tenant, per-tick admission budget + queueing caps.

    - ``ops_per_tick`` / ``bytes_per_tick``: how much decoded sync work
      one tick admits for this tenant. The first queued message of a
      visited tenant always admits (an oversized message eats the tick,
      it cannot wedge the tenant forever); past that, over-budget
      messages stay queued — deferral, not loss.
    - ``inbox_cap``: credit for the channel's admit gate. Frames beyond
      it drop UN-acked, so the peer's retransmit backoff is the
      backpressure signal. Structural memory bound per tenant:
      ``inbox_cap`` delivered + ``recv_window`` reorder-buffered frames.
    - ``priority``: higher admits first inside a tick; under deadline
      pressure the LOWEST priorities shed (defer) first. The scheduler's
      aging boost still front-runs any starved tenant, so low priority
      bounds latency, it never means "never".
    """

    __slots__ = ("ops_per_tick", "bytes_per_tick", "inbox_cap", "priority")

    def __init__(self, ops_per_tick: int = 256,
                 bytes_per_tick: int = 64 * 1024,
                 inbox_cap: int = 32, priority: int = 0):
        if ops_per_tick < 1 or bytes_per_tick < 1 or inbox_cap < 1:
            raise ValueError("tenant budget caps must be >= 1 "
                             f"(got ops={ops_per_tick}, "
                             f"bytes={bytes_per_tick}, inbox={inbox_cap})")
        self.ops_per_tick = ops_per_tick
        self.bytes_per_tick = bytes_per_tick
        self.inbox_cap = inbox_cap
        self.priority = priority


class ServiceConfig:
    """Service-wide knobs (every per-tenant default lives in
    :class:`TenantBudget`; ``connect`` accepts per-tenant overrides).

    - ``tick_budget_ms``: soft deadline for one tick's admission phase;
      0 disables. When the deadline passes mid-tick, the unvisited tail
      (lowest priority last) is SHED for this tick: counted, evented
      (``svc/shed``), and retried next tick — overload degrades to
      added latency for the cheapest victims, never to collapse or loss.
    - ``heartbeat_ticks`` / ``suspect_grace_ticks``: the peer-health
      ladder. A tenant we are OWED acks by (frames in flight) that has
      sent nothing for ``heartbeat_ticks`` turns SUSPECT; after
      ``suspect_grace_ticks`` more of silence it is declared dead and
      evicted. Any inbound frame (even a bare ack) resets the clock; an
      idle tenant with nothing owed is never suspected.
    - ``max_retries`` (+ ``base_rto``/``max_rto``/``recv_window``):
      server-side channel knobs. The retransmit cap is the heartbeat's
      backstop — whichever fires first declares the peer dead.
    - ``quarantine_capacity`` / ``quarantine_global_capacity``: per-room
      inbound-gate bounds (per-doc and aggregate).
    - ``starvation_boost_ticks``: a tenant with backlog that admitted
      nothing for this many consecutive ticks jumps the priority order
      on its next visit (the no-tenant-starves guarantee).
    - ``tick_ring``: how many tick durations the p50/p99 metrics window
      retains (the bounded history the percentiles are computed over —
      a long-lived service never accumulates unbounded timings).
    - ``lag_probe_ticks``: replication-lag probe cadence (every N ticks;
      0 disables). Each probe is one vectorized ClockMatrix comparison
      per room plus a bounded un-acked-frame scan per tenant
      (INTERNALS §14.2).
    - ``event_log``: how many degradation events (defer / shed /
      suspect / evict / protocol_error ...) the black-box ring retains
      for ``SyncService.describe()`` — the postmortem dump works with
      tracing OFF, so the service keeps its own bounded ring.
    - ``prom_lag_series``: at most this many per-tenant lag gauge
      series on the scrape page (worst-lagging first); aggregates are
      always exported, so the page stays bounded at any tenant count.
    - ``shard_lanes``: partition the room population across this many
      shard execution lanes over the device mesh (INTERNALS §15.4):
      each room maps onto a lane by the deterministic placement table
      and its grouped gate deliveries run under that lane's device
      context, so room document state lives device-local per shard. 0
      (the default) keeps the unsharded single-device behavior; -1 uses
      one lane per visible device.
    - ``residency_budget_bytes`` (+ ``residency_headroom`` /
      ``residency_cold_after`` / ``residency_spill_dir``): the
      device-residency tier (INTERNALS §22). Non-zero turns on the bulk
      doc mesh with a residency manager over the service's shard lanes:
      hot docs stay device-resident under the byte budget, warm docs
      demote to host checkpoint bundles, cold bundles age to disk after
      ``residency_cold_after`` pager rounds (``residency_spill_dir``
      must be set for the cold tier). ``tick()`` is the pager
      heartbeat; ``mesh_deliver`` feeds the paging gate. Like every
      other knob here, this is a BOUND: the live population may be any
      size, the device bytes may not.
    - ``device``: where the rooms' documents, the shard lanes and the
      bulk doc mesh live. None (the default) is the CUDA card — one lane
      per card for ``shard_lanes=-1`` — and raises when the first room
      or lane is built without one; ``"cpu"`` runs the engines' plain
      PyTorch versions there. Never a fallback.
    """

    __slots__ = ("tick_budget_ms", "heartbeat_ticks", "suspect_grace_ticks",
                 "max_retries", "base_rto", "max_rto", "recv_window",
                 "quarantine_capacity", "quarantine_global_capacity",
                 "starvation_boost_ticks", "tick_ring", "default_budget",
                 "lag_probe_ticks", "event_log", "prom_lag_series",
                 "shard_lanes", "region", "residency_budget_bytes",
                 "residency_headroom", "residency_cold_after",
                 "residency_spill_dir", "device")

    def __init__(self, *, tick_budget_ms: float = 0.0,
                 heartbeat_ticks: int = 30, suspect_grace_ticks: int = 30,
                 max_retries: int = 12, base_rto: int = 2, max_rto: int = 8,
                 recv_window: int = 256,
                 quarantine_capacity: int = DEFAULT_CAPACITY,
                 quarantine_global_capacity: int = 4 * DEFAULT_CAPACITY,
                 starvation_boost_ticks: int = 8, tick_ring: int = 4096,
                 default_budget: TenantBudget = None,
                 lag_probe_ticks: int = 1, event_log: int = 256,
                 prom_lag_series: int = 64, shard_lanes: int = 0,
                 region: str = None, residency_budget_bytes: int = 0,
                 residency_headroom: float = 0.85,
                 residency_cold_after: int = 64,
                 residency_spill_dir: str = None, device=None):
        self.tick_budget_ms = tick_budget_ms
        self.heartbeat_ticks = heartbeat_ticks
        self.suspect_grace_ticks = suspect_grace_ticks
        self.max_retries = max_retries
        self.base_rto = base_rto
        self.max_rto = max_rto
        self.recv_window = recv_window
        self.quarantine_capacity = quarantine_capacity
        self.quarantine_global_capacity = quarantine_global_capacity
        self.starvation_boost_ticks = starvation_boost_ticks
        self.tick_ring = tick_ring
        self.default_budget = default_budget or TenantBudget()
        self.lag_probe_ticks = lag_probe_ticks
        self.event_log = event_log
        self.prom_lag_series = prom_lag_series
        self.shard_lanes = shard_lanes
        #: federation (INTERNALS §20): the region name this service
        #: instance serves, or None for a single-region deployment.
        #: Region-qualifies the rooms' lineage replica-site labels
        #: (``svc:<region>/<room>``), so a change's hop chain names
        #: WHICH region's replica made it visible.
        self.region = region
        self.residency_budget_bytes = int(residency_budget_bytes)
        self.residency_headroom = float(residency_headroom)
        self.residency_cold_after = int(residency_cold_after)
        self.residency_spill_dir = residency_spill_dir
        self.device = device


def approx_msg_bytes(msg) -> int:
    """Cheap JSON-ish size estimate for budget accounting (recursive, no
    encode): close enough to wire bytes to meter tenants fairly, and two
    orders of magnitude cheaper than re-serializing every message. A
    binary wire frame's size is EXACT — its encoded length is the wire
    form. ONE implementation, shared with the channel's
    bytes_sent/bytes_resent accounting (resilience/channel.py
    ``payload_wire_bytes``) so the service's tenant metering and the
    bench's dict-vs-binary byte comparison can never drift apart."""
    from ..resilience.channel import payload_wire_bytes
    return payload_wire_bytes(msg)
