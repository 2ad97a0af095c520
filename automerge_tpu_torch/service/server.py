"""Multi-tenant sync service front end (INTERNALS §13): the port of the
JAX package's ``service/server.py``.

``SyncService`` turns the in-process sync stack — ``SyncHub`` fan-out,
``ResilientChannel`` transport reliability, the validated + quarantined
``InboundGate`` — into a serving tier that multiplexes thousands of tenant
sessions, where every resource is explicitly bounded and every failure mode
has a typed, observable, per-tenant degradation path.

Architecture decisions (the why, not just the what):

- **Rooms shard the hub.** One global ``SyncHub`` over N thousand peers is
  architecturally impossible: its ``ClockMatrix`` is DENSE over
  (peers x docs x actors), so 1000 peers x 250 docs x 1000 actors is
  terabytes. A *room* (one doc group) carries its own DocSet + hub +
  inbound gate, bounding each matrix to the room's members and making
  tenant eviction a room-local operation. Cross-room tenants are just
  multiple sessions.
- **Backpressure lives on the ack path.** A tenant's channel frames are
  admitted against inbox credit (``TenantBudget.inbox_cap``); beyond it
  they drop UN-acked, so the sender's own retransmit backoff throttles it.
  The server never queues unboundedly on behalf of a peer — over-budget
  tenants slow down; nobody else notices.
- **One tick, one flush, one decode.** Admission across tenants batches
  per (room, doc): all changes admitted this tick deliver through the
  gate as ONE batch (a single backend apply, which is a single columnar
  wire decode on the >=64-op engine path), and every room hub runs the
  tick inside ``hub.batched()`` so N deliveries + clock reveals cost one
  vectorized flush per room — the host planner amortized across tenants.
- **Degradation ladder** (each rung typed + counted + obs-evented, and
  strictly per-tenant): budget deferral (``svc/defer``) -> deadline shed
  of the lowest-priority tail (``svc/shed``) -> credit exhaustion
  (``chan/backpressure``) -> quarantine pressure eviction
  (``quar/evict_pressure``) -> peer-death declaration and full state
  reclamation (``svc/evict``: hub peer + ClockMatrix slot + quarantined
  changes attributed to the tenant).
- **Peer health is a state machine**, not a timeout scattered across call
  sites: LIVE -> SUSPECT (owed acks + silence) -> DEAD (grace expired),
  with the channel's retransmit cap (``PeerDeadError`` path) as the
  backstop that can jump straight to DEAD. Rejoins are first-class: a
  dead tenant reconnects fresh and bootstraps from the hub's cached
  snapshot bundle — one encode serves a whole join storm.
- **Rooms live on one device.** ``ServiceConfig.device`` (None: the
  CUDA card) binds every room's DocSet, and a room on a shard lane
  binds the lane's device; a lane's grouped deliveries run on its
  stream (``ShardLane.device_ctx``), joined both ways with the tick's
  stream, so the hub's flush after the deliveries reads committed
  documents without a host synchronize.
"""

from __future__ import annotations

import math
import time
from collections import deque
from contextlib import ExitStack, nullcontext

from .. import obs
from ..obs import lineage
from ..obs.telemetry import Telemetry
from ..resilience.channel import ResilientChannel
from ..resilience.errors import ProtocolError
from ..resilience.inbound import InboundGate
from ..resilience.validation import validate_msg
from ..backend.device import backend_for
from ..engine.base import resolve_device
from ..sync.doc_set import DocSet
from ..sync.hub import SyncHub
from .budget import ServiceConfig, TenantBudget, approx_msg_bytes

LIVE, SUSPECT, DEAD = "live", "suspect", "dead"


class Room:
    """One doc group's serving shard: DocSet + hub + bounded gate.

    With sharding on (``ServiceConfig.shard_lanes``), ``lane`` is the
    device execution lane the placement table assigned this room: every
    grouped gate delivery — the backend applies that mutate the room's
    document state — runs under the lane's device context, so the
    room's engine tables live on the lane's device (its stream, on a
    card). Causal metadata (hub, ClockMatrix, quarantine) is already
    room-local, hence shard-local — scale-out never grows a global
    clock (Okapi). Without a lane the room's documents live on
    ``config.device`` (None: the card; raises here without one)."""

    __slots__ = ("room_id", "doc_set", "hub", "gate", "tenants", "lane")

    def __init__(self, room_id: str, config: ServiceConfig, lane=None):
        self.room_id = room_id
        self.lane = lane
        device = (lane.device if lane is not None
                  else resolve_device(config.device))
        self.doc_set = DocSet(backend=backend_for(device))
        # the room's lineage replica-site label: commit hops recorded by
        # this room's gate carry it, so a change's chain names WHICH
        # server replica made it visible (INTERNALS §18.1); a federated
        # service region-qualifies it (§20.4) so chains spanning regions
        # name which REGION's replica, too
        self.doc_set._lineage_site = (
            f"svc:{config.region}/{room_id}" if config.region
            else f"svc:{room_id}")
        self.gate = InboundGate(
            self.doc_set, capacity=config.quarantine_capacity,
            global_capacity=config.quarantine_global_capacity)
        self.doc_set._inbound_gate = self.gate   # the one shared gate
        self.hub = SyncHub(self.doc_set)
        self.doc_set._sync_hub = self.hub        # Connection-compat cache
        self.hub.open()
        self.tenants: set = set()


class TenantSession:
    """One tenant's server-side endpoint: channel + inbox + health."""

    __slots__ = ("tenant_id", "room_id", "budget", "channel", "inbox",
                 "inbox_bytes", "last_inbound_tick", "state", "suspect_at",
                 "starved_streak", "pending_dead", "stats", "_svc",
                 "lag_ops", "lag_wire_ops", "lag_since_tick")

    def __init__(self, svc: "SyncService", tenant_id: str, room_id: str,
                 budget: TenantBudget):
        self._svc = svc
        self.tenant_id = tenant_id
        self.room_id = room_id
        self.budget = budget
        self.channel = None            # installed by SyncService.connect
        self.inbox: deque = deque()    # (msg, nbytes, nops)
        self.inbox_bytes = 0
        self.last_inbound_tick = svc._tick_no
        self.state = LIVE
        self.suspect_at = 0
        self.starved_streak = 0
        self.pending_dead = None       # reason string once doomed
        self.lag_ops = 0               # last probed replication lag
        self.lag_wire_ops = 0          # ... of which un-acked on the wire
        self.lag_since_tick = 0        # first tick of the current lag run
        self.stats = {"admitted_msgs": 0, "admitted_ops": 0,
                      "admitted_bytes": 0, "shed": 0, "deferred": 0,
                      "protocol_errors": 0, "last_admit_tick": 0}

    # the transport-facing inbound entry point for this tenant
    def on_wire(self, env):
        # ANY frame — even a bare ack, even one the credit gate then
        # rejects — proves the peer is alive
        self.last_inbound_tick = self._svc._tick_no
        if self.state == SUSPECT:
            self.state = LIVE
            self._svc._note("recover", tenant=self.tenant_id)
            if obs.ENABLED:
                obs.event("svc", "recover", args={"tenant": self.tenant_id})
        try:
            self.channel.on_wire(env)
            rb = len(self.channel._recv_buf)
            if rb > self._svc.stats["peak_recv_buf"]:
                self._svc.stats["peak_recv_buf"] = rb
        except ProtocolError as exc:
            # per-tenant typed degradation: one malformed message (or a
            # poison change batch the gate rejected) is counted against
            # ITS sender and dropped; it never tears down the session,
            # the tick, or another tenant
            self.stats["protocol_errors"] += 1
            self._svc.stats["protocol_errors"] += 1
            self._svc._note("protocol_error", tenant=self.tenant_id,
                            error=str(exc)[:120])
            if obs.ENABLED:
                obs.event("svc", "protocol_error",
                          args={"tenant": self.tenant_id,
                                "error": str(exc)[:120]})

    def _admit_frame(self, env) -> bool:
        """The channel's credit gate: inbox slots are the credit."""
        if self.pending_dead or self.state == DEAD:
            return False
        return len(self.inbox) < self.budget.inbox_cap

    def _enqueue(self, payload):
        """Channel deliver callback: validate at the service boundary,
        meter, and queue for the tick scheduler. Binary frames meter by
        their column lengths and exact encoded size — no op walk."""
        msg = validate_msg(payload)
        changes = msg.get("changes")
        nops = sum(len(c.get("ops") or []) for c in changes) if changes \
            else 0
        wire = msg.get("wire")
        if wire is not None:
            from ..engine.wire_format import as_frame
            nops += as_frame(wire).n_ops
        nbytes = approx_msg_bytes(msg)
        self.inbox.append((msg, nbytes, max(1, nops)))
        self.inbox_bytes += nbytes
        svc_stats = self._svc.stats
        if len(self.inbox) > svc_stats["peak_inbox"]:
            svc_stats["peak_inbox"] = len(self.inbox)


class SyncService:
    def __init__(self, config: ServiceConfig = None):
        self.config = config or ServiceConfig()
        self._rooms: dict = {}          # room_id -> Room
        self._tenants: dict = {}        # tenant_id -> TenantSession
        self._order: list = []          # admission rotation (tenant ids)
        self._tick_no = 0
        # bounded tick-duration window: percentiles in metrics() are
        # computed over at most `tick_ring` recent ticks, never a
        # process-lifetime list (the bounded-everything contract)
        self._tick_ms = deque(maxlen=self.config.tick_ring)
        #: always-on rolling telemetry (independent of obs tracing):
        #: tick-duration histogram + admission/degradation counter
        #: series + lag gauges — what the scrape endpoint exports
        self.telemetry = Telemetry()
        # sharded serving (INTERNALS §15.4): rooms map onto device
        # execution lanes through the deterministic placement table;
        # lanes also feed the per-shard admitted-ops window series
        # (the rebalance-policy signal) into the telemetry store
        self._shard_placement = None
        self._shard_lanes = []
        if self.config.shard_lanes:
            from ..shard import PlacementTable, ShardLane
            devices = self._devices()
            n = (len(devices) if self.config.shard_lanes < 0
                 else self.config.shard_lanes)
            self._shard_placement = PlacementTable(n)
            self._shard_lanes = [
                ShardLane(i, devices[i % len(devices)],
                          telemetry=self.telemetry, assert_budget=False)
                for i in range(n)]
        # the device-residency tier (INTERNALS §22): a non-zero budget
        # turns on the bulk doc mesh — a ShardedDocSet over the SAME
        # shard lanes (or one service-local lane) with a residency
        # manager enforcing the byte budget: mesh_deliver feeds the
        # paging gate, tick() is the pager heartbeat
        self._doc_mesh = None
        self._residency = None
        self._mesh_backlog: list = []
        if self.config.residency_budget_bytes:
            from ..shard.set import ShardedDocSet
            if self._shard_lanes:
                self._doc_mesh = ShardedDocSet(
                    telemetry=self.telemetry, lanes=self._shard_lanes)
            else:
                self._doc_mesh = ShardedDocSet(
                    n_shards=1, devices=self._devices(),
                    telemetry=self.telemetry, assert_budget=False)
            self._residency = self._doc_mesh.attach_residency(
                budget_bytes=self.config.residency_budget_bytes,
                headroom=self.config.residency_headroom,
                cold_after=self.config.residency_cold_after,
                spill_dir=self.config.residency_spill_dir)
        # black-box degradation-event ring for describe(): the
        # postmortem must work with tracing OFF, so the service keeps
        # its own bounded copy of the ladder events it obs-emits
        self._events = deque(maxlen=self.config.event_log)
        #: federation attachment (INTERNALS §20): a FederatedRegion
        #: installs itself here so scrape()/describe() export the
        #: cross-region link states, lag-token gauges, and ladder
        #: transition counters alongside the service families
        self._federation = None
        #: parallel tick executor (INTERNALS §24): lazily created when
        #: tick pipelining is on and the bulk doc mesh does not already
        #: carry a worker pool over the same lanes
        self._tick_executor = None
        self.stats = {"ticks": 0, "admitted_msgs": 0, "admitted_ops": 0,
                      "admitted_bytes": 0, "deferrals": 0, "shed_total": 0,
                      "evictions": 0, "joins": 0, "rejoins": 0,
                      "protocol_errors": 0, "max_starved_streak": 0,
                      "peak_inbox": 0, "peak_parked": 0, "peak_recv_buf": 0,
                      "peak_lag_ops": 0, "peak_lag_ticks": 0,
                      "backpressured_closed": 0, "retransmits_closed": 0}

    def _devices(self) -> list:
        """The lanes' devices: ``[config.device]``, or every card when
        it is None (raising without one)."""
        if self.config.device is None:
            from ..shard.set import default_devices
            return default_devices()
        return [resolve_device(self.config.device)]

    def _note(self, kind: str, **args):
        """Append one degradation/lifecycle event to the bounded
        black-box ring (the describe() postmortem feed)."""
        self._events.append({"tick": self._tick_no, "event": kind, **args})

    # -- lifecycle ------------------------------------------------------

    def room(self, room_id: str) -> Room:
        r = self._rooms.get(room_id)
        if r is None:
            lane = None
            if self._shard_placement is not None:
                lane = self._shard_lanes[
                    self._shard_placement.shard_of(room_id)]
            r = self._rooms[room_id] = Room(room_id, self.config,
                                            lane=lane)
        return r

    def seed_doc(self, room_id: str, doc, doc_id: str = None):
        """Install an authoritative replica for a room's doc (doc_id
        defaults to the room id)."""
        self.room(room_id).doc_set.set_doc(doc_id or room_id, doc)

    def shard_map(self) -> dict:
        """Room -> lane assignment plus per-lane load (empty when the
        service runs unsharded): the serving tier's placement view."""
        if self._shard_placement is None:
            return {}
        lanes = {lane.index: {"device": str(lane.device), "rooms": [],
                              "admitted_ops": lane.stats["admitted_ops"]}
                 for lane in self._shard_lanes}
        for room_id, room in self._rooms.items():
            if room.lane is not None:
                lanes[room.lane.index]["rooms"].append(room_id)
        for row in lanes.values():
            row["rooms"].sort()
        return {"n_lanes": len(self._shard_lanes),
                "placement_epoch": self._shard_placement.epoch,
                "lanes": lanes}

    def connect(self, tenant_id: str, room_id: str, send_raw, *,
                budget: TenantBudget = None, seed: int = 0) -> TenantSession:
        """Attach a tenant session; returns it (feed inbound transport
        frames to ``session.on_wire``). A same-id reconnect evicts the
        stale session first — the REJOIN path: the fresh hub peer
        bootstraps from the cached snapshot bundle like any joiner."""
        rejoin = tenant_id in self._tenants
        if rejoin:
            self.evict(tenant_id, reason="rejoin")
        cfg = self.config
        room = self.room(room_id)
        sess = TenantSession(self, tenant_id, room_id,
                             budget or cfg.default_budget)
        sess.channel = ResilientChannel(
            send_raw, sess._enqueue, seed=seed,
            base_rto=cfg.base_rto, max_rto=cfg.max_rto,
            recv_window=cfg.recv_window, max_retries=cfg.max_retries,
            on_dead=lambda ch, s=sess: self._mark_dead(s, "retransmit_cap"),
            admit=sess._admit_frame, label=tenant_id)
        self._tenants[tenant_id] = sess
        self._order.append(tenant_id)
        room.tenants.add(tenant_id)
        room.hub.add_peer(tenant_id, sess.channel.send)
        self.stats["rejoins" if rejoin else "joins"] += 1
        self._note("rejoin" if rejoin else "join",
                   tenant=tenant_id, room=room_id)
        if obs.ENABLED:
            obs.event("svc", "rejoin" if rejoin else "join",
                      args={"tenant": tenant_id, "room": room_id})
        return sess

    def disconnect(self, tenant_id: str):
        """Graceful leave: same full reclamation as a death eviction."""
        self.evict(tenant_id, reason="disconnect")

    def _mark_dead(self, sess: TenantSession, reason: str):
        if sess.pending_dead is None:
            sess.pending_dead = reason

    def evict(self, tenant_id: str, reason: str):
        """Reclaim EVERYTHING the tenant pinned: hub peer, ClockMatrix
        slot (recycled), quarantined changes it delivered, its inbox and
        channel windows. After this, :meth:`reclaimed` is true."""
        sess = self._tenants.pop(tenant_id, None)
        if sess is None:
            return
        try:
            self._order.remove(tenant_id)
        except ValueError:
            pass
        room = self._rooms.get(sess.room_id)
        dropped = 0
        if room is not None:
            room.hub.remove_peer(tenant_id)      # releases the matrix slot
            dropped = room.gate.evict_sender(tenant_id)
            room.tenants.discard(tenant_id)
        self.stats["backpressured_closed"] += \
            sess.channel.stats["backpressured"]
        self.stats["retransmits_closed"] += sess.channel.stats["retransmits"]
        sess.inbox.clear()
        sess.inbox_bytes = 0
        sess.state = DEAD
        self.stats["evictions"] += 1
        self.telemetry.observe_count("svc", "evict")
        self._note("evict", tenant=tenant_id, reason=reason,
                   quarantine_dropped=dropped)
        if obs.ENABLED:
            obs.event("svc", "evict",
                      args={"tenant": tenant_id, "reason": reason,
                            "quarantine_dropped": dropped})

    # -- the tick scheduler ---------------------------------------------

    def tick(self):
        """One scheduler round: budgeted cross-tenant admission (grouped
        per doc), retransmission, peer-health escalation, evictions, and
        one deferred hub flush per room."""
        t0 = obs.now() if obs.ENABLED else 0
        t_start = time.perf_counter()
        self._tick_no += 1
        cfg = self.config
        ops0 = self.stats["admitted_ops"]
        msgs0 = self.stats["admitted_msgs"]
        defer0 = self.stats["deferrals"]
        deadline = (t_start + cfg.tick_budget_ms / 1e3) \
            if cfg.tick_budget_ms else None
        groups: dict = {}       # (room_id, doc_id) ->
        #                         [changes, senders, frames]
        shed = 0
        with ExitStack() as stack:
            # every room hub defers its flushes to ONE flush per room at
            # stack exit — the tick's cross-tenant amortization
            for room in list(self._rooms.values()):
                stack.enter_context(room.hub.batched())
            t_admit = obs.now() if obs.ENABLED else 0
            order = self._admission_order()
            for i, sess in enumerate(order):
                if sess.pending_dead:
                    continue
                backlog = len(sess.inbox)
                if i and deadline is not None \
                        and time.perf_counter() >= deadline:
                    # deadline pressure: the tail of the order — lowest
                    # priority, modulo the starvation boost — defers
                    # wholesale to the next tick (work postponed, never
                    # dropped: the inbox is bounded and credit-gated).
                    # The FIRST tenant of the rotation is exempt: even a
                    # pathologically small tick budget admits one tenant
                    # per tick, so rotation + the starvation boost still
                    # reach everyone — shed degrades, it never wedges
                    if backlog:
                        shed += backlog
                        sess.stats["shed"] += backlog
                        if lineage.ENABLED:
                            # head of the shed backlog only (bounded)
                            for a, s in lineage.payload_keys(
                                    sess.inbox[0][0]):
                                lineage.hop(a, s, "svc/shed",
                                            site=sess.tenant_id)
                        self._starve(sess)
                    continue
                admitted = self._admit_tenant(sess, groups)
                if admitted:
                    sess.starved_streak = 0
                    sess.stats["last_admit_tick"] = self._tick_no
                elif backlog:
                    self._starve(sess)
            if shed:
                self.stats["shed_total"] += shed
                self._note("shed", msgs=shed)
                if obs.ENABLED:
                    obs.event("svc", "shed",
                              args={"msgs": shed, "tick": self._tick_no},
                              n=shed)
            if t_admit:
                obs.span("svc", "admit", t_admit, args={
                    "tenants": len(order),
                    "frames": self.stats["admitted_msgs"] - msgs0})
            # grouped admission: ONE gate delivery (one backend apply /
            # columnar decode) per (room, doc) for the whole tick —
            # executed under the room's shard-lane device context when
            # the service is sharded, so every backend apply's device
            # work lands on the lane that owns the room; with tick
            # pipelining on (INTERNALS §24) the groups fan out to the
            # lane workers concurrently, still inside the deferred-
            # flush stack — the one-flush-per-room amortization is
            # preserved at the barrier
            t_deliver = obs.now() if obs.ENABLED else 0
            self._deliver_groups(groups)
            if t_deliver:
                obs.span("svc", "deliver", t_deliver,
                         args={"groups": len(groups)})
            # retransmission (may declare peers dead via on_dead)
            t_chan = obs.now() if obs.ENABLED else 0
            for sess in list(self._tenants.values()):
                if not sess.pending_dead:
                    sess.channel.tick()
            self._health_pass()
            for sess in [s for s in list(self._tenants.values())
                         if s.pending_dead]:
                self.evict(sess.tenant_id, sess.pending_dead)
            if t_chan:
                obs.span("svc", "chan", t_chan)
        self._track_bounds()
        if self._doc_mesh is not None:
            # the residency tier's tick-loop paging hooks: drain the
            # bulk-mesh backlog through the paging gate (deliver_round
            # pages stored docs in, reserves for new ones, evicts to
            # budget), then beat the pager clock so warm bundles age
            # toward the cold tier even across idle ticks
            backlog, self._mesh_backlog = self._mesh_backlog, []
            for deliveries in backlog:
                self._doc_mesh.deliver_round(deliveries)
            self._residency.tick()
        if cfg.lag_probe_ticks \
                and self._tick_no % cfg.lag_probe_ticks == 0:
            self.probe_lag()
        self.stats["ticks"] += 1
        dt_ms = (time.perf_counter() - t_start) * 1e3
        self._tick_ms.append(dt_ms)
        # the always-on rolling telemetry (works with tracing off):
        # tick-duration histogram + this tick's admission/degradation
        # deltas as counter series, scrape-exported (INTERNALS §14)
        tel = self.telemetry
        tel.observe_span("svc", "tick", int(dt_ms * 1e6))
        d_ops = self.stats["admitted_ops"] - ops0
        if d_ops:
            tel.observe_count("svc", "admitted_ops", d_ops)
        d_msgs = self.stats["admitted_msgs"] - msgs0
        if d_msgs:
            tel.observe_count("svc", "admitted_msgs", d_msgs)
        d_defer = self.stats["deferrals"] - defer0
        if d_defer:
            tel.observe_count("svc", "defer", d_defer)
        if shed:
            tel.observe_count("svc", "shed", shed)
        if obs.ENABLED:
            obs.span("svc", "tick", t0,
                     args={"tick": self._tick_no, "shed": shed,
                           "tenants": len(self._tenants)})

    # -- parallel tick execution (INTERNALS §24) ------------------------

    def _mesh_executor(self):
        """The per-lane worker pool for the tick fan-out, or None when
        tick pipelining is off / the service is unsharded. Shares the
        bulk doc mesh's executor when the mesh rides the service's own
        lanes (the sharded+residency wiring) — one pool, one set of
        persistent workers, whichever tier fans out first."""
        from ..shard.parallel import (LaneExecutor, lane_devices,
                                      tick_pipeline_enabled)
        # the flag counts distinct devices, not lanes: lanes that are
        # streams of one card tick sequentially unless
        # AMTPU_TICK_PIPELINE=1 (shard/parallel.py)
        if not self._shard_lanes or not tick_pipeline_enabled(
                lane_devices(self._shard_lanes)):
            return None
        if self._doc_mesh is not None \
                and self._doc_mesh.lanes \
                and self._doc_mesh.lanes[0] is self._shard_lanes[0]:
            ex = self._doc_mesh.executor()
            if ex is not None:
                return ex
        if self._tick_executor is None:
            self._tick_executor = LaneExecutor(self._shard_lanes,
                                               telemetry=self.telemetry)
        return self._tick_executor

    def close(self):
        """Retire the parallel workers (idempotent; an unsharded or
        sequential service is a no-op). The service stays usable — a
        later parallel tick recreates the pool."""
        if self._tick_executor is not None:
            self._tick_executor.close()
            self._tick_executor = None
        if self._doc_mesh is not None:
            self._doc_mesh.close()

    def _deliver_groups(self, groups: dict):
        """Dispatch the tick's per-(room, doc) groups. The parallel leg
        fans each touched lane's groups to that lane's worker (a room
        belongs to exactly ONE lane, so workers never share gate/hub/
        doc state) while the caller pre-decodes the NEXT tick's queued
        frames; service-global stats fold after the barrier. The
        sequential loop below is the parity comparator — identical
        gate calls in identical per-lane order."""
        ex = self._mesh_executor() if groups else None
        if ex is not None:
            by_lane: dict = {}
            rest = []
            for key, payload in groups.items():
                room = self._rooms.get(key[0])
                if room is None:
                    continue
                if room.lane is None:
                    rest.append((key, room, payload))
                else:
                    by_lane.setdefault(room.lane.index, []).append(
                        (key, room, payload))
            if len(by_lane) > 1:
                tasks = [ex.submit(idx, self._deliver_lane_groups, items)
                         for idx, items in sorted(by_lane.items())]
                ex.barrier(tasks, while_waiting=lambda:
                           self._overlap_host_work(ex, tasks))
                for task in tasks:
                    self._fold_deliveries(task.result)
                for key, room, payload in rest:
                    self._deliver_one_group(key, room, payload)
                return
        for key, payload in groups.items():
            room = self._rooms.get(key[0])
            if room is None:
                continue
            self._deliver_one_group(key, room, payload)

    def _deliver_one_group(self, key, room, payload):
        """One (room, doc) group through the gate — the sequential leg,
        kept verbatim from the pre-parallel tick."""
        (_room_id, doc_id) = key
        (changes, senders, frames) = payload
        lane = room.lane
        ops0 = room.gate.stats["applied_ops"]
        try:
            with (lane.device_ctx() if lane is not None
                  else nullcontext()):
                if frames:
                    # N tenants' binary frames for one doc:
                    # combined columnar delivery — still ONE
                    # backend apply, zero per-op Python on the
                    # admissible path (dict prefix, if any,
                    # applies first)
                    room.gate.deliver_wire(
                        doc_id, frames, changes=changes,
                        senders=senders, validated=True)
                else:
                    room.gate.deliver(doc_id, changes,
                                      validated=True,
                                      sender=senders)
        except ProtocolError as exc:
            # the gate already salvaged every valid change and
            # parked/dropped the poison with per-sender stats;
            # the service just counts the rejection
            self.stats["protocol_errors"] += 1
            self._note("reject", doc=doc_id, error=str(exc)[:120])
            if obs.ENABLED:
                obs.event("svc", "reject",
                          args={"doc": doc_id,
                                "error": str(exc)[:120]})
        if lane is not None:
            # the gate's applied-ops delta, NOT the delivered op
            # count: a premature change that parks costs this
            # lane nothing (it counts on the tick that drains
            # it), so the per-lane load series the rebalance
            # policy reads stays honest — measured even on the
            # salvage path, where valid changes still applied
            n_ops = room.gate.stats["applied_ops"] - ops0
            if n_ops:
                lane.stats["admitted_ops"] += n_ops
                self.telemetry.observe_count(
                    "shard", f"lane{lane.index}_admitted_ops",
                    n_ops)

    def _deliver_lane_groups(self, items) -> dict:
        """Worker-side: one lane's groups in tick order, same gate
        calls as `_deliver_one_group`. Only room-local state (gate,
        docs, hub buffers, quarantine) is touched on the worker; every
        service-global increment is RETURNED as a fold the caller
        applies after the barrier (the per-worker delta discipline —
        no lost updates on the shared stats dicts). The worker thread
        already runs inside the lane's device context."""
        fold = {"lane_ops": {}, "rejects": []}
        for (_room_id, doc_id), room, (changes, senders, frames) in items:
            ops0 = room.gate.stats["applied_ops"]
            try:
                if frames:
                    room.gate.deliver_wire(
                        doc_id, frames, changes=changes,
                        senders=senders, validated=True)
                else:
                    room.gate.deliver(doc_id, changes, validated=True,
                                      sender=senders)
            except ProtocolError as exc:
                fold["rejects"].append((doc_id, str(exc)[:120]))
            n_ops = room.gate.stats["applied_ops"] - ops0
            if n_ops:
                idx = room.lane.index
                fold["lane_ops"][idx] = \
                    fold["lane_ops"].get(idx, 0) + n_ops
        return fold

    def _fold_deliveries(self, fold: dict):
        """Apply one worker's returned deltas on the caller thread:
        rejection counters + notes, and the per-lane admitted-ops
        series the rebalance policy reads."""
        for doc_id, err in fold["rejects"]:
            self.stats["protocol_errors"] += 1
            self._note("reject", doc=doc_id, error=err)
            if obs.ENABLED:
                obs.event("svc", "reject",
                          args={"doc": doc_id, "error": err})
        for idx, n_ops in fold["lane_ops"].items():
            self._shard_lanes[idx].stats["admitted_ops"] += n_ops
            self.telemetry.observe_count(
                "shard", f"lane{idx}_admitted_ops", n_ops)

    def _overlap_host_work(self, ex, tasks):
        """The tick-pipelining seam: while tick t's grouped gate
        deliveries drain on the lane workers, run the tick's REMAINING
        pure-host decode work on the caller thread instead of after the
        barrier. Two sources, cheapest-first:

        - queued bulk-mesh rounds (``mesh_deliver`` backlog): their wire
          payloads pre-decode through the mesh's identity-guarded cache
          (`ShardedDocSet._predecode_round`, INTERNALS §24) — this tick
          drains the backlog right after the barrier, so every decoded
          batch is consumed within the tick;
        - inbox binary frames whose columnar decode hasn't been forced
          yet (in-process senders can hand over bare ``WireFrame``
          objects; boundary traffic arrives pre-validated and is
          skipped).

        Opportunistic and drain-bounded: checks the lane tasks between
        units of work, so it extends a tick by at most one decode."""
        from ..engine.wire_format import WireFrame
        n = 0
        if self._doc_mesh is not None:
            for deliveries in self._mesh_backlog:
                n += self._doc_mesh._predecode_round(deliveries)
                if all(t.done() for t in tasks):
                    break
        if not all(t.done() for t in tasks):
            pending = []
            for sess in self._tenants.values():
                for msg, _nb, _no in sess.inbox:
                    wire = msg.get("wire")
                    if isinstance(wire, WireFrame) \
                            and getattr(wire, "_batch", None) is None:
                        pending.append(wire)
            for wire in pending:
                try:
                    wire.batch()
                    n += 1
                except Exception:
                    pass    # poison frames reject on their normal path
                if all(t.done() for t in tasks):
                    break
        if n:
            ex.stats["rounds_overlapped"] += 1
            ex.stats["predecoded_batches"] += n
            self.telemetry.observe_count("svc", "predecoded_frames", n)

    def _starve(self, sess: TenantSession):
        sess.starved_streak += 1
        if sess.starved_streak > self.stats["max_starved_streak"]:
            self.stats["max_starved_streak"] = sess.starved_streak

    def _admission_order(self) -> list:
        """Rotated round-robin, highest priority first, starvation boost
        in front: rotation makes the deadline cut fall on a different
        tenant each tick within a priority class; the boost guarantees a
        backlogged tenant is visited early after `starvation_boost_ticks`
        dry ticks regardless of class."""
        n = len(self._order)
        if not n:
            return []
        off = self._tick_no % n
        rotated = [self._tenants[t] for t in
                   self._order[off:] + self._order[:off]
                   if t in self._tenants]
        boost_at = self.config.starvation_boost_ticks
        starved = [s for s in rotated if s.starved_streak >= boost_at]
        rest = [s for s in rotated if s.starved_streak < boost_at]
        rest.sort(key=lambda s: -s.budget.priority)   # stable within class
        return starved + rest

    def _admit_tenant(self, sess: TenantSession, groups: dict) -> int:
        b = sess.budget
        ops_left, bytes_left = b.ops_per_tick, b.bytes_per_tick
        admitted = 0
        while sess.inbox:
            msg, nbytes, nops = sess.inbox[0]
            if admitted and (nops > ops_left or nbytes > bytes_left):
                # budget exhausted: the remainder defers to later ticks.
                # (The FIRST message of a visit always admits, so an
                # oversized message costs one whole tick, never a wedge.)
                # Both counters count deferral EVENTS (one per tenant per
                # tick), not backlog sizes — a message waiting N ticks
                # must not inflate the stat N times over
                sess.stats["deferred"] += 1
                self.stats["deferrals"] += 1
                if lineage.ENABLED:
                    # the HEAD deferred message only (bounded: never an
                    # O(backlog) walk) — its sampled changes gain one
                    # svc/defer hop whose dwell ends at the eventual
                    # svc/admit, i.e. the full deferral wait
                    for a, s in lineage.payload_keys(msg):
                        lineage.hop(a, s, "svc/defer",
                                    site=sess.tenant_id)
                self._note("defer", tenant=sess.tenant_id,
                           backlog=len(sess.inbox))
                if obs.ENABLED:
                    obs.event("svc", "defer",
                              args={"tenant": sess.tenant_id,
                                    "backlog": len(sess.inbox)})
                break
            sess.inbox.popleft()
            sess.inbox_bytes -= nbytes
            self._admit_msg(sess, msg, groups)
            ops_left -= nops
            bytes_left -= nbytes
            admitted += 1
            sess.stats["admitted_msgs"] += 1
            sess.stats["admitted_ops"] += nops
            sess.stats["admitted_bytes"] += nbytes
            self.stats["admitted_msgs"] += 1
            self.stats["admitted_ops"] += nops
            self.stats["admitted_bytes"] += nbytes
        return admitted

    def _admit_msg(self, sess: TenantSession, msg: dict, groups: dict):
        room = self._rooms[sess.room_id]
        changes = msg.get("changes")
        wire = msg.get("wire")
        if lineage.ENABLED:
            # adopt the tenant's origin context before grouping (frames'
            # manifest context is adopted again at the gate — idempotent)
            if msg.get("trace"):
                lineage.adopt(msg["trace"])
            for a, s in lineage.payload_keys(msg):
                lineage.hop(a, s, "svc/admit", site=sess.tenant_id,
                            doc=msg.get("docId"))
        if (changes or wire is not None) and msg.get("checkpoint") is None \
                and not msg.get("noSnapshot"):
            # strip changes/frames for the cross-tenant per-doc group;
            # record the revealed clock NOW (ordering is free — flush
            # reads the post-apply doc state at tick end either way).
            # Binary frames stay ENCODED here: they group as opaque
            # (frame, tenant) pairs and decode exactly once at the
            # gate's wire fast lane
            if msg.get("clock") is not None:
                room.hub.note_clock(sess.tenant_id, msg["docId"],
                                    msg["clock"])
            changes_l, senders, frames = groups.setdefault(
                (sess.room_id, msg["docId"]), ([], [], []))
            if changes:
                changes_l.extend(changes)
                senders.extend([sess.tenant_id] * len(changes))
            if wire is not None:
                from ..engine.wire_format import as_frame
                frames.append((as_frame(wire), sess.tenant_id))
        else:
            # metadata (clock reveal / advertisement), or a snapshot-
            # bearing message — a checkpoint+tail bootstrap from a
            # tenant serving a doc the server requested must dispatch on
            # its checkpoint FIRST (hub._receive order; stripping the
            # tail for grouped admission would park every tail change as
            # premature, its deps living inside the discarded bundle).
            # Full hub semantics, flush deferred by the tick's batched()
            try:
                room.hub._receive(sess.tenant_id, msg, validated=True)
            except ProtocolError as exc:
                sess.stats["protocol_errors"] += 1
                self.stats["protocol_errors"] += 1
                self._note("protocol_error", tenant=sess.tenant_id,
                           error=str(exc)[:120])
                if obs.ENABLED:
                    obs.event("svc", "protocol_error",
                              args={"tenant": sess.tenant_id,
                                    "error": str(exc)[:120]})

    # -- peer health ----------------------------------------------------

    def _health_pass(self):
        cfg = self.config
        for sess in self._tenants.values():
            if sess.pending_dead:
                continue
            if sess.channel.dead:
                self._mark_dead(sess, "retransmit_cap")
                continue
            owed = sess.channel.in_flight > 0
            silent = self._tick_no - sess.last_inbound_tick
            if sess.state == LIVE:
                if owed and silent >= cfg.heartbeat_ticks:
                    sess.state = SUSPECT
                    sess.suspect_at = self._tick_no
                    self._note("suspect", tenant=sess.tenant_id,
                               silent_ticks=silent)
                    if obs.ENABLED:
                        obs.event("svc", "suspect",
                                  args={"tenant": sess.tenant_id,
                                        "silent_ticks": silent})
            elif sess.state == SUSPECT:
                if not owed or silent < cfg.heartbeat_ticks:
                    sess.state = LIVE   # acked up / spoke up: recovered
                elif self._tick_no - sess.suspect_at \
                        >= cfg.suspect_grace_ticks:
                    self._mark_dead(sess, "heartbeat_timeout")

    # -- replication-lag probes (INTERNALS §14.2) -----------------------

    def probe_lag(self):
        """Refresh every live tenant's replication lag: the room hub's
        ClockMatrix deficit (changes not yet extracted for the peer —
        one vectorized comparison per room) PLUS the un-acked wire
        component (change batches sitting in the tenant channel's send
        window: believed clocks advance optimistically at send time, so
        the matrix alone cannot see in-flight frames). Runs every
        ``lag_probe_ticks`` inside tick(); callable directly for a
        fresh table."""
        peak_ops = self.stats["peak_lag_ops"]
        peak_ticks = self.stats["peak_lag_ticks"]
        for room in self._rooms.values():
            if not room.tenants:
                continue
            table = room.hub.replication_lag()
            for tid in room.tenants:
                sess = self._tenants.get(tid)
                if sess is None or sess.pending_dead:
                    continue
                wire = 0
                for payload in sess.channel.pending_payloads():
                    if isinstance(payload, dict):
                        wire += len(payload.get("changes") or ())
                matrix = table.get(tid, {}).get("ops", 0)
                sess.lag_ops = matrix + wire
                sess.lag_wire_ops = wire
                if sess.lag_ops:
                    if not sess.lag_since_tick:
                        sess.lag_since_tick = self._tick_no
                    if sess.lag_ops > peak_ops:
                        peak_ops = sess.lag_ops
                    ticks = self._tick_no - sess.lag_since_tick + 1
                    if ticks > peak_ticks:
                        peak_ticks = ticks
                else:
                    sess.lag_since_tick = 0
        self.stats["peak_lag_ops"] = peak_ops
        self.stats["peak_lag_ticks"] = peak_ticks
        mx = max((s.lag_ops for s in self._tenants.values()), default=0)
        self.telemetry.set_gauge("replication_lag_ops_max", mx)

    def _lag_ticks(self, sess: TenantSession) -> int:
        return (self._tick_no - sess.lag_since_tick + 1
                if sess.lag_since_tick else 0)

    def replication_lag(self) -> dict:
        """The per-tenant lag table from the last probe:
        {tenant: {"room", "ops", "wire_ops", "ticks"}} — `ops` is the
        total change deficit (matrix + wire), `ticks` how many ticks
        the tenant has been continuously behind."""
        return {tid: {"room": s.room_id, "ops": s.lag_ops,
                      "wire_ops": s.lag_wire_ops,
                      "ticks": self._lag_ticks(s)}
                for tid, s in list(self._tenants.items())}

    # -- introspection --------------------------------------------------

    def _track_bounds(self):
        # inbox / recv-buf peaks are exact (tracked at enqueue); the
        # per-room quarantine peak is the gate's own exact counter
        s = self.stats
        for room in self._rooms.values():
            if room.gate.stats["peak_parked"] > s["peak_parked"]:
                s["peak_parked"] = room.gate.stats["peak_parked"]

    @property
    def tenants(self) -> dict:
        return dict(self._tenants)

    def session(self, tenant_id: str):
        return self._tenants.get(tenant_id)

    def idle(self) -> bool:
        """No queued admission work and no channel in flight anywhere."""
        return all(not s.inbox and s.channel.idle
                   for s in self._tenants.values())

    def metrics(self, lag: dict | None = None) -> dict:
        ring = sorted(self._tick_ms)
        # nearest-rank percentiles (ceil(p*n)-1): the p-th percentile is
        # the smallest value covering at least p of the samples —
        # int(p*n) overshot by one rank at exact multiples (p50 of 100
        # ticks read the 51st value)
        pct = (lambda p: round(
            ring[max(0, math.ceil(p * len(ring)) - 1)], 3)) \
            if ring else (lambda p: 0.0)
        sessions = list(self._tenants.values())
        bp = self.stats["backpressured_closed"] + sum(
            s.channel.stats["backpressured"] for s in sessions)
        rt = self.stats["retransmits_closed"] + sum(
            s.channel.stats["retransmits"] for s in sessions)
        if lag is None:
            lag = self.replication_lag()
        return {**{k: v for k, v in self.stats.items()
                   if not k.endswith("_closed")},
                "live_tenants": len(sessions),
                "rooms": len(self._rooms),
                "shard_lanes": len(self._shard_lanes),
                "backpressured_total": bp, "retransmits_total": rt,
                "max_lag_ops": max((v["ops"] for v in lag.values()),
                                   default=0),
                "max_lag_ticks": max((v["ticks"] for v in lag.values()),
                                     default=0),
                "lagging_tenants": sum(1 for v in lag.values()
                                       if v["ops"] > 0),
                "p50_tick_ms": pct(0.50), "p99_tick_ms": pct(0.99),
                "max_tick_ms": round(ring[-1], 3) if ring else 0.0}

    # -- the bulk doc mesh (residency tier, INTERNALS §22) --------------

    @property
    def residency(self):
        """The residency manager, or None when the tier is off."""
        return self._residency

    @property
    def doc_mesh(self):
        """The bulk :class:`~..shard.set.ShardedDocSet`, or None."""
        return self._doc_mesh

    def mesh_deliver(self, deliveries: dict):
        """Enqueue one bulk-mesh serving round ``{doc_id: [changes]}``;
        the next :meth:`tick` drains it through the paging gate
        (demand page-ins, budget eviction, quarantine for premature
        changes). The tick-loop hook that lets sync traffic drive
        residency without a second scheduler."""
        if self._doc_mesh is None:
            raise RuntimeError(
                "residency tier is off: set residency_budget_bytes")
        self._mesh_backlog.append(dict(deliveries))
        return len(self._mesh_backlog)

    def reclaimed(self, tenant_id: str) -> bool:
        """True iff no service-side state remains for an evicted tenant:
        session, hub peer, ClockMatrix slot, quarantine attribution (the
        dead-peer reclamation contract the soak asserts). Checked
        entirely through the substrate's public introspection —
        `hub.peer_state` and `gate.quarantine_items` — the same surface
        `describe()` dumps."""
        if tenant_id in self._tenants:
            return False
        for room in list(self._rooms.values()):
            state = room.hub.peer_state(tenant_id)
            if state["present"] or state["matrix_slot"]:
                return False
            if any(sender == tenant_id
                   for *_, sender in room.gate.quarantine_items()):
                return False
        return True

    # -- the black-box surface (postmortem dump + Prometheus scrape) ----

    def describe(self) -> dict:
        """Black-box postmortem dump: one JSON-serializable snapshot of
        everything an operator needs to reconstruct a failure with
        tracing OFF — tenant health-ladder states with budget/credit
        occupancy, the replication-lag table, per-room quarantine
        state, aggregate metrics, and the last-N degradation events
        (bounded ring, ``ServiceConfig.event_log``). The soak writes
        this automatically when an acceptance assertion fails
        (INTERNALS §14.4)."""
        cfg = self.config
        tenants = {}
        for tid, s in list(self._tenants.items()):
            tenants[tid] = {
                "room": s.room_id, "state": s.state,
                "pending_dead": s.pending_dead,
                "starved_streak": s.starved_streak,
                "last_inbound_tick": s.last_inbound_tick,
                "inbox": len(s.inbox), "inbox_cap": s.budget.inbox_cap,
                "inbox_bytes": s.inbox_bytes,
                "in_flight": s.channel.in_flight,
                "recv_buffered": s.channel.buffered,
                "lag_ops": s.lag_ops, "lag_wire_ops": s.lag_wire_ops,
                "lag_ticks": self._lag_ticks(s),
                "priority": s.budget.priority,
                "stats": dict(s.stats),
                "channel": dict(s.channel.stats),
            }
        rooms = {}
        for rid, room in list(self._rooms.items()):
            rooms[rid] = {
                "tenants": sorted(room.tenants),
                "docs": sorted(room.doc_set.doc_ids),
                "quarantine": room.gate.quarantine_stats(),
                "parked": [list(item)
                           for item in room.gate.quarantine_items()[:64]],
            }
        lag_table = self.replication_lag()
        # the per-change lineage block (INTERNALS §18.4): the K
        # most-stuck sampled changes WITH their full hop chains — a
        # failed soak names the hop a change is stuck on, not just a
        # byte diff. Omitted entirely when lineage never ran.
        lin = lineage.postmortem(k=8) if lineage.ledger() is not None \
            else None
        from ..engine import learned_index
        return {
            "schema": "amtpu-postmortem-v1",
            "tick": self._tick_no,
            **({"lineage": lin} if lin is not None else {}),
            "config": {"tick_budget_ms": cfg.tick_budget_ms,
                       "heartbeat_ticks": cfg.heartbeat_ticks,
                       "suspect_grace_ticks": cfg.suspect_grace_ticks,
                       "max_retries": cfg.max_retries,
                       "recv_window": cfg.recv_window,
                       "starvation_boost_ticks":
                           cfg.starvation_boost_ticks,
                       "lag_probe_ticks": cfg.lag_probe_ticks},
            "metrics": self.metrics(lag_table),
            "lag": lag_table,
            "tenants": tenants,
            "rooms": rooms,
            "events": list(self._events),
            "tick_p99_ms_telemetry": self.tick_p99_ms_telemetry(),
            **({"shards": self.shard_map()} if self._shard_lanes else {}),
            **({"residency": self._residency.describe()}
               if self._residency is not None else {}),
            **({"federation": self._federation.describe()}
               if self._federation is not None else {}),
            # per-site learned-lookup stats + any site
            # currently demoted to its exact path (the drift signal an
            # operator acts on)
            "learned_index": learned_index.describe(),
        }

    def tick_p99_ms_telemetry(self) -> float:
        """Rolling-telemetry p99 bound on tick duration in ms (log-
        bucket conservative bound) — the one summary term the soak,
        the bench session row, and the postmortem dump all share."""
        return round(
            self.telemetry.quantile_ns("svc", "tick", 0.99) / 1e6, 3)

    def write_postmortem(self, path: str) -> str:
        """Serialize describe() to `path` (the failed-soak artifact)."""
        import json
        with open(path, "w") as fh:
            json.dump(self.describe(), fh, sort_keys=True, default=str)
        return path

    def scrape(self) -> str:
        """The Prometheus exposition page: service counters/gauges, the
        always-on tick/degradation telemetry (histogram + series), the
        worst-``prom_lag_series`` per-tenant lag gauges, and — when obs
        tracing is live — the span/event telemetry under the
        ``amtpu_obs_`` prefix. Best-effort point-in-time snapshot; never
        locks the tick loop."""
        from ..obs import prom
        lag_table = self.replication_lag()
        m = self.metrics(lag_table)
        counter_keys = ("ticks", "admitted_msgs", "admitted_ops",
                        "admitted_bytes", "deferrals", "shed_total",
                        "evictions", "joins", "rejoins",
                        "protocol_errors", "backpressured_total",
                        "retransmits_total")
        fams = [(f"amtpu_svc_{k[:-6] if k.endswith('_total') else k}"
                 "_total", "counter",
                 f"Service lifetime total of {k}.", [({}, m[k])])
                for k in counter_keys]
        gauge_keys = ("live_tenants", "rooms", "max_starved_streak",
                      "peak_inbox", "peak_parked", "peak_recv_buf",
                      "peak_lag_ops", "peak_lag_ticks", "max_lag_ops",
                      "max_lag_ticks", "lagging_tenants",
                      "p50_tick_ms", "p99_tick_ms", "max_tick_ms")
        fams += [(f"amtpu_svc_{k}", "gauge",
                  f"Current value of {k}.", [({}, m[k])])
                 for k in gauge_keys]
        lag = sorted(lag_table.items(), key=lambda kv: -kv[1]["ops"])
        lag = lag[: self.config.prom_lag_series]
        if lag:
            fams.append((
                "amtpu_svc_replication_lag_ops", "gauge",
                "Per-tenant replication lag in changes (matrix deficit "
                "+ un-acked wire frames), worst lagging first, series "
                "bounded by prom_lag_series.",
                [({"tenant": tid, "room": v["room"]}, v["ops"])
                 for tid, v in lag]))
            fams.append((
                "amtpu_svc_replication_lag_ticks", "gauge",
                "Ticks each exported tenant has been continuously "
                "behind.",
                [({"tenant": tid, "room": v["room"]}, v["ticks"])
                 for tid, v in lag]))
        fams += prom.telemetry_families(self.telemetry, "amtpu_svc")
        if self._federation is not None:
            # cross-region link/lag families (INTERNALS §20.5): link
            # ladder states, transition counters, per-(remote, room)
            # lag-token gauges, buffered/shipped/received totals
            fams += self._federation.families("amtpu_region")
        if self._residency is not None:
            # residency-tier families (INTERNALS §22.4): per-tier doc/
            # byte gauges, paging event counters, budget + peak, hit
            # rate, page-in dwell p99
            fams += self._residency.families("amtpu_residency")
        mesh_ex = (self._doc_mesh._executor
                   if self._doc_mesh is not None else None) \
            or self._tick_executor
        if mesh_ex is not None:
            # parallel-execution families (INTERNALS §24): live worker
            # count, per-lane round totals, rounds overlapped, barrier-
            # wait histogram
            fams += mesh_ex.families("amtpu_mesh")
        if lineage.ledger() is not None:
            # per-stage dwell histograms + end-to-end visibility
            # quantiles for the sampled change population (§18.3)
            fams += lineage.families("amtpu_lineage")
        if obs.ENABLED and obs.telemetry() is not None:
            fams += prom.telemetry_families(obs.telemetry(), "amtpu_obs")
        # device-truth families (INTERNALS §19): always-on like the
        # service telemetry — kernel compile/call counters, persistent-
        # cache outcomes, staged byte totals, per-doc/lane footprint
        from ..obs import device_truth
        fams += device_truth.families("amtpu_device")
        # learned-index families (INTERNALS §23): per-site model hits/
        # misses/refits/demotions, ε-window width, miss-rate gauge —
        # the exactness ledger of the learned lookup paths
        from ..engine import learned_index
        fams += learned_index.families("amtpu_index")
        return prom.expose(fams)

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1"):
        """Start the optional stdlib HTTP scrape endpoint (daemon
        thread): ``GET /metrics`` -> :meth:`scrape`, ``GET /describe``
        -> :meth:`describe` as JSON. Returns the
        :class:`~..obs.prom.ScrapeServer` (``.port``, ``.url``,
        ``.close()``); port 0 binds an ephemeral port."""
        from ..obs.prom import ScrapeServer
        return ScrapeServer(self.scrape, self.describe,
                            port=port, host=host)
