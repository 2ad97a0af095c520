"""The sharded serving tier: thousands of live docs partitioned across
lanes (INTERNALS §15).

``ShardedDocSet`` is the top of the tier: a population of engine docs
partitioned over N ``ShardLane``s by a deterministic
:class:`~.placement.PlacementTable`, with one single-device stacked
commit program per touched lane per serving round and NO multi-device
program anywhere on the commit path — each lane's programs see one
device and one stream. Lanes are placed round-robin over the CUDA
devices: on one card, ``n_shards`` lanes are ``n_shards`` streams of it
(`shard/lane.py`). Without a card the set raises unless the caller
names the CPU (``devices=[torch.device("cpu")]``); it never falls back.

Causal admission lives at the ROUTER, not in the engine queues: a
delivery whose dependencies the target doc does not yet cover parks in a
bounded per-doc :class:`~..resilience.quarantine.QuarantineQueue`
(wire form) and is retried after every round that advances any clock.
Keeping the engine queues empty is what makes migration safe — a
checkpoint capture refuses a doc holding causally-unready queued
changes, and a router-held parked change trivially survives a move: the
drain resolves the owning lane at release time.

Hot-doc migration (the rebalance path, `shard/rebalance.py`) moves one
doc between lanes via a checkpoint bundle at a commit boundary:

1. the doc is marked MIGRATING — deliveries arriving for it park in a
   dedicated migration pen (never half-applied on either lane);
2. the source lane captures + releases the doc (``lane.export``: the
   integrity-hashed columnar bundle);
3. the destination lane restores it (``lane.adopt``: tables staged onto
   the destination lane's device, on its stream);
4. the placement table records the move (the commit point), and the pen
   replays through the normal delivery gate — premature changes go back
   to quarantine, ready ones apply on the new owner.

Okapi's replication-group discipline (PAPERS.md) is why scale-out stays
cheap: causal metadata (clocks, dep closures, sync hubs) is per-doc /
per-room — shard-LOCAL — so adding lanes never grows a global clock.
"""

from __future__ import annotations

import torch

from .. import obs
from ..obs import lineage
from ..obs.telemetry import Telemetry
from ..resilience.inbound import _ready_under
from ..resilience.quarantine import QuarantineQueue
from .lane import ShardLane
from .placement import PlacementTable


def default_devices():
    """The CUDA devices, one entry each; raises without a card (pass
    ``devices=[torch.device("cpu")]`` to run the tier on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "automerge_tpu_torch: no CUDA device is available; pass "
            "devices=[torch.device('cpu')] to run the shard tier on the "
            "CPU")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class ShardedDocSet:
    """A live-doc population served by N shard lanes over the mesh."""

    def __init__(self, n_shards: int = None, devices=None,
                 doc_kind: str = "text", capacity: int = 1024,
                 quarantine_capacity: int = 1024, telemetry=None,
                 assert_budget: bool = True, lanes=None):
        if lanes is not None:
            # adopt pre-built lanes (the service shares its tick-loop
            # lanes with the bulk doc mesh this way) — they already
            # carry a telemetry sink and device bindings
            self.telemetry = telemetry if telemetry is not None \
                else lanes[0].telemetry
            self.lanes = list(lanes)
            self.placement = PlacementTable(len(self.lanes))
        else:
            if devices is None:
                devices = default_devices()
            if n_shards is None:
                n_shards = len(devices)
            #: always-on rolling telemetry: per-lane admitted-ops windows
            #: (the rebalance policy's input) + migration counters
            self.telemetry = telemetry if telemetry is not None \
                else Telemetry()
            self.placement = PlacementTable(n_shards)
            self.lanes = [ShardLane(i, devices[i % len(devices)],
                                    telemetry=self.telemetry,
                                    assert_budget=assert_budget,
                                    doc_kind=doc_kind, capacity=capacity)
                          for i in range(n_shards)]
        self.doc_kind = doc_kind
        self.capacity = capacity
        self._quarantine: dict = {}     # doc_id -> QuarantineQueue
        self._quarantine_cap = quarantine_capacity
        self._migrating: dict = {}      # doc_id -> [parked deliveries]
        self.rebalancer = None          # attach_rebalancer installs one
        self.residency = None           # attach_residency installs one
        self._executor = None           # lazy LaneExecutor (parallel.py)
        self._predecoded: dict = {}     # doc_id -> (src changes, batch)
        self.stats = {"rounds": 0, "admitted_ops": 0, "parked": 0,
                      "released": 0, "migrations": 0,
                      "migrations_deferred": 0, "migration_parked": 0,
                      "peak_parked": 0}

    # -- parallel execution (INTERNALS §24) -----------------------------

    def executor(self):
        """The per-lane worker pool when parallel mesh execution is on
        (``AMTPU_PARALLEL_LANES`` — read per call so tests flip the
        flag mid-process), else None. Workers are persistent: created
        on first parallel round, reused until :meth:`close`."""
        from .parallel import (LaneExecutor, lane_devices,
                               parallel_lanes_enabled)
        if not parallel_lanes_enabled(lane_devices(self.lanes)):
            return None
        if self._executor is None:
            self._executor = LaneExecutor(self.lanes,
                                          telemetry=self.telemetry)
        return self._executor

    def close(self):
        """Retire the worker pool (idempotent; a mesh without one is a
        no-op). Safe at any commit boundary — pending lane tasks drain
        before the workers exit."""
        if self._executor is not None:
            self._executor.close()
            self._executor = None

    # -- introspection --------------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self.lanes)

    def lane_of(self, doc_id: str) -> ShardLane:
        return self.lanes[self.placement.shard_of(doc_id)]

    def doc(self, doc_id: str):
        return self.lane_of(doc_id).docs.get(doc_id)

    def doc_ids(self) -> list:
        return sorted(d for lane in self.lanes for d in lane.docs)

    def quarantined(self, doc_id: str) -> int:
        q = self._quarantine.get(doc_id)
        return len(q) if q is not None else 0

    def describe(self) -> dict:
        """The tier's black-box snapshot: explicit placement entries,
        per-lane population/stats, quarantine occupancy."""
        return {
            "schema": "amtpu-shardmap-v1",
            "n_shards": self.n_shards,
            "devices": [str(lane.device) for lane in self.lanes],
            "placement_epoch": self.placement.epoch,
            "placement_overrides": self.placement.table(),
            "lanes": [{"index": lane.index, "device": str(lane.device),
                       "docs": sorted(lane.docs), "stats": dict(lane.stats)}
                      for lane in self.lanes],
            "quarantine": {d: len(q) for d, q in self._quarantine.items()
                           if len(q)},
            "migrating": sorted(self._migrating),
            "stats": dict(self.stats),
            **({"mesh_exec": self._executor.describe()}
               if self._executor is not None else {}),
            **({"residency": self.residency.describe()}
               if self.residency is not None else {}),
        }

    # -- the delivery gate ----------------------------------------------

    @staticmethod
    def _split_ready(changes, clock: dict):
        """Partition one delivery into (ready, premature) under `clock`,
        admitting in-delivery causal chains in any arrival order (the
        engine's scheduler handles the rounds; the router only refuses
        changes whose deps NOTHING in hand can satisfy). The serving
        hot path — one causally-ready change per doc per round — short-
        circuits before the fixpoint loop's clock copy."""
        if len(changes) == 1 and _ready_under(changes[0], clock):
            return list(changes), []
        ready, rest = [], list(changes)
        clock = dict(clock)
        progress = True
        while progress and rest:
            progress = False
            nxt = []
            for ch in rest:
                if _ready_under(ch, clock):
                    ready.append(ch)
                    if ch["seq"] > clock.get(ch["actor"], 0):
                        clock[ch["actor"]] = ch["seq"]
                    progress = True
                else:
                    nxt.append(ch)
            rest = nxt
        return ready, rest

    def _park(self, doc_id: str, changes, protect=()):
        q = self._quarantine.get(doc_id)
        if q is None:
            q = self._quarantine[doc_id] = QuarantineQueue(
                self._quarantine_cap)
        for ch in changes:
            q.park(ch)
            self.stats["parked"] += 1
            if lineage.ENABLED:
                lineage.hop(ch["actor"], ch["seq"], "quar/park",
                            site="router", doc=doc_id)
        total = sum(len(q) for q in self._quarantine.values())
        if total > self.stats["peak_parked"]:
            self.stats["peak_parked"] = total
        if self.residency is not None:
            # admission-aware prefetch: a park means this doc's missing
            # dependencies are in flight — a demoted doc starts staging
            # back before the release needs it (without evicting docs
            # the caller routed but has not yet ingested)
            self.residency.hint_park(doc_id, changes, protect=protect)

    def deliver(self, doc_id: str, changes) -> int:
        """Single-doc convenience wrapper over :meth:`deliver_round`."""
        return self.deliver_round({doc_id: changes})

    def deliver_rounds(self, rounds) -> int:
        """Serve a queued sequence of rounds with the lane-level round
        pipelining seam (INTERNALS §24): while the lane workers execute
        round t's device leg, the caller pre-decodes round t+1's wire
        payloads into columnar batches — the state-independent half of
        host planning (``_decode_wire`` reads only the payload and the
        doc's id, and is pure host work — numpy and the native codec, no
        staging, no tensor, no stream — so it may run while the doc's
        lane works on the card), extending the `PipelinedIngestor`
        chaining discipline from per-doc to per-lane. Admission (the state-
        dependent half) still runs in round order on the caller thread,
        and a batch only substitutes for its source list when the round
        admits it whole and in order — byte-identical to the sequential
        path by construction. With parallel execution off this is a
        plain :meth:`deliver_round` loop."""
        rounds = list(rounds)
        total = 0
        try:
            for i, chunk in enumerate(rounds):
                nxt = rounds[i + 1] if i + 1 < len(rounds) else None
                total += self.deliver_round(
                    chunk, _next_round=nxt if nxt else None)
        finally:
            # anything pre-decoded but never routed (an aborted run, a
            # doc that migrated away) must not outlive the sequence
            self._predecoded.clear()
        return total

    def _predecode_round(self, deliveries: dict) -> int:
        """Decode the next round's wire payloads (pure host: columnar
        batch build, cached per delivery list) — the work the executor
        overlaps with the in-flight round. Only docs that are already
        materialized and unambiguous (not migrating, not demoted to the
        store) pre-decode; everything else decodes in-round exactly as
        before."""
        n = 0
        for doc_id, changes in deliveries.items():
            if doc_id in self._predecoded or doc_id in self._migrating:
                continue
            if not isinstance(changes, list) or not changes \
                    or not all(isinstance(c, dict) for c in changes):
                continue
            if self.residency is not None \
                    and doc_id in self.residency.store:
                continue
            doc = self.lane_of(doc_id).docs.get(doc_id)
            if doc is None:
                continue
            try:
                batch = doc._decode_wire(changes)
            except Exception:
                continue    # poison payloads fail in-round, as before
            self._predecoded[doc_id] = (changes, batch)
            n += 1
        return n

    def deliver_round(self, deliveries: dict, _next_round: dict = None) \
            -> int:
        """One serving round: route ``{doc_id: [wire changes]}`` across
        the lanes (ready changes grouped into ONE stacked apply per
        touched lane), park premature changes in the per-doc quarantine,
        pen deliveries for migrating docs, then drain every quarantine
        the round unblocked. Returns the admitted wire-op count. The end
        of the round is a commit boundary: the attached rebalancer (if
        any) runs its policy here. `_next_round` is
        :meth:`deliver_rounds`' pipelining seam — the following round's
        deliveries, pre-decoded while this round's lane work drains."""
        _t0 = obs.now() if obs.ENABLED else 0
        if self.residency is not None:
            # the demand-paging gate: stored docs this round touches
            # page in and the eviction pass makes room BEFORE any lane
            # ingest can roll the footprint gauge past the budget
            self.residency.before_round(deliveries)
        per_lane: dict = {}
        for doc_id, changes in deliveries.items():
            pre = self._predecoded.pop(doc_id, None) \
                if self._predecoded else None
            orig = changes
            changes = list(changes)
            if doc_id in self._migrating:
                # the migration pen: the doc has no owner this instant —
                # nothing may apply until the new shard owns it
                self._migrating[doc_id].append(changes)
                self.stats["migration_parked"] += len(changes)
                if lineage.ENABLED:
                    lineage.hop_delivery(changes, "quar/pen",
                                         site="router", doc=doc_id)
                continue
            if self.residency is not None \
                    and doc_id in self.residency.store:
                # the doc's live state IS its stored bundle (before_round
                # judged nothing ready against the stored frontier):
                # routing here would ensure_doc a FRESH empty doc and
                # replay history over it — park everything instead; the
                # park hint prefetches, and the drain releases against
                # the live clock once the doc is resident again
                self._park(doc_id, changes, protect=tuple(deliveries))
                continue
            lane = self.lane_of(doc_id)
            doc = lane.docs.get(doc_id)
            ready, premature = self._split_ready(
                changes, doc.clock if doc is not None else {})
            if premature:
                self._park(doc_id, premature, protect=tuple(deliveries))
                # a park prefetch hint may have paged the doc in with
                # budget-aware placement — re-resolve the owner
                lane = self.lane_of(doc_id)
            if ready:
                if (pre is not None and not premature
                        and pre[0] is orig and len(ready) == len(changes)
                        and all(a is b for a, b in zip(ready, changes))):
                    # the whole delivery admitted, in arrival order: the
                    # pre-decoded batch IS what apply_stacked would have
                    # decoded in-round (same decoder, same payload) —
                    # hand the lane the batch, skipping the in-round
                    # decode the overlap already paid for
                    ready = pre[1]
                per_lane.setdefault(lane.index, {})[doc_id] = ready
        admitted = self._ingest_per_lane(per_lane, _next_round)
        admitted += self._drain_quarantine()
        self.stats["rounds"] += 1
        self.stats["admitted_ops"] += admitted
        if obs.ENABLED:
            obs.span("shard", "round", _t0, args={
                "docs": len(deliveries), "admitted_ops": admitted})
        if self.residency is not None:
            self.residency.after_round(deliveries)
        if self.rebalancer is not None:
            self.rebalancer.maybe_rebalance()
        return admitted

    def _ingest_per_lane(self, per_lane: dict, next_round: dict = None) \
            -> int:
        """Fan one routed round out across its touched lanes. With
        parallel execution on (shard/parallel.py) every touched lane's
        worker runs its stacked ingest concurrently and the caller
        pre-decodes `next_round` while the device legs drain; the
        sequential loop below is kept verbatim as the parity
        comparator. Either way the return is the round's admitted
        wire-op count and the caller resumes at a full barrier."""
        if not per_lane:
            return 0
        ex = self.executor()
        if ex is not None:
            return self._ingest_parallel(ex, per_lane, next_round)
        admitted = 0
        for idx in sorted(per_lane):
            admitted += self.lanes[idx].ingest(per_lane[idx])
            if lineage.ENABLED:
                self._hop_committed(idx, per_lane[idx])
        return admitted

    def _ingest_parallel(self, ex, per_lane: dict,
                         next_round: dict = None) -> int:
        """The concurrent leg: one task per touched lane on its
        persistent worker, per-worker stats deltas folded at the round
        barrier (no lost updates), lineage commit hops emitted
        caller-thread after the barrier (deterministic order). A worker
        error (budget assert included) re-raises on the caller AFTER
        every lane quiesced — completed lanes' stats still fold, like
        the sequential loop's partial progress."""
        tasks = []
        for idx in sorted(per_lane):
            lane = self.lanes[idx]
            delta = lane.stats_delta()
            tasks.append((idx, delta, ex.submit(
                idx, lane.ingest, per_lane[idx], stats=delta)))
        overlap = None
        if next_round:
            def overlap():
                n = self._predecode_round(next_round)
                if n:
                    ex.stats["rounds_overlapped"] += 1
                    ex.stats["predecoded_batches"] += n
        try:
            ex.barrier([t for _, _, t in tasks], while_waiting=overlap)
        finally:
            for idx, delta, task in tasks:
                if task.error is None and task.done():
                    lane_stats = self.lanes[idx].stats
                    for k, v in delta.items():
                        if v:
                            lane_stats[k] += v
        admitted = 0
        for idx, delta, task in tasks:
            admitted += task.result
            if lineage.ENABLED:
                self._hop_committed(idx, per_lane[idx])
        return admitted

    def _drain_quarantine(self) -> int:
        """Retry every parked change against the live clocks until a
        fixpoint; released changes ride a normal lane ingest (grouped
        per lane per iteration)."""
        admitted = 0
        progress = True
        while progress:
            progress = False
            per_lane: dict = {}
            routed: list = []   # released docs awaiting ingest — a
            #                     later page-in must not evict them
            for doc_id, q in list(self._quarantine.items()):
                if not len(q) or doc_id in self._migrating:
                    continue
                stored = (self.residency is not None
                          and doc_id in self.residency.store)
                if stored:
                    # judge readiness against the STORED frontier (the
                    # bundle manifest's clock) — only a releasable
                    # change justifies paging the doc in; an all-
                    # premature quarantine leaves it demoted
                    clock = self.residency.stored_clock(doc_id) or {}
                else:
                    doc = self.lane_of(doc_id).docs.get(doc_id)
                    clock = doc.clock if doc is not None else {}
                parked = q.drain()
                ready, premature = self._split_ready(parked, clock)
                for ch in premature:
                    q.park(ch, requeue=True)
                if ready:
                    if stored:
                        # admission hint: the release is about to
                        # ingest — page in now (and resolve the lane
                        # AFTER, page-in placement is budget-aware)
                        self.residency.hint_release(
                            doc_id, protect=tuple(routed) + (doc_id,))
                    lane = self.lane_of(doc_id)
                    per_lane.setdefault(lane.index, {})[doc_id] = ready
                    routed.append(doc_id)
                    self.stats["released"] += len(ready)
                    if lineage.ENABLED:
                        lineage.hop_delivery(ready, "quar/release",
                                             site="router", doc=doc_id)
            if per_lane:
                # releases ride the same fan-out as the round proper
                # (parallel when enabled, the verbatim sequential loop
                # otherwise); each fixpoint iteration barriers before
                # re-judging clocks, so causal ordering is untouched
                admitted += self._ingest_per_lane(per_lane)
                progress = True
        return admitted

    def _hop_committed(self, lane_idx: int, deliveries: dict):
        """Visibility hops for a lane ingest: every sampled change the
        router just handed the lane is now committed on that lane's
        replica (one hop per change per lane site)."""
        site = f"lane{lane_idx}"
        for doc_id, changes in deliveries.items():
            lineage.hop_delivery(changes, "commit", site=site, doc=doc_id)

    # -- migration ------------------------------------------------------

    def attach_rebalancer(self, **kwargs):
        from .rebalance import Rebalancer
        self.rebalancer = Rebalancer(self, **kwargs)
        return self.rebalancer

    def attach_residency(self, **kwargs):
        """Install the device-residency tier (INTERNALS §22): demand
        paging, budget-driven eviction to host bundles, disk aging."""
        from ..residency import ResidencyManager
        self.residency = ResidencyManager(self, **kwargs)
        return self.residency

    def migrate(self, doc_id: str, dst_shard: int,
                _mid_migration=None) -> bool:
        """Move one doc to `dst_shard` via a checkpoint bundle at a
        commit boundary. Returns False (nothing moved) when the doc is
        already home, or when its engine still holds causally-unready
        queued work — migration DEFERS rather than strand a causal hole
        (the next boundary retries). ``_mid_migration`` is the test seam
        for the quarantine handshake: called while the doc has no owner,
        so injected deliveries must pen and replay."""
        src_shard = self.placement.shard_of(doc_id)
        if not 0 <= dst_shard < self.n_shards:
            raise ValueError(f"no shard {dst_shard}")
        if dst_shard == src_shard:
            return False
        src = self.lanes[src_shard]
        doc = src.docs.get(doc_id)
        if doc is None:
            # never materialized here: ownership is just a table entry
            self.placement.move(doc_id, dst_shard)
            return True
        if doc.queue:
            self.stats["migrations_deferred"] += 1
            return False
        _t0 = obs.now() if obs.ENABLED else 0
        self._migrating[doc_id] = []
        moved = False
        try:
            bundle = src.export(doc_id)
            try:
                if _mid_migration is not None:
                    _mid_migration()
                self.lanes[dst_shard].adopt(doc_id, bundle)
                self.placement.move(doc_id, dst_shard)
                moved = True
            except BaseException:
                # failure atomicity: a failed adopt must not lose the
                # doc — restore residency on the SOURCE lane from the
                # bundle already in hand (placement never moved, so
                # ownership and state stay consistent) and let the
                # penned deliveries replay against it below
                src.adopt(doc_id, bundle)
                src.stats["docs_in"] -= 1       # a rollback, not a move
                src.stats["docs_out"] -= 1
                raise
        finally:
            # whatever happened, the doc has an owner again: replay the
            # pen through the normal gate — ready changes apply there,
            # premature ones go (back) to quarantine
            penned = self._migrating.pop(doc_id, [])
            for changes in penned:
                self.deliver_round({doc_id: changes})
        self.stats["migrations"] += 1
        self.telemetry.observe_count("shard", "migrations")
        if obs.ENABLED:
            obs.span("shard", "migrate", _t0, args={
                "doc": doc_id, "src": src_shard, "dst": dst_shard,
                "bundle_bytes": len(bundle), "penned": len(penned)})
        return moved

    # -- reads ----------------------------------------------------------

    def texts(self) -> dict:
        out = {}
        for lane in self.lanes:
            out.update(lane.texts())
        return out

    def capture(self, doc_id: str) -> bytes:
        """The doc's integrity-hashed checkpoint bundle (byte-
        deterministic for a given state — the shard-count-invariance
        soak compares exactly these bytes across mesh sizes)."""
        from ..checkpoint import capture_engine
        if self.residency is not None:
            # a demoted doc's checkpoint IS its stored bundle — it was
            # produced by this same capture at demotion, byte-identical
            bundle = self.residency.stored_bundle(doc_id)
            if bundle is not None:
                return bundle
        lane = self.lane_of(doc_id)
        with lane.device_ctx():
            return capture_engine(lane.docs[doc_id])
