"""The device-residency manager: millions of docs on bounded HBM
(INTERNALS §22).

Device footprint is a first-class measured quantity (per-doc gauges of
the storage bytes a doc's tables hold on its device, per-lane
aggregates, a peak high-water mark, exact h2d/d2h byte meters —
obs/device_truth.py); this tier exploits it to make bounded-HBM serving
a structural invariant instead of an accident of population size. Three
tiers, one ladder:

- **hot**: device-resident in a :class:`~..shard.lane.ShardLane` —
  the only tier that serves commits;
- **warm**: demoted to a host-side AMTPUCKPT1 checkpoint bundle
  (`BundleStore`; the checkpoint codec is the spill format — promotion is
  pure h2d table staging through the existing `export`/`adopt` halves,
  NEVER replay);
- **cold**: warm bundles untouched for ``cold_after`` pager rounds age
  to one spill file each on disk.

Paging is demand-driven by sync traffic: `before_round` runs inside
`ShardedDocSet.deliver_round` BEFORE any lane ingest — stored docs the
round touches page in, brand-new docs reserve estimated bytes, and the
eviction pass makes room FIRST, so the footprint gauge's high-water
mark stays under the budget through the whole round (the reservation
discipline; the budget bar is absolute). Admission-aware
prefetch treats a router park as a paging hint: a premature change for
a demoted doc means its dependencies are in flight, so the doc starts
staging before the release needs it. Eviction reads the SAME telemetry
windows the rebalance policy reads, and victim choice is the learned
working-set model of `policy.py` (plain LRU kept as the comparator).

Nothing is ever lost: every doc is, at all times, exactly one of
resident / warm / cold (plus router-parked wire changes for docs in any
tier) — `accounting()` is the exact surface the eviction-under-pressure
test asserts over.
"""

from __future__ import annotations

import functools
import threading
import time

from ..obs import lineage
from .policy import ResidencyConfig, lane_pressure, make_model
from .store import BundleStore


def _locked(fn):
    """Serialize a tier-transition method on the manager's re-entrant
    lock. The round hooks themselves stay caller-thread-only under
    parallel mesh execution (barrier-ordered by `ShardedDocSet`), but
    the reservation-ledger banking inside `page_in`/`_make_room` must
    be atomic against ANY concurrent pager entry point (prefetch hints,
    promotion reads, the thundering-herd stress in
    tests/test_torch_lane_workers.py) — interleaved make-room/adopt pairs
    could both fit the budget alone and overshoot it together."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)
    return wrapper


class ResidencyManager:
    """Tiered doc residency over one :class:`~..shard.set.ShardedDocSet`."""

    def __init__(self, mesh, config: ResidencyConfig = None, **kwargs):
        self.mesh = mesh
        self.config = config if config is not None \
            else ResidencyConfig(**kwargs)
        self.telemetry = mesh.telemetry
        self.store = BundleStore(self.config.spill_dir)
        self.model = make_model(self.config.eviction)
        self._round = 0                 # the pager clock
        self._sizes: dict = {}          # doc_id -> measured device bytes
        self._store_round: dict = {}    # doc_id -> round it was demoted
        self._est_bytes = 0             # max per-doc bytes seen
        self._fresh_bytes = None        # measured fresh-doc allocation
        self._reserved = 0              # round-scoped reservation ledger
        self._in_round = False
        #: guards every tier transition + the reservation ledger (see
        #: `_locked`); re-entrant so page_in -> _make_room -> demote nests
        self._lock = threading.RLock()
        self.peak_resident_bytes = 0
        self.stats = {"page_ins": 0, "page_outs": 0, "prefetches": 0,
                      "hints": 0, "hits": 0, "misses": 0, "cold_ages": 0,
                      "cold_loads": 0, "evictions": 0,
                      "budget_overruns": 0, "placement_moves": 0}

    # -- measurement ----------------------------------------------------

    def resident_bytes(self) -> int:
        """Mesh-wide device-resident bytes (each doc's ``device_bytes``:
        the storages its tables hold plus its extras, host math — never a
        device sync), refreshing the per-doc size ledger."""
        total = 0
        for lane in self.mesh.lanes:
            for doc_id, doc in lane.docs.items():
                nbytes = doc.device_footprint()["device_bytes"]
                self._sizes[doc_id] = nbytes
                if nbytes > self._est_bytes:
                    self._est_bytes = nbytes
                total += nbytes
        if total > self.peak_resident_bytes:
            self.peak_resident_bytes = total
        return total

    def _fresh_doc_bytes(self) -> int:
        """The exact footprint ``ensure_doc`` will allocate for a
        brand-new doc (tables are slot-capacity-bucketed, so this is a
        constant of the mesh's doc kind + capacity) — measured ONCE
        from a throwaway probe doc, never guessed from the resident
        population (restored docs pack tighter than fresh allocations,
        so a population-derived estimate under-reserves)."""
        if self._fresh_bytes is None:
            from ..obs import device_truth
            from ..shard.lane import _DOC_KINDS
            lane = self.mesh.lanes[0]
            pid = "__residency_probe__"
            if lane.doc_kind == "text":
                ops = [{"action": "ins", "obj": pid, "key": "_head",
                        "elem": 1},
                       {"action": "set", "obj": pid, "key": "__p__:1",
                        "value": "x"}]
            else:
                ops = [{"action": "set", "obj": pid, "key": "k",
                        "value": 0}]
            # tables allocate lazily at the first ingest, so the probe
            # applies one op to land in its capacity bucket — with the
            # footprint gauges suspended (a throwaway measurement must
            # not roll the session peak the budget is asserted against)
            prev, device_truth.ENABLED = device_truth.ENABLED, False
            try:
                with lane.device_ctx():
                    probe = _DOC_KINDS[lane.doc_kind](
                        pid, capacity=lane.capacity, device=lane.device)
                    # every commit compacts (engine/base.py
                    # `compact_tables`), so this is what a fresh doc holds
                    # after its first lane round (per-object: its tables
                    # plus extras; stacked: its tables, no more)
                    probe.apply_changes([{"actor": "__p__", "seq": 1,
                                          "deps": {}, "ops": ops}])
                    self._fresh_bytes = probe.device_footprint()[
                        "device_bytes"]
            finally:
                device_truth.ENABLED = prev
        return self._fresh_bytes

    def _reserve_estimate(self) -> int:
        """Bytes to reserve for a doc not yet materialized/measured:
        the fresh-doc allocation constant (what a new doc actually
        lands at; an all-time grown max would over-evict, a
        current-population max under-reserves when only compact
        restored docs are resident)."""
        return int(self._fresh_doc_bytes() * self.config.reserve_margin)

    # -- the paging gate (deliver_round integration) --------------------

    def stored_clock(self, doc_id: str):
        """A demoted doc's frontier clock read from its stored bundle's
        hash-verified manifest (`bundle.peek` — a cheap host read, no
        array verification, no promotion). None if the doc is not
        stored."""
        data = self.store.peek(doc_id)
        if data is None:
            return None
        from ..checkpoint import bundle as _bundle
        frag = _bundle.peek(data).get("doc") or {}
        return dict(frag.get("clock") or {})

    @_locked
    def before_round(self, deliveries: dict):
        """The demand-paging pass, called by `ShardedDocSet.deliver_round`
        BEFORE any routing/ingest: a stored doc with causally-READY work
        this round pages in (a demand miss, room made first), a stored
        doc whose changes are ALL premature against its stored frontier
        stays stored (the router parks them — `hint_park` decides
        prefetch), unseen docs reserve estimated bytes, and the budget is
        enforced by eviction of docs OUTSIDE the round's working set —
        the reservation discipline that keeps the peak footprint gauge
        under the budget."""
        self._in_round = True
        self._reserved = 0
        protect = [d for d in deliveries if d not in self.mesh._migrating]
        est = self._reserve_estimate()
        need = 0
        # batched stored-membership: the whole round's doc ids go through
        # ONE learned position probe over the store's sorted id table
        # (store.member_mask, the "residency_clock" site); None keeps the
        # exact per-doc `in` probes as the parity comparator
        stored_mask = self.store.member_mask(protect) if protect else None
        for i, doc_id in enumerate(protect):
            if (doc_id in self.store if stored_mask is None
                    else bool(stored_mask[i])):
                # route against the STORED clock: only causally-ready
                # work justifies burning h2d bandwidth now — premature
                # changes will park either way, and the park hint is
                # the admission-aware prefetch path
                ready, _ = self.mesh._split_ready(
                    list(deliveries[doc_id]),
                    self.stored_clock(doc_id) or {})
                if ready:
                    self.stats["misses"] += 1
                    # page_in itself banks the restored doc's re-growth
                    # headroom in the round ledger
                    self.page_in(doc_id, protect=protect,
                                 changes=deliveries[doc_id])
            elif self._doc_lane(doc_id) is not None:
                self.stats["hits"] += 1
                # a compact (restored earlier) resident doc re-grows to
                # its full capacity bucket when this round ingests it
                need += max(0, est - self._sizes.get(doc_id, est))
            else:
                # brand new: ensure_doc will materialize it inside the
                # lane ingest — reserve its estimated footprint now
                need += est
        self._make_room(need, protect)
        # bank the round's materialization/growth claims: every later
        # page-in this round (prefetch at park, release at drain) must
        # make room UNDER these reservations, not fill them — a
        # _make_room call alone is a check, the ledger is the hold
        self._reserved += need

    @_locked
    def after_round(self, deliveries: dict):
        """The bookkeeping half: touch the model for every doc the round
        actually reached, advance the pager clock, and run the aging
        pass (warm -> cold for bundles past ``cold_after``)."""
        self._round += 1
        self._in_round = False
        self._reserved = 0              # claims materialized into sizes
        for doc_id in deliveries:
            if self._doc_lane(doc_id) is not None:
                self.model.note_touch(doc_id, self._round)
        self.resident_bytes()           # refresh sizes + peak watermark
        # re-enforce: table growth (a capacity-bucket jump) or a stale
        # size estimate can leave the round's commit over budget —
        # nothing is protected here, the model's recency scoring is the
        # protection (docs just touched score ~0 and evict last)
        self._make_room(0)
        self._age_pass()

    @_locked
    def tick(self):
        """The pager heartbeat for rounds that arrive from a tick loop
        (SyncService.tick): advances the clock and ages warm bundles
        even when no mesh traffic flows."""
        self._round += 1
        self._in_round = False
        self._reserved = 0
        self._make_room(0)
        self._age_pass()

    def _age_pass(self):
        if self.config.spill_dir is None:
            return
        cutoff = self._round - self.config.cold_after
        for doc_id in self.store.warm_ids():
            if self._store_round.get(doc_id, self._round) <= cutoff:
                if self.store.age(doc_id):
                    self.stats["cold_ages"] += 1
                    self.telemetry.observe_count("res", "cold_ages")

    # -- paging hints ---------------------------------------------------

    def hint_park(self, doc_id: str, changes=None, protect=()):
        """A router park IS a paging hint: a premature change means the
        doc's missing dependencies are in flight, so a demoted doc
        starts staging back now instead of stalling the release.
        ``protect`` names docs the caller still needs resident this
        round (routed-but-not-yet-ingested) — the prefetch's room-making
        must not evict them."""
        self.stats["hints"] += 1
        if self.config.prefetch and doc_id in self.store \
                and doc_id not in self.mesh._migrating:
            self.stats["prefetches"] += 1
            self.telemetry.observe_count("res", "prefetches")
            self.page_in(doc_id, protect=protect, changes=changes,
                         why="prefetch")

    def hint_release(self, doc_id: str, changes=None, protect=()):
        """A quarantine release is the admission-side hint: the doc is
        about to take an ingest, so page it in if it was demoted
        between park and release."""
        self.stats["hints"] += 1
        self.ensure_resident(doc_id, changes=changes, protect=protect)

    def ensure_resident(self, doc_id: str, changes=None, protect=()):
        """Demand paging for any path about to touch the doc's engine
        state (quarantine drain, reads, round-trip promotion)."""
        if doc_id in self.store and doc_id not in self.mesh._migrating:
            self.stats["misses"] += 1
            self.page_in(doc_id, protect=protect, changes=changes)

    # -- tier transitions -----------------------------------------------

    def _doc_lane(self, doc_id: str):
        lane = self.mesh.lane_of(doc_id)
        return lane if doc_id in lane.docs else None

    def _choose_lane(self, doc_id: str):
        """Budget-aware placement for a page-in: the lane with the
        lightest device footprint, tiebroken by the quietest telemetry
        window (the rebalance policy's signal). A move away from the
        current placement is recorded in the table — ownership follows
        the bytes."""
        lanes = self.mesh.lanes
        if len(lanes) == 1:
            return lanes[0]
        pressure = lane_pressure(self.telemetry, lanes)
        best = min(
            range(len(lanes)),
            key=lambda i: (lanes[i].device_footprint()["device_bytes"],
                           pressure[i], i))
        home = self.mesh.placement.shard_of(doc_id)
        if best != home:
            self.mesh.placement.move(doc_id, best)
            self.stats["placement_moves"] += 1
        return lanes[best]

    @_locked
    def page_in(self, doc_id: str, protect=(), changes=None,
                why: str = "demand"):
        """Promote a warm/cold doc back to device residency: make room
        under the budget, then stage the bundle's tables h2d through
        `ShardLane.adopt` (restore_engine — verified bundle, no replay).
        The page-in dwell is measured two ways: the ``res``/``page_in``
        telemetry span (the cfg18 p99 source) and, for sampled changes,
        the paired ``res/page_wait`` -> ``res/page_in`` lineage hops."""
        was_cold = self.store.tier(doc_id) == "cold"
        bundle = self.store.pop(doc_id)
        if bundle is None:
            return None
        self._store_round.pop(doc_id, None)
        if was_cold:
            self.stats["cold_loads"] += 1
            self.telemetry.observe_count("res", "cold_loads")
        need = self._sizes.get(doc_id, self._reserve_estimate())
        self._make_room(need, tuple(protect) + (doc_id,))
        lane = self._choose_lane(doc_id)
        site = f"lane{lane.index}"
        if lineage.ENABLED and changes:
            lineage.hop_delivery(changes, "res/page_wait", site=site,
                                 doc=doc_id)
        t0 = time.perf_counter_ns()
        doc = lane.adopt(doc_id, bundle)
        dur_ns = time.perf_counter_ns() - t0
        if lineage.ENABLED and changes:
            lineage.hop_delivery(changes, "res/page_in", site=site,
                                 doc=doc_id)
        self.telemetry.observe_span("res", "page_in", dur_ns)
        self.telemetry.observe_count("res", "page_ins")
        self.stats["page_ins"] += 1
        actual = doc.device_footprint()["device_bytes"]
        self._sizes[doc_id] = actual
        if self._in_round:
            # the restored tables pack tighter than the room just made
            # — keep the difference held for this doc's re-growth at
            # the ingest that demanded it
            self._reserved += max(0, need - actual)
        self.model.note_touch(doc_id, self._round)
        return lane

    @_locked
    def demote(self, doc_id: str) -> bool:
        """Hot -> warm: capture the doc as its checkpoint bundle at a
        commit boundary and release the device tables (the lane drops
        the doc's footprint gauge). Refuses (False) for docs that are
        migrating or hold causally-unready queued work — the same
        commit-boundary discipline as `ShardedDocSet.migrate`."""
        if doc_id in self.mesh._migrating:
            return False
        lane = self._doc_lane(doc_id)
        if lane is None:
            return False
        doc = lane.docs[doc_id]
        if doc.queue:
            return False
        bundle = lane.export(doc_id)
        self.store.put(doc_id, bundle)
        self._store_round[doc_id] = self._round
        self._sizes.pop(doc_id, None)
        self.stats["page_outs"] += 1
        self.telemetry.observe_count("res", "page_outs")
        return True

    @_locked
    def _make_room(self, need: int, protect=()):
        """Evict (demote) resident docs until ``resident + need`` fits
        the budget, targeting ``headroom * budget`` once eviction
        triggers (hysteresis). Victims: the highest working-set score
        outside the protected set. A population whose protected working
        set alone exceeds the budget is counted as an overrun — the
        budget must hold at least one round's working set."""
        budget = self.config.budget_bytes
        if not budget:
            return
        need += self._reserved          # the round's banked claims hold
        resident = self.resident_bytes()
        if resident + need <= budget:
            return
        target = min(budget - need,
                     int(budget * self.config.headroom) - need)
        protect = set(protect)
        candidates = [d for lane in self.mesh.lanes for d in lane.docs
                      if d not in protect
                      and d not in self.mesh._migrating]
        candidates.sort(key=lambda d: self.model.score(d, self._round),
                        reverse=True)
        for doc_id in candidates:
            if resident <= target:
                break
            nbytes = self._sizes.get(doc_id, 0)
            if self.demote(doc_id):
                self.stats["evictions"] += 1
                self.telemetry.observe_count("res", "evictions")
                resident -= nbytes
        if resident + need > budget:
            self.stats["budget_overruns"] += 1

    # -- reads ----------------------------------------------------------

    def stored_bundle(self, doc_id: str):
        """A demoted doc's checkpoint WITHOUT promoting it: the stored
        bundle IS the canonical capture (byte-identical — produced by
        the same `capture_engine` at demotion)."""
        return self.store.peek(doc_id)

    def tier_of(self, doc_id: str):
        if self._doc_lane(doc_id) is not None:
            return "hot"
        return self.store.tier(doc_id)

    def accounting(self) -> dict:
        """The full population ledger the eviction-under-pressure test
        asserts over: every doc named in exactly one tier, plus
        router-parked wire-change counts per doc (parked changes belong
        to docs of ANY tier — they are router state, not doc state)."""
        hot = sorted(d for lane in self.mesh.lanes for d in lane.docs)
        tiers = self.store.tiers()
        return {"hot": hot, "warm": tiers["warm"], "cold": tiers["cold"],
                "parked": {d: len(q)
                           for d, q in self.mesh._quarantine.items()
                           if len(q)},
                "resident_bytes": sum(self._sizes.get(d, 0) for d in hot),
                "warm_bytes": tiers["warm_bytes"],
                "cold_bytes": tiers["cold_bytes"]}

    def page_in_p99_ms(self) -> float:
        """Telemetry-bound p99 page-in dwell in ms (the cfg18 SLO term)."""
        return round(
            self.telemetry.quantile_ns("res", "page_in", 0.99) / 1e6, 3)

    def hit_rate(self) -> float:
        """Steady-state residency hit rate: the fraction of delivery
        touches that found their doc already device-resident."""
        seen = self.stats["hits"] + self.stats["misses"]
        return round(self.stats["hits"] / seen, 4) if seen else 1.0

    def metrics(self) -> dict:
        acct = self.accounting()
        return {
            "budget_bytes": self.config.budget_bytes,
            "eviction": self.config.eviction,
            "round": self._round,
            "hot_docs": len(acct["hot"]),
            "warm_docs": len(acct["warm"]),
            "cold_docs": len(acct["cold"]),
            "resident_bytes": acct["resident_bytes"],
            "warm_bytes": acct["warm_bytes"],
            "cold_bytes": acct["cold_bytes"],
            "peak_resident_bytes": self.peak_resident_bytes,
            "hit_rate": self.hit_rate(),
            "page_in_p99_ms": self.page_in_p99_ms(),
            **self.stats,
        }

    def families(self, prefix: str = "amtpu_residency") -> list:
        """Prometheus exposition families (SyncService.scrape appends
        these next to the ``amtpu_device_*`` footprint gauges)."""
        m = self.metrics()
        counters = ("page_ins", "page_outs", "prefetches", "hints",
                    "hits", "misses", "cold_ages", "cold_loads",
                    "evictions", "budget_overruns", "placement_moves")
        fams = [
            (f"{prefix}_docs", "gauge",
             "Doc population per residency tier.",
             [({"tier": t}, m[f"{t}_docs"])
              for t in ("hot", "warm", "cold")]),
            (f"{prefix}_bytes", "gauge",
             "Bytes held per residency tier (device tables / host "
             "bundles / disk spill files).",
             [({"tier": "hot"}, m["resident_bytes"]),
              ({"tier": "warm"}, m["warm_bytes"]),
              ({"tier": "cold"}, m["cold_bytes"])]),
            (f"{prefix}_budget_bytes", "gauge",
             "Configured device budget (0 = unbounded).",
             [({}, m["budget_bytes"])]),
            (f"{prefix}_peak_resident_bytes", "gauge",
             "High-water mark of mesh-wide device-resident bytes as "
             "measured by the manager.",
             [({}, m["peak_resident_bytes"])]),
            (f"{prefix}_hit_rate", "gauge",
             "Fraction of delivery touches that found the doc already "
             "device-resident.",
             [({}, m["hit_rate"])]),
            (f"{prefix}_page_in_p99_ms", "gauge",
             "Telemetry-bound p99 page-in dwell (bundle pop + h2d "
             "staging restore).",
             [({}, m["page_in_p99_ms"])]),
            (f"{prefix}_events_total", "counter",
             "Residency tier transitions and paging events.",
             [({"event": k}, m[k]) for k in counters]),
        ]
        return fams

    def describe(self) -> dict:
        """The postmortem block (rides SyncService.describe / the mesh
        snapshot): tier ladder occupancy, budget posture, paging
        counters, dwell bound, and the model's shape."""
        acct = self.accounting()
        return {
            "schema": "amtpu-residency-v1",
            "config": {"budget_bytes": self.config.budget_bytes,
                       "headroom": self.config.headroom,
                       "cold_after": self.config.cold_after,
                       "spill_dir": self.config.spill_dir,
                       "eviction": self.config.eviction,
                       "prefetch": self.config.prefetch},
            "round": self._round,
            "tiers": {"hot": acct["hot"][:64], "warm": acct["warm"][:64],
                      "cold": acct["cold"][:64]},
            "tier_counts": {"hot": len(acct["hot"]),
                            "warm": len(acct["warm"]),
                            "cold": len(acct["cold"])},
            "bytes": {"resident": acct["resident_bytes"],
                      "warm": acct["warm_bytes"],
                      "cold": acct["cold_bytes"],
                      "peak_resident": self.peak_resident_bytes},
            "parked": acct["parked"],
            "hit_rate": self.hit_rate(),
            "page_in_p99_ms": self.page_in_p99_ms(),
            "stats": dict(self.stats),
            "store": dict(self.store.stats),
            "model": self.model.describe(),
        }
