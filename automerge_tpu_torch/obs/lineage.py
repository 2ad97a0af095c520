"""Distributed change-lineage tracing (INTERNALS §18); the port of the
JAX package's ``obs/lineage.py``.

The trace ring records *spans* (where did this process spend its time)
and the telemetry store *aggregates*.  Neither can answer
the question a federated deployment asks constantly: *where did this
specific change spend its time, and on which hop did it get stuck?*
This module makes per-change, cross-replica visibility a first-class
measured quantity: a bounded, deterministically-sampled provenance
ledger records every hop a change takes —

    origin -> chan/send (/retransmit) -> hub/flush -> svc/admit
    (/defer /shed) -> quar/park (/release /pen) -> plan/stacked
    -> commit (per replica) / ckpt/adopt (snapshot bootstrap)

keyed by ``(actor, seq)``, the change's globally-unique identity.

**Zero-coordination sampling.**  Whether a change is traced is a pure
function of its identity: ``sha1(actor:seq) % AMTPU_LINEAGE_RATE == 0``.
Every replica — with no handshake, no shared state, no sampling header —
independently selects the *identical* subset of changes, so the hops one
replica records stitch onto the hops every other replica records for the
same change.  (Okapi's cheap-causal-metadata discipline, PAPERS.md: the
metadata that makes geo-replication debuggable must not itself require
coordination.)

**Trace context on the wire.**  The origin timestamp travels as trace
context: an optional ``trace`` manifest entry on ``AMTPUWIRE1`` frames
and an optional ``trace`` field on dict sync messages — both
version-tolerant (old decoders ignore them) and typed-validated (a
malformed context is a ``ProtocolError``, never a crash).  Hop
timestamps are WALL-CLOCK nanoseconds (:func:`now_ns`), not the obs
tier's process-local ``perf_counter``: an adopted origin must be
comparable on the receiving replica, so cross-replica visibility is
accurate to clock sync (NTP) — the standard distributed-tracing
tradeoff.  ``adopt()`` re-verifies sampling on every adopted entry, so
hostile context can never grow the ledger beyond the sampled subset.

**Hot-path discipline**: every hop site is guarded by ONE module-flag
check::

    from ..obs import lineage
    ...
    if lineage.ENABLED:
        lineage.hop(actor, seq, "quar/park", site=..., doc=doc_id)

Disabled, the whole emit path is a module-dict lookup and a falsy
branch — no call, no hash, no lock (bounded and asserted in the
tests).

**Bounds.**  The ledger retains at most ``AMTPU_LINEAGE_CAPACITY``
chains (default 4096); at the cap the OLDEST chain is evicted while the
exact counters (``chains_started``/``chains_evicted``/``hops_recorded``)
survive eviction — the trace ring's wraparound discipline.  Each chain
holds at most ``AMTPU_LINEAGE_MAX_HOPS`` hops; duplicates dedup by
``(stage, site, extra)`` so dup/reorder/retransmit chaos never grows a
chain (a retransmission adds a distinct ``chan/retransmit`` hop — its
``extra`` carries the attempt — never a duplicate chain).

**Read side.**  Per-stage dwell histograms and end-to-end
``visibility`` spans feed the ledger's own always-on
:class:`~.telemetry.Telemetry` store at record time (exact across
eviction); :func:`families` exports them in Prometheus exposition form;
``LineageLedger.postmortem`` ranks the K most-stuck sampled changes with
their full hop chains; hops also
emit ``lineage``-category obs events when tracing is live, which
``obs/export.py`` stitches into Perfetto flow events — one change's
journey across actors as a single loadable timeline.

Enable via ``AMTPU_LINEAGE_RATE=N`` in the environment (sample 1/N;
``1`` samples everything; unset/0 disables) or :func:`enable`.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict
from typing import Optional

from .telemetry import Telemetry

#: THE fast-path gate: hop sites read this module attribute directly
#: (`if lineage.ENABLED:`) so a disabled process pays one dict lookup
#: per site and nothing else.  Mutated only by enable()/disable().
ENABLED = False

_ledger: Optional["LineageLedger"] = None

#: Hop stages that make a change VISIBLE on a replica: a normal gate
#: commit, or adoption via a checkpoint-bundle bootstrap (the change's
#: effect arrived inside the bundle; it never re-crossed the wire).
VISIBILITY_STAGES = ("commit", "ckpt/adopt")

DEFAULT_CAPACITY = 4096
DEFAULT_MAX_HOPS = 128

#: Longest trace-context list either wire accepts (typed rejection
#: beyond it — enforced by ``wire_format.validate_trace_context``):
#: context is bounded by the sender's sampled subset, so an oversized
#: list is malformed or hostile, never legitimate.
MAX_CONTEXT_ENTRIES = 8192


def now_ns() -> int:
    """THE lineage hop clock: wall-clock nanoseconds (``time.time_ns``),
    NOT the obs tier's ``perf_counter_ns`` — hop timestamps cross
    process boundaries inside trace context, and perf_counter epochs
    are process-local (an adopted origin would make every visibility/
    dwell number meaningless on a real wire).  Cross-replica accuracy
    is therefore bounded by clock sync (NTP), the standard distributed-
    tracing tradeoff; dwell computations clamp at 0 against small clock
    steps."""
    return time.time_ns()


def _env_int(name: str, default: int) -> int:
    try:
        v = int(os.environ.get(name, "") or 0)
    except ValueError:
        return default
    return v if v > 0 else default


def sample_key(actor: str, seq: int) -> int:
    """The content hash sampling keys on: the first 8 bytes of
    ``sha1(actor:seq)`` as an unsigned int.  A pure function of the
    change identity — every replica computes the same value with zero
    coordination."""
    digest = hashlib.sha1(f"{actor}:{seq}".encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big")


class LineageLedger:
    """Bounded, deterministic-sampled per-change provenance store.

    One instance lives module-level (`lineage.enable()`); tests
    instantiate their own to prove the zero-coordination sampling
    property across independent "processes"."""

    def __init__(self, rate: int, capacity: Optional[int] = None,
                 max_hops: Optional[int] = None):
        if rate < 1:
            raise ValueError("sampling rate must be >= 1 (1 = sample "
                             "everything)")
        self.rate = rate
        self.capacity = capacity if capacity is not None \
            else _env_int("AMTPU_LINEAGE_CAPACITY", DEFAULT_CAPACITY)
        self.max_hops = max_hops if max_hops is not None \
            else _env_int("AMTPU_LINEAGE_MAX_HOPS", DEFAULT_MAX_HOPS)
        #: always-on dwell/visibility store: per-stage ``dwell:<stage>``
        #: histograms + end-to-end ``visibility`` spans, fed at record
        #: time so accuracy is independent of chain eviction
        self.telemetry = Telemetry()
        self._lock = threading.Lock()
        # memoized sampling decisions: hop sites evaluate the same
        # (actor, seq) dozens of times along one change's journey, and
        # the sha1 is pure — bounded (wholesale-cleared at the cap, a
        # cache, never a record; GIL-atomic get/set, a racing clear just
        # recomputes)
        self._sample_cache: dict = {}
        # (actor, seq) -> chain dict; insertion-ordered so capacity
        # eviction drops the OLDEST chain deterministically
        self._chains: OrderedDict = OrderedDict()
        self.stats = {"chains_started": 0, "chains_evicted": 0,
                      "hops_recorded": 0, "hops_deduped": 0,
                      "hops_dropped_cap": 0, "context_adopted": 0,
                      "context_ignored": 0}

    # -- sampling -------------------------------------------------------

    def sampled(self, actor: str, seq: int) -> bool:
        key = (actor, seq)
        hit = self._sample_cache.get(key)
        if hit is None:
            if len(self._sample_cache) >= 65536:
                self._sample_cache.clear()
            hit = self._sample_cache[key] = \
                sample_key(actor, seq) % self.rate == 0
        return hit

    # -- write side -----------------------------------------------------

    #: Stage pairs whose dwell is measured between the MATCHING hops at
    #: the SAME site, not to whatever hop lands next on the shared
    #: chain: an interleaved hop from another replica (a retransmit, a
    #: commit elsewhere) must not truncate the reported parked/deferred
    #: period — these are the headline dwell numbers.
    PAIRED_DWELL = {"quar/release": "quar/park", "svc/admit": "svc/defer",
                    # residency page-in dwell: bundle pop + h2d staging,
                    # opened by res/page_wait at the adopting lane site
                    "res/page_in": "res/page_wait"}

    def record(self, actor: str, seq: int, stage: str, site=None,
               doc=None, extra=0, t_ns: Optional[int] = None) -> bool:
        """Append one hop to the change's chain (creating the chain on
        first sight).  Returns False when the change is not in the
        sampled subset or the hop deduped.  Dedup key: ``(stage, site,
        extra)`` — dup delivery of the same hop never grows the chain;
        distinguishable repeats (retransmit attempts) pass a distinct
        ``extra``.  An ``origin`` hop adopted AFTER later hops (late
        wire context for a chain another path already committed)
        prepends — it carries the oldest timestamp and must never make
        a finished chain look mid-flight."""
        if not self.sampled(actor, seq):
            return False
        if t_ns is None:
            t_ns = now_ns()
        site = site or ""
        key = (actor, seq)
        hop_key = (stage, site, extra)
        dwells = []
        visibility = []
        with self._lock:
            chain = self._chains.get(key)
            if chain is None:
                while len(self._chains) >= self.capacity:
                    self._chains.popitem(last=False)
                    self.stats["chains_evicted"] += 1
                chain = self._chains[key] = {
                    "actor": actor, "seq": seq, "origin_ns": None,
                    "origin_site": None, "hops": [], "keys": set(),
                    "docs": set()}
                self.stats["chains_started"] += 1
            if hop_key in chain["keys"] \
                    or (stage == "origin"
                        and chain["origin_ns"] is not None):
                self.stats["hops_deduped"] += 1
                return False
            if len(chain["hops"]) >= self.max_hops:
                self.stats["hops_dropped_cap"] += 1
                return False
            opener = self.PAIRED_DWELL.get(stage)
            if opener is not None:
                # paired dwell: latest matching opener at THIS site
                for h_stage, h_site, h_ts, _x in reversed(chain["hops"]):
                    if h_stage == opener and h_site == site:
                        dwells.append((opener, max(0, t_ns - h_ts)))
                        break
            elif chain["hops"] and stage != "origin":
                prev_stage, _ps, prev_ts, _pe = chain["hops"][-1]
                if prev_stage not in self.PAIRED_DWELL.values():
                    dwells.append((prev_stage, max(0, t_ns - prev_ts)))
            chain["keys"].add(hop_key)
            if stage == "origin" and chain["hops"]:
                # late-adopted origin: prepend (oldest timestamp), and
                # retroactively emit the visibility samples the earlier
                # commit hops could not compute without an origin
                chain["hops"].insert(0, (stage, site, t_ns, extra))
            else:
                chain["hops"].append((stage, site, t_ns, extra))
            self.stats["hops_recorded"] += 1
            if stage == "origin":
                chain["origin_ns"] = t_ns
                chain["origin_site"] = site
                for h_stage, h_site, h_ts, _x in chain["hops"][1:]:
                    if h_stage in VISIBILITY_STAGES and h_site != site:
                        visibility.append((max(0, h_ts - t_ns), h_ts))
            if stage in VISIBILITY_STAGES:
                if doc is not None:
                    chain["docs"].add(doc)
                if chain["origin_ns"] is not None \
                        and site != chain["origin_site"]:
                    visibility.append(
                        (max(0, t_ns - chain["origin_ns"]), t_ns))
        # telemetry + obs emission OUTSIDE the chain lock (the store has
        # its own striped locks; the obs ring likewise)
        for d_stage, d_ns in dwells:
            self.telemetry.observe_span("lineage", f"dwell:{d_stage}",
                                        d_ns, ts_ns=t_ns)
        for v_ns, v_ts in visibility:
            self.telemetry.observe_span("lineage", "visibility",
                                        v_ns, ts_ns=v_ts)
        from .. import obs as _obs
        if _obs.ENABLED:
            args = {"actor": actor, "seq": seq, "site": site}
            if doc is not None:
                args["doc"] = doc
            if extra:
                args["extra"] = str(extra)
            _obs.event("lineage", stage, args=args)
        return True

    def adopt(self, entries) -> int:
        """Merge wire trace context — ``[[actor, seq, origin_ns,
        origin_site], ...]`` — into the ledger: each SAMPLED entry
        ensures a chain exists with its origin hop pinned at the
        sender's origin timestamp/site.  Unsampled entries are counted
        and ignored (hostile or stale context cannot grow the ledger
        beyond the deterministic subset).  Returns adopted count."""
        n = 0
        for ent in entries:
            actor, seq, t0, site = ent
            if not self.sampled(actor, seq):
                self.stats["context_ignored"] += 1
                continue
            if self.record(actor, seq, "origin", site=site, t_ns=t0):
                n += 1
                self.stats["context_adopted"] += 1
        return n

    def adopt_clock(self, clock: dict, site=None, doc=None,
                    t_ns: Optional[int] = None) -> int:
        """Snapshot-bootstrap visibility: every retained chain whose
        ``(actor, seq)`` the adopted checkpoint clock covers gains a
        ``ckpt/adopt`` hop at `site` — the change became visible on
        this replica inside the bundle, without re-crossing the wire.
        Bounded by the ledger's own chain count, never the clock."""
        with self._lock:
            keys = list(self._chains.keys())
        n = 0
        for actor, seq in keys:
            if clock.get(actor, 0) >= seq:
                if self.record(actor, seq, "ckpt/adopt", site=site,
                               doc=doc, t_ns=t_ns):
                    n += 1
        return n

    # -- read side ------------------------------------------------------

    @property
    def n_chains(self) -> int:
        return len(self._chains)

    def chain(self, actor: str, seq: int) -> Optional[dict]:
        """One chain's snapshot: {"actor", "seq", "origin_ns",
        "origin_site", "docs", "hops": [(stage, site, ts_ns, extra)]}
        or None."""
        with self._lock:
            c = self._chains.get((actor, seq))
            if c is None:
                return None
            return {"actor": c["actor"], "seq": c["seq"],
                    "origin_ns": c["origin_ns"],
                    "origin_site": c["origin_site"],
                    "docs": set(c["docs"]), "hops": list(c["hops"])}

    def chains(self) -> list:
        """Snapshots of every retained chain (insertion order)."""
        with self._lock:
            keys = list(self._chains.keys())
        out = []
        for actor, seq in keys:
            c = self.chain(actor, seq)
            if c is not None:
                out.append(c)
        return out

    @staticmethod
    def visible_sites(chain: dict) -> set:
        """Sites where the chain's change is committed/visible."""
        return {site for stage, site, _ts, _x in chain["hops"]
                if stage in VISIBILITY_STAGES}

    def context_for(self, keys) -> list:
        """Wire trace-context entries for the sampled changes among
        `keys` (``(actor, seq)`` pairs) whose origin this ledger knows:
        ``[[actor, seq, origin_ns, origin_site], ...]``, deduped."""
        out = []
        seen = set()
        for actor, seq in keys:
            k = (actor, seq)
            if k in seen or not self.sampled(actor, seq):
                continue
            seen.add(k)
            with self._lock:
                c = self._chains.get(k)
                if c is None or c["origin_ns"] is None:
                    continue
                out.append([actor, seq, c["origin_ns"],
                            c["origin_site"] or ""])
        return out

    def visibility_ms(self, p: float) -> float:
        """Conservative end-to-end visibility-latency quantile bound in
        milliseconds (log-bucket histogram; 0.0 with no samples)."""
        return round(
            self.telemetry.quantile_ns("lineage", "visibility", p) / 1e6,
            3)

    def max_dwell_ms(self, stage: str) -> float:
        """Exact maximum dwell observed in `stage` (time from the
        stage's hop to the chain's next hop), ms."""
        agg = self.telemetry.span_aggregates().get(
            ("lineage", f"dwell:{stage}"))
        return round(agg["max_ns"] / 1e6, 3) if agg else 0.0

    def stuck(self, k: int = 8, at_ns: Optional[int] = None) -> list:
        """The K most-stuck sampled changes: chains with NO visibility
        hop anywhere yet (mid-flight), ranked by dwell since their last
        hop — the postmortem's "which hop is it stuck on" answer.
        (Visibility-anywhere, not last-hop-shape: a late retransmit or
        adopted hop landing after a commit must not resurrect a
        finished chain onto this list.)  Falls back to the slowest
        completed chains when nothing is mid-flight."""
        if at_ns is None:
            at_ns = now_ns()
        scored = []
        for c in self.chains():
            if not c["hops"]:
                continue
            last_stage, last_site, last_ts, _x = c["hops"][-1]
            mid_flight = not self.visible_sites(c)
            scored.append((mid_flight, at_ns - last_ts, c))
        scored.sort(key=lambda t: (not t[0], -t[1]))
        out = []
        for mid_flight, dwell_ns, c in scored[:k]:
            t0 = c["origin_ns"] if c["origin_ns"] is not None \
                else c["hops"][0][2]
            out.append({
                "actor": c["actor"], "seq": c["seq"],
                "origin_site": c["origin_site"],
                "docs": sorted(c["docs"]),
                "mid_flight": mid_flight,
                "stuck_at": c["hops"][-1][0],
                "stuck_site": c["hops"][-1][1],
                "dwell_ms": round(dwell_ns / 1e6, 3),
                "hops": [[stage, site, round((ts - t0) / 1e6, 3)]
                         + ([str(extra)] if extra else [])
                         for stage, site, ts, extra in c["hops"]],
            })
        return out

    def postmortem(self, k: int = 8) -> dict:
        """The JSON-serializable lineage block: config, exact counters,
        and the K most-stuck chains with their full hop chains
        (INTERNALS §18.4)."""
        agg = self.telemetry.span_aggregates()
        dwell_max = {key[1][len("dwell:"):]: round(v["max_ns"] / 1e6, 3)
                     for key, v in agg.items()
                     if key[0] == "lineage" and key[1].startswith("dwell:")}
        return {
            "schema": "amtpu-lineage-v1",
            "rate": self.rate,
            "capacity": self.capacity,
            "chains": self.n_chains,
            "stats": dict(self.stats),
            "visibility_p50_ms": self.visibility_ms(0.50),
            "visibility_p99_ms": self.visibility_ms(0.99),
            "max_dwell_ms": dwell_max,
            "stuck": self.stuck(k),
        }

    def families(self, prefix: str = "amtpu_lineage") -> list:
        """Prometheus exposition families: per-stage dwell + visibility
        histograms (from the ledger's telemetry store), ledger counters,
        and visibility quantile gauges."""
        from . import prom
        fams = prom.telemetry_families(self.telemetry, prefix)
        fams.append((
            f"{prefix}_ledger_total", "counter",
            "Exact lineage ledger counters (survive chain eviction).",
            [({"name": k}, v) for k, v in sorted(self.stats.items())]))
        fams.append((
            f"{prefix}_chains", "gauge",
            "Sampled chains currently retained (bounded by "
            "AMTPU_LINEAGE_CAPACITY).",
            [({}, self.n_chains)]))
        fams.append((
            f"{prefix}_visibility_ms", "gauge",
            "End-to-end origin->remote-visibility latency quantile "
            "bounds (log-bucket conservative).",
            [({"q": "p50"}, self.visibility_ms(0.50)),
             ({"q": "p99"}, self.visibility_ms(0.99))]))
        return fams

    def clear(self):
        with self._lock:
            self._chains = OrderedDict()
            for k in self.stats:
                self.stats[k] = 0
        self.telemetry.clear()


# ---------------------------------------------------------------------------
# module-level singleton + the hop-site emit surface
# ---------------------------------------------------------------------------


def ledger() -> Optional[LineageLedger]:
    """The live ledger (None when lineage never enabled)."""
    return _ledger


def enable(rate: Optional[int] = None,
           capacity: Optional[int] = None) -> LineageLedger:
    """Turn lineage tracing on (idempotent).  A ledger is created on
    first enable and retained across disable() so late readers can
    still export; pass `rate`/`capacity` to size a fresh one."""
    global ENABLED, _ledger
    if _ledger is None or rate is not None or capacity is not None:
        r = rate if rate is not None else _env_int(
            "AMTPU_LINEAGE_RATE", 64)
        _ledger = LineageLedger(r, capacity=capacity)
    ENABLED = True
    return _ledger


def disable():
    global ENABLED
    ENABLED = False


def clear():
    if _ledger is not None:
        _ledger.clear()


def hop(actor: str, seq: int, stage: str, site=None, doc=None, extra=0,
        t_ns: Optional[int] = None):
    """Record one hop for one change — call ONLY behind an
    ``if lineage.ENABLED:`` check (the one-flag-per-site contract)."""
    led = _ledger
    if led is not None:
        led.record(actor, seq, stage, site=site, doc=doc, extra=extra,
                   t_ns=t_ns)


def change_keys(delivery):
    """``(actor, seq)`` pairs of one delivery: a list of wire change
    dicts, a decoded columnar batch, or a WireFrame-shaped object.
    Never forces a frame decode (an undecoded frame yields nothing —
    the receive side decodes before its hops run)."""
    if delivery is None:
        return []
    if hasattr(delivery, "data") and callable(
            getattr(delivery, "batch", None)):  # WireFrame-shaped: read
        # ONLY the caches (hasattr on its n_changes PROPERTY would
        # decode; the send path must never pay that)
        chs = getattr(delivery, "_changes", None)
        if chs is not None:
            return [(c["actor"], c["seq"]) for c in chs]
        batch = getattr(delivery, "_batch", None)
        if batch is None:
            return []
        return list(zip(batch.actors, batch.seqs.tolist()))
    if hasattr(delivery, "n_changes"):          # decoded columnar batch
        return list(zip(delivery.actors, delivery.seqs.tolist()))
    return [(c["actor"], c["seq"]) for c in delivery
            if isinstance(c, dict) and "actor" in c and "seq" in c]


def hop_delivery(delivery, stage: str, site=None, doc=None, extra=0,
                 t_ns: Optional[int] = None):
    """Record `stage` for every sampled change in a delivery (change
    dicts / decoded batch / frame)."""
    led = _ledger
    if led is None:
        return
    for actor, seq in change_keys(delivery):
        led.record(actor, seq, stage, site=site, doc=doc, extra=extra,
                   t_ns=t_ns)


def payload_keys(payload):
    """``(actor, seq)`` pairs of one channel payload (a sync message
    dict, possibly carrying both a dict-change prefix and a binary
    frame).  Undecoded frames contribute their cached change list (set
    at mint time by ``split_outgoing``) — the send path never pays a
    decode."""
    if not isinstance(payload, dict):
        return []
    out = change_keys(payload.get("changes") or ())
    wire = payload.get("wire")
    if wire is not None:
        out.extend(change_keys(wire))
    return out


def families(prefix: str = "amtpu_lineage") -> list:
    led = _ledger
    return led.families(prefix) if led is not None else []


# honor AMTPU_LINEAGE_RATE at import (mirrors AMTPU_TRACE): a soak or CI
# step enables sampling with an env var, no code path needed
if os.environ.get("AMTPU_LINEAGE_RATE", "0") not in ("", "0"):
    try:
        enable(int(os.environ["AMTPU_LINEAGE_RATE"]))
    except ValueError:
        pass
