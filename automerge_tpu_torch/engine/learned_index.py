"""Bounded-error learned position models for host planning.

The per-lookup ``np.searchsorted`` / dict probes of actor interning and
the range index are the top host share of the planning floor. This
module removes the per-lookup term the way the RocksDB learned-index
work does (PAPERS.md): a **piecewise-linear model over the sorted key
space** predicts each query's position to within a proven error bound
ε, and a vectorized ε-window verify turns the prediction into the EXACT
answer — a model miss falls back to the exact probe, never a wrong
answer.

Model form and contract
-----------------------

- ``fit``: anchors are S evenly spaced table positions (first and last
  always included); prediction is monotone linear interpolation between
  anchors (``np.interp`` — one C pass per query column). ε is computed
  *closed form at fit time* as the exact max |prediction − position|
  over every table key, so the bound is a measurement, not an estimate.
  Refit is O(n) vectorized — cheap enough to run on every
  interning-generation bump (the rank-cache invalidation token doubles
  as the retrain trigger).
- ``searchsorted``: predict ± ε, then an exact windowed rank count
  (one (Q, 2ε+3) gather + one comparison reduce) yields the candidate
  position; a final boundary check proves it equals
  ``np.searchsorted``'s answer. Queries that fail the check (float
  rounding at the int64 edge) fall back to the exact probe.
- Monotonicity is by construction (anchor positions are increasing), so
  the table-key bound extends to arbitrary queries: a query between two
  table keys predicts between their predictions, within ε+1 of its
  insertion point.

Sites and demotion
------------------

Every hot probe site registers under the JAX package's site name
(`SITES`): ``_intern_batch_actors`` / ``_plan_round``'s actor-rank
resolution ("actor_rank"), ``cross_doc``'s per-shape rank joins
("cross_doc_seed"), the ``host_index.BatchRangeIndex`` probes of text
rounds and DocSet builds ("range_index"), and the residency store's
stored-doc lookups ("residency_clock"). Per-site counters (lookups /
keys / model hits / misses / refits / demotions) feed the
``amtpu_index_*`` prom families (service/server.py scrape()) and the
``describe()`` block of the service postmortem.

Drift — non-append workloads, actor churn — shows up as a rising miss
rate: a sliding window per site demotes the site to its exact path when
the windowed miss rate crosses ``_DEMOTE_RATE`` (the model is advisory;
the exact path is always correct), and the next refit re-arms it. The
JAX package's environment switches (``AMTPU_LEARNED_INDEX``, its audit,
demotion-rate and window knobs) are not read: the learned path is
always on, at the JAX package's defaults.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = [
    "PositionModel", "fit_model", "pack_str_keys", "actor_positions",
    "doc_actor_model", "site_state", "site_enabled", "note_refit",
    "stats_snapshot", "reset_stats", "families", "describe", "SITES",
    "RANGE_SITE",
]

_LOCK = threading.Lock()

#: Tables below this size take the exact probe (binary search over a
#: handful of keys beats any model's fixed overhead).
_MIN_KEYS = 16
#: A fit whose measured ε exceeds this refuses to build: the verify
#: window would gather more than the binary search it replaces.
_MAX_EPS = 64
_ANCHORS = 64

_DEMOTE_WINDOW = 256      # sliding miss window per site
_DEMOTE_RATE = 0.25


class SiteState:
    """Per-site counters + the miss-rate demotion window.

    ``misses``/``hits`` count per KEY (the per-lookup quantity the model
    exists to kill); ``lookups`` counts batched probe calls. The window
    tracks the last ``_DEMOTE_WINDOW`` keys' hit/miss outcomes; crossing
    ``_DEMOTE_RATE`` demotes the site — consumers then take their exact
    path until the next refit re-arms it. ``wrong`` stays in the schema
    (the JAX package's audit mode counts there) and is never raised."""

    __slots__ = ("name", "lookups", "keys", "hits", "misses", "refits",
                 "demotions", "wrong", "exact_fallbacks", "eps_last",
                 "_win_keys", "_win_misses", "demoted")

    def __init__(self, name: str):
        self.name = name
        self.lookups = 0
        self.keys = 0
        self.hits = 0
        self.misses = 0
        self.refits = 0
        self.demotions = 0
        self.wrong = 0
        self.exact_fallbacks = 0  # whole probes routed exact (unpackable
        #                           keys), not per-key misses
        self.eps_last = -1        # ε of the most recent fit (-1: none)
        self._win_keys = 0
        self._win_misses = 0
        self.demoted = False

    def note(self, n_keys: int, n_misses: int):
        with _LOCK:
            self.lookups += 1
            self.keys += n_keys
            self.misses += n_misses
            self.hits += n_keys - n_misses
            self._win_keys += n_keys
            self._win_misses += n_misses
            if self._win_keys >= _DEMOTE_WINDOW:
                if (not self.demoted
                        and self._win_misses > _DEMOTE_RATE
                        * self._win_keys):
                    self.demoted = True
                    self.demotions += 1
                self._win_keys = 0
                self._win_misses = 0

    def note_hits(self, n_keys: int):
        """Lock-free all-hit counting for the scalar fast path: the
        counters are advisory (exactness never depends on them) and a
        zero-miss probe cannot trip the demotion window."""
        self.lookups += 1
        self.keys += n_keys
        self.hits += n_keys

    def note_exact(self):
        with _LOCK:
            self.lookups += 1
            self.exact_fallbacks += 1

    def note_refit(self, eps: int):
        """A fresh fit re-arms a demoted site (the drift that demoted it
        is what the refit absorbs)."""
        with _LOCK:
            self.refits += 1
            self.eps_last = int(eps)
            self.demoted = False
            self._win_keys = 0
            self._win_misses = 0

    def reset(self):
        """Zero in place — module-level handles (`RANGE_SITE`) stay
        valid across resets."""
        with _LOCK:
            self.lookups = self.keys = self.hits = self.misses = 0
            self.refits = self.demotions = self.wrong = 0
            self.exact_fallbacks = 0
            self.eps_last = -1
            self._win_keys = self._win_misses = 0
            self.demoted = False

    def miss_rate(self) -> float:
        return self.misses / self.keys if self.keys else 0.0

    def snapshot(self) -> dict:
        return {"lookups": self.lookups, "keys": self.keys,
                "hits": self.hits, "misses": self.misses,
                "refits": self.refits, "demotions": self.demotions,
                "wrong": self.wrong,
                "exact_fallbacks": self.exact_fallbacks,
                "eps_last": self.eps_last,
                "miss_rate": round(self.miss_rate(), 6),
                "demoted": self.demoted}


#: The registered hot probe sites. Consumers fetch by name; an unknown
#: name registers lazily.
SITES: dict = {}
for _name in ("actor_rank", "cross_doc_seed", "range_index",
              "residency_clock"):
    SITES[_name] = SiteState(_name)

#: Direct handle for the hottest site (host_index's probes skip the
#: registry dict lookup per call).
RANGE_SITE = SITES["range_index"]


def site_state(name: str) -> SiteState:
    st = SITES.get(name)
    if st is None:
        with _LOCK:
            st = SITES.setdefault(name, SiteState(name))
    return st


def note_refit(name: str, eps: int):
    site_state(name).note_refit(eps)


def site_enabled(name: str) -> bool:
    """The site is not currently demoted — the per-probe gate every
    consumer checks before leaving its exact path."""
    return not site_state(name).demoted


def stats_snapshot() -> dict:
    return {name: st.snapshot() for name, st in sorted(SITES.items())}


def reset_stats():
    """Zero every site in place (test isolation; module-level site
    handles stay valid)."""
    for st in list(SITES.values()):
        st.reset()


class PositionModel:
    """One fitted piecewise-linear position model over a sorted key
    column (uint64/int64). Immutable — refit builds a new instance.
    ``padded`` is the key column with one trailing sentinel slot
    (dtype max) so the verify gather never branches on the right edge;
    ``keys`` is its length-n prefix view."""

    __slots__ = ("keys", "padded", "n", "anchor_keys", "anchor_pos", "eps",
                 "site")

    def __init__(self, padded, anchor_keys, anchor_pos, eps: int,
                 site: str):
        self.padded = padded
        self.keys = padded[:-1]
        self.n = len(padded) - 1
        self.anchor_keys = anchor_keys
        self.anchor_pos = anchor_pos
        self.eps = eps
        self.site = site

    def predict(self, q: np.ndarray) -> np.ndarray:
        """Monotone position prediction (float64; ONE model evaluation
        for the whole query column)."""
        return np.interp(q.astype(np.float64),
                         self.anchor_keys, self.anchor_pos)

    def searchsorted(self, q: np.ndarray, side: str = "left") -> np.ndarray:
        """Exact ``np.searchsorted(self.keys, q, side)`` through the
        model, counted on the site the model was fitted for."""
        pos, n_miss = self.probe(q, side)
        if len(q):
            site_state(self.site).note(len(q), n_miss)
        return pos

    def probe(self, q: np.ndarray, side: str = "left"):
        """-> (exact positions, misses), uncounted: predict ± ε, windowed
        rank count, boundary verify, exact fallback on the misses."""
        n = self.n
        if len(q) == 0:
            return np.zeros(0, np.int64), 0
        p = np.rint(self.predict(q)).astype(np.int64)
        w = self.eps + 1
        lo = np.clip(p - w, 0, n)
        # window gather: keys[lo + j] with an out-of-range sentinel that
        # compares above every real key (keys are < 2**63 by the packing
        # envelope / the uint64 prefix map, so UINT64_MAX is safe)
        idx = lo[:, None] + np.arange(2 * w + 1, dtype=np.int64)
        np.clip(idx, 0, n, out=idx)
        pad = self.padded
        vals = pad[idx]
        qf = q.astype(self.keys.dtype, copy=False)
        qq = qf[:, None]
        if side == "left":
            pos = lo + (vals < qq).sum(axis=1)
        else:
            pos = lo + (vals <= qq).sum(axis=1)
        # boundary verify proves pos == the exact answer: every key below
        # pos is below the query (per side), every key at/after is not
        if side == "left":
            ok = ((pos == 0) | (pad[np.maximum(pos - 1, 0)] < qf)) \
                & ((pos == n) | (pad[np.minimum(pos, n)] >= qf))
        else:
            ok = ((pos == 0) | (pad[np.maximum(pos - 1, 0)] <= qf)) \
                & ((pos == n) | (pad[np.minimum(pos, n)] > qf))
        miss = ~ok
        n_miss = int(miss.sum())
        if n_miss:
            pos[miss] = np.searchsorted(self.keys, qf[miss], side=side)
        return pos, n_miss


def fit_model(keys: np.ndarray, site: str):
    """Fit a model over one sorted, strictly-increasing key column.
    Returns None (caller takes the exact path) when the table is too
    small, not strictly increasing (prefix-collided packed strings), or
    the measured ε exceeds the window budget. Counts the refit on
    `site` when a model is produced."""
    n = len(keys)
    if n < _MIN_KEYS:
        return None
    if keys.dtype not in (np.dtype(np.int64), np.dtype(np.uint64)):
        keys = keys.astype(np.int64)
    # strictly increasing is the exactness precondition for the windowed
    # rank count (duplicate keys would still verify, but a prefix-packed
    # string table with collisions must refuse: packed order != full
    # order there)
    if not bool((keys[1:] > keys[:-1]).all()):
        return None
    S = min(_ANCHORS, n)
    idx = np.linspace(0, n - 1, S).astype(np.int64)
    anchor_keys = keys[idx].astype(np.float64)
    anchor_pos = idx.astype(np.float64)
    # closed-form ε: the exact max |prediction - position| over every
    # table key (one vectorized pass — this IS the online refit cost)
    pred = np.interp(keys.astype(np.float64), anchor_keys, anchor_pos)
    eps = int(np.ceil(np.abs(pred - np.arange(n)).max()))
    if eps > _MAX_EPS:
        return None
    # sentinel-pad ONCE: index n must compare above every real key for
    # both int64 (packing keeps keys >= 0) and uint64 prefix keys
    padded = np.empty(n + 1, keys.dtype)
    padded[:n] = keys
    padded[n] = np.iinfo(keys.dtype).max
    padded.setflags(write=False)
    site_state(site).note_refit(eps)
    return PositionModel(padded, anchor_keys, anchor_pos, eps, site)


# --------------------------------------------------------------------------
# string-keyed tables (actor ids)
# --------------------------------------------------------------------------

def pack_str_keys(values) -> "np.ndarray | None":
    """Order-preserving uint64 keys for a sequence of str/bytes: the
    first 8 bytes, big-endian. Returns None when the values cannot map
    (non-ASCII strings — UTF-8 prefix order would still hold, but numpy
    S-casting refuses; the caller takes the exact path)."""
    try:
        b = np.asarray(values, dtype="S8")
    except (UnicodeEncodeError, ValueError):
        return None
    if b.size == 0:
        return np.zeros(0, np.uint64)
    # itemsize is always 8 for an explicit S8 request; view big-endian
    out = np.ascontiguousarray(b).view(">u8").astype(np.uint64)
    return out.reshape(-1)


def actor_positions(table, queries, site: str, model):
    """Exact positions of ``queries`` within the sorted string ``table``
    via a prefitted ``(packed_keys, model_or_None)`` pair (as
    ``doc_actor_model`` returns): prefix-key probe (model, or packed
    searchsorted for a below-threshold table), then a full-key equality
    gate — a query whose table entry does not match EXACTLY reports not
    found, so prefix collisions can never alias. The probe counts on
    `site`, whatever site the model was fitted for.

    Returns ``(pos int64, found bool)`` or None when `site` is demoted or
    the queries cannot pack (the caller takes its exact path)."""
    st = site_state(site)
    if st.demoted:
        return None
    qk = pack_str_keys(queries)
    if qk is None:
        st.note_exact()
        return None
    tk, m = model
    if m is None:
        pos = np.searchsorted(tk, qk)
        st.note(len(qk), 0)
    else:
        pos, n_miss = m.probe(qk, side="left")
        if len(qk):
            st.note(len(qk), n_miss)
    tbl = np.asarray(table, object)
    if not len(tbl):
        return pos, np.zeros(len(qk), bool)
    safe = np.clip(pos, 0, len(tbl) - 1)
    found = (pos < len(tbl)) & (tbl[safe] == np.asarray(queries, object))
    return pos, found


def doc_actor_model(doc, site: str = "actor_rank"):
    """The per-(doc, intern-gen) packed actor-table model for a probe on
    `site`: cached on the doc, invalidated by the SAME generation token
    that invalidates the rank caches — an interning bump IS the retrain
    trigger. Returns (packed_keys, model_or_None), or None when `site` is
    demoted (checked first, so a demoted site neither refits nor probes)
    or the table cannot pack (model None = small table: packed
    searchsorted, still exact)."""
    if site_state(site).demoted:
        return None
    gen = doc._intern_gen
    cached = getattr(doc, "_learned_actor_model", None)
    if cached is not None and cached[0] == gen:
        return cached[1]
    tk = pack_str_keys(doc.actor_table)
    ent = None
    if tk is not None and (len(tk) < 2 or bool((tk[1:] > tk[:-1]).all())):
        ent = (tk, fit_model(tk, "actor_rank"))
    doc._learned_actor_model = (gen, ent)
    return ent


# --------------------------------------------------------------------------
# observability (amtpu_index_* families + describe block)
# --------------------------------------------------------------------------

def families(prefix: str = "amtpu_index") -> list:
    """Prometheus families over the per-site stats (rendered on
    SyncService.scrape(); validate_prom-clean)."""
    snaps = stats_snapshot()
    counters = (
        ("lookups_total", "lookups",
         "Batched learned-index probe calls per site."),
        ("keys_total", "keys",
         "Keys resolved through the learned path per site."),
        ("model_hits_total", "hits",
         "Keys whose model prediction verified exactly."),
        ("model_misses_total", "misses",
         "Keys that fell back to the exact probe (counted, never "
         "wrong)."),
        ("refits_total", "refits",
         "Model refits (interning-generation bumps / new runs)."),
        ("demotions_total", "demotions",
         "Miss-rate window demotions to the exact path."),
        ("exact_fallbacks_total", "exact_fallbacks",
         "Whole probes routed to the exact path (demoted site or "
         "unmodelable table)."),
        ("wrong_answers_total", "wrong",
         "Audit-mode disagreements with the exact probe (must be 0)."),
    )
    fams = []
    for suffix, field, help_ in counters:
        fams.append((f"{prefix}_{suffix}", "counter", help_,
                     [({"site": name}, snap[field])
                      for name, snap in snaps.items()]))
    fams.append((f"{prefix}_eps", "gauge",
                 "Measured epsilon (verify half-window) of each site's "
                 "most recent fit; -1 before any fit.",
                 [({"site": name}, snap["eps_last"])
                  for name, snap in snaps.items()]))
    fams.append((f"{prefix}_miss_rate", "gauge",
                 "Lifetime model miss rate per site.",
                 [({"site": name}, snap["miss_rate"])
                  for name, snap in snaps.items()]))
    fams.append((f"{prefix}_demoted", "gauge",
                 "1 when the site is currently demoted to the exact "
                 "path (miss-rate window tripped; refit re-arms).",
                 [({"site": name}, int(snap["demoted"]))
                  for name, snap in snaps.items()]))
    return fams


def describe() -> dict:
    """The postmortem block (service describe()): per-site stats plus
    the demotion roster — a failed soak names the site that fell off the
    learned path, not just a latency diff."""
    snaps = stats_snapshot()
    return {
        "schema": "amtpu-learned-index-v1",
        "enabled": True,
        "sites": snaps,
        "demoted_sites": sorted(n for n, s in snaps.items()
                                if s["demoted"]),
    }
