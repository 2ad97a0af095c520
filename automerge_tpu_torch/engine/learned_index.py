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

Sites: ``_intern_batch_actors`` / ``_plan_round``'s actor-rank
resolution (``actor_positions`` over the doc's sorted actor table) and
the ``host_index.BatchRangeIndex`` base-run probe (``fit_model``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["PositionModel", "fit_model", "pack_str_keys",
           "actor_positions", "doc_actor_model"]

#: Tables below this size take the exact probe (binary search over a
#: handful of keys beats any model's fixed overhead).
_MIN_KEYS = 16
#: A fit whose measured ε exceeds this refuses to build: the verify
#: window would gather more than the binary search it replaces.
_MAX_EPS = 64
_ANCHORS = 64


class PositionModel:
    """One fitted piecewise-linear position model over a sorted key
    column (uint64/int64). Immutable — refit builds a new instance.
    ``padded`` is the key column with one trailing sentinel slot
    (dtype max) so the verify gather never branches on the right edge;
    ``keys`` is its length-n prefix view."""

    __slots__ = ("keys", "padded", "n", "anchor_keys", "anchor_pos", "eps")

    def __init__(self, padded, anchor_keys, anchor_pos, eps: int):
        self.padded = padded
        self.keys = padded[:-1]
        self.n = len(padded) - 1
        self.anchor_keys = anchor_keys
        self.anchor_pos = anchor_pos
        self.eps = eps

    def predict(self, q: np.ndarray) -> np.ndarray:
        """Monotone position prediction (float64; ONE model evaluation
        for the whole query column)."""
        return np.interp(q.astype(np.float64),
                         self.anchor_keys, self.anchor_pos)

    def searchsorted(self, q: np.ndarray, side: str = "left") -> np.ndarray:
        """Exact ``np.searchsorted(self.keys, q, side)`` through the
        model: predict ± ε, windowed rank count, boundary verify, exact
        fallback on the misses."""
        n = self.n
        if len(q) == 0:
            return np.zeros(0, np.int64)
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
        if miss.any():
            pos[miss] = np.searchsorted(self.keys, qf[miss], side=side)
        return pos


def fit_model(keys: np.ndarray):
    """Fit a model over one sorted, strictly-increasing key column.
    Returns None (caller takes the exact path) when the table is too
    small, not strictly increasing (prefix-collided packed strings), or
    the measured ε exceeds the window budget."""
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
    return PositionModel(padded, anchor_keys, anchor_pos, eps)


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


def actor_positions(table, queries, model):
    """Exact positions of ``queries`` within the sorted string ``table``
    via ``doc_actor_model``'s prefitted ``(packed_keys, model_or_None)``
    pair: prefix-key probe (model, or packed searchsorted for a
    below-threshold table), then a full-key equality gate — a query
    whose table entry does not match EXACTLY reports not found, so prefix
    collisions can never alias.

    Returns ``(pos int64, found bool)`` or None for unpackable queries
    (the caller takes its exact path)."""
    qk = pack_str_keys(queries)
    if qk is None:
        return None
    tk, m = model
    pos = (np.searchsorted(tk, qk) if m is None
           else m.searchsorted(qk, side="left"))
    tbl = np.asarray(table, object)
    if not len(tbl):
        return pos, np.zeros(len(qk), bool)
    safe = np.clip(pos, 0, len(tbl) - 1)
    found = (pos < len(tbl)) & (tbl[safe] == np.asarray(queries, object))
    return pos, found


def doc_actor_model(doc):
    """The per-(doc, intern-gen) packed actor-table model: cached on the
    doc, invalidated by the SAME generation token that invalidates the
    rank caches — an interning bump IS the retrain trigger. Returns
    (packed_keys, model_or_None) or None when the table cannot pack
    (model None = small table: packed searchsorted, still exact)."""
    gen = doc._intern_gen
    cached = getattr(doc, "_learned_actor_model", None)
    if cached is not None and cached[0] == gen:
        return cached[1]
    tk = pack_str_keys(doc.actor_table)
    ent = None
    if tk is not None and (len(tk) < 2 or bool((tk[1:] > tk[:-1]).all())):
        ent = (tk, fit_model(tk))
    doc._learned_actor_model = (gen, ent)
    return ent
