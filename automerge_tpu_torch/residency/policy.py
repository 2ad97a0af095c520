"""Eviction policy for the residency manager: which resident doc leaves
the device when the budget needs room.

Two scorers share one contract — ``score(doc_id, now_round)`` returns a
number where HIGHER means "safer to evict":

- **lru**: score = rounds since last touch (ties broken toward fewer
  lifetime ops). The classic baseline, kept as the comparator.
- **learned** (default): a cheap learned working-set model in the
  RocksDB learned-index spirit (PAPERS.md): instead of one global
  recency order, each doc carries an EWMA of its own inter-touch gap —
  its serving *rhythm* — seeded for cold-start docs by a 2-parameter
  online regression of log(gap) on log(1 + touches) fit across the
  whole population (closed-form normal equations, O(1) per touch, no
  training loop, no dependency). The score is ``age / predicted_gap``:
  a doc touched every 50 rounds and last seen 5 rounds ago scores 0.1
  and survives, while a doc with a 1-round rhythm that went quiet 5
  rounds ago scores 5.0 and leaves — exactly the inversion plain LRU
  gets wrong for mixed-rhythm populations (pinned in
  tests/test_torch_residency.py).

Pressure ordering reads the SAME telemetry windows the rebalance policy
reads (``shard`` / ``lane<i>_admitted_ops``, `shard/rebalance.py`):
`lane_pressure` ranks lanes by recent window load so budget-aware
placement can prefer quiet, empty lanes without new bookkeeping.
"""

from __future__ import annotations

import math


class ResidencyConfig:
    """Residency knobs (bounded-everything, like ServiceConfig)."""

    __slots__ = ("budget_bytes", "headroom", "cold_after", "spill_dir",
                 "eviction", "prefetch", "reserve_margin")

    def __init__(self, budget_bytes: int = 0, headroom: float = 0.85,
                 cold_after: int = 64, spill_dir: str = None,
                 eviction: str = "learned", prefetch: bool = True,
                 reserve_margin: float = 1.0):
        if eviction not in ("learned", "lru"):
            raise ValueError(f"unknown eviction policy {eviction!r}")
        #: device budget in bytes over the WHOLE mesh (0 = unbounded:
        #: the manager still tiers and meters, but never evicts)
        self.budget_bytes = int(budget_bytes)
        #: when a reservation breaches the budget, evict down to
        #: headroom * budget — hysteresis so every round doesn't evict
        self.headroom = float(headroom)
        #: warm bundles untouched for this many pager rounds age to disk
        self.cold_after = int(cold_after)
        self.spill_dir = spill_dir
        self.eviction = eviction
        #: a router park is a paging hint: prefetch the parked doc
        self.prefetch = bool(prefetch)
        #: reservation multiplier for docs whose size is only estimated
        self.reserve_margin = float(reserve_margin)


class WorkingSetModel:
    """Per-doc inter-touch rhythm + global learned cold-start prior."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self._gap: dict = {}        # doc_id -> EWMA inter-touch gap
        self._last: dict = {}       # doc_id -> last touch round
        self._touches: dict = {}    # doc_id -> lifetime touch count
        # online least squares for log(gap) ~ w0 + w1 * log(1+touches):
        # running sums are the whole model state (closed-form solve)
        self._n = 0
        self._sx = self._sy = self._sxx = self._sxy = 0.0

    def note_touch(self, doc_id: str, now_round: int):
        last = self._last.get(doc_id)
        self._last[doc_id] = now_round
        touches = self._touches.get(doc_id, 0) + 1
        self._touches[doc_id] = touches
        if last is None:
            return
        gap = max(1, now_round - last)
        prev = self._gap.get(doc_id)
        self._gap[doc_id] = gap if prev is None else \
            (1 - self.alpha) * prev + self.alpha * gap
        x = math.log1p(touches)
        y = math.log(gap)
        self._n += 1
        self._sx += x
        self._sy += y
        self._sxx += x * x
        self._sxy += x * y

    def _prior_gap(self, doc_id: str) -> float:
        """Cold-start gap from the global fit (population mean when the
        regression is degenerate)."""
        if self._n < 2:
            return 1.0
        det = self._n * self._sxx - self._sx * self._sx
        if abs(det) < 1e-9:
            return math.exp(self._sy / self._n)
        w1 = (self._n * self._sxy - self._sx * self._sy) / det
        w0 = (self._sy - w1 * self._sx) / self._n
        x = math.log1p(self._touches.get(doc_id, 0))
        return max(1.0, math.exp(w0 + w1 * x))

    def predicted_gap(self, doc_id: str) -> float:
        gap = self._gap.get(doc_id)
        return gap if gap is not None else self._prior_gap(doc_id)

    def score(self, doc_id: str, now_round: int) -> float:
        """Normalized age: rounds-since-touch in units of the doc's own
        predicted rhythm. Higher = further past its working set."""
        age = now_round - self._last.get(doc_id, 0)
        return age / max(1.0, self.predicted_gap(doc_id))

    def forget(self, doc_id: str):
        """Drop per-doc state (the doc left the population entirely);
        the global fit keeps its observations — they were real."""
        self._gap.pop(doc_id, None)
        self._last.pop(doc_id, None)
        self._touches.pop(doc_id, None)

    def describe(self) -> dict:
        return {"kind": "learned", "tracked_docs": len(self._last),
                "fitted_gaps": self._n}


class LruModel:
    """The comparator heuristic: plain recency, ops as the tiebreak."""

    def __init__(self):
        self._last: dict = {}
        self._ops: dict = {}

    def note_touch(self, doc_id: str, now_round: int, n_ops: int = 1):
        self._last[doc_id] = now_round
        self._ops[doc_id] = self._ops.get(doc_id, 0) + n_ops

    def score(self, doc_id: str, now_round: int) -> float:
        age = now_round - self._last.get(doc_id, 0)
        # fewer lifetime ops nudges the score up (evict the quiet one
        # first among equally stale docs); bounded to never outweigh a
        # full round of age
        return age + 1.0 / (2.0 + self._ops.get(doc_id, 0))

    def forget(self, doc_id: str):
        self._last.pop(doc_id, None)
        self._ops.pop(doc_id, None)

    def describe(self) -> dict:
        return {"kind": "lru", "tracked_docs": len(self._last)}


def make_model(kind: str):
    return WorkingSetModel() if kind == "learned" else LruModel()


def lane_pressure(telemetry, lanes) -> list:
    """Per-lane admitted-ops totals over the retained telemetry windows
    — the SAME signal `shard/rebalance.py` reads; the page-in placement
    tiebreak (quietest lane wins among equally light ones)."""
    return [sum(v for _, v in telemetry.series(
                "shard", f"lane{lane.index}_admitted_ops"))
            for lane in lanes]
