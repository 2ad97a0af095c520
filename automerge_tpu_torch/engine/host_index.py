"""Host-side elemId -> device-slot index, compressed as counter ranges.

The reference resolves elemId references through per-object Immutable.js maps
(`_insertion`, reference backend/op_set.js:95-98,461-470). The device
engine instead keeps element *tables* on the TPU and resolves references on
the host, where the op columns originate anyway. Two facts make this cheap:

- elemIds minted by one actor have consecutive counters within a typing run,
  and runs land in consecutive device slots, so the index stores *ranges*
  ((actor, ctr0) .. +len -> slot0 .. +len), not individual elements;
- lookups are numpy ``searchsorted`` over packed range starts — C-speed
  binary search, no device round trip, no int64 emulation on the TPU (int64
  sorts/searches run emulated and severalfold slower than int32 on v5e;
  design assumption, docs/MEASUREMENTS.md).

Keys pack as (actor_rank << 32 | ctr); counters stay < 2^31 so keys within a
range are consecutive integers and slot arithmetic is a subtraction.

The structure is :class:`BatchRangeIndex` (INTERNALS §16.2), Jiffy-style
batch-update tiers: a round's minted ranges land as ONE immutable sorted
run appended to a small tier list, with amortized size-doubling
compaction; every instance is persistent (``merge``/``remap_actors``
return NEW indexes, nothing published is ever written again), so readers
take zero-coordination O(1) snapshots (``snapshot()`` is ``self``) that
can never observe a torn merge. Per-round cost is O(K log K + K log R)
instead of a sorted-insert array's O(R) whole-array copy; the index grows
with document lifetime, the round's ranges do not. The flattened view
coalesces key- and slot-contiguous neighbors, so its rows match the JAX
package's index rows byte for byte.
"""

from __future__ import annotations


import numpy as np

from .._common import check_int32_envelope
from .. import obs
from . import learned_index as _learned

#: Below this many ranges in the base run, ``lookup_learned`` skips the
#: model-fit attempt outright: a binary search over a handful of ranges
#: is already cheaper than any model's fixed probe cost.
_MIN_MODEL_RANGES = 8


def pack_keys(actor: np.ndarray, ctr: np.ndarray) -> np.ndarray:
    """(actor_rank, ctr) -> packed int64 key. Loud on envelope overflow:
    a ctr or rank past 2^31-1 (or negative) would corrupt the packing —
    adjacent keys would collide or reorder — instead of failing, so the
    guard raises OverflowError before any key escapes (VERDICT r5 item 3;
    tests/test_int32_guards.py)."""
    check_int32_envelope("elemId counter", ctr)
    check_int32_envelope("actor rank", actor)
    return (actor.astype(np.int64) << 32) | ctr.astype(np.int64)


def unpack_key(key: int) -> tuple:
    """packed key -> (actor_rank, ctr)."""
    return key >> 32, key & 0xFFFFFFFF


class DuplicateElemId(ValueError):
    """An inserted elemId overlaps an existing one (`key` is packed).

    The engine decodes `key` against its actor table for the user-facing
    message (the reference's duplicate-insertion inconsistency check,
    op_set.js applyInsert)."""

    def __init__(self, key: int):
        super().__init__("Duplicate list element ID")
        self.key = key


def _sort_new(starts, lens, slots):
    """Sort one merge call's ranges by start (stable) and validate the
    within-call overlap; int64 working copies."""
    new_starts = np.asarray(starts, np.int64)
    new_lens = np.asarray(lens, np.int64)
    new_slots = np.asarray(slots, np.int64)
    if len(new_starts) > 1:
        order = np.argsort(new_starts, kind="stable")
        new_starts = new_starts[order]
        new_lens = new_lens[order]
        new_slots = new_slots[order]
        ends = new_starts + new_lens
        bad = np.flatnonzero(ends[:-1] > new_starts[1:])
        if len(bad):
            raise DuplicateElemId(int(new_starts[bad[0] + 1]))
    return new_starts, new_lens, new_slots


def _coalesce(starts, lens, slots):
    """Coalesce key- AND slot-contiguous neighbors of one sorted,
    non-overlapping run."""
    if len(starts) > 1:
        ends = starts + lens
        joined = (ends[:-1] == starts[1:]) & \
                 (slots[:-1] + lens[:-1] == slots[1:])
        if joined.any():
            head = np.concatenate([[True], ~joined])
            group = np.cumsum(head) - 1
            n = int(group[-1]) + 1
            g_start = starts[head]
            g_slot = slots[head]
            g_len = np.zeros(n, np.int64)
            np.add.at(g_len, group, lens)
            starts, lens, slots = g_start, g_len, g_slot
    return starts, lens, slots


def _merge_runs(a, b):
    """Merge two sorted disjoint runs into one (stable by start; equal
    starts cannot occur — runs are key-disjoint), coalescing neighbors."""
    starts = np.concatenate([a[0], b[0]])
    lens = np.concatenate([a[1], b[1]])
    slots = np.concatenate([a[2], b[2]])
    order = np.argsort(starts, kind="stable")
    return _coalesce(starts[order], lens[order], slots[order])


def _slot_to_key(view, slots):
    """Reverse-lookup body over a (slots, lens, starts) slot-sorted
    view."""
    s_slots, s_lens, s_starts = view
    slots = np.asarray(slots, np.int64)
    pos = np.searchsorted(s_slots, slots, side="right") - 1
    safe = np.clip(pos, 0, None)
    ok = (pos >= 0) & (slots < s_slots[safe] + s_lens[safe])
    if not ok.all():
        raise KeyError(
            f"slot {int(slots[np.flatnonzero(~ok)[0]])} not in index")
    key = s_starts[safe] + (slots - s_slots[safe])
    return key >> 32, key & 0xFFFFFFFF


class BatchRangeIndex:
    """Tiered batch-update range index with O(1) persistent snapshots.

    Jiffy's batch-update + O(1)-snapshot discipline (PAPERS.md) applied
    to the range map: a ``merge`` call lands the whole round's minted
    ranges as ONE immutable sorted run appended to a small tier tuple,
    validated against the existing tiers by binary-search probes
    (O(K log K + K·T·log R), T = tier count) — never by rewriting the
    resident O(R) array. Amortized size-doubling compaction (merge the
    newest run into its predecessor while it is at least as long) bounds
    the tier count at O(log R) and total compaction work at O(R log R)
    over a document's lifetime.

    Persistence is the memory model: every ``merge``/``remap_actors``
    returns a NEW index whose runs are frozen numpy arrays shared with
    the parent where unchanged; NOTHING reachable from a published index
    is ever written again. ``snapshot()`` is therefore ``self`` — a
    checkpoint grab, a pull, or the stacked gather can take it with zero
    coordination while another thread merges, and can never observe a
    torn state (tests/test_batch_index.py pins this under 8 threads).
    """

    __slots__ = ("_runs", "n_ranges", "_flat", "_slot_view", "_model")

    _COMPACT_TIERS = 12   # hard lid on tier count (lookup cost bound);
    # the doubling rule keeps real documents far below it

    def __init__(self):
        self._runs = ()        # tuple of (starts, lens, slots) sorted runs
        self.n_ranges = 0      # total ranges across runs (pre-coalesce)
        self._flat = None      # lazy flattened+coalesced view
        self._slot_view = None
        self._model = None     # lazy learned model over the base run;
        # inherited across merges while runs[0] is identity-preserved
        # (engine/learned_index.py)

    @classmethod
    def from_rows(cls, starts, lens, slots) -> "BatchRangeIndex":
        out = cls()
        run = (np.asarray(starts, np.int64), np.asarray(lens, np.int64),
               np.asarray(slots, np.int64))
        if len(run[0]):
            out._runs = (run,)
            out.n_ranges = len(run[0])
            out._flat = run
        return out

    # -- flattened view ---------------------------------------------------

    def _flatten(self) -> tuple:
        flat = self._flat
        if flat is None:
            if not self._runs:
                flat = (np.empty(0, np.int64), np.empty(0, np.int64),
                        np.empty(0, np.int64))
            else:
                flat = self._runs[0]
                for run in self._runs[1:]:
                    flat = _merge_runs(flat, run)
            self._flat = flat
        return flat

    @property
    def starts(self) -> np.ndarray:
        return self._flatten()[0]

    @property
    def lens(self) -> np.ndarray:
        return self._flatten()[1]

    @property
    def slots(self) -> np.ndarray:
        return self._flatten()[2]

    def rows(self) -> tuple:
        """Flattened, coalesced (starts, lens, slots) view."""
        return self._flatten()

    def snapshot(self) -> "BatchRangeIndex":
        """O(1), zero-coordination: the index is persistent, so the
        instance IS its own immutable snapshot."""
        return self

    # -- batch update ----------------------------------------------------

    def _check_overlap(self, new_starts, new_lens):
        """Raise DuplicateElemId when any new range overlaps a resident
        one. Probe-based (O(K log R) per tier); the offending key matches
        a sorted-insert merge's report: the later range's start in the
        merged order (new-before-old on equal starts, so an exact
        collision reports the OLD start — both carry the same key half
        anyway)."""
        new_ends = new_starts + new_lens
        worst = None
        for starts, lens, _slots in self._runs:
            # (a) a new range starting inside a resident range
            pos = np.searchsorted(starts, new_starts, side="right") - 1
            safe = np.clip(pos, 0, None)
            inside = (pos >= 0) & (new_starts < starts[safe] + lens[safe])
            if inside.any():
                k = int(new_starts[np.flatnonzero(inside)[0]])
                worst = k if worst is None else min(worst, k)
            # (b) a resident range starting inside a new range (strictly
            # after its start — case (a) covered equality)
            lo = np.searchsorted(starts, new_starts, side="right")
            safe = np.clip(lo, 0, len(starts) - 1)
            hit = (lo < len(starts)) & (starts[safe] < new_ends)
            if hit.any():
                k = int(starts[safe[np.flatnonzero(hit)[0]]])
                worst = k if worst is None else min(worst, k)
        if worst is not None:
            raise DuplicateElemId(worst)

    def merge(self, starts: np.ndarray, lens: np.ndarray,
              slots: np.ndarray) -> "BatchRangeIndex":
        """One bulk batch-update: the whole round's ranges land as one
        immutable run. Returns the NEW index (persistent); raises
        DuplicateElemId on any key overlap, leaving every published
        index untouched."""
        if len(starts) == 0:
            return self
        _t0 = obs.now() if obs.ENABLED else 0
        new_run = _sort_new(starts, lens, slots)
        self._check_overlap(new_run[0], new_run[1])
        runs = list(self._runs)
        runs.append(_coalesce(*new_run))
        # amortized doubling compaction: merge the newest run downward
        # while it has grown at least as long as its predecessor
        while len(runs) > 1 and (
                len(runs[-1][0]) >= len(runs[-2][0])
                or len(runs) > self._COMPACT_TIERS):
            b = runs.pop()
            a = runs.pop()
            runs.append(_merge_runs(a, b))
        for run in runs:
            for arr in run:
                arr.setflags(write=False)
        out = BatchRangeIndex()
        out._runs = tuple(runs)
        out.n_ranges = sum(len(r[0]) for r in runs)
        if len(runs) == 1:
            out._flat = runs[0]
        # the learned base-run model survives every merge that leaves
        # runs[0] untouched (the common case under doubling compaction);
        # a compaction that reaches the base invalidates it — the next
        # learned probe refits
        if self._runs and runs[0][0] is self._runs[0][0]:
            out._model = self._model
        if obs.ENABLED:
            obs.span("plan", "index_merge", _t0, args={
                "structure": "batch_tiers", "n_new": len(new_run[0]),
                "n_tiers": len(runs), "n_ranges": out.n_ranges})
        return out

    # -- reads -----------------------------------------------------------

    def scalar_affine(self, keys: np.ndarray):
        """The ε=0 degenerate model, evaluated in scalars: when the
        index has coalesced to ONE affine range (append-only steady
        state) and the query column is narrower than vector width,
        numpy's per-call fixed cost exceeds the arithmetic — the model
        evaluation is three int ops per key. Returns (slots, found)
        python lists, or None when the index is not a single range
        (caller falls through to the vectorized probe)."""
        runs = self._runs
        if len(runs) != 1 or len(runs[0][0]) != 1:
            return None
        starts, lens, slots_r = runs[0]
        s0 = int(starts[0])
        l0 = int(lens[0])
        z0 = int(slots_r[0])
        slots = []
        found = []
        for k in keys.tolist():
            off = k - s0
            hit = 0 <= off < l0
            found.append(hit)
            slots.append(z0 + off if hit else 0)
        return slots, found

    def lookup_learned(self, keys: np.ndarray):
        """-> (slots int64, found bool) for packed query keys. One probe
        per tier; a key lives in at most one tier (ranges are globally
        disjoint), so the per-tier hits combine by masked select. The
        base-run probe goes through the learned position model: the
        model predicts the range position ± ε and the windowed verify
        makes it exact, with exact fallback on miss. Tail tiers (small,
        freshly merged runs) probe exactly; the base run is where the
        document's lifetime of ranges lives, so it is where the binary
        search depth was."""
        runs = self._runs
        n = len(keys)
        if len(runs) == 1:
            starts, lens, slots_r = runs[0]
            if len(starts) == 1:
                # the ε=0 degenerate model: an append-only document's
                # index coalesces to ONE affine range (slot = key −
                # start + slot0), so predict + verify collapses to a
                # single window compare — this is the steady state the
                # RocksDB learned-index result predicts for
                # append-mostly key distributions, and the hot shape of
                # the serving bench
                off = keys - starts[0]
                hit = (off >= 0) & (off < lens[0])
                return np.where(hit, slots_r[0] + off, 0), hit
        slot = np.zeros(n, np.int64)
        found = np.zeros(n, bool)
        first = True
        for starts, lens, slots_r in runs:
            if first:
                first = False
                if len(starts) >= _MIN_MODEL_RANGES:
                    ent = self._model
                    if ent is None or ent[0] is not starts:
                        # (source array, model | None): a refused fit is
                        # cached too, not re-attempted per probe
                        ent = (starts, _learned.fit_model(starts))
                        self._model = ent
                    m = ent[1]
                else:
                    m = None
                if m is not None:
                    pos = m.searchsorted(keys, side="right") - 1
                else:
                    pos = np.searchsorted(starts, keys, side="right") - 1
            else:
                pos = np.searchsorted(starts, keys, side="right") - 1
            safe = np.clip(pos, 0, None)
            hit = (pos >= 0) & (keys < starts[safe] + lens[safe])
            if hit.any():
                slot = np.where(hit, slots_r[safe] + (keys - starts[safe]),
                                slot)
                found |= hit
        return slot, found

    def slot_to_key(self, slots: np.ndarray):
        """Reverse lookup over the flattened slot-sorted view (cached —
        instances are immutable)."""
        view = self._slot_view
        if view is None:
            f_starts, f_lens, f_slots = self._flatten()
            order = np.argsort(f_slots, kind="stable")
            view = (f_slots[order], f_lens[order], f_starts[order])
            self._slot_view = view
        return _slot_to_key(view, slots)

    def remap_actors(self, remap: np.ndarray) -> "BatchRangeIndex":
        """Re-rank the actor halves after an interning order change.
        Pure: returns a NEW index; the receiver (and every outstanding
        snapshot of it) is untouched."""
        if not self._runs:
            return self
        runs = []
        for starts, lens, slots_r in self._runs:
            actor = (starts >> 32).astype(np.int64)
            ctr = starts & 0xFFFFFFFF
            new_starts = (remap[actor].astype(np.int64) << 32) | ctr
            order = np.argsort(new_starts, kind="stable")
            run = (new_starts[order], lens[order], slots_r[order])
            for arr in run:
                arr.setflags(write=False)
            runs.append(run)
        out = BatchRangeIndex()
        out._runs = tuple(runs)
        out.n_ranges = self.n_ranges
        return out
