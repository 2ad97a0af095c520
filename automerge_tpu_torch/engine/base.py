"""Shared machinery for device-resident CRDT documents.

Both device engines (text/list: `text_doc.py`, map/counter: `map_doc.py`)
share the host-side orchestration the reference implements per-op in
`backend/op_set.js`:

- causal admission: changes schedule into causally-ready rounds against a
  host vector clock, with queueing of unready changes and idempotent
  duplicate skips (`applyQueuedOps`/`causallyReady`,
  reference backend/op_set.js:20-27,329-345)
- order-preserving actor interning: actor-id strings map to dense ranks in
  lexicographic order, so int32 comparisons on device reproduce the
  reference's string tie-breaks (op_set.js:245,432-436)
- the slow register path: multi-writer LWW registers, counter increments,
  and deletions resolve on the host against the conflict/value-pool state
  (`applyAssign`, op_set.js:196-258) — the device flags them, the host
  resolves, one scatter writes the winners back.

Subclasses implement `_ingest(batch, mask)` (one causally-ready round ->
device programs) and `_remap_device(remap)` (re-rank actor columns after an
interning order change).

This is the PyTorch counterpart of `automerge_tpu/engine/base.py`: the host
orchestration is the same code, and the device seams (the prepare barrier,
the slow-register writeback, the mirror fetch) run on torch tensors on the
document's `device`. Rounds run out of place unless `donate_buffers` is
set; then they write into the live tables' storage (`_inplace_store`,
ops/ingest.py `TableStore`), the port's form of the JAX package's buffer
donation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .._common import KIND_DEL, KIND_INC, KIND_SET
from .. import obs
from . import accounting
from . import learned_index

import threading


def resolve_device(device=None) -> torch.device:
    """The device a document lives on: `None` means the CUDA card. Without
    a card the engine raises instead of running on the CPU; pass
    ``device="cpu"`` to run the plain PyTorch versions there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "automerge_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the engine on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class _GroupedRound(list):
    """A causally-ready round already in grouped-column form: a list of
    ``(batch, rows_arr, mask)`` triples (the shape `_group_round`
    produces), emitted directly by the columnar scheduler so no
    per-change ``(batch, row)`` tuples ever materialize on the planning
    hot path. `_group_round` passes instances through untouched."""

    __slots__ = ()


def _round_row_pairs(ready) -> set:
    """(actor, seq) pairs of one round, either representation."""
    if isinstance(ready, _GroupedRound):
        out: set = set()
        for b, rows_arr, _ in ready:
            actors = b.actors
            seqs = b.seqs
            out.update((actors[r], int(seqs[r])) for r in rows_arr.tolist())
        return out
    return {(b.actors[r], int(b.seqs[r])) for b, r in ready}

# thread-local accounting region: commit_prepared opens one so its
# per-batch delta counts ONLY the commit's own device interactions — a
# pipeline worker's concurrent prepare barriers on the same document
# must not bleed into the committed batch's budget
_ACCT_TLS = threading.local()


@dataclass
class PreparedBatch:
    """A batch planned + staged against a document's current state.

    Produced by `CausalDeviceDoc.prepare_batch`, consumed exactly once by
    `commit_prepared`. Holds the admission plan (causal rounds) and each
    round's staged device inputs, so the commit path is pure bookkeeping +
    kernel dispatch — all host->device byte movement already happened.
    This is the engine's ingestion pipelining seam: prepare batch k+1
    (host planning + transfers) while the device still executes batch k.

    A plan prepared with `after=` (a pending, not-yet-committed base plan)
    is CHAINED: it was planned against the base plan's post-commit shadow
    state, carries `after`, and commits only when the base plan committed
    and nothing else mutated the document since (committed_gen check) —
    the seam `engine/pipeline.PipelinedIngestor` uses to plan batch k+1
    on a background thread while batch k commits."""

    gen: Optional[int]        # document generation the plan is valid for
    rounds: list              # [(batch, rows_arr, book, exec_plan), ...]
    #   book = ([(actor, seq), ...], [allDeps closure, ...]) per round group
    queue_after: list         # queue state once the batch is admitted
    prior_queue: list         # queue state to restore on failure
    memo_overlay: dict        # closure-memo entries minted while planning
    n_staged_bytes: int       # total bytes shipped host->device at prepare
    after: Optional["PreparedBatch"] = None  # chained base plan (pending)
    final_shadow: Optional[tuple] = None     # shadow state post this plan
    clock_after: dict = field(default_factory=dict)  # clock post this plan
    deps_overlay: dict = field(default_factory=dict)  # (actor, seq)->closure
    committed_gen: Optional[int] = None      # _gen right after commit


def transitive_closure(all_deps: dict, actor: str, seq: int,
                       deps: dict) -> dict:
    """allDeps of a change: its explicit deps plus its own predecessor,
    closed transitively over the (actor, seq) -> clock map (the reference's
    `transitiveDeps`, reference backend/op_set.js:29-37)."""
    base = dict(deps)
    if seq > 1:
        base[actor] = seq - 1
    out: dict = {}
    for dep_actor, dep_seq in base.items():
        if dep_seq <= 0:
            continue
        transitive = all_deps.get((dep_actor, dep_seq))
        if transitive:
            for a, s in transitive.items():
                if s > out.get(a, 0):
                    out[a] = s
        out[dep_actor] = dep_seq
    return out


# batches below this use the per-change admission loop: the numpy column
# setup costs more than the walk at small sizes (tests monkeypatch it to
# force either path for parity pinning)
_BULK_SCHEDULE_MIN = 64


class CausalDeviceDoc:
    """Base: causal batch admission + registers + actor interning."""

    batch_type = None  # subclass: columnar batch class (has .from_changes)

    # `donate_buffers` selects the in-place rounds (ops/ingest.py
    # `TableStore`, the round programs' `store=`), on a card and on the
    # CPU alike: each commit writes into the live tables' storage, so a
    # pipeline ring's device allocation stays flat instead of holding a
    # new table set per commit. A table tensor taken from `_dev` before an
    # in-place commit sees the commit's writes. A commit that raises after
    # its first in-place write leaves no valid table state: the document
    # is then lost (`_check_device_alive`). `packed_residual_writeback`
    # ships the host slow-register resolution back as ONE (6, S) matrix
    # instead of six per-column arrays (one h2d transfer; the per-column
    # path is its comparator).
    donate_buffers = False
    packed_residual_writeback = True

    _TABLE_KEYS: tuple = ()      # subclass: the device tables, in order
    _TABLE_FILLS: tuple = ()     # and their padding fills

    def __init__(self, obj_id: str, device=None):
        self.obj_id = obj_id
        self.device = resolve_device(device)
        self.actor_table: list = []           # rank -> actor id (lex-ordered)
        self._actor_rank: dict = {}
        self.clock: dict = {}                 # actor id -> seq
        self._all_deps: dict = {}             # (actor, seq) -> allDeps dict
        self._closure_memo: dict = {}         # frozen base deps -> allDeps
        self.queue: list = []                 # (batch, row) not causally ready
        self.conflicts: dict = {}             # slot -> extra surviving ops
        self.value_pool: list = []            # rich values (non-inline)
        self._dev: Optional[dict] = None      # device arrays (lazy)
        self._host: Optional[dict] = None     # numpy mirrors (lazy)
        self._store = None                    # TableStore of the in-place
        # rounds (its views are `_dev` while they write in place)
        self._device_lost = False             # an in-place commit raised
        # after its first write: no valid table state remains, so every
        # later access fails loudly (_check_device_alive)
        # prepares stage their inputs on this stream, so that a prepare
        # never waits for the commits running on the compute stream
        self._stage_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)
        self._acct = {"dispatches": 0, "syncs": 0,
                      "h2d_bytes": 0, "d2h_bytes": 0}  # device-interaction
        # counters (engine/accounting.py): every jitted program launch,
        # every blocking d2h sync, and the exact staged bytes each way
        # this document performs
        self.last_commit_stats: Optional[dict] = None  # delta of the most
        # recent commit_prepared (the pipeline ring's per-batch budget)
        self._gen = 0                         # bumps on every state mutation
        self._intern_gen = 0                  # bumps when the actor table /
        # rank mapping changes: the validity token of every batch-level
        # rank cache (wire_columns.ColumnarChangeBatch.rank_cache)
        self._busy = 0                        # >0 while a mutation is in
        # flight: generation stamps alone cannot expose a mutation that
        # SPANS an observer's whole read (the gen bump lands at the end),
        # so content-mutating entry points raise this first and drop it
        # last — the checkpoint writer's optimistic grab treats any
        # nonzero observation as a conflict (checkpoint/engine_codec)

    def _check_device_alive(self):
        """The gate every `_ensure_dev` passes: after an in-place commit
        raised past its first write there is no valid table state, and
        resurrecting empty tables would be silent corruption."""
        if self._device_lost:
            raise RuntimeError(
                f"device state of {self.obj_id!r} was lost: a commit with "
                "in-place tables (donate_buffers) failed after its first "
                "write. Rebuild the document from its change log")

    def _lose_device(self):
        """Mark the tables lost (an in-place write happened before a
        failure) and drop every cache derived from them."""
        self._device_lost = True
        self._dev = None
        self._store = None
        self._invalidate()

    def _inplace_store(self, out_cap: int):
        """The TableStore the in-place rounds write into, holding the live
        tables. When the tables are not its views (a fresh document, or
        tables an out-of-place program replaced) they are packed into a
        new store at max(capacity, out_cap): one allocation and copy."""
        from ..ops.ingest import TableStore
        dev = self._ensure_dev()
        st = self._store
        if st is None or not st.holds(dev):
            st = TableStore(self._TABLE_KEYS, self._TABLE_FILLS, dev,
                            max(self._cap, out_cap))
            self._store = st
            self._dev = dict(st.views)
        return st

    def _to_dev(self, arr) -> torch.Tensor:
        """A small host array -> tensor on the document's device (a
        synchronous copy; bulk plan inputs go through `_stage`)."""
        return torch.as_tensor(np.asarray(arr), device=self.device)

    # ------------------------------------------------------------------
    # dispatch/sync accounting (engine/accounting.py; INTERNALS §9)
    # ------------------------------------------------------------------

    def _count_dispatch(self, n: int = 1, label: str = None):
        accounting.record_dispatch(n, self._acct, label=label)
        region = getattr(_ACCT_TLS, "region", None)
        if region is not None:
            region["dispatches"] += n

    def _count_sync(self, n: int = 1, label: str = None, dur_ns: int = 0,
                    d2h_bytes: int = 0):
        accounting.record_sync(n, self._acct, label=label, dur_ns=dur_ns,
                               d2h_bytes=d2h_bytes)
        region = getattr(_ACCT_TLS, "region", None)
        if region is not None:
            region["syncs"] += n

    def _count_h2d(self, nbytes: int):
        accounting.record_h2d(nbytes, self._acct)

    # ------------------------------------------------------------------
    # device-resident footprint
    # ------------------------------------------------------------------

    def device_footprint(self) -> dict:
        """Device-resident bytes of this document — never a device sync.
        `table_bytes` is dtype x shape over the live engine tables;
        `storage_bytes` the distinct storages they sit in
        (`untyped_storage().nbytes()`: an in-place document's tables are
        rows of one buffer per dtype, an out-of-place round's outputs
        views of its scatter buffer), which is what the device holds;
        `device_bytes` adds the subclass extras to it. Host-side
        companion state (index ranges, value pool, conflicts) rides
        along as counts."""
        table_bytes = 0
        n_tables = 0
        storages = {}
        if self._dev is not None:
            for arr in self._dev.values():
                table_bytes += arr.numel() * arr.element_size()
                n_tables += 1
                st = arr.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
        storage_bytes = sum(storages.values())
        extra = self._device_footprint_extra()
        return {
            "device_bytes": storage_bytes + extra,
            "table_bytes": table_bytes,
            "storage_bytes": storage_bytes,
            "n_tables": n_tables,
            "extra_bytes": extra,
            "host": {"value_pool": len(self.value_pool),
                     "conflicts": len(self.conflicts),
                     **self._host_footprint_extra()},
        }

    def _device_footprint_extra(self) -> int:
        """Subclass hook: device bytes held OUTSIDE the table dict
        (staged scalars, cached materializations)."""
        return 0

    def _host_footprint_extra(self) -> dict:
        return {}

    def _note_footprint(self):
        """Feed this doc's device-resident bytes to the device-truth
        gauges at a commit boundary (obs/device_truth.py peaks + prom
        families)."""
        from ..obs import device_truth
        if device_truth.ENABLED:
            device_truth.REGISTRY.note_footprint(
                "doc", self.obj_id, self.device_footprint()["device_bytes"])

    def compact_tables(self) -> int:
        """Copy the live tables into storage of their own — one buffer
        per dtype whose rows are the tables — when their storages hold
        more than the tables. Every commit ends with it, so between
        commits a doc holds exactly its tables, the bytes the residency
        budget counts: an out-of-place round leaves its outputs as rows of
        a wider scatter buffer (bool tables staged as int32 rows, a
        scratch column), while a stacked apply already hands each doc
        tables of its own (`ops.ingest.unstack_rows`). Returns the bytes
        released. A no-op for a doc writing in place (its store's buffers
        are the live storage, grown ahead on purpose) and for a doc
        without tables. The copy runs on the current stream; the values
        do not change."""
        if self._dev is None or self._store is not None \
                or self.donate_buffers:
            return 0
        fp = self.device_footprint()
        if fp["storage_bytes"] <= fp["table_bytes"]:
            return 0
        by_dtype: dict = {}
        for k, t in self._dev.items():
            by_dtype.setdefault(t.dtype, []).append(k)
        own = {}
        for keys in by_dtype.values():
            own.update(zip(keys, torch.stack(
                [self._dev[k] for k in keys]).unbind(0)))
        self._dev = {k: own[k] for k in self._dev}
        return fp["storage_bytes"] - fp["table_bytes"]

    @property
    def dispatch_stats(self) -> dict:
        """Device-interaction counts for this document: total jitted
        program launches (`dispatches`) and blocking device->host syncs
        (`syncs`) since construction, plus the most recent
        `commit_prepared`'s delta (`last_commit`) — the quantity the
        streaming tier's per-batch budget is asserted against."""
        out = dict(self._acct)
        out["last_commit"] = (dict(self.last_commit_stats)
                              if self.last_commit_stats else None)
        return out

    # ------------------------------------------------------------------
    # actor interning (order-preserving: rank order == lexicographic order)
    # ------------------------------------------------------------------

    def _intern_actors(self, new_actors,
                       presorted: bool = False) -> Optional[np.ndarray]:
        """Add actors; if rank order changes, return the old->new remap.

        ``presorted`` asserts `new_actors` is already sorted and
        duplicate-free (the columnar batch's cached table): the missing
        scan then stays sorted by construction and the union is a linear
        merge of two sorted disjoint lists instead of re-sorting the
        whole table per batch."""
        if presorted:
            missing = [a for a in new_actors if a not in self._actor_rank]
        else:
            missing = sorted(set(a for a in new_actors
                                 if a not in self._actor_rank))
        if not missing:
            return None
        table = self.actor_table
        if not table:
            merged = list(missing)
        elif missing[0] > table[-1]:
            merged = table + missing
        elif missing[-1] < table[0]:
            merged = missing + table
        else:
            import heapq      # disjoint sorted lists: linear merge
            merged = list(heapq.merge(table, missing))
        new_rank = dict(zip(merged, range(len(merged))))
        remap = None
        if table and merged[: len(table)] != table:
            remap = np.asarray([new_rank[a] for a in table], np.int32)
        self.actor_table = merged
        self._actor_rank = new_rank
        self._intern_gen += 1
        return remap

    def _intern_batch_actors(self, b, append_only: bool = False
                             ) -> Optional[np.ndarray]:
        """Intern one batch's whole actor table.

        Uses the batch's cached presorted table when the per-change
        columns exist, and skips the scan entirely when this batch's
        ranks are already resolved against this document at the current
        interning generation (ColumnarChangeBatch.rank_cache — populated
        by the engine planners). `append_only` routes through
        `_intern_actors_append` (the chained-prepare constraint).

        The all-new prepend/append shape (a wide merge of fresh actors
        landing entirely before or after the current table — the
        headline workload) resolves ranks POSITIONALLY: the batch's
        precomputed table positions plus one offset, seeded straight
        into the rank cache, so no per-actor rank lookups run at all."""
        cols = getattr(b, "_change_columns", None)
        if cols is None:
            if append_only:
                self._intern_actors_append(b.actor_table)
                return None
            return self._intern_actors(b.actor_table)
        rc = cols.rank_cache.get(self)
        if rc is not None and rc["gen"] == self._intern_gen:
            return None         # already resolved; table unchanged since
        if append_only:
            self._intern_actors_append(cols.table_sorted, presorted=True)
            return None
        ts = cols.table_sorted
        rank = self._actor_rank
        # learned actor-rank site: the membership scan over the batch
        # table (which existing actors does it reference?) runs as ONE
        # packed position-model probe instead of per-actor dict lookups;
        # small batches keep the dict scan (model call overhead beats
        # the win below ~8 keys), and an unpackable table falls through.
        missing = None
        if len(ts) >= 8:
            m = learned_index.doc_actor_model(self)
            if m is not None:
                got = learned_index.actor_positions(
                    self.actor_table, np.asarray(ts, object),
                    "actor_rank", m)
                if got is not None:
                    fnd = got[1]
                    missing = ([] if fnd.all() else
                               [a for a, f in zip(ts, fnd.tolist())
                                if not f])
        if missing is None:
            missing = [a for a in ts if a not in rank]
        if not missing:
            return None
        table = self.actor_table
        if len(ts) - len(missing) == len(table):
            # every existing actor appears in the batch table too, so the
            # merged table IS `ts` and ranks are the batch's precomputed
            # positions — zero per-actor rank lookups (the headline
            # shape: a wide merge referencing the document's actors)
            pos = cols.table_pos_map()
            old_pos = [pos[a] for a in table]
            remap = (np.asarray(old_pos, np.int32)
                     if old_pos != list(range(len(table))) else None)
            self.actor_table = list(ts)
            self._actor_rank = dict(zip(ts, range(len(ts))))
            self._intern_gen += 1
            tp, rp = cols.positional_ranks(b)
            cols.rank_cache[self] = {
                "gen": self._intern_gen, "batch_rank": tp, "row_rank": rp}
            return remap
        off = None
        remap = None
        if len(missing) == len(ts):
            if not table or missing[0] > table[-1]:
                off = len(table)            # append: existing ranks keep
                merged = table + missing
            elif missing[-1] < table[0]:
                off = 0                     # prepend: old ranks shift up
                merged = missing + table
                remap = np.arange(len(missing),
                                  len(missing) + len(table), dtype=np.int32)
        if off is None:                     # interleaved: general merge
            return self._intern_actors(ts, presorted=True)
        self.actor_table = merged
        self._actor_rank = dict(zip(merged, range(len(merged))))
        self._intern_gen += 1
        tp, rp = cols.positional_ranks(b)
        cols.rank_cache[self] = {
            "gen": self._intern_gen,
            "batch_rank": tp + off,
            "row_rank": (rp + off).astype(np.int32)}
        return remap

    def _apply_remap(self, remap: np.ndarray):
        self._busy += 1   # device/index/conflict columns move together
        try:
            self._remap_device(remap)
            for ops in self.conflicts.values():
                for op in ops:
                    op["actor_rank"] = int(remap[op["actor_rank"]])
            self._invalidate()
        finally:
            self._busy -= 1

    def _intern_actors_append(self, new_actors, presorted: bool = False):
        """Intern actors WITHOUT ever remapping existing ranks — the only
        interning a chained prepare may perform, because a remap would
        invalidate the pending base plan's staged actor columns. Raises
        ValueError when the new actors would not all rank after the
        current table (the caller falls back to a fresh, unchained
        prepare once the base commit lands)."""
        if presorted:
            missing = [a for a in new_actors if a not in self._actor_rank]
        else:
            missing = sorted(set(a for a in new_actors
                                 if a not in self._actor_rank))
        if not missing:
            return
        if self.actor_table and missing[0] < self.actor_table[-1]:
            raise ValueError(
                "actor interning would reorder existing ranks; cannot "
                "chain this prepare onto a pending plan")
        for a in missing:
            self._actor_rank[a] = len(self.actor_table)
            self.actor_table.append(a)
        self._intern_gen += 1

    # ------------------------------------------------------------------
    # causality
    # ------------------------------------------------------------------

    def _compute_all_deps(self, actor: str, seq: int, deps: dict,
                          all_deps=None, memo=None) -> dict:
        # batches of concurrent changes typically share one dep frontier
        # (e.g. 10k actors all depending on {base: 1}); the closure depends
        # only on the effective base dep set — (implicit self-dep, explicit
        # deps) — so memoize on that key without building the merged dict on
        # hits. Entries are treated as read-only by every consumer.
        # `all_deps`/`memo` default to the document's maps; prepare_batch
        # passes ChainMap overlays so planning stays side-effect-free.
        if all_deps is None:
            all_deps = self._all_deps
        if memo is None:
            memo = self._closure_memo
        key = ((actor, seq - 1, tuple(sorted(deps.items()))) if seq > 1
               else (None, 0, tuple(sorted(deps.items()))))
        hit = memo.get(key)
        if hit is None:
            base = dict(deps)
            if seq > 1:
                base[actor] = seq - 1
            hit = transitive_closure(all_deps, actor, 0, base)
            memo[key] = hit
        return hit

    def _causally_covers(self, all_deps: dict, op: dict) -> bool:
        if op["actor_rank"] < 0:
            return True
        return all_deps.get(self.actor_table[op["actor_rank"]], 0) >= op["seq"]

    @staticmethod
    def _shared_frontier(deps_list, rows, seqs):
        """The ONE deps dict shared (by identity) by every given row, all
        at seq 1 — the wide-concurrent-merge shape (N actors, one
        frontier) — or None. Identity is deliberate: `intern_deps`
        (columnar.py) collapses equal dicts at batch construction, so the
        common shape is recognized in O(rows) pointer compares and the
        closure/admission work collapses to a single computation. Any
        other shape falls back to the general per-row path."""
        d0 = deps_list[rows[0]]
        for r in rows:
            if seqs[r] != 1 or deps_list[r] is not d0:
                return None
        return d0

    # ------------------------------------------------------------------
    # batch application
    # ------------------------------------------------------------------

    def apply_changes(self, changes):
        return self.apply_batch(self._decode_wire(changes))

    def _decode_wire(self, changes):
        """Protocol boundary: wire changes -> columnar batch. Subclasses
        with a vectorized boundary decoder (text: wire_columns) override;
        the base decodes ops columnar and leaves the per-change columns
        to derive lazily at first schedule (equivalent — they cache on
        the batch either way)."""
        return type(self).batch_type.from_changes(changes, self.obj_id)

    def _schedule(self, batch, clock=None, prior_queue=None):
        """Admission scheduling: partition the batch + queued items into
        causally-ready rounds over a host clock (no state mutation).
        Returns (rounds, queue_after, prior_queue). `clock`/`prior_queue`
        default to the document's live state; a chained prepare passes the
        pending base plan's post-commit snapshots instead."""
        if obs.ENABLED:
            _t0 = obs.now()
            out = self._schedule_inner(batch, clock, prior_queue)
            obs.span("plan", "admission", _t0, args={
                "doc": self.obj_id, "n_changes": batch.n_changes,
                "n_rounds": len(out[0]), "queued": len(out[1])})
            return out
        return self._schedule_inner(batch, clock, prior_queue)

    def _schedule_inner(self, batch, clock=None, prior_queue=None):
        prior_queue = list(self.queue if prior_queue is None
                           else prior_queue)
        # columnar planner (INTERNALS §10): admission over the batch's
        # per-change struct-of-arrays — rounds come back already GROUPED
        # ((batch, rows, mask) triples), no per-change tuples. It covers
        # every batch of at least _BULK_SCHEDULE_MIN changes with an
        # empty queue; the per-change loop below takes the rest.
        if not prior_queue and batch.n_changes:
            out = self._schedule_columnar(
                batch, self.clock if clock is None else clock, prior_queue)
            if out is not None:
                return out
        pending = list(range(batch.n_changes)) + prior_queue
        clock = dict(self.clock if clock is None else clock)
        scheduled: set = set()  # (actor, seq) admitted in this call
        rounds: list = []
        queue_after: list = []
        batch_actors = batch.actors
        batch_seqs = batch.seqs.tolist() if batch.n_changes else []

        # fast path — wide concurrent merge: empty queue, every change at
        # seq 1 from a distinct new actor, all sharing ONE already-covered
        # dep frontier. One check admits the whole batch as one round.
        # (A frontier naming a batch actor would need the slow path's
        # self-dep skip; such an actor has clock>=1 and fails the new-actor
        # test, so the fallback is automatic.)
        if not prior_queue and batch.n_changes:
            d0 = self._shared_frontier(batch.deps, range(batch.n_changes),
                                       batch_seqs)
            if d0 is not None and all(
                    clock.get(a, 0) >= s for a, s in d0.items()):
                actor_set = set(batch_actors)
                if (len(actor_set) == batch.n_changes
                        and not (actor_set & clock.keys())):
                    return ([[(batch, r) for r in range(batch.n_changes)]],
                            [], prior_queue)
        while pending:
            ready, not_ready = [], []
            for item in pending:
                if isinstance(item, int):
                    b, row = batch, item
                    actor, seq = batch_actors[row], batch_seqs[row]
                else:
                    b, row = item
                    actor, seq = b.actors[row], int(b.seqs[row])
                if seq <= clock.get(actor, 0) or (actor, seq) in scheduled:
                    continue  # duplicate: idempotent skip (inconsistent reuse
                    # of a seq by the same actor is not detected here; the
                    # oracle backend raises on it)
                # implicit self-dep on (actor, seq-1) OVERRIDES any explicit
                # self-dep, matching the reference's causallyReady
                # (reference backend/op_set.js:20-27)
                deps = b.deps[row]
                if (seq <= 1 or clock.get(actor, 0) >= seq - 1) and all(
                        clock.get(a, 0) >= s for a, s in deps.items()
                        if a != actor):
                    ready.append((b, row))
                    scheduled.add((actor, seq))
                else:
                    not_ready.append(item if not isinstance(item, int) else (b, row))
            if not ready:
                queue_after = not_ready
                break
            for b, row in ready:
                clock[b.actors[row]] = int(b.seqs[row])
            rounds.append(ready)
            pending = not_ready
        return rounds, queue_after, prior_queue

    @staticmethod
    def _admission_rounds(aidx, seqs, dgid, g_actor, g_seq,
                          n_groups: int, clock):
        """The ONE vectorized admission loop (one numpy pass per causal
        round) of `_schedule_columnar` — the admission SEMANTICS
        (idempotent dup skip, implicit self-dep override via
        single-failure forgiveness, first-occurrence-wins for
        same-(actor, seq) rows in one round) live here and nowhere else.
        `clock` is mutated in place. Returns (round index arrays,
        remaining mask: rows still pending = the queue)."""
        n = len(seqs)
        round_rows: list = []
        remaining = np.ones(n, bool)
        while True:
            idxs = np.flatnonzero(remaining)
            if not len(idxs):
                break
            a_i = aidx[idxs]
            s_i = seqs[idxs]
            dup = s_i <= clock[a_i]
            if dup.any():            # idempotent skips leave pending for good
                remaining[idxs[dup]] = False
                idxs = idxs[~dup]
                a_i, s_i = a_i[~dup], s_i[~dup]
                if not len(idxs):
                    continue
            seq_ready = (s_i <= 1) | (clock[a_i] >= s_i - 1)
            # per-group dep check; a group's SINGLE failing entry is
            # forgiven for rows whose own actor it names (the implicit
            # self-dep override)
            gs = np.unique(dgid[idxs])
            n_fail = np.zeros(n_groups, np.int64)
            fail_one = np.full(n_groups, -1, np.int64)
            for g in gs:
                fa, fs = g_actor[g], g_seq[g]
                fails = fa[clock[fa] < fs]
                n_fail[g] = len(fails)
                if len(fails) == 1:
                    fail_one[g] = fails[0]
            gr = dgid[idxs]
            dep_ok = (n_fail[gr] == 0) | ((n_fail[gr] == 1)
                                          & (fail_one[gr] == a_i))
            ready = seq_ready & dep_ok
            r_idx = idxs[ready]
            if not len(r_idx):
                break
            # same-round same-(actor, seq) rows: first occurrence wins
            pairk = (aidx[r_idx] << np.int64(32)) | seqs[r_idx]
            _, first = np.unique(pairk, return_index=True)
            if len(first) != len(r_idx):
                r_idx = r_idx[np.sort(first)]
            remaining[r_idx] = False
            np.maximum.at(clock, aidx[r_idx], seqs[r_idx])
            round_rows.append(r_idx)
        return round_rows, remaining

    def _schedule_columnar(self, batch, clock0: dict, prior_queue: list):
        """Columnar admission (INTERNALS §10): rounds over the batch's
        per-change struct-of-arrays, emitted pre-grouped.

        The per-change metadata — dense actor ids, seq column, dep
        GROUPS — was derived once at the protocol boundary
        (engine/wire_columns.change_columns) and is reused across every
        application of the (immutable) batch, so admission is boolean
        column ops against a clock vector: no per-change dict lookups,
        no (batch, row) tuple lists. Returns None for shapes the columns
        do not cover (small batches without the wide-merge shape fall to
        the per-change loop, whose cost at that size is the setup's).
        Admission decisions are exactly the loop path's — the fast path
        tests the same frontier/new-actor conditions at dep-CONTENT
        level, and `_admission_rounds` keeps the loop's semantics."""
        n = batch.n_changes
        cols = getattr(batch, "_change_columns", None)
        if cols is None and n < _BULK_SCHEDULE_MIN:
            # tiny (interactive) batches: deriving columns costs more
            # than the per-change loop saves, and the legacy identity
            # fast path covers the small wide-merge shape equally well —
            # don't burden the cfg7 write-behind hot path
            return None
        if cols is None:
            from .wire_columns import change_columns
            cols = change_columns(batch)

        # fast path — wide concurrent merge: every change at seq 1 from a
        # distinct new actor, one already-covered dep frontier. The
        # columns make each test O(distinct) instead of O(changes).
        if cols.all_seq1 and cols.distinct_actors and cols.single_group:
            d0 = cols.group_deps[0]
            if all(clock0.get(a, 0) >= s for a, s in d0.items()):
                # new-actor test from the cheaper side: the batch's actor
                # set is a frozenset, the clock a dict — iterate whichever
                # is smaller
                if len(clock0) <= cols.n_change_actors:
                    fresh = not any(a in cols.actor_set for a in clock0)
                else:
                    fresh = not any(
                        a in clock0
                        for a in cols.local_actors[:cols.n_change_actors])
                if fresh:
                    return ([_GroupedRound(
                        [(batch, np.arange(n, dtype=np.int32),
                          slice(None))])], [], prior_queue)

        if n < _BULK_SCHEDULE_MIN:
            return None         # loop path: setup costs more than the walk

        # bulk columnar rounds — one vector pass per causal round over the
        # batch's cached columns (dense ids, dep grouping, group arrays).
        # Only the clock vector is per-document.
        aidx = cols.actor_idx.astype(np.int64)
        seqs = cols.seqs.astype(np.int64)
        dgid = cols.dep_gid
        n_groups = len(cols.group_deps)
        clock = np.empty(len(cols.local_actors), np.int64)
        for j, a in enumerate(cols.local_actors):
            clock[j] = clock0.get(a, 0)
        g_actor = [cols.g_actor[cols.g_off[g]:cols.g_off[g + 1]]
                   .astype(np.int64) for g in range(n_groups)]
        g_seq = [cols.g_seq[cols.g_off[g]:cols.g_off[g + 1]]
                 for g in range(n_groups)]

        round_rows, remaining = self._admission_rounds(
            aidx, seqs, dgid, g_actor, g_seq, n_groups, clock)
        queue_after = [(batch, int(r)) for r in np.flatnonzero(remaining)]

        if len(round_rows) == 1 and len(round_rows[0]) == n:
            rounds = [_GroupedRound(
                [(batch, np.arange(n, dtype=np.int32), slice(None))])]
        else:
            # one pass builds every round's op mask: rounds partition the
            # admitted changes, so op masks come from a change->round map
            round_of = np.full(n, -1, np.int64)
            for k, r_idx in enumerate(round_rows):
                round_of[r_idx] = k
            op_round = round_of[batch.op_change]
            rounds = [
                _GroupedRound([(batch, r_idx.astype(np.int32),
                                op_round == k)])
                for k, r_idx in enumerate(round_rows)]
        return rounds, queue_after, prior_queue

    def apply_batch(self, batch):
        """Merge a columnar change batch (causally gated, idempotent).
        Traced as `apply/batch`; inside it `plan/admission`, per round
        `apply/intern`, `apply/bookkeeping` and the subclass's ingest
        spans, then `apply/finish`."""
        self._busy += 1
        _t0 = obs.now() if obs.ENABLED else 0
        try:
            return self._apply_batch(batch)
        finally:
            self._busy -= 1
            if obs.ENABLED:
                obs.span("apply", "batch", _t0, args={
                    "doc": self.obj_id, "n_ops": getattr(batch, "n_ops", 0),
                    "n_changes": batch.n_changes})

    def _apply_batch(self, batch):
        rounds, queue_after, prior_queue = self._schedule(batch)
        self.queue = queue_after
        applied: set = set()
        try:
            for ready in rounds:
                self._apply_round(ready)
                applied |= _round_row_pairs(ready)
        except BaseException:
            # a failed round must not swallow changes that were queued before
            # this call: admission consumed self.queue into the round plan, so
            # put back every prior item that did not actually apply. Changes
            # delivered IN this call are dropped wholesale — the call raised,
            # so the caller redelivers (matching the reference's all-or-
            # nothing applyChanges; completed earlier rounds are the
            # documented change-granularity deviation).
            self.queue = [
                it for it in prior_queue
                if (it[0].actors[it[1]], int(it[0].seqs[it[1]])) not in applied]
            self._gen += 1  # queue changed: invalidate outstanding plans
            self._plan_failed()
            raise
        _tf = obs.now() if obs.ENABLED else 0
        self._invalidate()
        self.compact_tables()
        self._note_footprint()
        if obs.ENABLED:
            obs.span("apply", "finish", _tf, args={"doc": self.obj_id})
        return self

    @staticmethod
    def _group_round(ready) -> list:
        """Group one round's (batch, row) pairs by source batch and compute
        each group's op mask. Columnar rounds arrive pre-grouped and pass
        through untouched."""
        if isinstance(ready, _GroupedRound):
            return ready
        b0 = ready[0][0]
        if len(ready) == b0.n_changes and all(it[0] is b0 for it in ready):
            # single whole batch (the fast-schedule shape): rows are the
            # full dedeuplicated set by construction
            return [(b0, np.arange(b0.n_changes, dtype=np.int32),
                     slice(None))]
        by_batch: dict = {}
        for b, row in ready:
            by_batch.setdefault(id(b), (b, []))[1].append(row)
        groups = []
        for b, rows in by_batch.values():
            if len(rows) == b.n_changes:
                # whole batch ready (scheduler dedupes, so a full-length
                # row list IS 0..n-1): no sort, no filtering
                rows_arr = np.arange(b.n_changes, dtype=np.int32)
                mask = slice(None)
            else:
                rows_arr = np.sort(np.asarray(rows, np.int32))
                mask = np.isin(b.op_change, rows_arr)
            groups.append((b, rows_arr, mask))
        return groups

    def _frontier_pairs(self, b, rows_arr):
        """The shared-frontier decision of one round group, ONE place for
        both the apply path (`_round_bookkeeping`) and the prepare path
        (`prepare_batch`): returns (d0, pairs, rows_l, seqs_l) where a
        non-None `d0` is the single dep frontier every row shares (all at
        seq 1) and `pairs` its (actor, 1) rows — derived from the
        columnar shape flags + the batch-level pairs cache when the
        columns exist, from the identity walk otherwise. d0 None = mixed
        round; rows_l/seqs_l are the materialized lists the mixed path
        consumes (only built when actually needed)."""
        actors = b.actors
        cols = getattr(b, "_change_columns", None)
        if (cols is not None and len(rows_arr)
                and cols.all_seq1 and cols.single_group):
            pairs = (cols.pairs_all(actors, b.seqs)
                     if len(rows_arr) == b.n_changes
                     else [(actors[r], 1) for r in rows_arr.tolist()])
            return cols.group_deps[0], pairs, None, None
        seqs_l = b.seqs.tolist()
        rows_l = rows_arr.tolist()
        d0 = (self._shared_frontier(b.deps, rows_l, seqs_l)
              if rows_l else None)
        pairs = ([(actors[r], 1) for r in rows_l]
                 if d0 is not None else None)
        return d0, pairs, rows_l, seqs_l

    def _round_bookkeeping(self, b, rows_arr):
        """Advance clock/_all_deps for a round's rows; returns the snapshots
        `_rollback_bookkeeping` needs if the round's ingest fails."""
        clock = self.clock
        all_deps = self._all_deps
        actors, deps_list = b.actors, b.deps
        d0, pairs, rows, seqs = self._frontier_pairs(b, rows_arr)
        if d0 is not None:
            # one closure serves the whole round; bookkeeping is bulk
            # C-speed dict work (dict.fromkeys/update) per row
            hit = self._compute_all_deps(pairs[0][0], 1, d0)
            prev_clock = {a: clock.get(a) for a, _ in pairs}
            prev_deps = {p: all_deps.get(p) for p in pairs}
            all_deps.update(dict.fromkeys(pairs, hit))
            clock.update(pairs)
            return prev_clock, prev_deps
        # d0 None comes only from the identity-walk branch: rows/seqs set
        assert rows is not None

        # mixed round: closures computed grouped by shared deps dict
        # (rows of one round are causally independent, so computing every
        # closure against the PRE-round maps is equivalent to the old
        # insert-as-you-go walk), then committed as bulk dict updates
        pairs, closures = self._bulk_closures(rows, actors, seqs,
                                              deps_list, all_deps,
                                              self._closure_memo)
        prev_clock = {}
        prev_deps = {}
        for (actor, seq), hit in zip(pairs, closures):
            if actor not in prev_clock:
                prev_clock[actor] = clock.get(actor)
            prev_deps[(actor, seq)] = all_deps.get((actor, seq))
            all_deps[(actor, seq)] = hit
            clock[actor] = seq
        return prev_clock, prev_deps

    def _rollback_bookkeeping(self, snapshots):
        prev_clock, prev_deps = snapshots
        for actor, old in prev_clock.items():
            if old is None:
                self.clock.pop(actor, None)
            else:
                self.clock[actor] = old
        for key, old in prev_deps.items():
            if old is None:
                self._all_deps.pop(key, None)
            else:
                self._all_deps[key] = old
        # closures derived from the rolled-back entries are stale
        self._closure_memo.clear()

    def _apply_round(self, ready):
        """Apply causally-ready (batch, row) pairs: one device program each."""
        for b, rows_arr, mask in self._group_round(ready):
            # ops may reference ids minted by actors whose own changes sit
            # in other rounds, so intern the batch's whole actor table.
            # Interning runs BEFORE the clock advances: a raising remap then
            # leaves the causal state untouched (extra interned actors are
            # harmless — interning only renames ranks consistently, it adds
            # no document content).
            _ti = obs.now() if obs.ENABLED else 0
            remap = self._intern_batch_actors(b)
            if remap is not None:
                self._apply_remap(remap)
            if obs.ENABLED:
                obs.span("apply", "intern", _ti, args={
                    "doc": self.obj_id, "remap": remap is not None})

            # _ingest needs clock/_all_deps populated for this round's
            # changes (the slow register path reads them), but a raising
            # _ingest must leave them untouched or a corrected redelivery
            # of the same (actor, seq) is silently skipped as a duplicate —
            # so snapshot and roll back on failure.
            _tb = obs.now() if obs.ENABLED else 0
            snapshots = self._round_bookkeeping(b, rows_arr)
            if obs.ENABLED:
                obs.span("apply", "bookkeeping", _tb, args={
                    "doc": self.obj_id, "n_rows": len(rows_arr)})
            if b.n_ops:
                try:
                    self._ingest(b, mask)
                except BaseException:
                    self._rollback_bookkeeping(snapshots)
                    raise

    # ------------------------------------------------------------------
    # two-phase ingestion (pipelining seam)
    # ------------------------------------------------------------------

    def _bulk_closures(self, rows_l, actors, seqs_l, deps_list, all_map,
                       memo_map):
        """allDeps closures for one round group's rows, grouped by shared
        deps OBJECT: seq-1 rows sharing one deps dict share one closure
        (their memo key is actor-independent), so mixed rounds pay
        per-distinct-frontier work instead of per-row closure walks.
        Returns (pairs, closures) aligned with `rows_l`'s order."""
        pairs: list = [None] * len(rows_l)
        closures: list = [None] * len(rows_l)
        by_dep: dict = {}
        for i, row in enumerate(rows_l):
            by_dep.setdefault(id(deps_list[row]), []).append(i)
        for idxs in by_dep.values():
            d = deps_list[rows_l[idxs[0]]]
            shared = None
            for i in idxs:
                row = rows_l[i]
                actor, seq = actors[row], seqs_l[row]
                if seq == 1:
                    if shared is None:
                        shared = self._compute_all_deps(
                            actor, 1, d, all_deps=all_map, memo=memo_map)
                    hit = shared
                else:
                    hit = self._compute_all_deps(
                        actor, seq, d, all_deps=all_map, memo=memo_map)
                pairs[i] = (actor, seq)
                closures[i] = hit
        return pairs, closures

    def prepare_batch(self, batch, after: Optional[PreparedBatch] = None
                      ) -> PreparedBatch:
        """Plan + stage a batch without mutating document content.

        Runs admission scheduling, per-round host planning (run detection,
        reference resolution, validity checks), and ships every device
        input buffer host->device — so `commit_prepared` is bookkeeping +
        kernel dispatch only. The only state this touches is actor
        interning, which is content-free (it renames ranks consistently).

        The plan binds to the document's current generation: any other
        mutation between prepare and commit invalidates it (commit raises
        ValueError, document unharmed). Use it to pipeline ingestion —
        prepare batch k+1 while the device executes batch k — or to move
        transfer latency off the merge critical path.

        `after=` chains this plan onto a PENDING (prepared, uncommitted)
        base plan: planning runs against the base plan's post-commit
        shadow/clock/closure state, so a background thread can prepare
        batch k+1 while the caller thread still commits batch k
        (engine/pipeline.PipelinedIngestor). A chained plan commits only
        directly after its base (commit re-checks via the base's
        committed generation). Chaining never remaps actor ranks — if the
        batch's actors would reorder the interning table, this raises
        ValueError and the caller falls back to an unchained prepare."""
        from collections import ChainMap
        _t0 = obs.now() if obs.ENABLED else 0
        chain: list = []
        if after is not None:
            if after.final_shadow is None:
                raise ValueError(
                    "cannot chain prepare onto a plan without shadow state")
            # append-only interning (raises on reorder) — a remap would
            # invalidate the pending base plan's staged actor columns
            self._intern_batch_actors(batch, append_only=True)
            p: Optional[PreparedBatch] = after
            while p is not None:
                chain.append(p)
                p = p.after
            rounds, queue_after, prior_queue = self._schedule(
                batch, clock=after.clock_after,
                prior_queue=after.queue_after)
            grounds = [self._group_round(r) for r in rounds]
            for groups in grounds:
                for b, _, _ in groups:
                    if b is not batch:
                        self._intern_batch_actors(b, append_only=True)
            gen = None
            shadow = after.final_shadow
            base_clock = after.clock_after
        else:
            remap = self._intern_batch_actors(batch)
            if remap is not None:
                self._apply_remap(remap)
            rounds, queue_after, prior_queue = self._schedule(batch)
            grounds = [self._group_round(r) for r in rounds]
            # intern queued batches' actors too, BEFORE planning: a remap
            # after a round was planned would invalidate its staged ranks
            for groups in grounds:
                for b, _, _ in groups:
                    if b is not batch:
                        remap = self._intern_batch_actors(b)
                        if remap is not None:
                            self._apply_remap(remap)
            gen = self._gen
            shadow = self._plan_shadow()
            base_clock = self.clock
        planned_rounds = []
        staged_bytes = 0
        # precompute each round's clock/deps bookkeeping (the allDeps
        # closures) so commit is dict updates only. Later rounds may depend
        # on closures of earlier rounds of this same plan — or of a pending
        # chained base plan — which are not in self._all_deps yet; thread
        # them through overlay maps.
        deps_overlay: dict = {}
        memo_overlay: dict = {}
        all_map = ChainMap(deps_overlay,
                           *[p.deps_overlay for p in chain], self._all_deps)
        memo_map = ChainMap(memo_overlay,
                            *[p.memo_overlay for p in chain],
                            self._closure_memo)
        clock_after = dict(base_clock)
        for groups in grounds:
            for b, rows_arr, mask in groups:
                actors, deps_list = b.actors, b.deps
                # ONE shared-frontier decision for apply and prepare
                # paths alike (`_frontier_pairs`): columnar shape flags +
                # the batch-level pairs cache when columns exist, the
                # identity walk otherwise
                d0, pairs, rows_l, seqs_l = self._frontier_pairs(
                    b, rows_arr)
                if d0 is not None:
                    hit = self._compute_all_deps(
                        pairs[0][0], 1, d0, all_deps=all_map,
                        memo=memo_map)
                    closures = [hit] * len(pairs)
                    deps_overlay.update(dict.fromkeys(pairs, hit))
                else:
                    pairs, closures = self._bulk_closures(
                        rows_l, actors, seqs_l, deps_list, all_map,
                        memo_map)
                    deps_overlay.update(zip(pairs, closures))
                clock_after.update(pairs)
                exec_plan = None
                if b.n_ops:
                    exec_plan, shadow = self._plan_round(b, mask, shadow)
                if exec_plan is not None:
                    staged_bytes += sum(
                        x.numel() * x.element_size()
                        for x in exec_plan.staged)
                planned_rounds.append((b, rows_arr, (pairs, closures),
                                       exec_plan))
        # barrier: the prepared plan is complete only once its buffers are
        # resident (keeps commit free of transfer stalls). Counted as a
        # blocking sync — it is one — but it lands on the PREPARE side,
        # which the pipeline ring overlaps under device execution, so it
        # never appears in a commit's per-batch delta.
        _tb = obs.now() if obs.ENABLED else 0
        if self.device.type == "cuda":
            # the staging copies were enqueued non-blocking on the staging
            # stream: one event there waits for all of them (and for no
            # commit), after which the pinned host buffers may go
            done = torch.cuda.Event()
            done.record(self._stage_stream)
            done.synchronize()
        for _, _, _, p in planned_rounds:
            if p is not None:
                p.pinned = []
        self._count_sync(label="stage_barrier",
                         dur_ns=(obs.now() - _tb) if _tb else 0)
        # exact h2d byte meter: the plan's summed staged
        # bytes, counted once at the seam where they are already known
        self._count_h2d(staged_bytes)
        if obs.ENABLED:
            obs.span("plan", "prepare_batch", _t0, args={
                "doc": self.obj_id, "n_ops": getattr(batch, "n_ops", 0),
                "n_changes": batch.n_changes,
                "n_rounds": len(planned_rounds),
                "staged_bytes": staged_bytes,
                "chained": after is not None})
        return PreparedBatch(gen=gen, rounds=planned_rounds,
                             queue_after=queue_after,
                             prior_queue=prior_queue,
                             memo_overlay=memo_overlay,
                             n_staged_bytes=staged_bytes,
                             after=after, final_shadow=shadow,
                             clock_after=clock_after,
                             deps_overlay=deps_overlay)

    def commit_prepared(self, prepared: PreparedBatch):
        """Commit a `prepare_batch` plan: clock/deps bookkeeping + staged
        kernel dispatch. Raises ValueError (document untouched) if the
        document mutated since the plan was prepared — for a chained plan,
        if its base plan has not committed or anything mutated since."""
        self._busy += 1
        # thread-local region: the delta counts the COMMIT's own device
        # interactions only — concurrent worker-thread prepares against
        # this doc (the pipeline ring) update the doc totals but not this
        region = {"dispatches": 0, "syncs": 0}
        prior_region = getattr(_ACCT_TLS, "region", None)
        _ACCT_TLS.region = region
        n_rounds = len(prepared.rounds)     # severed on success — read now
        _t0 = obs.now() if obs.ENABLED else 0
        try:
            out = self._commit_prepared(prepared)
        finally:
            self._busy -= 1
            _ACCT_TLS.region = prior_region
            if obs.ENABLED:
                obs.span("commit", "batch", _t0, args={
                    "doc": self.obj_id, "n_rounds": n_rounds,
                    "gen": self._gen, **region})
        # per-committed-batch device-interaction delta: the quantity the
        # streaming tier budgets (asserted <= a small constant on the
        # write-behind path; carried in bench --pipeline records)
        self.last_commit_stats = {**region, "n_rounds": n_rounds}
        self.compact_tables()
        self._note_footprint()
        return out

    def _commit_prepared(self, prepared: PreparedBatch):
        if prepared.committed_gen is not None:
            raise ValueError("prepared batch already committed; re-prepare")
        if prepared.after is not None:
            base = prepared.after
            if base.committed_gen is None or base.committed_gen != self._gen:
                raise ValueError(
                    "document changed since prepare_batch; re-prepare the "
                    "batch")
        elif prepared.gen != self._gen:
            raise ValueError(
                "document changed since prepare_batch; re-prepare the batch")
        self.queue = prepared.queue_after
        applied: set = set()
        self._closure_memo.update(prepared.memo_overlay)
        try:
            for b, rows_arr, book, exec_plan in prepared.rounds:
                pairs, closures = book
                # bulk bookkeeping: closures were precomputed at prepare
                prev_clock = {a: self.clock.get(a) for a, _ in pairs}
                prev_deps = {p: self._all_deps.get(p) for p in pairs}
                self._all_deps.update(zip(pairs, closures))
                self.clock.update(pairs)
                if exec_plan is not None:
                    try:
                        self._execute_plan(b, exec_plan)
                    except BaseException:
                        self._rollback_bookkeeping((prev_clock, prev_deps))
                        raise
                applied.update(pairs)
        except BaseException:
            self.queue = [
                it for it in prepared.prior_queue
                if (it[0].actors[it[1]], int(it[0].seqs[it[1]])) not in applied]
            self._gen += 1  # queue changed: invalidate outstanding plans
            self._plan_failed()
            raise
        self._invalidate()
        # stamp AFTER the final invalidation: a chained follow-up plan
        # commits iff _gen still equals this value (nothing else mutated)
        prepared.committed_gen = self._gen
        # sever consumed state: the rounds' staged device buffers are
        # spent, and the base link's committed_gen check has passed — a
        # long pipelined session must not retain every plan (and its
        # device arrays) back to session start through the after-chain
        prepared.rounds = []
        prepared.after = None
        return self

    def _plan_failed(self):
        """Hook: a batch application raised after partial device work.
        Subclasses drop host caches that can no longer be trusted."""

    def _plan_shadow(self):
        raise NotImplementedError(
            f"{type(self).__name__} does not support two-phase ingestion")

    def _plan_round(self, b, mask, shadow):
        raise NotImplementedError

    def _execute_plan(self, b, exec_plan):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # slow register path (host; matches oracle applyAssign semantics)
    # ------------------------------------------------------------------

    def _apply_slow(self, b, slots, kinds, values, actor_ranks, seqs,
                    slot_cap: int, reg_state):
        """Resolve non-fast assigns against register state.

        `reg_state` = (value, has, win_actor, win_seq, win_counter) numpy
        rows aligned with `slots` — pre-gathered by the ingest kernel's
        packed slow_info output, so resolution costs zero extra device
        round trips beyond the one write-back scatter. Traced as
        `apply/slow`."""
        _t0 = obs.now() if obs.ENABLED else 0
        wb = self._resolve_slow_host(b, slots, kinds, values, actor_ranks,
                                     seqs, slot_cap, reg_state)
        self._scatter_slow(wb)
        if obs.ENABLED:
            obs.span("apply", "slow", _t0, args={"doc": self.obj_id,
                                                 "n_slow": len(slots)})

    def _resolve_slow_host(self, b, slots, kinds, values, actor_ranks,
                           seqs, slot_cap: int, reg_state) -> np.ndarray:
        """HOST half of the slow register path: oracle-mirroring register
        resolution (winner = highest actor rank, survivors -> conflicts,
        `inc` folds into covered counters), mutating only host state
        (conflicts, value pool). Returns the packed (6, S) writeback
        matrix (ops/ingest.py WB_* row layout; padding rows carry
        `slot_cap`, the out-of-bounds drop sentinel). The device half is
        `_scatter_slow`."""
        from ..ops.ingest import bucket

        slots = np.asarray(slots)
        kinds = np.asarray(kinds)
        values = np.asarray(values)
        actor_ranks = np.asarray(actor_ranks)
        seqs = np.asarray(seqs)
        g_v, g_h, g_wa, g_ws, g_wc = reg_state   # aligned per op
        uniq, inv, cnt = np.unique(
            slots, return_inverse=True, return_counts=True)
        S = bucket(len(uniq), 64)
        slots_p = np.full(S, slot_cap, np.int32)
        slots_p[: len(uniq)] = uniq
        # winner rows start cleared: a slot whose surviving-op list ends
        # empty (covered delete) writes back exactly these defaults
        w_v = np.zeros(S, np.int32)
        w_h = np.zeros(S, bool)
        w_wa = np.full(S, -1, np.int32)
        w_ws = np.zeros(S, np.int32)
        w_wc = np.zeros(S, bool)

        at = self.actor_table
        all_deps_by_key = self._all_deps

        # --- vectorized bulk path -------------------------------------
        # Realistic mixed loads are dominated by plain single-writer
        # SET/DEL on conflict-free slots (cfg5b: 1M bare deletes of
        # distinct base elements); resolving those through the per-op
        # Python loop below was a >10x cliff on the residual-heavy
        # benchmark. An op is "bulk" when: its slot carries exactly one
        # slow op this round (the device gate already guarantees no fast
        # op shares it), the slot holds no stored conflicts, the op is a
        # plain non-pooled SET or a DEL, and the op causally covers the
        # register's current single winner. Covered SET -> the op is the
        # new winner; covered DEL -> the register clears. Everything else
        # (concurrent writes, counters, pooled values, multi-op slots)
        # keeps the oracle-mirroring loop.
        single = cnt[inv] == 1
        if self.conflicts:
            conf_keys = np.fromiter(self.conflicts.keys(), np.int64,
                                    len(self.conflicts))
            no_conf = ~np.isin(slots.astype(np.int64), conf_keys)
        else:
            no_conf = np.ones(len(slots), bool)
        plain = (((kinds == KIND_SET) & (values >= 0))
                 | (kinds == KIND_DEL))
        bulk = single & no_conf & plain
        if bulk.any():
            exists = g_wa >= 0   # rank<0 (incl. empty) is always covered
            cov = np.ones(len(slots), bool)
            need = np.nonzero(bulk & exists)[0]
            if len(need):
                # ops of one change share one deps closure: sort the
                # needing ops by change, then vectorize the coverage
                # check per contiguous change group (per distinct
                # current-winner actor within it) — per-group cost is
                # proportional to group size, not to the whole round
                ckey = ((actor_ranks[need].astype(np.int64) << 32)
                        | seqs[need].astype(np.int64))
                order = np.argsort(ckey, kind="stable")
                nzo = need[order]
                cko = ckey[order]
                cuts = np.nonzero(np.diff(cko))[0] + 1
                starts = np.concatenate(([0], cuts))
                ends = np.concatenate((cuts, [len(cko)]))
                for s0, e0 in zip(starts, ends):
                    idx = nzo[s0:e0]
                    key = int(cko[s0])
                    rank, seq = key >> 32, key & 0xFFFFFFFF
                    deps = all_deps_by_key.get((at[rank], seq), {})
                    wran = g_wa[idx]
                    ur = np.unique(wran)
                    th = np.array([deps.get(at[int(r)], 0) for r in ur],
                                  np.int64)
                    cov[idx] = th[np.searchsorted(ur, wran)] >= g_ws[idx]
            bulk &= cov          # concurrent cases fall through to the loop
            j_set = np.nonzero(bulk & (kinds == KIND_SET))[0]
            i_set = inv[j_set]
            w_v[i_set] = values[j_set]
            w_h[i_set] = True
            w_wa[i_set] = actor_ranks[j_set]
            w_ws[i_set] = seqs[j_set]
            # covered DELs keep the cleared defaults; no stored conflicts
            # exist on bulk slots, so there is nothing to pop

        # --- oracle-mirroring loop for the rest -----------------------
        rest = np.nonzero(~bulk)[0]
        regs: dict = {}
        for j in rest:
            slot = int(slots[j])
            kind = int(kinds[j])
            value = int(values[j])
            actor_rank = int(actor_ranks[j])
            seq = int(seqs[j])
            actor_id = at[actor_rank]
            all_deps = all_deps_by_key.get((actor_id, seq), {})
            ops = regs.get(slot)
            if ops is None:
                # every slow op on a slot carries the same pre-round
                # register snapshot (gathered post fast-path writes)
                ops = []
                if g_h[j] or g_wa[j] >= 0:
                    ops.append({"actor_rank": int(g_wa[j]),
                                "seq": int(g_ws[j]),
                                "value": int(g_v[j]),
                                "counter": bool(g_wc[j])})
                ops.extend(self.conflicts.get(slot, []))
                regs[slot] = ops

            if kind == KIND_INC:
                for op in ops:
                    if op["counter"] and self._causally_covers(all_deps, op):
                        entry = self.value_pool[-op["value"] - 1]
                        self.value_pool.append(
                            {"value": entry["value"] + value,
                             "datatype": "counter"})
                        op["value"] = -len(self.value_pool)
                continue

            surviving = [op for op in ops
                         if not self._causally_covers(all_deps, op)]
            if kind == KIND_SET:
                pooled, counter = value, False
                if value < 0:
                    entry = b.value_pool[-value - 1]
                    self.value_pool.append(entry)
                    pooled = -len(self.value_pool)
                    counter = entry.get("datatype") == "counter"
                # at most one op per actor per register (same convergence
                # rule as the oracle, op_set.py _apply_assign: a later op
                # of the same change supersedes its predecessor; same-rank
                # pairs make the winner application-order-dependent)
                surviving = [o for o in surviving
                             if o["actor_rank"] != actor_rank]
                surviving.append({"actor_rank": actor_rank, "seq": seq,
                                  "value": pooled, "counter": counter})
            regs[slot] = surviving

        # finalize loop slots: winner = highest actor rank; extras become
        # conflicts (bulk slots were finalized vectorized above and never
        # share a slot with a loop op — the single-op gate)
        for s, slot_ops in regs.items():
            i = int(np.searchsorted(uniq, s))
            # descending by actor rank — unique per actor (the filter at
            # append time), so the order is total and
            # application-order-independent, matching the oracle
            # (backend/op_set.py _apply_assign)
            ops = sorted(slot_ops, key=lambda o: o["actor_rank"])[::-1]
            if ops:
                w = ops[0]
                w_v[i], w_h[i] = w["value"], True
                w_wa[i], w_ws[i], w_wc[i] = (w["actor_rank"], w["seq"],
                                             w["counter"])
            if ops[1:]:
                self.conflicts[s] = ops[1:]
            else:
                self.conflicts.pop(s, None)

        wb = np.zeros((6, S), np.int32)
        wb[0] = slots_p
        wb[1] = w_v
        wb[2] = w_h
        wb[3] = w_wa
        wb[4] = w_ws
        wb[5] = w_wc
        return wb

    def _scatter_slow(self, wb: np.ndarray):
        """DEVICE half of the slow register path: write the resolved
        winners back over the live register tables (one packed upload, in
        place under `donate_buffers`, or the per-column comparator)."""
        from ..ops.ingest import (REG_KEYS, scatter_registers,
                                  scatter_registers_packed)

        self._count_dispatch(label="scatter_registers")
        self._count_h2d(wb.nbytes)   # the packed (6, S) writeback upload
        store = None
        writes = 0
        try:
            if self.packed_residual_writeback and self.donate_buffers:
                store = self._inplace_store(self._cap)
                writes = store.writes
            regs_in = tuple(self._dev[k] for k in REG_KEYS)
            if self.packed_residual_writeback:
                out = scatter_registers_packed(*regs_in, self._to_dev(wb),
                                               store=store)
            else:
                out = scatter_registers(
                    *regs_in, self._to_dev(wb[0]), self._to_dev(wb[1]),
                    self._to_dev(wb[2].astype(bool)),
                    self._to_dev(wb[3]), self._to_dev(wb[4]),
                    self._to_dev(wb[5].astype(bool)))
        except BaseException:
            # a failure after the first in-place write leaves no valid
            # register state; one before it leaves the tables as they were
            if store is not None and store.writes != writes:
                self._lose_device()
            raise
        self._dev.update(zip(REG_KEYS, out))
        self._invalidate()

    def _fetch_mirrors(self, keys) -> dict:
        """Host numpy mirrors of device tables, fetched as ONE packed
        transfer. bool tables come back as bool; everything else int32."""
        from ..ops.ingest import pack_rows
        dev = self._ensure_dev()
        self._count_dispatch(label="pack_rows")
        _tf = obs.now() if obs.ENABLED else 0
        packed = pack_rows(*(dev[k] for k in keys)).cpu().numpy()
        self._count_sync(label="mirror_fetch",       # the packed d2h fetch
                         dur_ns=(obs.now() - _tf) if _tf else 0,
                         d2h_bytes=packed.nbytes)
        out = {}
        for i, k in enumerate(keys):
            row = packed[i]
            out[k] = row.astype(bool) if dev[k].dtype == torch.bool else row
        return out

    # ------------------------------------------------------------------
    # subclass hooks
    # ------------------------------------------------------------------

    def _ingest(self, batch, mask):
        raise NotImplementedError

    def _remap_device(self, remap: np.ndarray):
        raise NotImplementedError

    def _invalidate(self):
        self._host = None
        self._gen += 1
