"""One shard's execution lane: a device, a CUDA stream on it, its
resident docs, and the stacked commit programs that serve them.

A lane is the single-device unit of the sharded serving tier
(INTERNALS §15): every engine doc the placement table routes here lives
with its tables on THIS lane's device, and one ingest round across the
lane's touched docs executes through the stacked multi-object executor
(`engine/stacked.py`) — admission, columnar planning, and the round
kernels are the SAME code the single-device path runs, so the sharded
and unsharded paths cannot drift; the lane only decides *where* the
programs run. A lane never talks to another lane's device: there is no
multi-device program on the commit path.

On a CUDA device a lane is a stream: ``device_ctx()`` pins the current
device AND makes the lane's own ``torch.cuda.Stream`` the current
stream, so every staging copy, round program and kernel launch the
engine issues inside it (they all go to
``torch.cuda.current_stream(device)``) lands on the lane's stream.
Several lanes on one card are several streams: the lane workers
(`shard/parallel.py`) run their rounds concurrently. The ordering
discipline across the lane boundary:

- entering the context from another stream makes the lane's stream wait
  for the entering stream (nothing enqueued before the entry can race
  the lane's work), and leaving it makes the entering stream wait for
  the lane's (nothing the caller enqueues after the exit can race it);
- entering from the lane's own stream (a worker already bound to it) is
  a device pin only;
- the workers' round barrier applies the same two waits per task
  (`LaneExecutor.submit` / `barrier`).

Every doc compacts at the end of each commit (`engine/base.py`
`compact_tables`), so between rounds a resident doc holds exactly its
tables, the bytes the residency budget counts per doc.

A doc's tables are only ever written on its lane's stream, so the
caching allocator's per-stream reuse is safe without `record_stream`;
the engine ties cross-stream staged inputs itself (`engine/text_doc.py`
`_execute_plan`, `checkpoint/engine_codec.py`). On the CPU the context
is a no-op. A lane never falls back: ``device=None`` is the CUDA card
and raises without one.
"""

from __future__ import annotations

import contextlib

import torch

from .. import obs
from ..engine import stacked as _stacked
from ..engine.base import resolve_device
from ..engine.map_doc import DeviceMapDoc
from ..engine.text_doc import DeviceTextDoc

_DOC_KINDS = {"text": DeviceTextDoc, "map": DeviceMapDoc}


@contextlib.contextmanager
def _stream_ctx(device, stream):
    """The lane context on a card: device pin + the lane's stream current,
    joined both ways with the entering thread's stream."""
    with torch.cuda.device(device):
        outer = torch.cuda.current_stream(device)
        if outer == stream:
            yield
            return
        stream.wait_stream(outer)
        try:
            with torch.cuda.stream(stream):
                yield
        finally:
            outer.wait_stream(stream)


class ShardLane:
    """One device's shard: resident docs + stacked ingest."""

    def __init__(self, index: int, device=None, telemetry=None,
                 assert_budget: bool = True, doc_kind: str = "text",
                 capacity: int = 1024):
        self.index = index
        self.device = resolve_device(device)
        #: the lane's stream on a card (None on the CPU)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.docs: dict = {}          # doc_id -> engine doc
        self.doc_ops: dict = {}       # doc_id -> lifetime admitted wire ops
        self.telemetry = telemetry
        self.assert_budget = assert_budget
        self.doc_kind = doc_kind
        self.capacity = capacity
        self.stats = {"applies": 0, "stacked_applies": 0,
                      "per_object_applies": 0, "admitted_ops": 0,
                      "docs_in": 0, "docs_out": 0,
                      "cross_planned_docs": 0, "index_merges": 0}

    def stats_delta(self) -> dict:
        """A zeroed per-round counter delta (same keys as ``stats``) for
        the parallel executor's fold-at-the-barrier discipline."""
        return dict.fromkeys(self.stats, 0)

    def device_ctx(self):
        """Every engine call for this lane runs inside this context, so
        staged tensors and kernel launches land on the lane's device and
        stream (see the module note for the ordering it keeps)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return _stream_ctx(self.device, self.stream)

    # -- population -----------------------------------------------------

    def ensure_doc(self, doc_id: str, kind: str = None,
                   capacity: int = None):
        """Materialize a doc on this lane (the lane's configured kind
        and slot capacity unless overridden — the ShardedDocSet threads
        its population-wide settings through the lane constructor)."""
        doc = self.docs.get(doc_id)
        if doc is None:
            with self.device_ctx():
                doc = _DOC_KINDS[kind or self.doc_kind](
                    doc_id, capacity=capacity or self.capacity,
                    device=self.device)
            self.docs[doc_id] = doc
            self.doc_ops[doc_id] = 0
        return doc

    def adopt(self, doc_id: str, bundle: bytes):
        """Install a migrated doc from its checkpoint bundle (the
        restore stages the tables onto THIS lane's device, on its
        stream)."""
        from ..checkpoint import restore_engine
        with self.device_ctx():
            doc = restore_engine(bundle, self.device)
        self.docs[doc_id] = doc
        self.doc_ops[doc_id] = 0
        self.stats["docs_in"] += 1
        # a promote boundary: the doc's tables just landed on this
        # device — feed its gauge and this lane's aggregate immediately
        # (the residency budget invariant reads the live gauges, not
        # the next commit)
        doc._note_footprint()
        self._note_footprint()
        return doc

    def export(self, doc_id: str) -> bytes:
        """Capture a resident doc as a checkpoint bundle and release it
        (the migration source half; commit-boundary only — the caller
        guarantees no in-flight plan)."""
        from ..checkpoint import capture_engine
        from ..obs import device_truth
        doc = self.docs[doc_id]
        with self.device_ctx():
            bundle = capture_engine(doc)
        del self.docs[doc_id]
        self.doc_ops.pop(doc_id, None)
        self.stats["docs_out"] += 1
        # a demote boundary: the tables leave the device with the doc —
        # retire its gauge (peak already recorded) and re-aggregate
        if device_truth.ENABLED:
            device_truth.REGISTRY.drop_footprint("doc", doc.obj_id)
        self._note_footprint()
        return bundle

    # -- the commit path ------------------------------------------------

    def ingest(self, deliveries: dict, stats: dict = None):
        """One serving round over this lane's touched docs:
        ``{doc_id: changes}`` (wire dicts or decoded columnar batches)
        executes as ONE stacked multi-object apply on the lane's device
        and stream (`engine/stacked.apply_stacked` — per-round budget
        asserted against the stats dict THIS apply returned, never the
        module global, so concurrent lanes assert race-free), falling
        back to the per-object engine exactly like the single-device
        backend when the population is ineligible. Returns the admitted
        wire-op count. `stats` redirects the per-round counter
        increments into a caller-owned delta dict — the parallel
        executor's per-worker fold discipline (INTERNALS §24): a worker
        accumulates into its task delta and the caller folds into
        ``self.stats`` at the round barrier, so no increment is ever
        lost to a concurrent writer."""
        if not deliveries:
            return 0
        st_out = self.stats if stats is None else stats
        items = [(self.ensure_doc(doc_id), changes)
                 for doc_id, changes in deliveries.items()]
        n_ops = sum(_stacked._item_ops(subs) for _, subs in items)
        _t0 = obs.now() if obs.ENABLED else 0
        with self.device_ctx():
            st = _stacked.apply_stacked(items)
            if st:
                st_out["stacked_applies"] += 1
                # cross-doc planning visibility (INTERNALS §16): how many
                # of this lane's doc-rounds rode a shared admission
                # template, and the bulk-merge count the budget bounds
                cd = st.get("cross_doc")
                if cd:
                    st_out["cross_planned_docs"] += cd.get(
                        "sched_shared", 0)
                st_out["index_merges"] += st.get("index_merges", 0)
                if self.assert_budget:
                    _stacked.assert_round_budget(st)
            else:
                for doc, changes in items:
                    if hasattr(changes, "n_changes"):
                        doc.apply_batch(changes)
                    else:
                        doc.apply_changes(changes)
                st_out["per_object_applies"] += 1
        st_out["applies"] += 1
        st_out["admitted_ops"] += n_ops
        for doc_id, changes in deliveries.items():
            self.doc_ops[doc_id] = (self.doc_ops.get(doc_id, 0)
                                    + _stacked._item_ops(changes))
        if self.telemetry is not None:
            # the per-shard admitted-ops window series the rebalance
            # policy reads (INTERNALS §15.3): one rolling counter per
            # lane, bounded cardinality regardless of population size
            self.telemetry.observe_count(
                "shard", f"lane{self.index}_admitted_ops", n_ops)
        if obs.ENABLED:
            obs.span("shard", "lane_ingest", _t0, args={
                "lane": self.index, "docs": len(items), "n_ops": n_ops,
                "stacked": bool(st)})
        # the stacked path commits outside the per-doc apply wrappers,
        # so feed each touched doc's footprint gauge here — the lane
        # ingest IS their commit boundary (the residency budget
        # invariant is asserted against the doc-kind peak gauge)
        for doc_id in deliveries:
            self.docs[doc_id]._note_footprint()
        self._note_footprint()
        return n_ops

    def device_footprint(self) -> dict:
        """Device-resident bytes of this lane: the sum of every resident
        doc's ``device_bytes`` (the storages its tables sit in plus its
        extras; obs/device_truth.py, INTERNALS §19) — the per-shard-lane
        view the ``amtpu_device_`` footprint gauges carry next to the
        per-doc ones."""
        per_doc = {doc_id: doc.device_footprint()["device_bytes"]
                   for doc_id, doc in self.docs.items()}
        return {"device_bytes": sum(per_doc.values()),
                "n_docs": len(per_doc), "per_doc": per_doc}

    def _note_footprint(self):
        from ..obs import device_truth
        if device_truth.ENABLED:
            device_truth.REGISTRY.note_footprint(
                "lane", f"lane{self.index}",
                self.device_footprint()["device_bytes"])

    def ring(self, doc_id: str, slots: int = None, donate: bool = False):
        """A K-deep pipelined ingestion ring (engine/pipeline) over one
        of this lane's docs, built under the lane's context so that its
        worker's device work runs on the lane's stream — the streaming
        path for a shard's hot doc. Drive it (feed, flush, close) under
        ``with lane.device_ctx():`` too, so the caller's commits share
        that stream."""
        from ..engine.pipeline import PipelinedIngestor
        doc = self.ensure_doc(doc_id)
        with self.device_ctx():
            return PipelinedIngestor(doc, slots=slots, donate=donate)

    def hottest_doc(self):
        """(doc_id, lifetime ops) of the lane's hottest resident doc, or
        None — the migration candidate the rebalance policy exports."""
        if not self.doc_ops:
            return None
        doc_id = max(self.doc_ops, key=self.doc_ops.get)
        return doc_id, self.doc_ops[doc_id]

    def texts(self) -> dict:
        """Materialize every resident text doc (outside the commit
        path; convergence checks and pulls)."""
        with self.device_ctx():
            return {doc_id: doc.text() for doc_id, doc in self.docs.items()
                    if isinstance(doc, DeviceTextDoc)}
