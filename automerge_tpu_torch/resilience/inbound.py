"""Inbound gate: the one validated, quarantined path for remote changes.

Every network-delivered change batch — ``SyncHub._receive``, an open or
closed ``Connection.receive_msg``, ``DocSet.deliver`` — funnels through one
``InboundGate`` per DocSet (cached on the doc-set instance, like the shared
sync hub). The gate guarantees:

- **Validation first.** Malformed changes raise
  :class:`~.errors.ProtocolError` before any document state is touched.
- **Typed failures.** A delivery the backend rejects mid-application
  (unknown object, inconsistent seq reuse, …) re-raises as
  ``ProtocolError`` — never a raw ``KeyError``/``TypeError``/
  ``RuntimeError`` — after the backend's failure-atomic restore ran, so
  document state and clock are bit-identical to before the delivery and a
  corrected redelivery is never silently skipped.
- **Bounded quarantine.** Causally-premature changes (deps the local doc
  does not cover, even transitively within the delivery) park in a bounded
  per-doc :class:`~.quarantine.QuarantineQueue` instead of the backends'
  unbounded internal queues; they release automatically when the missing
  deps arrive (via any later delivery, or a local merge through
  ``release``).
- **Idempotent redelivery.** Exact duplicates pass through to the backends,
  whose admission layer skips them; a same-``(actor, seq)`` redelivery with
  *different* content surfaces as ``ProtocolError`` (wrapping the backend's
  inconsistent-reuse rejection).
"""

from __future__ import annotations

import logging

from .. import obs
from ..obs import lineage
from .errors import ProtocolError
from .quarantine import DEFAULT_CAPACITY, QuarantineQueue
from .validation import prevalidated, validate_changes

logger = logging.getLogger("automerge_tpu_torch.resilience")

#: Total parked changes across ALL docs of one gate. DocIds are
#: peer-chosen, so a per-doc bound alone is no bound at all — a hostile
#: peer would just mint a fresh docId per premature change.
GLOBAL_CAPACITY = 4 * DEFAULT_CAPACITY

#: Empty per-doc queues kept around for their stats; beyond this many
#: tracked docs, emptied queues are dropped so attacker-minted docIds
#: cannot grow the bookkeeping dict without bound either.
_MAX_IDLE_QUEUES = 64


def inbound_gate(doc_set) -> "InboundGate":
    """The one gate every inbound path on a DocSet shares (cached on the
    doc-set instance, so quarantined changes survive hub/connection
    churn)."""
    gate = getattr(doc_set, "_inbound_gate", None)
    if gate is None:
        gate = InboundGate(doc_set)
        doc_set._inbound_gate = gate
    return gate


def absorb_msg(doc_set, msg: dict):
    """A late in-flight message with no live peer behind it — a closed
    Connection, or a hub peer removed mid-flight: absorb inbound changes
    through the shared gate, never write to the (torn-down) transport.
    `msg` must already be validated. Returns the doc."""
    if lineage.ENABLED and msg.get("trace"):
        lineage.adopt(msg["trace"])
    if msg.get("wire") is not None:
        from ..engine.wire_format import as_frame
        return inbound_gate(doc_set).deliver_wire(
            msg["docId"], [(as_frame(msg["wire"]), None)],
            changes=msg.get("changes") or (), validated=True)
    if msg.get("changes"):
        return inbound_gate(doc_set).deliver(msg["docId"], msg["changes"],
                                             validated=True)
    return doc_set.get_doc(msg["docId"])


def _ready_under(change: dict, clock: dict) -> bool:
    """Whether `clock` admits `change`: next-in-sequence (or a duplicate —
    the backends dedup those idempotently) with every dep covered."""
    if change["seq"] > clock.get(change["actor"], 0) + 1:
        return False
    deps = change.get("deps") or {}
    return all(clock.get(a, 0) >= s for a, s in deps.items())


class InboundGate:
    def __init__(self, doc_set, capacity: int = DEFAULT_CAPACITY,
                 global_capacity: int = GLOBAL_CAPACITY):
        self._doc_set = doc_set
        self._capacity = capacity
        self._global_capacity = global_capacity
        self._quarantine: dict = {}       # doc_id -> QuarantineQueue
        self._n_parked = 0                # total across all docs
        self._busy: set = set()           # re-entrancy guard (doc ids)
        self.stats = {"delivered": 0, "applied_ops": 0,
                      "parked_rejected": 0,
                      "global_evicted": 0,
                      "peak_parked": 0}      # per-doc quarantine stats
        # live on the queues (see quarantine_stats)

    # -- public entry points -------------------------------------------

    def deliver(self, doc_id: str, changes, validated: bool = False,
                sender=None):
        """Apply one inbound delivery; returns the (possibly unchanged)
        document. Premature changes park; parked changes whose deps this
        delivery satisfied apply in the same call.

        ``sender`` attributes the delivery to a transport peer / service
        tenant for quarantine accounting: either one id for the whole
        batch, or a list aligned with `changes` (the service tier's
        grouped cross-tenant admission). Attribution powers the
        ``quar/evict_pressure`` events and dead-peer reclamation
        (:meth:`evict_sender`)."""
        if not validated:
            changes = validate_changes(changes, strict=True)
        senders = self._sender_map(changes, sender)
        if doc_id in self._busy:
            # re-entrant delivery (a change handler fed back into the
            # gate): park everything; the outer drain picks it up
            for change in changes:
                self._park(doc_id, change, sender=senders.get(id(change)))
            return self._doc_set.get_doc(doc_id)
        self._busy.add(doc_id)
        try:
            return self._drain_loop(doc_id, changes, senders)
        finally:
            self._busy.discard(doc_id)

    def deliver_wire(self, doc_id: str, frames, changes=(), sender=None,
                     senders=None, validated: bool = False):
        """Apply one inbound delivery carrying binary frames
        (engine/wire_format.py), with an optional dict-change prefix
        (applied first — the split_outgoing message shape).

        ``frames`` is ``[(WireFrame, sender_or_None), ...]``. The FAST
        LANE — no dict prefix, no parked quarantine, no re-entrant
        drain, frames combining into one same-object delivery whose
        rows are all causally admissible — hands the decoded batch
        straight to the backend: one apply, zero per-change dicts on
        the hot path (the dicts materialize lazily at backend admission
        for history bookkeeping only). Anything else degrades to the
        dict path via ``WireFrame.changes()`` — same drain loop, same
        quarantine, same typed failures, byte-identical committed
        state (the parity contract, tests/test_wire_format.py)."""
        from ..engine.wire_format import as_frame, combine_frames
        frames = [(as_frame(f).validate(), s) for f, s in frames]
        if lineage.ENABLED:
            for f, _s in frames:
                ctx = f.trace
                if ctx:
                    lineage.adopt(ctx)
        if not changes and frames and doc_id not in self._busy \
                and not self.quarantined(doc_id):
            delivery = combine_frames([f for f, _ in frames]) \
                if len(frames) > 1 else frames[0][0]
            if delivery is not None \
                    and delivery.ready_under(self._clock(doc_id)):
                self._busy.add(doc_id)
                try:
                    doc = self._apply(doc_id, delivery)
                    self.stats["delivered"] += delivery.n_changes
                    if obs.ENABLED:
                        obs.event("gate", "wire_fast",
                                  args={"doc": doc_id,
                                        "n_ops": delivery.n_ops})
                    return doc
                except ProtocolError:
                    # backend rejection: its failure-atomic restore ran,
                    # so re-deliver through the dict path, which salvages
                    # valid changes and attributes the poison per sender
                    pass
                finally:
                    self._busy.discard(doc_id)
        all_changes = list(changes)
        sender_list = (list(senders) if senders is not None
                       else [sender] * len(all_changes))
        for f, s in frames:
            sub = f.changes()
            all_changes.extend(sub)
            sender_list.extend([s if s is not None else sender] * len(sub))
        return self.deliver(doc_id, all_changes, validated=validated,
                            sender=sender_list)

    @staticmethod
    def _sender_map(changes, sender) -> dict:
        """id(change) -> sender for this delivery (objects are alive for
        the whole call, so identity keys are safe for unhashable change
        dicts)."""
        if sender is None:
            return {}
        if isinstance(sender, (list, tuple)):
            return {id(c): s for c, s in zip(changes, sender)}
        return {id(c): sender for c in changes}

    def evict_sender(self, sender) -> int:
        """Reclaim every parked change attributed to `sender` across all
        docs (dead-peer eviction). Empty queues drop with their
        bookkeeping; returns the number of changes reclaimed."""
        dropped = 0
        for doc_id in list(self._quarantine):
            q = self._quarantine[doc_id]
            dropped += q.drop_sender(sender)
            if not len(q):
                del self._quarantine[doc_id]
        if dropped:
            self._n_parked -= dropped
            if obs.ENABLED:
                obs.event("quar", "evict_peer",
                          args={"tenant": sender, "n": dropped}, n=dropped)
        return dropped

    def release(self, doc_id: str):
        """Retry parked changes for a doc whose clock advanced outside the
        gate (a local merge, a handler-applied change). No-op when nothing
        is parked or a drain for this doc is already on the stack.

        Rejections never raise out of here: release runs inside local
        mutation paths (set_doc handlers), and a remote peer's
        quarantined poison change must not crash a local operation that
        already succeeded. `_isolate` already drops-and-logs rejected
        PARKED changes (everything drained here is parked), so this path
        cannot see a ProtocolError; the guard below is a backstop."""
        q = self._quarantine.get(doc_id)
        if doc_id in self._busy or q is None or not len(q):
            return
        self._busy.add(doc_id)
        try:
            self._drain_loop(doc_id, ())
        except ProtocolError as exc:
            self.stats["parked_rejected"] += 1
            logger.warning("dropped quarantined change(s) for doc %r on "
                           "release: %s", doc_id, exc)
        finally:
            self._busy.discard(doc_id)

    def quarantined(self, doc_id: str) -> int:
        q = self._quarantine.get(doc_id)
        return len(q) if q else 0

    def quarantine_items(self, doc_id: str = None) -> list:
        """Non-destructive snapshot of everything parked (one doc, or
        all): [(doc_id, actor, seq, sender)]. The public face of the
        per-doc queues for the service tier's reclamation check and the
        postmortem dump — callers never touch ``_quarantine``."""
        docs = ([doc_id] if doc_id is not None
                else list(self._quarantine))
        out = []
        for d in docs:
            q = self._quarantine.get(d)
            if q is not None:
                out.extend((d, a, s, sender)
                           for a, s, sender in q.entries())
        return out

    def quarantine_stats(self, doc_id: str = None) -> dict:
        """Per-doc stats, or the aggregate across every quarantined doc."""
        if doc_id is not None:
            q = self._quarantine.get(doc_id)
            return dict(q.stats) if q is not None else \
                {"parked": 0, "evicted": 0, "released": 0, "peak": 0}
        agg = {"parked": 0, "evicted": 0, "released": 0, "peak": 0}
        for q in list(self._quarantine.values()):
            for k in agg:
                agg[k] += q.stats[k]
        return agg

    # -- internals ------------------------------------------------------

    def _clock(self, doc_id: str) -> dict:
        from .. import frontend as Frontend
        doc = self._doc_set.get_doc(doc_id)
        if doc is None:
            return {}
        state = Frontend.get_backend_state(doc)
        return dict(state.clock) if state is not None else {}

    def _park(self, doc_id: str, change: dict, requeue: bool = False,
              sender=None):
        q = self._quarantine.get(doc_id)
        if q is None:
            q = self._quarantine[doc_id] = QuarantineQueue(self._capacity)
        if self._n_parked >= self._global_capacity:
            # aggregate bound: evict the oldest entry of the LARGEST
            # queue (deterministic; the scan only runs at the cap, which
            # only sustained abuse reaches), and drop the queue itself
            # once emptied so attacker-minted docIds can't grow the
            # bookkeeping dict either
            victim_id = max(self._quarantine,
                            key=lambda d: len(self._quarantine[d]))
            victim = self._quarantine[victim_id]
            victim.drain_oldest()
            self._n_parked -= 1
            self.stats["global_evicted"] += 1
            if not len(victim) and victim_id != doc_id:
                del self._quarantine[victim_id]
        before = len(q)
        q.park(change, requeue=requeue, sender=sender)
        self._n_parked += len(q) - before
        if self._n_parked > self.stats["peak_parked"]:
            self.stats["peak_parked"] = self._n_parked
        if lineage.ENABLED:
            # one park hop per (change, site) — a requeue dedups, so
            # the quarantine dwell (park -> release) spans the WHOLE
            # parked period, not the last requeue
            lineage.hop(change["actor"], change["seq"], "quar/park",
                        site=lineage.site_of(self._doc_set), doc=doc_id)

    def _drain_loop(self, doc_id: str, incoming, senders=None):
        """Drain until quiescent: a change handler may feed further
        deliveries for the SAME doc back into the gate mid-apply (they
        park via the re-entrancy branch), and the batch just applied can
        make them ready — so keep draining while progress is made and the
        quarantine is non-empty."""
        senders = senders or {}
        doc, applied = self._drain(doc_id, incoming, senders)
        while applied:
            q = self._quarantine.get(doc_id)
            if q is None or not len(q):
                break
            doc, applied = self._drain(doc_id, (), {})
        q = self._quarantine.get(doc_id)
        if q is not None and not len(q) \
                and len(self._quarantine) > _MAX_IDLE_QUEUES:
            del self._quarantine[doc_id]   # keep the tracking dict bounded
        return doc

    def _drain(self, doc_id: str, incoming, senders):
        pool = list(incoming)
        q = self._quarantine.get(doc_id)
        drained_keys: set = set()
        if q is not None and len(q):
            drained = q.drain_items()
            self._n_parked -= len(drained)
            drained_keys = {(c["actor"], c["seq"]) for c, _ in drained}
            senders = dict(senders)
            for change, sender in drained:
                pool.append(change)
                if sender is not None:
                    senders[id(change)] = sender
        # one admission pass: a change is ready when the doc clock plus the
        # changes already admitted from this pool cover its deps (the
        # backends' own fixpoint drain, run here so the leftovers can park
        # in the BOUNDED quarantine instead of the unbounded backend queue)
        sim = self._clock(doc_id)
        ready: list = []
        rest = pool
        progress = True
        while progress and rest:
            progress, nxt = False, []
            for change in rest:
                if _ready_under(change, sim):
                    ready.append(change)
                    if change["seq"] > sim.get(change["actor"], 0):
                        sim[change["actor"]] = change["seq"]
                    progress = True
                else:
                    nxt.append(change)
            rest = nxt
        # park leftovers BEFORE applying: a raising apply must not lose the
        # premature remainder (re-parking a drained change does not count
        # as a fresh park — see QuarantineQueue.park)
        for change in rest:
            self._park(doc_id, change,
                       requeue=(change["actor"],
                                change["seq"]) in drained_keys,
                       sender=senders.get(id(change)))
        if not ready:
            return self._doc_set.get_doc(doc_id), 0
        if lineage.ENABLED and drained_keys:
            # release hops BEFORE the apply, so a completed chain reads
            # park -> release -> commit (the commit hop is the apply's)
            site = lineage.site_of(self._doc_set)
            for c in ready:
                if (c["actor"], c["seq"]) in drained_keys:
                    lineage.hop(c["actor"], c["seq"], "quar/release",
                                site=site, doc=doc_id)
        try:
            doc = self._apply(doc_id, ready)
        except ProtocolError:
            # only backend REJECTION triggers isolation; a handler
            # exception (non-ProtocolError) means the batch applied and
            # must propagate as-is, never re-applied
            return self._isolate(doc_id, ready, drained_keys, senders)
        if drained_keys:
            released = sum(1 for c in ready
                           if (c["actor"], c["seq"]) in drained_keys)
            if released:
                q.stats["released"] += released
                if obs.ENABLED:
                    obs.event("quar", "release", args={"n": released},
                              n=released)
        self.stats["delivered"] += len(ready)
        return doc, len(ready)

    def _isolate(self, doc_id: str, ready: list, drained_keys: set,
                 senders=None):
        """A rejected batch: salvage every valid change, drop only the
        poison. Transports ack on first delivery and the hub advances
        believed clocks optimistically on send, so a valid change lost to
        a co-batched poison change would NEVER be re-sent — silent
        divergence. Changes are re-applied one at a time (failure path
        only): authoritatively-rejected ones are dropped, changes whose
        deps a rejected predecessor was to supply re-park as premature
        (honest state: they wait for a corrected redelivery), everything
        else applies. A rejection is raised to the caller ONLY when it
        came from the INCOMING delivery — a poison change another peer
        parked earlier is dropped-and-logged, never blamed on the current
        (valid) sender."""
        n_ok = 0
        incoming_err = None
        senders = senders or {}
        for change in ready:
            key = (change["actor"], change["seq"])
            if not _ready_under(change, self._clock(doc_id)):
                # its dep was rejected above: premature again, park it
                # (never feed it to the backend, whose internal queue is
                # unbounded)
                self._park(doc_id, change, requeue=key in drained_keys,
                           sender=senders.get(id(change)))
                continue
            try:
                self._apply(doc_id, [change])
                n_ok += 1
            except ProtocolError as exc:   # the poison: drop, attribute
                if key in drained_keys:
                    self.stats["parked_rejected"] += 1
                    logger.warning("dropped quarantined change %r for doc "
                                   "%r: %s", key, doc_id, exc)
                elif incoming_err is None:
                    incoming_err = exc
        self.stats["delivered"] += n_ok
        if incoming_err is not None:
            raise incoming_err
        return self._doc_set.get_doc(doc_id), n_ok

    def _apply(self, doc_id: str, changes: list):
        try:
            # the gate's strict wire checks subsume the backend's lenient
            # ones: skip the second per-op walk on the catch-up hot path
            with prevalidated():
                doc = self._doc_set._applied_doc(doc_id, changes)
        except ProtocolError:
            raise
        except (KeyError, TypeError, RuntimeError, ValueError) as exc:
            # the backends restored their state before raising (facade
            # _restore / device core.restore), so this rejection leaves the
            # document and its clock untouched
            raise ProtocolError(
                f"backend rejected inbound changes for doc {doc_id!r}: "
                f"{exc}") from exc
        # commit OUTSIDE the wrap: an exception from a change handler fires
        # after the document changed — reporting it as a state-untouched
        # rejection would make the sender treat an APPLIED delivery as
        # rejected (and its corrected redelivery then dedups silently)
        self._doc_set.set_doc(doc_id, doc)
        # what actually committed, in wire ops — the honest per-lane
        # load signal (a premature change that parks costs the backend
        # nothing; it is counted here on the call that DRAINS it).
        # `changes` may be a decoded wire delivery (the binary fast
        # lane), whose op count is a column length, not a walk
        self.stats["applied_ops"] += (
            int(changes.n_ops) if hasattr(changes, "n_ops")
            else sum(len(c.get("ops") or ()) for c in changes))
        if lineage.ENABLED:
            # THE visibility hop: the change is committed on this
            # replica's document — what end-to-end visibility latency
            # measures against the chain's origin timestamp
            lineage.hop_delivery(changes, "commit",
                                 site=lineage.site_of(self._doc_set),
                                 doc=doc_id)
        return doc
