"""Wire-to-tensor change decode: per-change struct-of-arrays columns.

The op payload of a batch has been columnar since the start
(`engine/columnar.py`: one numpy column per op field). The per-CHANGE
metadata was not: actors were Python string lists, deps per-change dicts,
and every `prepare_batch` re-derived the same facts about the same
(immutable) batch — dense actor ids, dep grouping, the all-concurrent
shape test — with per-change dict lookups and Python walks. At headline
scale (10k changes) that re-derivation, not the op math, dominated host
planning (docs/PROFILE_r7.md).

`ColumnarChangeBatch` is the missing half: int32 struct-of-arrays for the
per-change metadata, decoded ONCE at the protocol boundary and cached on
the (immutable) batch object, so causal admission, closure bookkeeping,
and run planning operate on column slices — no per-op or per-change
Python objects on the planning hot path (engine/base.py
`_schedule_columnar`). The shape follows PAM's bulk-parallel batch
construction over augmented maps and Jiffy's batch-update amortization
(PAPERS.md): pay O(batch) once, then every per-document application is
vectorized.

Scope and layering:

- `change_columns(batch)` — derive + cache the columns for any op-columnar
  batch (text or map). Interning is vectorized (`np.unique` over the actor
  strings gives the sorted-distinct table and the dense inverse in one C
  pass); dep dicts group by identity first (`intern_deps` collapsed equal
  dicts at construction) and content second.
- `decode_text_changes_columnar(data, obj_id)` — protocol-boundary
  decoder: JSON (str/bytes) goes through the Python JSON decoder,
  wire dicts through the vectorized numpy
  decoder below, and the columns are attached eagerly so the first
  prepare already runs columnar.
- `_from_changes_numpy` — the vectorized dict decoder: one flat
  extraction pass, then `np.unique`/`searchsorted` interning of actors
  and elemIds (each DISTINCT elemId string parses once, not once per
  op). Falls back to the per-op walk for shapes outside its scope (rich
  values, datatypes); both produce identical batches.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

__all__ = ["ColumnarChangeBatch", "change_columns",
           "decode_text_changes_columnar"]


@dataclass
class ColumnarChangeBatch:
    """Per-change int32 struct-of-arrays companion of an op-columnar batch.

    Dense ids: `actor_idx` maps each change row into `local_actors`
    (change actors first, dep-only actors appended), so admission's clock
    vector and dep checks are integer column ops. Dep dicts collapse to
    content-distinct GROUPS stored flattened ((g_off, g_actor, g_seq) —
    CSR-style), so a round's readiness test loops over the handful of
    distinct frontiers, never over changes.

    Instances are derived from an immutable batch and must be treated as
    read-only; they are shared across every document the batch is applied
    to (replica fan-out, bench reps)."""

    n_changes: int
    actor_idx: np.ndarray        # int32[n] -> local_actors (values < n_actors)
    local_actors: list           # distinct change actors + dep-only actors
    n_change_actors: int         # prefix of local_actors that are change actors
    seqs: np.ndarray             # int32[n] (aliases batch.seqs)
    dep_gid: np.ndarray          # int32[n] -> content-distinct dep group
    group_deps: list             # representative deps dict per group
    g_off: np.ndarray            # int32[G+1] CSR offsets into g_actor/g_seq
    g_actor: np.ndarray          # int32[sum] -> local_actors
    g_seq: np.ndarray            # int64[sum]
    table_sorted: list           # sorted distinct batch.actor_table
    actor_set: frozenset         # distinct change actors
    all_seq1: bool               # every change at seq 1
    distinct_actors: bool        # one change per actor
    # (actor, seq) tuple rows for full-batch bookkeeping, built on first
    # use (commit-side dict updates need the tuples either way; building
    # them once per batch instead of once per prepare is the win)
    _pairs_all: Optional[list] = None
    # doc -> (intern_gen, batch_rank int64, row_rank int32) — the batch
    # actor table resolved against one document's interning; reusable
    # until that document's interning changes (replica fan-out and bench
    # reps hit this every application after the first)
    rank_cache: "weakref.WeakKeyDictionary" = field(
        default_factory=weakref.WeakKeyDictionary)

    # (table_pos int64, row_pos int32): each batch actor-table entry's /
    # change row actor's index within `table_sorted` — the positional
    # half of rank resolution, so the all-new prepend/append interning
    # shape resolves ranks as `pos + offset` with zero dict lookups
    _pos_ranks: Optional[tuple] = None

    @property
    def single_group(self) -> bool:
        return len(self.group_deps) == 1

    def pairs_all(self, actors, seqs_arr) -> list:
        """[(actor, seq)] for every change row, cached on the batch."""
        if self._pairs_all is None:
            self._pairs_all = list(zip(actors, seqs_arr.tolist()))
        return self._pairs_all

    def positional_ranks(self, batch) -> tuple:
        """(table_pos, row_pos) of `batch`'s actor table / change actors
        within `table_sorted`, computed once per batch."""
        if self._pos_ranks is None:
            pos = self.table_pos_map()
            self._pos_ranks = (
                np.asarray([pos[a] for a in batch.actor_table], np.int64),
                np.asarray([pos[a] for a in batch.actors], np.int32))
        return self._pos_ranks

    _pos_map: Optional[dict] = None

    def table_pos_map(self) -> dict:
        """actor -> index within `table_sorted`, computed once per batch."""
        if self._pos_map is None:
            self._pos_map = {a: i for i, a in enumerate(self.table_sorted)}
        return self._pos_map


def change_columns(batch) -> ColumnarChangeBatch:
    """The per-change columns of `batch`, derived once and cached.

    Safe on any batch exposing (actors, seqs, deps, actor_table); the
    derivation mutates nothing and the result is keyed to the batch
    object, so hand-built and decoded batches both amortize."""
    cols = getattr(batch, "_change_columns", None)
    if cols is not None:
        return cols
    actors = batch.actors
    n = len(actors)
    if n:
        uniq, inv = np.unique(np.asarray(actors, object),
                              return_inverse=True)
        local_actors = uniq.tolist()
        actor_idx = inv.astype(np.int32)
    else:
        local_actors = []
        actor_idx = np.empty(0, np.int32)
    n_change_actors = len(local_actors)

    # dep grouping: identity first (columnar.intern_deps collapsed equal
    # dicts at construction, so the common wide-merge shape is one id),
    # then content
    gid_by_id: dict = {}
    raw_groups: list = []
    dgid = np.empty(n, np.int32)
    for i, d in enumerate(batch.deps):
        g = gid_by_id.get(id(d))
        if g is None:
            g = gid_by_id[id(d)] = len(raw_groups)
            raw_groups.append(d)
        dgid[i] = g
    by_content: dict = {}
    group_deps: list = []
    remap = np.empty(max(len(raw_groups), 1), np.int32)
    for g, d in enumerate(raw_groups):
        key = tuple(sorted(d.items()))
        j = by_content.get(key)
        if j is None:
            j = by_content[key] = len(group_deps)
            group_deps.append(d)
        remap[g] = j
    dep_gid = remap[dgid] if n else dgid

    # dep-referenced actors extend the local id space past the change
    # actors; CSR-flatten the groups so admission never touches the dicts
    local = {a: i for i, a in enumerate(local_actors)}
    local_actors = list(local_actors)
    g_off = np.zeros(len(group_deps) + 1, np.int32)
    ga: list = []
    gs: list = []
    for g, d in enumerate(group_deps):
        for a, s in d.items():
            j = local.get(a)
            if j is None:
                j = local[a] = len(local_actors)
                local_actors.append(a)
            ga.append(j)
            gs.append(s)
        g_off[g + 1] = len(ga)
    seqs = np.asarray(batch.seqs, np.int32)
    cols = ColumnarChangeBatch(
        n_changes=n, actor_idx=actor_idx, local_actors=local_actors,
        n_change_actors=n_change_actors, seqs=seqs, dep_gid=dep_gid,
        group_deps=group_deps, g_off=g_off,
        g_actor=np.asarray(ga, np.int32), g_seq=np.asarray(gs, np.int64),
        table_sorted=sorted(set(batch.actor_table)),
        actor_set=frozenset(local_actors[:n_change_actors]),
        all_seq1=bool((seqs == 1).all()) if n else True,
        distinct_actors=n_change_actors == n)
    try:
        batch._change_columns = cols
    except AttributeError:      # exotic batch types without __dict__
        pass
    return cols


# ---------------------------------------------------------------------------
# protocol-boundary decoding
# ---------------------------------------------------------------------------


_NUMPY_MIN_OPS = 64   # below this the numpy column setup costs more than
# the per-op walk (interactive windows are a handful of ops; the walk
# already wins there and the columns still derive lazily at schedule)

#: Non-zero while the backend replays its own write-behind pending
#: rounds (device.flush_pending): decode spans in that extent emit as
#: ``plan/decode_replay`` — the changes never crossed the wire, so the
#: wire-ingest ``plan/decode`` serial term must not absorb them (the
#: cfg13 A/B separates the two; INTERNALS §17).
REPLAY_DEPTH = 0


def decode_text_changes_columnar(data, obj_id: str):
    """Wire payload -> TextChangeBatch with columns attached.

    THE production text ingestion boundary (`DeviceTextDoc._decode_wire`
    routes `apply_changes` here). `data` may be a JSON change list
    (str/bytes — the sync wire format; parsed by the Python decoder) or already-parsed wire dicts (the vectorized numpy
    decoder below for bulk payloads; per-op Python walk for small
    windows and shapes outside the numpy scope). The per-change columns
    are built eagerly: the caller hands the engine a batch whose first
    `prepare_batch` is already fully columnar."""
    from .columnar import TextChangeBatch
    from .. import obs
    _t0 = obs.now() if obs.ENABLED else 0
    if isinstance(data, (str, bytes)):
        batch = TextChangeBatch.from_json(data, obj_id)
        bulk = batch.n_ops >= _NUMPY_MIN_OPS
    else:
        batch = None
        bulk = (isinstance(data, list)
                and sum(len(c.get("ops", ())) for c in data
                        if isinstance(c, dict)) >= _NUMPY_MIN_OPS)
        if bulk:
            batch = _from_changes_numpy(data, obj_id)
        if batch is None:
            batch = TextChangeBatch.from_changes(data, obj_id)
    # eager columns only where they amortize: an interactive window's
    # columns would cost more to derive than the per-change loop saves,
    # and the scheduler applies the same gate (base._schedule_columnar)
    if bulk:
        change_columns(batch)
    if obs.ENABLED:
        obs.span("plan", "decode_replay" if REPLAY_DEPTH else "decode",
                 _t0, args={
                     "obj": obj_id, "n_changes": batch.n_changes,
                     "n_ops": batch.n_ops, "bulk": bulk})
    return batch


_ACTION_LIST = ("del", "inc", "ins", "link", "set")   # sorted


def _from_changes_numpy(changes, obj_id: str):
    """Vectorized wire-dict decoder for text/list batches.

    One flat field-extraction pass (C-speed list building), then numpy
    interning: actors through `np.unique`, elemId references parsed once
    per DISTINCT string instead of once per op (`np.unique` +
    searchsorted inverse). Values outside the plain single-character /
    small-int scope return None — the caller falls back to the per-op
    decoder, which handles the rich shapes. Identical output to
    `TextChangeBatch.from_changes` on everything it accepts."""
    from .._common import HEAD_PARENT, KIND_DEL, KIND_INC, KIND_INS, KIND_SET
    from .columnar import TextChangeBatch, _int32_col, intern_deps
    if not isinstance(changes, list) or not changes:
        return None
    try:
        actors = [c["actor"] for c in changes]
        seqs = [c["seq"] for c in changes]
        deps = [c.get("deps", {}) for c in changes]
        messages = [c.get("message") for c in changes]
        ops_per = [len(c["ops"]) for c in changes]
        flat_ops = [op for c in changes for op in c["ops"]]
        n_ops = len(flat_ops)
        actions = [op["action"] for op in flat_ops]
        objs = [op.get("obj") for op in flat_ops]
        keys = [op.get("key") for op in flat_ops]
    except (KeyError, TypeError):
        return None
    if any(o != obj_id for o in objs):
        raise ValueError(f"op targets a different object, batch is for "
                         f"{obj_id}")

    act_arr = np.asarray(actions, object)
    code = np.searchsorted(np.asarray(_ACTION_LIST, object), act_arr)
    code_safe = np.clip(code, 0, len(_ACTION_LIST) - 1)
    if not (np.asarray(_ACTION_LIST, object)[code_safe] == act_arr).all():
        return None                       # unknown action: per-op path raises
    code = code_safe
    is_ins = code == 2
    is_set = code == 4
    is_link = code == 3

    # scope gate: plain values only (single non-datatype chars on set,
    # int deltas on inc). Anything else -> per-op decoder.
    vals = np.zeros(n_ops, np.int64)
    for j in np.flatnonzero(is_set | (code == 1) | is_link):
        op = flat_ops[j]
        if "datatype" in op and op.get("datatype"):
            return None
        v = op.get("value")
        if code[j] == 1:                  # inc
            if not isinstance(v, int) or isinstance(v, bool):
                return None
            vals[j] = v
        elif code[j] == 3:                # link: pooled, out of scope here
            return None
        else:                             # set
            if not (isinstance(v, str) and len(v) == 1):
                return None
            vals[j] = ord(v)

    # elemId interning: every non-head key string parses ONCE. ins keys
    # are the parent ref ('_head' allowed); assign keys are the target.
    key_arr = np.asarray(keys, object)
    if (key_arr == None).any():           # noqa: E711  (missing key field)
        return None
    is_head = is_ins & (key_arr == "_head")
    need = ~is_head
    uniq_keys, key_inv = np.unique(key_arr[need], return_inverse=True)
    u_actor: list = []
    u_ctr = np.empty(len(uniq_keys), np.int64)
    for i, k in enumerate(uniq_keys.tolist()):
        # mirror parse_elem_id exactly (`(.*):(\d+)`): a ctr that is not
        # pure digits (e.g. "b:+5") must NOT decode — bare int() would
        # silently alias it onto a valid element instead of failing
        if not isinstance(k, str):
            return None
        a, sep, c = k.rpartition(":")
        if not (a and sep and c.isdigit()):
            return None
        u_ctr[i] = int(c)
        u_actor.append(a)

    # batch-local actor table: change actors first (in change order, as
    # the per-op decoder interns them), then elemId actors on first use.
    # Replicate the walk's first-appearance order exactly so the two
    # decoders emit identical batches: walk op order, interning the
    # change actor at each change start, then each op's referenced actor.
    rank: dict = {}
    actor_table: list = []

    def intern(a: str) -> int:
        r = rank.get(a)
        if r is None:
            r = rank[a] = len(actor_table)
            actor_table.append(a)
        return r

    ref_rank = np.empty(len(uniq_keys), np.int64)
    op_change = np.repeat(np.arange(len(changes), dtype=np.int32),
                          np.asarray(ops_per, np.int64))
    # first-appearance interleaving of change actors and referenced
    # actors: iterate unique keys in FIRST-USE op order with change
    # boundaries interleaved
    first_use = np.full(len(uniq_keys), n_ops, np.int64)
    np.minimum.at(first_use, key_inv, np.flatnonzero(need))
    order = np.argsort(first_use, kind="stable")
    boundaries = np.cumsum([0] + ops_per[:-1])
    bi = 0
    for u in order.tolist():
        pos = first_use[u]
        while bi < len(boundaries) and boundaries[bi] <= pos:
            intern(actors[bi])
            bi += 1
        ref_rank[u] = intern(u_actor[u])
    while bi < len(changes):
        intern(actors[bi])
        bi += 1

    ta = np.zeros(n_ops, np.int32)
    tc = np.zeros(n_ops, np.int32)
    # assigns and head-parented ins both carry HEAD_PARENT in the parent
    # column (only a referenced ins parent overrides it) — the per-op
    # decoder's exact layout
    pa = np.full(n_ops, HEAD_PARENT, np.int32)
    pc = np.zeros(n_ops, np.int32)
    need_idx = np.flatnonzero(need)
    row_rank = np.asarray([rank[a] for a in actors], np.int64)

    # ins: target = (change actor, elem), parent = key ref (or head)
    ins_idx = np.flatnonzero(is_ins)
    if len(ins_idx):
        try:
            elems = np.asarray([flat_ops[j]["elem"] for j in ins_idx])
        except (KeyError, TypeError):
            return None
        if not np.issubdtype(elems.dtype, np.integer):
            return None
        ta[ins_idx] = row_rank[op_change[ins_idx]]
        tc[ins_idx] = _int32_col("elemId counter", elems)
    # non-head refs scatter through the unique-key inverse
    ref_of_op = np.zeros(n_ops, np.int64)
    ref_of_op[need_idx] = key_inv
    ins_ref = is_ins & ~is_head
    if ins_ref.any():
        pa[ins_ref] = ref_rank[ref_of_op[ins_ref]]
        pc[ins_ref] = _int32_col("parent elemId counter",
                                 u_ctr[ref_of_op[ins_ref]])
    assign = ~is_ins
    if assign.any():
        ta[assign] = ref_rank[ref_of_op[assign]]
        tc[assign] = _int32_col("elemId counter", u_ctr[ref_of_op[assign]])

    kind_map = np.asarray([KIND_DEL, KIND_INC, KIND_INS, KIND_SET, KIND_SET],
                          np.int8)
    batch = TextChangeBatch(
        obj_id=obj_id, actors=actors,
        seqs=_int32_col("seq", seqs, lo=1), deps=intern_deps(deps),
        messages=messages, op_change=op_change, op_kind=kind_map[code],
        op_target_actor=ta, op_target_ctr=tc, op_parent_actor=pa,
        op_parent_ctr=pc, op_value=vals, actor_table=actor_table,
        value_pool=[])
    return batch
