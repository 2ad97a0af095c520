"""The port's stacked executor (automerge_tpu_torch.engine.stacked,
device="cpu") against the JAX package's.

Populations of map and text documents start from ONE state (a seed round
applied per document by the JAX engine, carried into the port by
automerge_tpu_torch.state), then the same deliveries go through both
packages' `apply_stacked` with ``AMTPU_STACKED_MIN_OPS=1``: mixed map and
text lanes, text residual rounds (deletes, assigns, unpaired inserts),
map counters (the host slow path and `fused_scatter_registers`),
multi-round causal chains, out-of-order and duplicate deliveries, and an
actor that sorts before the interned table (its remap folds into the
stacked gather). Compared with zero tolerance: the live prefixes of the
tables (slots 0..n_elems of the text tables, the first len(key_table)
registers), the host mirrors, `_pos_cache`, conflicts, clocks, texts and
map values, and the apply's stats dict.

Also here: the row forms' drop-mode scatters keep a dropped index inside
its own row (the next document's head slot stays as it was), an
ineligible population returns False and changes nothing, `worth_trying`
is `apply_stacked`'s own gate, every document owns its tables after an
apply, and `fused_stacked_round` equals
per-document calls of the solo round programs and the JAX program."""

import random

import numpy as np
import pytest
import torch

from automerge_tpu.engine import DeviceMapDoc as JMap
from automerge_tpu.engine import DeviceTextDoc as JText
from automerge_tpu.engine import stacked as JS
from automerge_tpu_torch import state
from automerge_tpu_torch.engine import DeviceMapDoc as TMap
from automerge_tpu_torch.engine import DeviceTextDoc as TText
from automerge_tpu_torch.engine import stacked as TS
from automerge_tpu_torch.ops import fused_round as TF
from automerge_tpu_torch.ops import ingest as TI

TEXT_KEYS = ("parent", "ctr", "actor", "value", "has_value", "win_actor",
             "win_seq", "win_counter", "chain")
REG_KEYS = ("value", "has_value", "win_actor", "win_seq", "win_counter")


@pytest.fixture(autouse=True)
def _small_gate(monkeypatch):
    """Engage the stacked path at test scale on both packages."""
    monkeypatch.setenv("AMTPU_STACKED_MIN_OPS", "1")


# ---------------------------------------------------------------------------
# populations: wire changes over map and text documents
# ---------------------------------------------------------------------------


class Population:
    """Seeded change streams over `n_text` text and `n_map` map documents.
    Round r's change of every actor depends on every actor's round r-1
    change, so round r's ops may reference anything minted before it."""

    def __init__(self, seed, n_text=4, n_map=3, actors=("a1", "a2", "a3")):
        self.rng = random.Random(seed)
        self.text_ids = [f"t{i}" for i in range(n_text)]
        self.map_ids = [f"m{i}" for i in range(n_map)]
        self.actors = list(actors)
        self.elems = {o: [] for o in self.text_ids}   # minted elemIds
        self.ctr = {o: 0 for o in self.text_ids}
        self.prev = {}                                 # actor -> last seq

    def _deps(self, actor):
        return {a: s for a, s in self.prev.items() if a != actor}

    def _text_ops(self, o, actor, first):
        rng, ops = self.rng, []
        known = list(self.elems[o])
        minted = []

        def ins(after, value=True):
            self.ctr[o] += 1
            c = self.ctr[o]
            ops.append({"action": "ins", "obj": o, "key": after, "elem": c})
            eid = f"{actor}:{c}"
            if value:
                ops.append({"action": "set", "obj": o, "key": eid,
                            "value": chr(97 + rng.randrange(26))})
            minted.append(eid)
            return eid

        after = rng.choice(known) if known and rng.random() < 0.7 \
            else "_head"
        for _ in range(rng.randint(2, 6)):          # a typing run
            after = ins(after)
        if not first:
            if known and rng.random() < 0.6:
                ops.append({"action": "del", "obj": o,
                            "key": rng.choice(known)})
            if known and rng.random() < 0.6:
                # often one of the first few elements: concurrent writers
                # of one element become conflicts
                ops.append({"action": "set", "obj": o,
                            "key": rng.choice(known[:3] if rng.random() < 0.5
                                              else known),
                            "value": chr(65 + rng.randrange(26))})
            if known and rng.random() < 0.4:
                # an insert whose value comes later: a residual insert
                eid = ins(rng.choice(known), value=False)
                ins(eid)
                ops.append({"action": "set", "obj": o, "key": eid,
                            "value": "!"})
        return ops, minted

    def _map_ops(self, o, actor, first):
        rng, ops = self.rng, []
        if first and actor == self.actors[0]:
            ops.append({"action": "set", "obj": o, "key": "cnt", "value": 5,
                        "datatype": "counter"})
        for _ in range(rng.randint(1, 4)):
            key = f"k{rng.randrange(6)}"
            r = rng.random()
            if r < 0.55:
                ops.append({"action": "set", "obj": o, "key": key,
                            "value": rng.randrange(1000)})
            elif r < 0.7:
                ops.append({"action": "set", "obj": o, "key": key,
                            "value": f"s{rng.randrange(99)}"})
            elif not first:
                ops.append({"action": "del", "obj": o, "key": key})
        if not first:
            ops.append({"action": "inc", "obj": o, "key": "cnt",
                        "value": rng.randint(-3, 9)})
        return ops

    def round(self, actors=None):
        """One causal round: {obj_id: [wire changes]}."""
        actors = self.actors if actors is None else actors
        out = {o: [] for o in self.text_ids + self.map_ids}
        minted = {o: [] for o in self.text_ids}
        nxt = {}
        for actor in actors:
            seq = self.prev.get(actor, 0) + 1
            first = seq == 1
            deps = self._deps(actor)
            for o in self.text_ids:
                ops, m = self._text_ops(o, actor, first)
                minted[o] += m
                out[o].append({"actor": actor, "seq": seq, "deps": deps,
                               "ops": ops})
            for o in self.map_ids:
                out[o].append({"actor": actor, "seq": seq, "deps": deps,
                               "ops": self._map_ops(o, actor, first)})
            nxt[actor] = seq
        self.prev.update(nxt)
        for o in self.text_ids:
            self.elems[o] += minted[o]
        return out


def seeded_pair(pop: Population):
    """Both packages' documents after one seed round applied per document
    by the JAX engine, the port's loaded from the carried state."""
    seed = pop.round()
    jdocs, tdocs = {}, {}
    for o in pop.text_ids:
        jdocs[o] = JText(o, capacity=64).apply_changes(seed[o])
        tdocs[o] = state.load_text_doc_state(TText(o, device="cpu"),
                                             state.host_state(jdocs[o]))
    for o in pop.map_ids:
        jdocs[o] = JMap(o, capacity=16).apply_changes(seed[o])
        tdocs[o] = state.load_map_doc_state(TMap(o, device="cpu"),
                                            state.map_state(jdocs[o]))
    return jdocs, tdocs


def deliver(jdocs, tdocs, delivery: dict):
    """One delivery {obj: [changes]} through both stacked executors; both
    must decide alike, and an ineligible one applies per document."""
    order = [o for o in delivery if delivery[o]]
    js = JS.apply_stacked([(jdocs[o], delivery[o]) for o in order])
    ts = TS.apply_stacked([(tdocs[o], delivery[o]) for o in order])
    assert bool(js) == bool(ts)
    if js:
        assert ts == js
        TS.assert_round_budget(ts)
    else:
        for o in order:
            jdocs[o].apply_changes(delivery[o])
            tdocs[o].apply_changes(delivery[o])
    return ts


def assert_docs_equal(jdoc, tdoc):
    assert tdoc.clock == jdoc.clock
    assert tdoc.actor_table == jdoc.actor_table
    assert tdoc.conflicts == jdoc.conflicts
    assert tdoc.value_pool == jdoc.value_pool
    assert len(tdoc.queue) == len(jdoc.queue)
    assert tdoc._cap == jdoc._cap
    if isinstance(jdoc, JText):
        n = jdoc.n_elems + 1
        keys = TEXT_KEYS
        assert tdoc.n_elems == jdoc.n_elems
        jp, tp = jdoc._pos_cache, tdoc._pos_cache
        assert (tp is None) == (jp is None)
        if jp is not None:
            np.testing.assert_array_equal(tp, np.asarray(jp))
        for a, b in zip(tdoc.index.rows(), jdoc.index.rows()):
            np.testing.assert_array_equal(a, b)
    else:
        n = len(jdoc.key_table)
        keys = REG_KEYS
        assert tdoc.key_table == jdoc.key_table
    jh, th = jdoc._host, tdoc._host
    assert (th is None) == (jh is None)
    if jh is not None:
        assert sorted(th) == sorted(jh)
        for k in jh:
            np.testing.assert_array_equal(th[k], np.asarray(jh[k]), err_msg=k)
    jd, td = jdoc._ensure_dev(), tdoc._ensure_dev()
    for k in keys:
        a, b = np.asarray(jd[k]), td[k].numpy()
        assert b.dtype == a.dtype, k
        np.testing.assert_array_equal(b[:n], a[:n], err_msg=k)
    if isinstance(jdoc, JText):
        assert tdoc.text() == jdoc.text()
        assert tdoc.values() == jdoc.values()
        for i in range(len(jdoc.values())):
            assert tdoc.conflicts_at(i) == jdoc.conflicts_at(i)
    else:
        assert tdoc.to_dict() == jdoc.to_dict()
        for key in jdoc.key_table:
            assert tdoc.conflicts_for(key) == jdoc.conflicts_for(key)


def assert_all_equal(jdocs, tdocs):
    for o in jdocs:
        assert_docs_equal(jdocs[o], tdocs[o])


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_mixed_population_rounds_match_jax(seed):
    """Mixed map + text lanes, text residual rounds and map counters,
    round after round, one delivery per round."""
    pop = Population(seed)
    jdocs, tdocs = seeded_pair(pop)
    for _ in range(3):
        st = deliver(jdocs, tdocs, pop.round())
        assert st and st["map_docs"] == 3 and st["text_docs"] == 4
        assert_all_equal(jdocs, tdocs)


def test_cross_doc_planning_matches_jax():
    """Documents receiving batches of one wire shape share one planning
    pass (engine/cross_doc.py): admission templates, one run detection,
    seeded rank caches — with the same stats as the JAX package's."""
    def items(mk):
        docs = {f"c{i}": mk(f"c{i}") for i in range(4)}
        out = []
        for k, doc in docs.items():
            ops, key = [], "_head"
            for j in range(1, 9):
                ops.append({"action": "ins", "obj": k, "key": key,
                            "elem": j})
                ops.append({"action": "set", "obj": k, "key": f"a:{j}",
                            "value": chr(97 + j)})
                key = f"a:{j}"
            out.append((doc, [{"actor": "a", "seq": 1, "deps": {},
                               "ops": ops}]))
        return docs, out
    jdocs, jitems = items(JText)
    tdocs, titems = items(lambda o: TText(o, device="cpu"))
    js, ts = JS.apply_stacked(jitems), TS.apply_stacked(titems)
    assert ts == js
    assert ts["cross_doc"]["sched_shared"] == 3
    assert ts["index_merges"] == ts["text_plans"] == 4
    TS.assert_round_budget(ts)
    with pytest.raises(AssertionError, match="bulk merge per doc"):
        TS.assert_round_budget({**ts, "index_merges": 5})
    assert_all_equal(jdocs, tdocs)


def test_text_residual_rounds_match_jax():
    """Text documents alone, every round carrying residual ops."""
    pop = Population(11, n_text=5, n_map=0)
    jdocs, tdocs = seeded_pair(pop)
    for _ in range(3):
        assert deliver(jdocs, tdocs, pop.round())
    assert_all_equal(jdocs, tdocs)


def test_map_counters_take_the_slow_path():
    """Map documents alone: counter increments and concurrent writes take
    the host slow path, written back by `fused_scatter_registers`."""
    pop = Population(12, n_text=0, n_map=4)
    jdocs, tdocs = seeded_pair(pop)
    acct = dict(TS.accounting.LABELS["dispatch"].get("fused_scatter",
                                                     {"n": 0}))
    for _ in range(2):
        assert deliver(jdocs, tdocs, pop.round())
    assert TS.accounting.LABELS["dispatch"]["fused_scatter"]["n"] > acct["n"]
    assert_all_equal(jdocs, tdocs)
    assert all("cnt" in tdocs[o].to_dict() for o in pop.map_ids)


def test_multi_round_causal_chains_match_jax():
    """Three causally chained rounds in ONE delivery: >= 3 stacked rounds
    executed as ordered passes."""
    pop = Population(13)
    jdocs, tdocs = seeded_pair(pop)
    rounds = [pop.round() for _ in range(3)]
    delivery = {o: [c for r in rounds for c in r[o]] for o in rounds[0]}
    st = deliver(jdocs, tdocs, delivery)
    assert st["rounds"] >= 3
    assert_all_equal(jdocs, tdocs)


@pytest.mark.parametrize("seed", [3, 4])
def test_out_of_order_and_duplicate_deliveries(seed):
    """Shuffled, chunked deliveries with duplicates: premature changes
    queue, duplicates skip, and both packages commit the same state
    through every partial apply."""
    pop = Population(seed)
    jdocs, tdocs = seeded_pair(pop)
    rng = random.Random(seed)
    pairs = [(o, c) for _ in range(3) for o, cs in pop.round().items()
             for c in cs]
    rng.shuffle(pairs)
    for _ in range(4):
        pairs.insert(rng.randrange(len(pairs) + 1), rng.choice(pairs))
    i = 0
    while i < len(pairs):
        n = rng.randrange(3, 12)
        delivery = {}
        for o, c in pairs[i: i + n]:
            delivery.setdefault(o, []).append(c)
        deliver(jdocs, tdocs, delivery)
        assert_all_equal(jdocs, tdocs)
        i += n
    assert all(not d.queue for d in tdocs.values())


def test_actor_remap_folds_into_the_gather():
    """An actor sorting before every interned actor re-ranks the tables:
    the remap folds into the stacked gather (no per-doc remap program)."""
    pop = Population(14)
    jdocs, tdocs = seeded_pair(pop)
    deliver(jdocs, tdocs, pop.round())
    pop.actors.append("0-early")
    before = dict(TS.accounting.LABELS["dispatch"])
    st = deliver(jdocs, tdocs, pop.round())
    assert st
    after = TS.accounting.LABELS["dispatch"]
    for label in ("remap_actors", "remap_ranks"):
        assert after.get(label, {"n": 0})["n"] == \
            before.get(label, {"n": 0})["n"]
    assert all(d.actor_table[0] == "0-early" for d in tdocs.values())
    assert_all_equal(jdocs, tdocs)


def test_ineligible_population_changes_nothing(monkeypatch):
    """A declined population (one document, a tiny payload, a capacity
    mix over the cell gate) returns False with nothing mutated."""
    pop = Population(15, n_text=2, n_map=1)
    _jdocs, tdocs = seeded_pair(pop)
    delivery = pop.round()
    snap = {o: (dict(d.clock), {k: v.clone() for k, v in
                                d._ensure_dev().items()}, d._gen)
            for o, d in tdocs.items()}
    items = [(tdocs[o], delivery[o]) for o in delivery]
    assert TS.apply_stacked(items[:1]) is False
    monkeypatch.setenv("AMTPU_STACKED_MIN_OPS", "100000")
    assert TS.apply_stacked(items) is False
    monkeypatch.setenv("AMTPU_STACKED_MIN_OPS", "1")
    monkeypatch.setenv("AMTPU_STACKED_MAX_CELLS", "10")
    assert TS.apply_stacked(items) is False
    for o, d in tdocs.items():
        clock, tables, gen = snap[o]
        assert d.clock == clock and d._gen == gen and not d.queue
        for k, v in d._ensure_dev().items():
            assert torch.equal(v, tables[k]), (o, k)


def test_donating_document_is_declined():
    pop = Population(16, n_text=2, n_map=0)
    _jdocs, tdocs = seeded_pair(pop)
    tdocs["t0"].donate_buffers = True
    delivery = pop.round()
    assert TS.apply_stacked([(tdocs[o], delivery[o])
                             for o in delivery]) is False


@pytest.mark.parametrize("min_ops", ["1", "40", "100000"])
def test_worth_trying_is_apply_stacked_gate(min_ops, monkeypatch):
    """`worth_trying` hoists `apply_stacked`'s own pre-decode gates (two
    op-bearing documents, AMTPU_STACKED_MIN_OPS wire ops) and answers as
    the JAX package's does: where it says no, the delivery is declined
    with nothing mutated; where it says yes, the delivery stacks."""
    pop = Population(18, n_text=2, n_map=1)
    _jdocs, tdocs = seeded_pair(pop)
    delivery = pop.round()
    items = [(tdocs[o], delivery[o]) for o in delivery]
    n_wire = sum(len(c["ops"]) for _, subs in items for c in subs)
    monkeypatch.setenv("AMTPU_STACKED_MIN_OPS", min_ops)
    for n_docs in (0, 1, 2, len(items)):
        for n in (0, n_wire // 2, n_wire, n_wire * 2):
            assert TS.worth_trying(n, n_docs) == JS.worth_trying(n, n_docs)
    assert not TS.worth_trying(n_wire, 1)
    assert TS.apply_stacked(items[:1]) is False
    clocks = {o: dict(d.clock) for o, d in tdocs.items()}
    if TS.worth_trying(n_wire, len(items)):
        assert TS.apply_stacked(items)
    else:
        assert TS.apply_stacked(items) is False
        assert {o: d.clock for o, d in tdocs.items()} == clocks


def test_each_document_owns_its_tables_after_an_apply():
    """`_finalize` hands every document tables of its own (disjoint rows
    of one fresh copy per dtype): an in-place write to one document's
    tables leaves every other unchanged."""
    pop = Population(17, n_text=3, n_map=2)
    jdocs, tdocs = seeded_pair(pop)
    assert deliver(jdocs, tdocs, pop.round())
    snap = {o: {k: v.clone() for k, v in d._dev.items()}
            for o, d in tdocs.items()}
    for t in tdocs["t0"]._dev.values():
        t.fill_(7)
    for t in tdocs["m0"]._dev.values():
        t.fill_(7)
    for o, d in tdocs.items():
        if o in ("t0", "m0"):
            continue
        for k, v in d._dev.items():
            assert torch.equal(v, snap[o][k]), (o, k)


# ---------------------------------------------------------------------------
# row forms: drop-mode scatters stay inside their row
# ---------------------------------------------------------------------------


def test_drop_sentinel_stays_in_its_row():
    """Row d's out-of-range index n (the padding sentinel) must not land
    on row d + 1's slot 0 (its head slot), and a negative index wraps
    within its own row."""
    dst = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    idx = torch.tensor([[4, 9, -1], [4, 0, -4], [5, 4, 2]])
    vals = torch.full((3, 3), -7, dtype=torch.int32)
    got = TI._set_drop_r(dst, idx, vals)
    want = dst.clone()
    want[0, 3] = -7
    want[1, 0] = -7
    want[2, 2] = -7
    assert torch.equal(got, want)


def test_stacked_round_padding_leaves_next_head_slot():
    """A stacked text round whose first document carries only padding
    residual rows (slot = out_cap) leaves the second document's head
    slot — and every other slot — exactly as it was."""
    cap, D = 32, 2
    tables = [torch.zeros((D, cap), dtype=torch.int32) for _ in range(9)]
    for k in (4, 7, 8):
        tables[k] = torch.zeros((D, cap), dtype=torch.bool)
    tables[0][1, 0] = 55          # doc 1's head slot, distinctive
    tables[1][1, 0] = 66
    tables[5][:] = -1
    desc = np.zeros((D, 9, 64), np.int32)
    desc[:, TI.DESC_ELEM_BASE] = 256
    res = np.zeros((D, 8, 128), np.int32)
    res[:, TI.RES_KIND] = -1
    res[:, TI.RES_SLOT] = cap
    res[:, TI.RES_NEW_SLOT] = cap
    res[0, TI.RES_KIND, 0] = 2    # a live assign on doc 0, slot 0 of row 0
    res[0, TI.RES_SLOT, 0] = cap  # ... that targets the sentinel
    touch = np.zeros((D, 3, 64), np.int32)
    touch[:, 1:] = -1
    out = TF.fused_stacked_round(
        *(TF._absent("cpu"),) * 7, *tables, torch.from_numpy(desc),
        torch.zeros((D, 256), dtype=torch.int32), torch.from_numpy(res),
        torch.full((D, 64), cap, dtype=torch.int32),
        torch.from_numpy(touch), map_cap=1, text_cap=cap, with_map=False,
        with_text=True)
    for k in range(9):
        assert torch.equal(out[k], tables[k]), TEXT_KEYS[k]


# ---------------------------------------------------------------------------
# fused_stacked_round against the solo programs and the JAX program
# ---------------------------------------------------------------------------


def _random_text_round(rng, cap, R, N, M, T, n_elems):
    """One document's (desc, blob, res, conflict, touch) with distinct
    write targets: a dense run window after n_elems, residual inserts past
    it, residual assigns on live slots."""
    n_runs = int(rng.integers(0, 4))
    lens = rng.integers(1, 5, n_runs)
    desc = np.zeros((9, R), np.int32)
    desc[TI.DESC_ELEM_BASE] = N
    base = n_elems + 1
    eb = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32) \
        if n_runs else np.zeros(0, np.int32)
    desc[TI.DESC_HEAD_SLOT, :n_runs] = base + eb
    desc[TI.DESC_PARENT_SLOT, :n_runs] = rng.integers(0, n_elems + 1, n_runs)
    desc[TI.DESC_CTR0, :n_runs] = rng.integers(1, 50, n_runs)
    desc[TI.DESC_ACTOR, :n_runs] = rng.integers(0, 4, n_runs)
    desc[TI.DESC_WIN_ACTOR, :n_runs] = rng.integers(0, 4, n_runs)
    desc[TI.DESC_WIN_SEQ, :n_runs] = rng.integers(1, 9, n_runs)
    desc[TI.DESC_ELEM_BASE, :n_runs] = eb
    desc[TI.DESC_HAS_VALUE, :n_runs] = 1
    n_run_elems = int(lens.sum()) if n_runs else 0
    desc[TI.DESC_META, TI.META_N_ELEMS] = n_run_elems
    desc[TI.DESC_META, TI.META_BASE_SLOT] = base
    desc[TI.DESC_META, TI.META_N_RUNS] = n_runs
    blob = np.zeros(N, np.int32)
    blob[:n_run_elems] = rng.integers(97, 123, n_run_elems)
    res = np.zeros((8, M), np.int32)
    res[TI.RES_KIND] = -1
    res[TI.RES_SLOT] = cap
    res[TI.RES_NEW_SLOT] = cap
    n_res = int(rng.integers(0, 5))
    next_slot = base + n_run_elems
    for i in range(n_res):
        if rng.random() < 0.4:
            res[TI.RES_KIND, i] = 0                   # KIND_INS
            res[TI.RES_SLOT, i] = rng.integers(0, n_elems + 1)
            res[TI.RES_NEW_SLOT, i] = next_slot
            res[TI.RES_CTR, i] = rng.integers(1, 60)
            res[TI.RES_ACTOR, i] = rng.integers(0, 4)
            next_slot += 1
        else:
            res[TI.RES_KIND, i] = int(rng.integers(1, 4))  # set/del/inc
            res[TI.RES_SLOT, i] = rng.integers(1, n_elems + 1)
        res[TI.RES_VALUE, i] = rng.integers(-2, 120)
        res[TI.RES_WIN_ACTOR, i] = rng.integers(0, 4)
        res[TI.RES_WIN_SEQ, i] = rng.integers(1, 9)
    conflict = np.full(8, cap, np.int32)
    conflict[0] = rng.integers(1, n_elems + 1)
    touch = np.zeros((3, T), np.int32)
    touch[1:] = -1
    k = int(rng.integers(0, 4))
    touch[0, :k] = rng.integers(0, n_elems + 1, k)
    touch[1, :k] = rng.integers(1, 60, k)
    touch[2, :k] = rng.integers(0, 4, k)
    return desc, blob, res, conflict, touch


def _random_tables(rng, cap, n_elems):
    t = [np.zeros(cap, np.int32) for _ in range(9)]
    s = np.arange(1, n_elems + 1)
    t[0][s] = rng.integers(0, s)            # parent before the slot
    t[1][s] = rng.integers(1, 40, n_elems)
    t[2][s] = rng.integers(0, 4, n_elems)
    t[3][s] = rng.integers(97, 123, n_elems)
    t[4] = np.zeros(cap, bool)
    t[4][s] = rng.random(n_elems) < 0.8
    t[5] = np.full(cap, -1, np.int32)
    t[5][s] = rng.integers(0, 4, n_elems)
    t[6][s] = rng.integers(1, 9, n_elems)
    t[7] = rng.random(cap) < 0.1
    t[8] = np.zeros(cap, bool)
    t[8][s] = rng.random(n_elems) < 0.5
    return t


@pytest.mark.parametrize("seed", range(3))
def test_fused_stacked_round_matches_solo_and_jax(seed):
    """Every row of one `fused_stacked_round` (both lanes) equals the
    port's solo `fused_mixed_round` / `apply_map_round` on that row's
    inputs, and the whole result equals the JAX `fused_stacked_round`."""
    import jax.numpy as jnp
    from automerge_tpu.ops import fused_round as JF

    rng = np.random.default_rng(seed)
    cap, D, R, N, M, T = 64, 4, 64, 256, 128, 64
    ns = rng.integers(3, 20, D)
    per_doc = [_random_tables(rng, cap, int(n)) for n in ns]
    rounds = [_random_text_round(rng, cap, R, N, M, T, int(n)) for n in ns]
    stk = [np.stack([p[k] for p in per_doc]) for k in range(9)]
    ops_t = [np.stack([r[i] for r in rounds]) for i in range(5)]
    mcap, Dm, Mm = 32, 3, 128
    regs = [rng.integers(0, 50, (Dm, 16)).astype(np.int32),
            rng.random((Dm, 16)) < 0.5,
            rng.integers(-1, 4, (Dm, 16)).astype(np.int32),
            rng.integers(0, 5, (Dm, 16)).astype(np.int32),
            rng.random((Dm, 16)) < 0.1]
    m_ops = np.zeros((Dm, 5, Mm), np.int32)
    m_ops[:, TI.MOP_KIND] = -1
    m_ops[:, TI.MOP_SLOT] = mcap
    for d in range(Dm):
        n = int(rng.integers(1, 9))
        m_ops[d, TI.MOP_KIND, :n] = rng.integers(1, 4, n)
        m_ops[d, TI.MOP_SLOT, :n] = rng.integers(0, mcap, n)
        m_ops[d, TI.MOP_VALUE, :n] = rng.integers(-2, 90, n)
        m_ops[d, TI.MOP_WIN_ACTOR, :n] = rng.integers(0, 5, n)
        m_ops[d, TI.MOP_WIN_SEQ, :n] = rng.integers(1, 6, n)
    m_conf = np.full((Dm, 4), mcap, np.int32)
    m_conf[:, 0] = rng.integers(0, mcap, Dm)

    t = torch.from_numpy
    got = TF.fused_stacked_round(
        *map(t, regs), t(m_ops), t(m_conf), *map(t, stk), *map(t, ops_t),
        map_cap=mcap, text_cap=cap, with_map=True, with_text=True)
    assert len(got) == 16
    want = JF.fused_stacked_round(
        *map(jnp.asarray, regs), jnp.asarray(m_ops), jnp.asarray(m_conf),
        *map(jnp.asarray, stk), *map(jnp.asarray, ops_t), map_cap=mcap,
        text_cap=cap, with_map=True, with_text=True, mode="lax")
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    for d in range(Dm):
        solo = TI.apply_map_round(
            *(t(r[d]) for r in regs), t(m_ops[d, TI.MOP_KIND]),
            t(m_ops[d, TI.MOP_SLOT]), t(m_ops[d, TI.MOP_VALUE]),
            t(m_ops[d, TI.MOP_WIN_ACTOR]), t(m_ops[d, TI.MOP_WIN_SEQ]),
            t(m_conf[d]), out_cap=mcap)
        for s, g in zip(solo, got[:6]):
            assert torch.equal(s, g[d])
    for d in range(D):
        solo = TF.fused_mixed_round(
            *(t(x) for x in per_doc[d]), *(t(x) for x in rounds[d]),
            out_cap=cap)
        for s, g in zip(solo, got[6:]):
            assert torch.equal(s, g[d])


def test_absent_lane_returns_only_the_live_lane():
    cap, D = 32, 2
    regs = (torch.zeros((D, cap), dtype=torch.int32),
            torch.zeros((D, cap), dtype=torch.bool),
            torch.full((D, cap), -1, dtype=torch.int32),
            torch.zeros((D, cap), dtype=torch.int32),
            torch.zeros((D, cap), dtype=torch.bool))
    ops = torch.full((D, 5, 128), cap, dtype=torch.int32)
    ops[:, TI.MOP_KIND] = -1
    out = TF.fused_stacked_round(
        *regs, ops, torch.full((D, 4), cap, dtype=torch.int32),
        *(TF._absent("cpu"),) * 14, map_cap=cap, text_cap=1, with_map=True,
        with_text=False)
    assert len(out) == 6
    for a, b in zip(out[:5], regs):
        assert torch.equal(a, b)
    assert not out[5][:, 0].any()                 # no slow op
