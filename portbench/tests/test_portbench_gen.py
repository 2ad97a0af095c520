"""The generators: deterministic by seed, of the sizes their traffic
files give, the same work for every seed, and causally ready."""

import numpy as np
import pytest

from conftest import small_cell
from portbench.drive import rng_for
from portbench.families import docset_build, docset_rounds, text_backlog

SEEDS = (0, 7, 2**31 + 5, 2**40 + 3, -12)
TEXT = ["text_1m.ring_backlog", "text_1m.residual_backlog"]


def _backlog_key(bl):
    return [(b.actors, b.targets.tolist(), b.letters.tolist())
            for b in bl.batches]


def _changes_key(rounds):
    return [{obj: [(c.actor, c.seq, sorted(c.deps.items()), c.ops)
                   for c in cs] for obj, cs in r.items()} for r in rounds]


def _rounds(seed, n=4):
    c = small_cell("docset_1k.append_rounds")
    pop = docset_build.Population(c.config, seed)
    g = docset_rounds.AppendRounds(pop, c.traffic, seed)
    return c, pop, [g.changes(r) for r in range(n)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", TEXT)
def test_backlog_is_deterministic_by_seed(name, seed):
    c = small_cell(name)
    a = text_backlog.backlog(c.config, c.traffic, seed)
    b = text_backlog.backlog(c.config, c.traffic, seed)
    assert _backlog_key(a) == _backlog_key(b)
    assert len(a.batches) == c.traffic["batches"]
    assert all(len(x.actors) == c.traffic["actors"] for x in a.batches)
    assert a.n_ops == (c.traffic["batches"] * c.traffic["actors"]
                       * (2 * c.traffic["pairs"] + c.traffic["deletes"]
                          + c.traffic["bare_inserts"]))


@pytest.mark.parametrize("name", TEXT)
def test_backlog_seeds_differ_in_order_not_in_work(name):
    c = small_cell(name)
    a = text_backlog.backlog(c.config, c.traffic, 1)
    b = text_backlog.backlog(c.config, c.traffic, 2)
    assert _backlog_key(a) != _backlog_key(b)
    for x, y in zip(a.batches, b.batches):
        assert sorted(x.targets.tolist()) == sorted(y.targets.tolist())


def test_zipf_quantiles_follow_the_law():
    """The quantile multiset sits where numpy's clipped Zipf draws do."""
    law = text_backlog.zipf_quantiles(1.2, 2000, 1_000_000)
    draws = rng_for(3, 9).zipf(1.2, (100, 2000)).clip(1, 1_000_000)
    for k in (1, 2, 10):
        want = (draws <= k).sum(1)
        assert abs((law <= k).sum() - want.mean()) < 3 * want.std() + 1
    assert abs((law == 1_000_000).sum()
               - (draws == 1_000_000).sum(1).mean()) < 15


@pytest.mark.parametrize("seed", SEEDS)
def test_rounds_are_deterministic_by_seed(seed):
    _, p1, r1 = _rounds(seed)
    _, p2, r2 = _rounds(seed)
    assert _changes_key([p1.changes()]) == _changes_key([p2.changes()])
    assert _changes_key(r1) == _changes_key(r2)


def test_rounds_are_ready_sized_and_touch_every_document():
    c, pop, rounds = _rounds(2**33 + 1, n=6)
    clock = {obj: {ch.actor: ch.seq for ch in cs}
             for obj, cs in pop.changes().items()}
    for changes in rounds:
        assert sorted(changes) == sorted(pop.ids)
        for obj, cs in changes.items():
            for ch in cs:
                # the next seq of its actor, on deps the doc already has
                assert ch.seq == clock[obj].get(ch.actor, 0) + 1
                assert all(clock[obj].get(a, 0) >= s
                           for a, s in ch.deps.items())
                clock[obj][ch.actor] = ch.seq
            assert sum(ch.n_ops for ch in cs) == 2 * c.traffic["run"]


def test_population_is_the_same_work_for_every_seed():
    c = small_cell("docset_1k.batched_build")
    a = docset_build.Population(c.config, 5).changes()
    b = docset_build.Population(c.config, 6).changes()
    shape = [[(ch.actor, ch.seq, [op[:2] for op in ch.ops]) for ch in cs]
             for cs in a.values()]
    assert shape == [[(ch.actor, ch.seq, [op[:2] for op in ch.ops])
                      for ch in cs] for cs in b.values()]
    assert _changes_key([a]) != _changes_key([b])


def test_program_batches_carry_the_generated_ops():
    """The program's columns say what the plain data says, op for op."""
    from portbench import drive
    M = drive.program()
    C = M.C
    c, pop, _ = _rounds(11)
    g = docset_rounds.AppendRounds(pop, c.traffic, 11)
    for changes, batches in ((pop.changes(), pop.batches(M)),
                             (g.changes(3), g.batches(M, 3))):
        for obj, cs in changes.items():
            b = batches[obj]
            rank = {a: i for i, a in enumerate(b.actor_table)}
            kinds = {"ins": C.KIND_INS, "set": C.KIND_SET}
            rows = []
            for ci, ch in enumerate(cs):
                assert (b.actors[ci], int(b.seqs[ci])) == (ch.actor, ch.seq)
                for op in ch.ops:
                    e = op[1]
                    if op[0] == "ins":
                        p = op[2]
                        par = ((C.HEAD_PARENT, 0) if p is None
                               else (rank[p[1]], p[0]))
                        rows.append((ci, kinds["ins"], rank[e[1]], e[0])
                                    + par + (0,))
                    else:
                        rows.append((ci, kinds["set"], rank[e[1]], e[0],
                                     0, 0, op[2]))
            got = list(zip(*(np.asarray(getattr(b, f)).tolist() for f in (
                "op_change", "op_kind", "op_target_actor", "op_target_ctr",
                "op_parent_actor", "op_parent_ctr", "op_value"))))
            assert got == rows
