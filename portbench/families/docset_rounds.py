"""Family `docset_rounds`: a server whose DocSet of many small text
documents, built as `docset_build` builds it, takes serving rounds
(bench.py's cfg12t population stream, `_sharded_text_round`).

The generator: in every round each document receives one causally ready
change from one actor (`writer`, the index of one of the documents'
actors) that types a run of `run` chars right after that actor's last
character: one ins/set pair a char. The seed draws the letters; the work
is the same for every seed.

The runner: set-up builds the set and makes the rounds; each unit hands
one round to `apply_batches` and reads `texts()`.
"""

from __future__ import annotations

import collections

import numpy as np

from portbench.drive import rng_for
from portbench.families.docset_build import (Change, DocSetRunner,
                                             Population, typing_run)
from portbench.reference.docset import DocSetReference


class AppendRounds:
    """The rounds, as plain data and as the program's columns."""

    def __init__(self, pop: Population, traffic: dict, seed: int):
        self.pop, self.seed = pop, seed
        self.w = int(traffic["writer"])
        self.writer = pop.actors[self.w]
        self.run = int(traffic["run"])

    @property
    def n_ops(self) -> int:
        return self.pop.n_docs * 2 * self.run

    def _ctr0(self, r: int) -> int:
        """The first counter round r types: past every counter before."""
        return self.pop.chars + self.run * r + 1

    def codes(self, r: int) -> np.ndarray:
        return rng_for(self.seed, 3, r).integers(
            97, 123, size=(self.pop.n_docs, self.run))

    def changes(self, r: int) -> dict:
        """{doc id: [Change]} of round r (the round after the build is 0)."""
        c0, codes = self._ctr0(r), self.codes(r)
        parent = (c0 - 1, self.writer)
        return {obj: [Change(self.writer, r + 2, {}, typing_run(
            self.writer, c0, parent, codes[d]))]
            for d, obj in enumerate(self.pop.ids)}

    def batches(self, M, r: int) -> dict:
        C = M.C
        c0, codes = self._ctr0(r), self.codes(r)
        n = 2 * self.run
        ctrs = np.repeat(np.arange(c0, c0 + self.run, dtype=np.int32), 2)
        pc = ctrs - 1
        pc[1::2] = 0
        pa = np.zeros(n, np.int32)
        pa[0::2] = self.w
        kind = np.tile(np.array([C.KIND_INS, C.KIND_SET], np.int8),
                       self.run)
        out = {}
        for d, obj in enumerate(self.pop.ids):
            val = np.zeros(n, np.int64)
            val[1::2] = codes[d]
            out[obj] = M.TB(
                obj_id=obj, actors=[self.writer],
                seqs=np.full(1, r + 2, np.int32), deps=[{}],
                messages=[None], op_change=np.zeros(n, np.int32),
                op_kind=kind.copy(), op_target_actor=np.full(n, self.w,
                                                             np.int32),
                op_target_ctr=ctrs.copy(), op_parent_actor=pa.copy(),
                op_parent_ctr=pc.copy(), op_value=val,
                actor_table=list(self.pop.actors), value_pool=[])
        return out


class Rounds(DocSetRunner):
    WARM = 2            # rounds before the window
    MAX_AHEAD = 256     # rounds made before the window, at most

    def setup(self, seconds: float):
        self.pop = Population(self.config, self.seed)
        self.gen = AppendRounds(self.pop, self.traffic, self.seed)
        self.ds = self.new_set()
        self.round(self.ds, self.pop.batches(self.M))
        self.n_made = 0
        self.reads: list = []        # the window's texts, round by round
        for _ in range(self.WARM):
            self.round(self.ds, self._make())
        warm_s = (self.spans[-1][2] - self.spans[-1][1]) / 1e9
        self.spans.clear()
        # the rounds the window takes, made before it: a fifth more than
        # the last warm round's pace fills it, at most MAX_AHEAD (more are
        # made inline, and counted, should the window outrun them)
        n = min(int(1.2 * seconds / max(warm_s, 1e-3)) + 8, self.MAX_AHEAD)
        self.queue = collections.deque(self._make() for _ in range(n))
        self.counters["inline_rounds"] = 0

    def _make(self) -> dict:
        self.n_made += 1
        return self.gen.batches(self.M, self.n_made - 1)

    def unit(self):
        if self.queue:
            batches = self.queue.popleft()
        else:
            self.counters["inline_rounds"] += 1
            batches = self._make()
        self.reads.append(self.round(self.ds, batches))
        self.n_ops += self.gen.n_ops

    def release(self):
        self.counters["off_path"] = self.graduated(self.ds)
        self.n_applied = self.WARM + len(self.reads)
        del self.ds, self.queue

    def _want(self):
        """The reference's texts after each of the window's rounds."""
        ref = DocSetReference(self.pop.changes())
        for r in range(self.n_applied):
            texts = ref.apply(self.gen.changes(r))
            if r >= self.WARM:
                yield texts

    def check(self) -> tuple:
        return self.compare(self._want())


class Control(Rounds):
    """The reference in the program's place, with the read of one
    document after each round (the last one) showing it as it was before
    the round: the change is acknowledged and lost to the read."""

    def setup(self, seconds: float):
        self.pop = Population(self.config, self.seed)
        self.gen = AppendRounds(self.pop, self.traffic, self.seed)
        self.ref = DocSetReference(self.pop.changes())
        for r in range(self.WARM):
            self.ref.apply(self.gen.changes(r))
        self.reads, self.n_made = [], self.WARM

    def unit(self):
        lost = self.pop.ids[-1]
        stale = self.ref.docs[lost].text()
        texts = self.ref.apply(self.gen.changes(self.n_made))
        texts[lost] = stale
        self.n_made += 1
        self.reads.append(texts)
        self.n_ops += self.gen.n_ops

    def release(self):
        self.counters["off_path"] = 0
        self.n_applied = self.n_made


RUNNER, CONTROL = Rounds, Control
