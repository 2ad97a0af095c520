"""Family `docset_build`: a server building a DocSet of many small text
documents from one batched round (run_all.py's config3_docset).

The generator: `docs` documents, each typed by `doc_actors` actors in
concurrent runs of `doc_chars` chars from the head, every run one
change (seq 1, no deps). The seed draws each document's letters; the
work is the same for every seed.

The runner: each unit makes a fresh `DeviceTextDocSet` of the
configuration's capacity, hands it the whole population's changes in
one `apply_batches` and reads `texts()`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from portbench.drive import Runner, now, rng_for
from portbench.reference.docset import DocSetReference

HEAD = None   # the virtual list head as a parent


@dataclass
class Change:
    """One change to one document: ops are ("ins", elem, parent),
    ("set", elem, code point) and ("del", elem); an elem is (ctr, actor)."""
    actor: str
    seq: int
    deps: dict
    ops: list

    @property
    def n_ops(self) -> int:
        return len(self.ops)


def typing_run(actor: str, ctr0: int, parent, codes) -> list:
    """Ops typing `codes` after `parent`, elements ctr0, ctr0 + 1, ..."""
    ops, prev = [], parent
    for i, code in enumerate(codes):
        elem = (ctr0 + i, actor)
        ops.append(("ins", elem, prev))
        ops.append(("set", elem, int(code)))
        prev = elem
    return ops


class Population:
    """The documents of the set and their build, from the seed."""

    def __init__(self, config: dict, seed: int):
        self.n_docs = int(config["docs"])
        self.n_actors = int(config["doc_actors"])
        self.chars = int(config["doc_chars"])
        self.ids = [f"d{d:04d}" for d in range(self.n_docs)]
        self.actors = [f"actor-{i:03d}" for i in range(self.n_actors)]
        offsets = rng_for(seed, 2).integers(26, size=self.n_docs)
        # codes[d, a]: the letter actor a types all through document d
        self.codes = 97 + (np.arange(self.n_actors)[None, :]
                           + offsets[:, None]) % 26

    @property
    def n_ops(self) -> int:
        return self.n_docs * self.n_actors * 2 * self.chars

    def changes(self) -> dict:
        """{doc id: [Change]}: the build as plain data."""
        return {obj: [Change(name, 1, {}, typing_run(
            name, 1, HEAD, [self.codes[d, a]] * self.chars))
            for a, name in enumerate(self.actors)]
            for d, obj in enumerate(self.ids)}

    def batches(self, M) -> dict:
        """{doc id: batch}: the build as the program's columns (every
        document's columns alike but for their letters)."""
        C = M.C
        n_a, run = self.n_actors, self.chars
        n = n_a * run * 2
        ctrs = np.tile(np.repeat(np.arange(1, run + 1, dtype=np.int32), 2),
                       n_a)
        a_of = np.repeat(np.arange(n_a, dtype=np.int32), 2 * run)
        pa = a_of.copy()
        pc = ctrs - 1
        first = np.arange(n_a) * 2 * run
        pa[first] = C.HEAD_PARENT
        pa[1::2] = 0
        pc[1::2] = 0
        kind = np.tile(np.array([C.KIND_INS, C.KIND_SET], np.int8), n // 2)
        out = {}
        for d, obj in enumerate(self.ids):
            val = np.zeros(n, np.int64)
            val[1::2] = np.repeat(self.codes[d], run)
            out[obj] = M.TB(
                obj_id=obj, actors=list(self.actors),
                seqs=np.ones(n_a, np.int32), deps=[{}] * n_a,
                messages=[None] * n_a, op_change=a_of.copy(),
                op_kind=kind.copy(), op_target_actor=a_of.copy(),
                op_target_ctr=ctrs.copy(), op_parent_actor=pa.copy(),
                op_parent_ctr=pc.copy(), op_value=val,
                actor_table=list(self.actors), value_pool=[])
        return out


class DocSetRunner(Runner):
    """What the doc-set families share: a round through the set, the
    reads kept for the comparison, and the checks."""

    def new_set(self):
        return self.M.DeviceTextDocSet(
            self.pop.ids, capacity=int(self.config["capacity"]),
            device=self.device)

    def round(self, ds, batches: dict) -> dict:
        fresh = {k: dataclasses.replace(b) for k, b in batches.items()}
        t0 = now()
        ds.apply_batches(fresh)
        t1 = now()
        texts = ds.texts()
        t2 = now()
        self.span("round/apply", t0, t1)
        self.span("round/texts", t1, t2)
        self.span("round", t0, t2)
        return texts

    @staticmethod
    def graduated(ds) -> int:
        """Documents the set moved off its fast tier."""
        return len(ds._overlay)

    def compare(self, want_rounds) -> tuple:
        """Each kept read against the reference's texts after the same
        round (`want_rounds` yields them in the window's order)."""
        wrong = bad = 0
        for got, want in zip(self.reads, want_rounds):
            n = sum(got.get(obj) != text for obj, text in want.items())
            wrong += n
            bad += n > 0
        return ({"wrong_reads": (wrong, 0),
                 "docs_off_path": (self.counters["off_path"], 0)}, bad)


class Builds(DocSetRunner):
    def setup(self, seconds: float):
        self.pop = Population(self.config, self.seed)
        self.batches = self.pop.batches(self.M)
        self.reads: list = []          # every unit's texts
        self.counters["off_path"] = 0
        self.unit(keep=False)          # one warm build
        self.spans.clear()

    def unit(self, keep: bool = True):
        ds = self.new_set()
        texts = self.round(ds, self.batches)
        self.counters["off_path"] = max(self.counters["off_path"],
                                        self.graduated(ds))
        del ds
        if keep:
            self.reads.append(texts)
            self.n_ops += self.pop.n_ops

    def release(self):
        del self.batches

    def check(self) -> tuple:
        want = DocSetReference(self.pop.changes()).texts()
        return self.compare([want] * len(self.reads))


class Control(Builds):
    """The reference in the program's place, with one acknowledged change
    of each build (the last actor's run of the last document) left out
    of the texts it reads."""

    def setup(self, seconds: float):
        self.pop = Population(self.config, self.seed)
        changes = self.pop.changes()
        last = self.pop.ids[-1]
        changes[last] = changes[last][:-1]
        self.text = DocSetReference(changes).texts()
        self.reads, self.counters["off_path"] = [], 0

    def unit(self, keep: bool = True):
        self.reads.append(self.text)
        self.n_ops += self.pop.n_ops

    def release(self):
        pass


RUNNER, CONTROL = Builds, Control
