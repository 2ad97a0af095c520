"""Family `text_backlog`: a replica that reconnects and merges a backlog
of concurrent changes into one big text.

The generator: a base text of the configuration's `base_len` chars (one
change by actor "base") and `batches` concurrent batches of `actors`
changes each. A change types a run of `pairs` ins/set pairs after its
target base element, deletes `deletes` chars of its own base range and
adds `bare_inserts` inserts with no value. Targets follow a Zipf law
(`{"zipf": s}`: the law's quantiles, the same multiset for every seed,
dealt to the actors in an order drawn from the seed) or are each actor's
own range (`{"own_range": stride}`). The seed draws the letters and the
order; the work is the same for every seed.

The runner: each session opens the base document from a checkpoint
bundle that set-up made, merges the backlog through the traffic's entry
(`ring`: `PipelinedIngestor`, in place; `apply_batch`: one call a
batch) and reads `text()`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from portbench.drive import Runner, now, rng_for
from portbench.reference.backlog import backlog_text

OBJ = "text"


# --- the generator -----------------------------------------------------------

@dataclass
class BacklogBatch:
    """One batch of concurrent changes on the base text, as plain data."""
    actors: list            # actor name per change, ascending
    targets: np.ndarray     # base element each change's run hangs off
    letters: np.ndarray     # the code point each change's run types
    del_start: np.ndarray   # first base element each change deletes
    bare_parent: np.ndarray  # base element each value-less insert follows


@dataclass
class Backlog:
    base_n: int
    pairs: int
    deletes: int
    bare_inserts: int
    batches: list = field(default_factory=list)

    @property
    def ops_per_change(self) -> int:
        return 2 * self.pairs + self.deletes + self.bare_inserts

    @property
    def n_ops(self) -> int:
        return sum(len(b.actors) for b in self.batches) * self.ops_per_change

    @property
    def ctr0(self) -> int:
        """The counter of every run's first element: past the base's."""
        return self.base_n + 2


def base_letters(n: int) -> np.ndarray:
    """The base text's code points: 'a' + i mod 26 for element i."""
    return 97 + np.arange(1, n + 1) % 26


def zipf_quantiles(s: float, n: int, top: int) -> np.ndarray:
    """n draws' worth of the Zipf(s) law on 1, 2, ..., as its quantiles
    at (i + 0.5) / n; the mass past `top` falls on `top` (a draw clipped
    to the base text, as numpy's zipf clipped would)."""
    k = np.arange(1, top, dtype=np.float64)
    pmf = k ** -s
    # zeta(s): the sum to top - 1, and the tail from top on (Euler-Maclaurin)
    zeta = pmf.sum() + top ** (1 - s) / (s - 1) + 0.5 * top ** -s
    cdf = np.cumsum(pmf) / zeta
    q = (np.arange(n) + 0.5) / n
    return np.minimum(np.searchsorted(cdf, q, side="right") + 1, top)


def backlog(config: dict, traffic: dict, seed: int) -> Backlog:
    base_n = int(config["base_len"])
    n_b, n_a = int(traffic["batches"]), int(traffic["actors"])
    bl = Backlog(base_n, int(traffic["pairs"]), int(traffic["deletes"]),
                 int(traffic["bare_inserts"]))
    target = traffic["target"]
    a = np.arange(n_a)
    if "zipf" in target:
        law = zipf_quantiles(float(target["zipf"]), n_a, base_n)
    else:
        stride = int(target["own_range"])
        if stride * n_a > base_n or bl.deletes > stride:
            raise ValueError("own ranges do not fit the base text")
    stride = base_n // n_a
    for k in range(n_b):
        rng = rng_for(seed, 1, k)
        targets = (rng.permutation(law) if "zipf" in target
                   else a * int(target["own_range"]) + 1)
        letters = 97 + (a + int(rng.integers(26))) % 26
        prefix = f"s{k:03d}" if n_b > 1 else "actor"
        bl.batches.append(BacklogBatch(
            actors=[f"{prefix}-{i:06d}" for i in range(n_a)],
            targets=targets.astype(np.int64),
            letters=letters.astype(np.int64),
            del_start=(a * stride + 1).astype(np.int64),
            bare_parent=(a * stride + stride // 2).astype(np.int64)))
    return bl


def drop_last_change(bl: Backlog) -> Backlog:
    """The backlog less the last change of its last batch."""
    last = bl.batches[-1]
    cut = BacklogBatch(
        actors=last.actors[:-1], targets=last.targets[:-1],
        letters=last.letters[:-1], del_start=last.del_start[:-1],
        bare_parent=last.bare_parent[:-1])
    return dataclasses.replace(bl, batches=bl.batches[:-1] + [cut])


# --- the program's batches ---------------------------------------------------

def base_batch(M, obj: str, n: int):
    """One change by actor "base" typing the n-char base text."""
    C = M.C
    ctrs = np.arange(1, n + 1, dtype=np.int32)
    tc = np.repeat(ctrs, 2)
    pa = np.full(2 * n, C.HEAD_PARENT, np.int32)
    pc = np.zeros(2 * n, np.int32)
    pa[2::2] = 0
    pc[2::2] = ctrs[:-1]
    val = np.zeros(2 * n, np.int64)
    val[1::2] = base_letters(n)
    return M.TB(
        obj_id=obj, actors=["base"], seqs=np.ones(1, np.int32),
        deps=[{}], messages=[None], op_change=np.zeros(2 * n, np.int32),
        op_kind=np.tile(np.array([C.KIND_INS, C.KIND_SET], np.int8), n),
        op_target_actor=np.zeros(2 * n, np.int32), op_target_ctr=tc,
        op_parent_actor=pa, op_parent_ctr=pc, op_value=val,
        actor_table=["base"], value_pool=[])


def backlog_batch(M, obj: str, bl: Backlog, b: BacklogBatch):
    """One backlog batch as the program's columns: per change, its run of
    ins/set pairs, its deletes, its value-less inserts."""
    C = M.C
    n_a, P, nd, nb = len(b.actors), bl.pairs, bl.deletes, bl.bare_inserts
    per = bl.ops_per_change
    a = np.arange(n_a, dtype=np.int32)[:, None]
    base_rank = n_a
    kind = np.empty((n_a, per), np.int8)
    ta = np.empty((n_a, per), np.int32)
    tc = np.empty((n_a, per), np.int32)
    pa = np.zeros((n_a, per), np.int32)
    pc = np.zeros((n_a, per), np.int32)
    val = np.zeros((n_a, per), np.int64)
    ctrs = bl.ctr0 + np.arange(P, dtype=np.int32)
    kind[:, : 2 * P] = np.tile(np.array([C.KIND_INS, C.KIND_SET], np.int8),
                               P)
    ta[:, : 2 * P] = a
    tc[:, 0: 2 * P: 2] = ctrs
    tc[:, 1: 2 * P: 2] = ctrs
    pa[:, 0] = base_rank
    pc[:, 0] = b.targets
    pa[:, 2: 2 * P: 2] = a
    pc[:, 2: 2 * P: 2] = ctrs[:-1]
    val[:, 1: 2 * P: 2] = b.letters[:, None]
    d0 = 2 * P
    kind[:, d0: d0 + nd] = C.KIND_DEL
    ta[:, d0: d0 + nd] = base_rank
    tc[:, d0: d0 + nd] = b.del_start[:, None] + np.arange(nd)
    b0 = d0 + nd
    kind[:, b0:] = C.KIND_INS
    ta[:, b0:] = a
    tc[:, b0:] = bl.ctr0 + P + np.arange(nb)
    pa[:, b0:] = base_rank
    pc[:, b0:] = b.bare_parent[:, None]
    return M.TB(
        obj_id=obj, actors=list(b.actors), seqs=np.ones(n_a, np.int32),
        deps=[{"base": 1}] * n_a, messages=[None] * n_a,
        op_change=np.repeat(np.arange(n_a, dtype=np.int32), per),
        op_kind=kind.ravel(), op_target_actor=ta.ravel(),
        op_target_ctr=tc.ravel(), op_parent_actor=pa.ravel(),
        op_parent_ctr=pc.ravel(), op_value=val.ravel(),
        actor_table=list(b.actors) + ["base"], value_pool=[])


# --- the runner and its control ----------------------------------------------

class Sessions(Runner):
    SAMPLE = 8          # session texts the comparison keeps
    # the merge and the codes' materialization as one round program, as
    # bench.py's --pipeline and run_all.py's cfg5b run the document
    EAGER_MATERIALIZE = True

    def setup(self, seconds: float):
        M = self.M
        self.bl = backlog(self.config, self.traffic, self.seed)
        self.entry = self.traffic["entry"]
        self.batches = [backlog_batch(M, OBJ, self.bl, b)
                        for b in self.bl.batches]
        doc = M.DeviceTextDoc(OBJ, device=self.device)
        doc.apply_batch(base_batch(M, OBJ, self.bl.base_n))
        doc.text()
        self.bundle = M.ckpt.capture_engine(doc)
        del doc
        self.sample: list = []         # (session, text), a seeded sample
        self.lengths: list = []        # every session's text length
        self.pick = rng_for(self.seed, 5)
        self.ring_stats: list = []
        self.unit(keep=False)          # one warm session
        self.spans.clear()
        self.ring_stats.clear()

    def unit(self, keep: bool = True):
        M = self.M
        batches = [dataclasses.replace(b) for b in self.batches]
        t0 = now()
        doc = M.ckpt.restore_engine(self.bundle, self.device)
        doc.eager_materialize = self.EAGER_MATERIALIZE
        t1 = now()
        if self.entry == "ring":
            with M.PipelinedIngestor(doc, slots=int(self.traffic["depth"]),
                                     donate=True) as ring:
                ring.run(batches)
            self.ring_stats.append(ring.stats)
        else:
            for b in batches:
                doc.apply_batch(b)
        t2 = now()
        text = doc.text()
        t3 = now()
        del doc
        self.span("session/open", t0, t1)
        self.span("session/merge", t1, t2)
        self.span("session/read", t2, t3)
        if keep:
            self.keep(text)
            self.n_ops += self.bl.n_ops

    def keep(self, text: str):
        """Every session's length, and the texts of a sample of the
        window's sessions drawn from the seed (a reservoir of SAMPLE:
        each session is in it alike, whatever their number)."""
        n = len(self.lengths)
        self.lengths.append(len(text))
        if n < self.SAMPLE:
            self.sample.append((n, text))
        else:
            j = int(self.pick.integers(n + 1))
            if j < self.SAMPLE:
                self.sample[j] = (n, text)

    def release(self):
        del self.bundle, self.batches

    def check(self) -> tuple:
        want = backlog_text(self.bl)
        wrong = sum(t != want for _, t in self.sample)
        wrong_len = sum(n != len(want) for n in self.lengths)
        # failed: sessions of a wrong length, and sampled ones of the
        # right length but wrong text
        return ({"wrong_texts": (wrong, 0), "wrong_lengths": (wrong_len, 0)},
                wrong_len + sum(len(t) == len(want) and t != want
                                for _, t in self.sample))


class Control(Sessions):
    """The reference in the program's place, with the last acknowledged
    change of each session's backlog left out of the text it reads."""

    def setup(self, seconds: float):
        self.bl = backlog(self.config, self.traffic, self.seed)
        self.text = backlog_text(drop_last_change(self.bl))
        self.sample, self.lengths = [], []
        self.pick = rng_for(self.seed, 5)

    def unit(self, keep: bool = True):
        self.keep(self.text)
        self.n_ops += self.bl.n_ops

    def release(self):
        pass


RUNNER, CONTROL = Sessions, Control
