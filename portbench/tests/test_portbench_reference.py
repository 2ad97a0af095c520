"""The reference against a tiny brute-force RGA (a tree walked
depth-first, children in descending order: another algorithm than the
reference's list), and against the generator's own model."""

import pytest

from conftest import small_cell
from portbench.families import docset_build, docset_rounds, text_backlog
from portbench.reference.backlog import backlog_text
from portbench.reference.docset import DocSetReference
from portbench.reference.rga import RgaText


class TreeRga:
    def __init__(self):
        self.children = {None: []}
        self.value, self.gone = {}, set()

    def apply(self, ops):
        for op in ops:
            if op[0] == "ins":
                self.children.setdefault(op[2], []).append(op[1])
                self.children.setdefault(op[1], [])
            elif op[0] == "set":
                self.value[op[1]] = op[2]
            else:
                self.gone.add(op[1])

    def text(self):
        out, stack = [], list(sorted(self.children[None]))
        while stack:
            e = stack.pop()
            if e in self.value and e not in self.gone:
                out.append(chr(self.value[e]))
            stack.extend(sorted(self.children[e]))
        return "".join(out)


def backlog_ops(bl):
    """The backlog as plain ops: the base change, then every change."""
    base = []
    prev = None
    for i, code in enumerate(text_backlog.base_letters(bl.base_n).tolist(), 1):
        e = (i, "base")
        base += [("ins", e, prev), ("set", e, code)]
        prev = e
    changes = [base]
    for b in bl.batches:
        for a, name in enumerate(b.actors):
            ops, prev = [], (int(b.targets[a]), "base")
            for j in range(bl.pairs):
                e = (bl.ctr0 + j, name)
                ops += [("ins", e, prev), ("set", e, int(b.letters[a]))]
                prev = e
            ops += [("del", (int(b.del_start[a]) + j, "base"))
                    for j in range(bl.deletes)]
            ops += [("ins", (bl.ctr0 + bl.pairs + j, name),
                     (int(b.bare_parent[a]), "base"))
                    for j in range(bl.bare_inserts)]
            changes.append(ops)
    return changes


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
@pytest.mark.parametrize("name", ["text_1m.ring_backlog",
                                  "text_1m.residual_backlog"])
def test_backlog_text_agrees_with_brute_force(name, seed):
    c = small_cell(name)
    c.config["base_len"] = 3000
    c.traffic.update({"actors": 30, "pairs": 6})
    if "own_range" in c.traffic["target"]:
        c.traffic.update({"deletes": 5, "bare_inserts": 3})
    bl = text_backlog.backlog(c.config, c.traffic, seed)
    tree, rga = TreeRga(), RgaText()
    for ops in backlog_ops(bl):
        tree.apply(ops)
        rga.apply(ops)
    assert backlog_text(bl) == tree.text() == rga.text()


@pytest.mark.parametrize("seed", [4, 2**35 + 1])
def test_docset_reference_agrees_with_brute_force(seed):
    c = small_cell("docset_1k.append_rounds")
    c.config["docs"] = 20
    pop = docset_build.Population(c.config, seed)
    g = docset_rounds.AppendRounds(pop, c.traffic, seed)
    init = pop.changes()
    ref = DocSetReference(init)
    trees = {obj: TreeRga() for obj in init}
    for obj, cs in init.items():
        for ch in cs:
            trees[obj].apply(ch.ops)
    for obj, t in ref.texts().items():
        assert t == trees[obj].text()
    for r in range(12):
        changes = g.changes(r)
        got = ref.apply(changes)
        for obj, cs in changes.items():
            for ch in cs:
                trees[obj].apply(ch.ops)
            assert got[obj] == trees[obj].text()
    for obj, t in ref.texts().items():
        assert t == trees[obj].text()


def test_docset_build_text_in_closed_form():
    """cfg3's build: concurrent runs from the head, the larger actor id
    first; each round appends the writer's run to the writer's own."""
    c = small_cell("docset_1k.append_rounds")
    pop = docset_build.Population(c.config, 9)
    g = docset_rounds.AppendRounds(pop, c.traffic, 9)
    ref = DocSetReference(pop.changes())
    n, w = pop.chars, c.traffic["writer"]
    runs = [[chr(pop.codes[d, a]) * n for a in range(pop.n_actors)]
            for d in range(pop.n_docs)]
    for obj, t in ref.texts().items():
        assert t == "".join(reversed(runs[pop.ids.index(obj)]))
    for r in range(3):
        codes = g.codes(r)
        for d in range(pop.n_docs):
            runs[d][w] += "".join(map(chr, codes[d]))
        ref.apply(g.changes(r))
    for obj, t in ref.texts().items():
        assert t == "".join(reversed(runs[pop.ids.index(obj)]))
