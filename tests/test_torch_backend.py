"""The port's device backend (automerge_tpu_torch.backend.device, bound to
the CPU with `backend_for("cpu")`) against the JAX package's device
backend and its oracle.

Every scenario (after test_device_backend.py, test_engine_parity.py,
test_map_engine.py, test_graduation.py, test_fast_local.py and
test_undo_redo.py) runs on three backends behind each package's own
frontend: the JAX device backend, the JAX oracle and the port. Tolerance
is zero throughout:

- the port's patches (every diff list, clock, deps and undo flag it hands
  the frontend, in order), its final clocks, deps, `history()`, `save()`
  bytes, write-behind backlog and graduation counts equal the JAX device
  backend's;
- the materialized documents (values, conflicts of every key and index,
  element ids) of all three are equal.

Object ids come from each package's uuid factory, pinned to one counter
for every run, and actors are fixed, so `save()` is byte-comparable."""

import copy
import itertools
import random

import pytest

import automerge_tpu as J
import automerge_tpu_torch as T
from automerge_tpu import _uuid as j_uuid
from automerge_tpu.backend import device as j_device
from automerge_tpu.backend import facade as j_facade
from automerge_tpu_torch import _uuid as t_uuid
from automerge_tpu_torch.backend import device as t_device

ROOT = "00000000-0000-0000-0000-000000000000"


@pytest.fixture(autouse=True)
def uuid_factories_left_default():
    """Every test here must leave both packages' uuid factories as it
    found them: a pinned factory leaks into every later test file that
    shares this process. A test that leaks fails here, by name; both
    factories are reset either way."""
    yield
    leaked = [m.__name__ for m in (j_uuid, t_uuid)
              if m._factory is not m._default_factory]
    j_uuid.reset()
    t_uuid.reset()
    assert not leaked, f"uuid factory left pinned: {leaked}"


class Ctx:
    """One backend under one package's frontend, recording every patch the
    backend hands the frontend (local changes, deliveries, merges)."""

    def __init__(self, name):
        self.name = name
        if name == "port":
            self.pkg, self.mod = T, t_device
            ns = T.backend.backend_for("cpu")
        elif name == "jax_device":
            self.pkg, self.mod = J, j_device
            ns = j_device.DeviceBackend
        else:
            self.pkg, self.mod = J, j_facade
            ns = j_facade.Backend
        self.F = self.pkg.frontend
        self.Text, self.Counter, self.Table = (self.pkg.Text,
                                               self.pkg.Counter,
                                               self.pkg.Table)
        self.patches: list = []
        self.notes: list = []          # other observations, compared too
        rec = self.patches

        def alc(state, request):
            new, patch = ns.apply_local_change(state, request)
            rec.append(_plain(patch))
            return new, patch
        self.ns = type("Recording", (ns,), {
            "apply_local_change": staticmethod(alc),
            "applyLocalChange": staticmethod(alc)})

    # -- the frontend-facing helpers ----------------------------------
    def init(self, actor):
        return self.F.init({"actorId": actor, "backend": self.ns})

    def change(self, doc, fn):
        return self.pkg.change(doc, fn)

    def undo(self, doc):
        return self.pkg.undo(doc)

    def redo(self, doc):
        return self.pkg.redo(doc)

    def state(self, doc):
        return self.F.get_backend_state(doc)

    def _patched(self, doc, state, patch):
        self.patches.append(_plain(patch))
        patch["state"] = state
        return self.F.apply_patch(doc, patch)

    def apply(self, doc, changes):
        state, patch = self.mod.apply_changes(self.state(doc), changes)
        return self._patched(doc, state, patch)

    def merge(self, a, b):
        state, patch = self.mod.merge(self.state(a), self.state(b))
        return self._patched(a, state, patch)

    def all_changes(self, doc):
        return self.mod.get_missing_changes(self.state(doc), {})

    def changes_since(self, old, new):
        return self.mod.get_changes(self.state(old), self.state(new))

    def missing_deps(self, doc):
        return self.mod.get_missing_deps(self.state(doc))

    def pending(self, doc):
        core = getattr(self.state(doc), "_core", None)
        return None if core is None else len(core.pending)


def _plain(patch):
    return copy.deepcopy({k: v for k, v in patch.items() if k != "state"})


def fingerprint(ctx, doc):
    """Everything user-visible, nested: values, the conflicts of every map
    key and list index, element ids of lists and texts."""
    F, types = ctx.F, ctx.pkg.frontend.types

    def conf(c):
        return None if not c else {a: walk(v) for a, v in c.items()}

    def walk(v):
        if isinstance(v, types.Text):
            return ("text", str(v), F.get_element_ids(v),
                    [conf(F.get_conflicts(v, i)) for i in range(len(v))])
        if isinstance(v, types.Table):
            return ("table", {k: walk(r) for k, r in v.to_json().items()})
        if isinstance(v, types.Counter):
            return ("counter", v.value)
        if isinstance(v, types.MapDoc):
            return ("map", {k: (walk(x), conf(F.get_conflicts(v, k)))
                            for k, x in v.items()})
        if isinstance(v, types.ListDoc):
            return ("list", [(walk(x), conf(F.get_conflicts(v, i)))
                             for i, x in enumerate(v)],
                    F.get_element_ids(v))
        return v
    return walk(doc)


def pin_uuids():
    for m in (j_uuid, t_uuid):
        c = itertools.count(1)
        m.set_factory(lambda c=c: f"00000000-0000-0000-0000-{next(c):012d}")


def run3(scenario):
    """Run `scenario(ctx) -> [docs]` on the three backends and hold the
    port to the JAX device backend (patches, clocks, histories, save
    bytes) and to the oracle (documents)."""
    out = {}
    try:
        for name in ("jax_device", "jax_oracle", "port"):
            pin_uuids()
            j_device.GRADUATION_STATS.clear()
            t_device.GRADUATION_STATS.clear()
            ctx = Ctx(name)
            docs = scenario(ctx)
            grad = dict(j_device.GRADUATION_STATS if ctx.pkg is J
                        else t_device.GRADUATION_STATS)
            out[name] = (ctx, docs, grad)
    finally:
        j_uuid.reset()
        t_uuid.reset()
    (jc, jd, jg), (oc, od, _), (tc, td, tg) = (
        out["jax_device"], out["jax_oracle"], out["port"])
    assert len(tc.patches) == len(jc.patches)
    for i, (a, b) in enumerate(zip(tc.patches, jc.patches)):
        assert a == b, f"patch {i} differs"
    assert tc.notes == jc.notes == oc.notes
    assert tg == jg
    for dj, do, dt in zip(jd, od, td):
        want = fingerprint(oc, do)
        assert fingerprint(jc, dj) == want
        assert fingerprint(tc, dt) == want
        sj, st = jc.state(dj), tc.state(dt)
        assert type(st).__name__ == type(sj).__name__
        assert st.clock == sj.clock and st.deps == sj.deps
        assert st.can_undo == sj.can_undo and st.can_redo == sj.can_redo
        assert st.history() == sj.history()
        assert tuple(st.queue) == tuple(sj.queue)
        assert tc.pending(dt) == jc.pending(dj)
        assert T.save(dt) == J.save(dj)
    return out


# --------------------------------------------------------------------------
# scenarios (test_device_backend.py's parity set, written once for both
# packages)
# --------------------------------------------------------------------------


def sc_typing(x):
    d = x.change(x.init("alice"), lambda doc: doc.__setitem__("t",
                                                              x.Text("")))
    for i, ch in enumerate("hello world"):
        d = x.change(d, lambda doc, c=ch, i=i: doc["t"].insert_at(i, c))
    return [d]


def sc_concurrent_text(x):
    a = x.change(x.init("alice"),
                 lambda doc: doc.__setitem__("t", x.Text("base")))
    b = x.apply(x.init("bob"), x.all_changes(a))
    a = x.change(a, lambda doc: doc["t"].insert_at(4, "A", "A"))
    b = x.change(b, lambda doc: doc["t"].insert_at(0, "B"))
    b = x.change(b, lambda doc: doc["t"].delete_at(1))
    return [x.merge(a, b), x.merge(b, a)]


def sc_map_conflicts(x):
    a = x.change(x.init("aaa"), lambda doc: doc.__setitem__("k", "from-a"))
    b = x.change(x.init("zzz"), lambda doc: doc.__setitem__("k", "from-z"))
    b = x.change(b, lambda doc: doc.__setitem__("other", 42))
    return [x.merge(a, b), x.merge(b, a)]


def sc_counters(x):
    a = x.change(x.init("alice"),
                 lambda doc: doc.__setitem__("c", x.Counter(10)))
    b = x.apply(x.init("bob"), x.all_changes(a))
    a = x.change(a, lambda doc: doc["c"].increment(3))
    b = x.change(b, lambda doc: doc["c"].increment(5))
    return [x.merge(a, b), x.merge(b, a)]


def sc_delete_and_resurrect(x):
    a = x.change(x.init("alice"),
                 lambda doc: doc.__setitem__("t", x.Text("xyz")))
    b = x.apply(x.init("bob"), x.all_changes(a))
    a = x.change(a, lambda doc: doc["t"].delete_at(1))
    b = x.change(b, lambda doc: doc["t"].set(1, "Y"))   # add-wins
    return [x.merge(a, b), x.merge(b, a)]


def sc_keys_and_table(x):
    a = x.change(x.init("alice"), lambda doc: doc.update({"x": 1, "y": 2}))
    a = x.change(a, lambda doc: doc.__delitem__("x"))

    def setup(doc):
        doc["todos"] = x.Table()
        doc["todos"].add({"title": "one", "done": False})
    a = x.change(a, setup)
    b = x.apply(x.init("bob"), x.all_changes(a))
    b = x.change(b, lambda doc: doc["todos"].add({"title": "two",
                                                  "done": True}))
    return [x.merge(a, b), x.merge(b, a)]


def sc_nested_maps(x):
    a = x.change(x.init("alice"), lambda doc: doc.__setitem__(
        "card", {"title": "hi", "meta": {"stars": 3}}))
    a = x.change(a, lambda doc: doc["card"]["meta"].__setitem__("stars", 4))
    a = x.change(a, lambda doc: doc["card"].__setitem__("done", True))
    b = x.apply(x.init("bob"), x.all_changes(a))
    a = x.change(a, lambda doc: doc["card"].__delitem__("title"))
    b = x.change(b, lambda doc: doc["card"]["meta"].__setitem__("stars", 5))
    return [x.merge(a, b), x.merge(b, a)]


def sc_nested_lists(x):
    a = x.change(x.init("alice"), lambda doc: doc.__setitem__(
        "board", {"cards": [{"t": "one"}, {"t": "two"}]}))
    b = x.apply(x.init("bob"), x.all_changes(a))
    a = x.change(a, lambda doc: doc["board"]["cards"].append({"t": "three"}))
    b = x.change(b, lambda doc: doc["board"]["cards"][0].__setitem__(
        "t", "ONE"))
    b = x.change(b, lambda doc: doc["board"]["cards"].delete_at(1))
    return [x.merge(a, b), x.merge(b, a)]


def sc_nested_conflicts(x):
    a = x.change(x.init("aaa"), lambda doc: doc.__setitem__("m",
                                                            {"k": "init"}))
    b = x.apply(x.init("zzz"), x.all_changes(a))
    a = x.change(a, lambda doc: doc["m"].__setitem__("k", "from-a"))
    b = x.change(b, lambda doc: doc["m"].__setitem__("k", "from-z"))
    a2 = x.change(a, lambda doc: doc.__setitem__("m", {"k": "replaced"}))
    return [x.merge(a, b), x.merge(b, a), x.merge(a2, b)]


def sc_text_in_nested_map(x):
    a = x.change(x.init("alice"), lambda doc: doc.__setitem__("card",
                                                              {"n": 1}))
    a = x.change(a, lambda doc: doc["card"].__setitem__("notes",
                                                        x.Text("hey")))
    b = x.apply(x.init("bob"), x.all_changes(a))
    b = x.change(b, lambda doc: doc["card"]["notes"].insert_at(3, "!"))
    return [x.merge(a, b), x.merge(b, a)]


def sc_causal_buffering(x):
    a = x.change(x.init("alice"),
                 lambda doc: doc.__setitem__("t", x.Text("a")))
    a = x.change(a, lambda doc: doc["t"].insert_at(1, "b"))
    a = x.change(a, lambda doc: doc.__setitem__("n", 1))
    ch = x.all_changes(a)
    b = x.apply(x.init("bob"), [ch[2]])            # seq 3 first
    x.notes.append(x.missing_deps(b))
    b = x.apply(b, [ch[1]])                        # seq 2
    x.notes.append(x.missing_deps(b))
    b = x.apply(b, [ch[0]])                        # seq 1: all three admit
    x.notes.append(x.missing_deps(b))
    b = x.apply(b, ch)                             # duplicates: idempotent
    return [b]


def sc_stale_fork(x):
    d = x.change(x.init("aaaa"),
                 lambda doc: doc.__setitem__("t", x.Text("fork")))
    d2 = x.change(d, lambda doc: doc["t"].insert_at(0, "A"))
    d3 = x.change(d2, lambda doc: doc.__setitem__("k", 1))
    # branch from older states: the core forks by replay (pending fast
    # rounds included)
    branch = x.change(d, lambda doc: doc["t"].insert_at(4, "Z"))
    branch2 = x.change(d2, lambda doc: doc["t"].delete_at(1))
    peer = x.apply(x.init("bbbb"), x.all_changes(d))
    x.notes.append(len(x.changes_since(d, d3)))
    return [d2, d3, branch, branch2, x.merge(peer, branch2)]


def sc_failing_batch(x):
    a = x.change(x.init("alice"),
                 lambda doc: doc.__setitem__("t", x.Text("keep")))
    good = {"actor": "mallory", "seq": 1, "deps": {}, "ops": [
        {"action": "set", "obj": ROOT, "key": "m", "value": 1}]}
    a = x.apply(a, [good])
    reuse = {"actor": "mallory", "seq": 1, "deps": {}, "ops": [
        {"action": "set", "obj": ROOT, "key": "m", "value": 2}]}
    fresh = {"actor": "carol", "seq": 1, "deps": {}, "ops": [
        {"action": "set", "obj": ROOT, "key": "c", "value": 3}]}
    with pytest.raises(Exception, match="Inconsistent reuse"):
        x.apply(a, [fresh, reuse])
    unknown = {"actor": "dave", "seq": 1, "deps": {}, "ops": [
        {"action": "set", "obj": "no-such-object", "key": "k", "value": 1}]}
    with pytest.raises(ValueError, match="unknown object"):
        x.apply(a, [unknown])
    # the prior state stays usable on its own lineage
    a = x.change(a, lambda doc: doc["t"].insert_at(4, "!"))
    a = x.apply(a, [fresh])
    return [a]


def sc_undo_redo(x):
    d = x.init("sk")

    def double_set(doc):
        doc["x"] = 1
        doc["x"] = 2
    d = x.change(d, double_set)
    d = x.undo(d)
    d = x.change(d, lambda doc: doc.__setitem__("y", 5))

    def mixed(doc):
        del doc["y"]
        doc["y"] = 7
    d = x.change(d, mixed)
    d = x.undo(d)
    d = x.redo(d)
    d = x.change(d, lambda doc: doc.__setitem__("c", x.Counter(10)))
    d = x.change(d, lambda doc: doc["c"].increment(5))
    d = x.undo(d)
    # list ops and undo across a merge (test_undo_redo.py)
    d = x.change(d, lambda doc: doc.__setitem__("l", [1, 2, 3]))
    d = x.change(d, lambda doc: doc["l"].delete_at(0))
    d = x.change(d, lambda doc: doc["l"].__setitem__(0, 20))
    d = x.undo(x.undo(d))
    peer = x.change(x.apply(x.init("tt"), x.all_changes(d)),
                    lambda doc: doc.__setitem__("x", 9))
    d = x.merge(d, peer)
    d = x.redo(d)
    d = x.undo(d)
    return [d, peer]


def sc_fast_local(x):
    d = x.change(x.init("aaaa"),
                 lambda doc: doc.__setitem__("t", x.Text("hello world")))
    for i in range(5):
        d = x.change(d, lambda doc, i=i: doc["t"].insert_at(5 + i, "X"))
    d = x.change(d, lambda doc: [doc["t"].delete_at(1),
                                 doc["t"].delete_at(1)])
    d = x.change(d, lambda doc: doc["t"].set(0, "H"))
    d = x.change(d, lambda doc: doc["t"].insert_at(3, *"123"))
    d = x.undo(x.undo(d))
    d = x.redo(x.redo(d))                   # set runs on tombstones
    peer = x.change(x.apply(x.init("bbbb"), x.all_changes(d)),
                    lambda doc: doc["t"].insert_at(0, "Q"))
    return [d, x.merge(d, peer)]


def sc_fast_remote(x):
    author = x.change(x.init("author"),
                      lambda d: d.__setitem__("t", x.Text("x" * 200)))
    peer = x.merge(x.init("peer"), author)
    doc = author
    for k in range(6):
        doc = x.change(doc, lambda d, k=k: d["t"].insert_at(10 + k, *"ab"))
    remote = x.changes_since(author, doc)
    for ch in remote:                       # one by one: covering deliveries
        peer = x.apply(peer, [ch])
    # a covering change setting one tombstoned element twice
    author2 = x.change(author, lambda d: d["t"].delete_at(2))
    peer2 = x.merge(x.init("obs"), author2)
    del_op = [op for ch in x.all_changes(author2) for op in ch["ops"]
              if op["action"] == "del"][0]
    crafted = {"actor": "zzz", "seq": 1, "deps": dict(x.state(author2).clock),
               "ops": [{"action": "set", "obj": del_op["obj"],
                        "key": del_op["key"], "value": "X"},
                       {"action": "set", "obj": del_op["obj"],
                        "key": del_op["key"], "value": "Y"}]}
    return [peer, x.apply(peer2, [crafted])]


def sc_map_fast_rounds(x):
    d = x.change(x.init("aaaa"), lambda doc: doc.update(
        {"card": {"title": "a", "meta": {"n": 1}}, "k": 0}))
    for i in range(4):
        d = x.change(d, lambda doc, i=i: (
            doc["card"].__setitem__("title", f"t{i}"),
            doc["card"]["meta"].__setitem__("n", i),
            doc.__setitem__("k", i)))
    d = x.change(d, lambda doc: doc["card"].__delitem__("title"))
    d = x.undo(d)
    peer = x.change(x.merge(x.init("bbbb"), d),
                    lambda doc: doc["card"].__setitem__("title", "peer"))
    return [d, x.merge(d, peer)]


def sc_graduation(x):
    """Deliveries outside the device grammar graduate the lineage to the
    oracle: an unknown op action, which the oracle then rejects (the
    document stays usable), and an `ins` on a map object, which the
    oracle accepts (its patch is not one the frontend can render, so that
    lineage is followed at the backend: its patches, `get_patch` and a
    further delivery)."""
    d = x.change(x.init("alice"), lambda doc: doc.update(
        {"m": {"k": 1}, "t": x.Text("ab")}))
    bad = {"actor": "zed", "seq": 1, "deps": {}, "ops": [
        {"action": "frobnicate", "obj": ROOT, "key": "z"}]}
    with pytest.raises(ValueError, match="Unknown operation type"):
        x.apply(d, [bad])
    d = x.change(d, lambda doc: doc["t"].insert_at(2, "c"))
    m_id = x.F.get_object_id(d["m"])
    odd = {"actor": "zed", "seq": 1, "deps": dict(x.state(d).clock),
           "ops": [{"action": "ins", "obj": m_id, "key": "_head",
                    "elem": 1}]}
    g, patch = x.mod.apply_changes(x.state(d), [odd])
    x.patches.append(_plain(patch))
    more = {"actor": "yan", "seq": 1, "deps": dict(g.clock), "ops": [
        {"action": "set", "obj": ROOT, "key": "after", "value": 2}]}
    g, patch = x.mod.apply_changes(g, [more])
    x.patches.append(_plain(patch))
    x.notes.append((type(g).__name__, x.mod.get_patch(g), g.history()))
    return [d]


def sc_stacked_merge(x):
    """A merge touching many objects with enough ops to take the stacked
    multi-object round (engine/stacked.py) in both packages."""
    base = x.change(x.init("base"), lambda d: d.update(
        {"cards": [{"title": f"card{i}", "tasks": [f"t{j}" for j in
                                                   range(3)]}
                   for i in range(4)]}))
    bc = x.all_changes(base)
    changes = []
    for a in range(9):
        peer = x.apply(x.init(f"actor-{a:05d}"), bc)
        k = a % 4
        if a % 3 == 0:
            peer = x.change(peer, lambda d, k=k, a=a: d["cards"][k]["tasks"]
                            .append(f"new-{a}"))
        elif a % 3 == 1:
            peer = x.change(peer, lambda d, k=k, a=a: d["cards"][k]
                            .__setitem__("title", f"retitled-{a}"))
        else:
            peer = x.change(peer, lambda d, k=k: d["cards"][k]["tasks"]
                            .__delitem__(0))
        changes.extend(x.changes_since(base, peer))
    merged = x.apply(base, changes)
    if x.name != "jax_oracle":
        stacked = (J.engine.stacked if x.pkg is J else T.stacked)
        x.notes.append(bool(stacked.LAST_STATS))
    else:
        x.notes.append(True)
    return [merged]


def _random_flat(seed):
    def sc(x):
        base = x.change(x.init("base"), lambda doc: doc.update(
            {"t": x.Text("seed"), "n": 0}))
        bc = x.all_changes(base)
        docs = [x.apply(x.init(f"ac{i}"), bc) for i in range(3)]
        r = random.Random(seed + 1)
        for _ in range(6):
            i = r.randrange(3)

            def edit(d, r=r):
                t = d["t"]
                for _ in range(r.randrange(1, 4)):
                    op = r.random()
                    if op < 0.5 or len(t) == 0:
                        t.insert_at(r.randint(0, len(t)),
                                    chr(97 + r.randrange(26)))
                    elif op < 0.75:
                        t.delete_at(r.randrange(len(t)))
                    else:
                        d["n"] = r.randrange(100)
            docs[i] = x.change(docs[i], edit)
            i, j = r.sample(range(3), 2)
            docs[i] = x.merge(docs[i], docs[j])
        return docs
    sc.__name__ = f"random_flat_{seed}"
    return sc


def _random_nested(seed):
    def sc(x):
        base = x.change(x.init("base"), lambda doc: doc.update(
            {"cards": [{"title": "c0", "tags": ["x"]}], "n": 0}))
        bc = x.all_changes(base)
        docs = [x.apply(x.init(f"ac{i}"), bc) for i in range(3)]
        r = random.Random(seed + 77)
        for _ in range(5):
            i = r.randrange(3)

            def edit(d, r=r):
                cards = d["cards"]
                op = r.random()
                if op < 0.3:
                    cards.append({"title": f"c{r.randrange(100)}",
                                  "tags": []})
                elif op < 0.5 and len(cards) > 1:
                    cards.delete_at(r.randrange(len(cards)))
                elif op < 0.75:
                    cards[r.randrange(len(cards))]["title"] = \
                        f"t{r.randrange(100)}"
                else:
                    cards[r.randrange(len(cards))]["tags"].append(
                        chr(97 + r.randrange(26)))
            docs[i] = x.change(docs[i], edit)
            i, j = r.sample(range(3), 2)
            docs[i] = x.merge(docs[i], docs[j])
        return docs
    sc.__name__ = f"random_nested_{seed}"
    return sc


def _random_undo(seed):
    def sc(x):
        d = x.change(x.init("solo"), lambda doc: doc.update({"a": 0,
                                                             "b": "x"}))
        r = random.Random(seed + 31)
        for _ in range(12):
            op = r.random()
            if op < 0.45:
                key, val = r.choice(["a", "b", "c"]), r.randrange(100)
                d = x.change(d, lambda doc, k=key, v=val:
                             doc.__setitem__(k, v))
            elif op < 0.6 and "c" in d:
                d = x.change(d, lambda doc: doc.__delitem__("c"))
            elif op < 0.8 and x.F.can_undo(d):
                d = x.undo(d)
            elif x.F.can_redo(d):
                d = x.redo(d)
        return [d]
    sc.__name__ = f"random_undo_{seed}"
    return sc


SCENARIOS = [
    sc_typing, sc_concurrent_text, sc_map_conflicts, sc_counters,
    sc_delete_and_resurrect, sc_keys_and_table, sc_nested_maps,
    sc_nested_lists, sc_nested_conflicts, sc_text_in_nested_map,
    sc_causal_buffering, sc_stale_fork, sc_failing_batch, sc_undo_redo,
    sc_fast_local, sc_fast_remote, sc_map_fast_rounds, sc_graduation,
    sc_stacked_merge,
    *[_random_flat(s) for s in range(3)],
    *[_random_nested(s) for s in range(2)],
    *[_random_undo(s) for s in range(2)],
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_backend_matches_jax_device_backend_and_oracle(scenario):
    run3(scenario)


def test_graduation_happens_on_the_same_delivery():
    out = run3(sc_graduation)
    ctx, docs, grad = out["port"]
    assert grad == {"out_of_scope": 2}
    assert type(ctx.state(docs[0])).__name__ == "DeviceBackendState"
    assert ctx.notes[0][0] == "BackendState"


def test_stacked_merge_takes_the_stacked_round_in_both_packages():
    out = run3(sc_stacked_merge)
    assert out["port"][0].notes == out["jax_device"][0].notes == [True]
    assert T.stacked.LAST_STATS["passes"] >= 1
    T.stacked.assert_round_budget(T.stacked.LAST_STATS)


def test_fast_paths_serve_the_same_rounds():
    """The write-behind path serves the same local and covering remote
    rounds in both packages (the backlog is compared after every round)."""
    backlog = {}
    try:
        for name in ("jax_device", "port"):
            pin_uuids()
            x = Ctx(name)
            d = x.change(x.init("aaaa"),
                         lambda doc: doc.__setitem__("t", x.Text("hello")))
            seen = []
            for i in range(4):
                d = x.change(d, lambda doc, i=i: doc["t"].insert_at(i, "X"))
                seen.append(x.pending(d))
            peer = x.apply(x.init("bbbb"), x.all_changes(d))
            seen.append(x.pending(peer))
            d = x.merge(d, peer)
            seen.append(x.pending(d))
            backlog[name] = seen
    finally:
        j_uuid.reset()
        t_uuid.reset()
    assert backlog["port"] == backlog["jax_device"]
    assert backlog["port"][:4] == [1, 2, 3, 4]


def test_cpu_binding_keeps_every_engine_on_the_cpu():
    """Forks, restores and every object the core builds inherit the
    lineage's device."""
    pin_uuids()
    try:
        x = Ctx("port")
        d = x.change(x.init("alice"), lambda doc: doc.update(
            {"t": x.Text("ab"), "m": {"k": 1}}))
        d2 = x.change(d, lambda doc: doc["t"].insert_at(0, "z"))
        branch = x.change(d, lambda doc: doc["m"].__setitem__("k", 2))
    finally:
        j_uuid.reset()
        t_uuid.reset()
    for doc in (d2, branch):
        core = x.state(doc)._core
        assert str(core.device) == "cpu"
        docs = [core.root.doc] + [w.doc for w in core.objects.values()]
        assert {str(e.device) for e in docs} == {"cpu"}
        assert all(t.device.type == "cpu" for e in docs
                   for t in e._ensure_dev().values())
