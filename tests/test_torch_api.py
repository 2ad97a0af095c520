"""The port's public API (automerge_tpu_torch) against automerge_tpu's.

The same calls, with the same actors and the same pinned object ids, go
through both packages: the JAX package on its default (device) backend,
the port on `backend.backend_for("cpu")`. Tolerance is zero: documents
(`to_json`), diffs, histories, missing deps and `save()` bytes must be
equal. Also: cfg4's trellis merge (benchmarks/run_all.py
`trellis_changes`) at 30 actors, binary wire-frame deliveries against
their dict form, the default binding on a machine without a card, and a
backend lineage carried from the JAX package with
`state.backend_state_from_jax`."""

import itertools
import json

import pytest
import torch

import automerge_tpu as J
import automerge_tpu_torch as T
from automerge_tpu import _uuid as j_uuid
from automerge_tpu.backend import device as j_device
from automerge_tpu.backend import facade as j_facade
from automerge_tpu_torch import _uuid as t_uuid
from automerge_tpu_torch.backend import device as t_device
from automerge_tpu_torch.backend import facade as t_facade
from automerge_tpu_torch.state import backend_state_from_jax

CPU = T.backend.backend_for("cpu")


@pytest.fixture(autouse=True)
def pinned_uuids():
    for m in (j_uuid, t_uuid):
        c = itertools.count(1)
        m.set_factory(lambda c=c: f"00000000-0000-0000-0000-{next(c):012d}")
    yield
    j_uuid.reset()
    t_uuid.reset()


def opts(pkg, actor):
    return actor if pkg is J else {"actorId": actor, "backend": CPU}


def both(fn):
    """fn(pkg) on each package, each from a freshly pinned uuid counter."""
    out = []
    for pkg in (J, T):
        for m in (j_uuid, t_uuid):
            c = itertools.count(1)
            m.set_factory(
                lambda c=c: f"00000000-0000-0000-0000-{next(c):012d}")
        out.append(fn(pkg))
    return out


def canon(pkg, doc):
    return json.dumps(pkg.to_json(doc), sort_keys=True, default=str)


# --------------------------------------------------------------------------
# the public surface
# --------------------------------------------------------------------------


def _editing_session(am):
    a = am.from_({"title": "notes", "t": am.Text("hello"), "n": am.Counter(1),
                  "tags": ["x", "y"]}, opts(am, "alice"))
    a = am.change(a, "retitle", lambda d: d.__setitem__("title", "Notes"))
    b = am.merge(am.init(opts(am, "bob")), a)
    b = am.change(b, lambda d: (d["t"].insert_at(5, *" world"),
                                d["n"].increment(2)))
    a = am.change(a, lambda d: (d["t"].delete_at(0), d["tags"].append("z")))
    a = am.empty_change(a, "ack")
    m = am.merge(a, b)
    m = am.undo(m)
    m = am.redo(m)
    return a, b, m


def test_editing_session_matches_jax_package():
    (ja, jb, jm), (ta, tb, tm) = both(_editing_session)
    for jd, td in ((ja, ta), (jb, tb), (jm, tm)):
        assert T.to_json(td) == J.to_json(jd)
        assert T.save(td) == J.save(jd)
        assert T.get_all_changes(td) == J.get_all_changes(jd)
        assert T.frontend.can_undo(td) == J.frontend.can_undo(jd)
        assert T.frontend.can_redo(td) == J.frontend.can_redo(jd)
    assert T.diff(ta, tm) == J.diff(ja, jm)
    assert T.get_changes(ta, tm) == J.get_changes(ja, jm)
    assert T.equals(T.to_json(tm), J.to_json(jm))
    assert not T.equals(T.to_json(ta), T.to_json(tm))
    assert isinstance(T.frontend.get_backend_state(tm),
                      t_device.DeviceBackendState)


def test_history_and_snapshots_match_and_stay_on_the_doc_backend():
    def run(am):
        d = am.change(am.init(opts(am, "h")),
                      lambda x: x.__setitem__("t", am.Text("ab")))
        d = am.change(d, lambda x: x["t"].insert_at(2, "c"))
        d = am.change(d, lambda x: x.__setitem__("k", {"v": 1}))
        return d, am.get_history(d)
    (jd, jh), (td, th) = both(run)
    assert [h.change for h in th] == [h.change for h in jh]
    for jx, tx in zip(jh, th):
        snap = tx.snapshot
        assert T.to_json(snap) == J.to_json(jx.snapshot)
        # built on the document's own (CPU) backend, never the default
        assert T.frontend.get_backend_state(snap)._core.device.type == "cpu"


def test_save_load_round_trip_matches():
    def run(am):
        d = am.change(am.init(opts(am, "s")), lambda x: x.update(
            {"t": am.Text("persist"), "rows": am.Table()}))
        d = am.change(d, lambda x: (x["t"].delete_at(0),
                                    x["rows"].add({"a": 1})))
        saved = am.save(d)
        loaded = am.load(saved, opts(am, "s2"))
        return saved, loaded
    (js, jl), (ts, tl) = both(run)
    assert ts == js
    assert T.save(tl) == J.save(jl)
    assert canon(T, tl) == canon(J, jl)
    with pytest.raises(T.ProtocolError):
        T.load("[1]")
    with pytest.raises(ValueError, match="Unsupported save format"):
        T.load(json.dumps({"format": "other", "changes": []}))


def test_causal_buffering_and_missing_deps_match():
    def run(am):
        a = am.change(am.init(opts(am, "alice")),
                      lambda d: d.__setitem__("t", am.Text("a")))
        a = am.change(a, lambda d: d["t"].insert_at(1, "b"))
        ch = am.get_all_changes(a)
        b = am.apply_changes(am.init(opts(am, "bob")), [ch[1]])
        seen = [am.to_json(b), am.get_missing_deps(b)]
        b = am.apply_changes(b, [ch[0]])
        seen += [am.to_json(b), am.get_missing_deps(b)]
        return seen
    jr, tr = both(run)
    assert tr == jr
    assert tr[1] == {"alice": 1} and tr[2] == {"t": "ab"}


# --------------------------------------------------------------------------
# cfg4: the trellis board (benchmarks/run_all.py trellis_changes)
# --------------------------------------------------------------------------


def trellis(am, oracle, n_actors: int, n_cards: int = 10):
    """benchmarks/run_all.py `trellis_changes` through `am`: a board of
    n_cards x 3 tasks on the device backend `opts` names, n_actors
    peers on the package's oracle doing task appends, retitles and task
    deletes."""
    base = am.change(am.init(opts(am, "base")), lambda d: d.update(
        {"cards": [{"title": f"card{i}", "tasks": [f"t{j}" for j in range(3)]}
                   for i in range(n_cards)]}))
    base_changes = am.get_all_changes(base)
    changes = []
    for a in range(n_actors):
        peer = am.apply_changes(am.init({"actorId": f"actor-{a:05d}",
                                         "backend": oracle}), base_changes)
        k = a % n_cards
        if a % 3 == 0:
            peer = am.change(peer, lambda d, k=k, a=a: d["cards"][k]["tasks"]
                             .append(f"new-{a}"))
        elif a % 3 == 1:
            peer = am.change(peer, lambda d, k=k, a=a: d["cards"][k]
                             .__setitem__("title", f"retitled-{a}"))
        else:
            peer = am.change(peer, lambda d, k=k: d["cards"][k]["tasks"]
                             .__delitem__(0))
        changes.extend(am.get_changes(base, peer))
    return base, changes


def test_trellis_merge_30_actors_matches_jax_package_and_oracles():
    def run(am):
        dev, oracle, stacked = ((j_device, j_facade.Backend,
                                 J.engine.stacked) if am is J else
                                (t_device, t_facade.Backend, T.stacked))
        base, changes = trellis(am, oracle, 30)
        dev.GRADUATION_STATS.clear()
        stacked.LAST_STATS.clear()
        merged = am.apply_changes(am.load(am.save(base), opts(am, "m")),
                                  changes)
        assert isinstance(am.frontend.get_backend_state(merged),
                          dev.DeviceBackendState)
        assert dev.GRADUATION_STATS == {}
        stats = dict(stacked.LAST_STATS)
        stacked.assert_round_budget(stats)
        ref = am.apply_changes(am.init({"actorId": "o", "backend": oracle}),
                               am.get_all_changes(base) + changes)
        assert canon(am, ref) == canon(am, merged)
        return merged, changes, stats
    (jm, jc, js), (tm, tc, ts) = both(run)
    assert tc == jc
    assert canon(T, tm) == canon(J, jm)
    assert T.save(tm) == J.save(jm)
    assert len(T.to_json(tm)["cards"]) == 10
    for k in ("passes", "rounds", "dispatches"):
        assert ts[k] == js[k], k


# --------------------------------------------------------------------------
# binary wire frames
# --------------------------------------------------------------------------


def _typed_peer(am):
    a = am.change(am.init(opts(am, "writer")),
                  lambda d: d.__setitem__("t", am.Text("seed")))
    base = a
    for i in range(12):
        a = am.change(a, lambda d, i=i: d["t"].insert_at(4 + 6 * i,
                                                         *f"w{i:04d}."))
    a = am.change(a, lambda d: d["t"].delete_at(0, 2))
    return base, a


@pytest.mark.parametrize("receiver", ["fresh", "base"])
def test_wire_frame_delivery_equals_dict_delivery(receiver):
    from automerge_tpu.engine import wire_format as jw
    from automerge_tpu_torch.engine import wire_format as tw

    def run(am):
        w = jw if am is J else tw
        base, a = _typed_peer(am)
        tail = am.get_changes(base, a)
        frame = w.WireFrame(w.encode_changes(tail))
        assert frame.n_changes == len(tail) and frame.kind == "text"
        start = (am.merge(am.init(opts(am, "r")), base)
                 if receiver == "base" else am.init(opts(am, "r")))
        head = am.get_all_changes(base) if receiver == "fresh" else []
        if head:
            start = am.apply_changes(start, head)
        via_frame = am.apply_changes(start, frame)
        via_dict = am.apply_changes(start, tail)
        assert am.save(via_frame) == am.save(via_dict)
        assert am.to_json(via_frame) == am.to_json(via_dict) \
            == am.to_json(a)
        return bytes(frame.data), am.save(via_frame)
    (jb, js), (tb, ts) = both(run)
    assert tb == jb
    assert ts == js


# --------------------------------------------------------------------------
# the device seam
# --------------------------------------------------------------------------


def test_default_binding_runs_on_the_card_or_raises():
    """`init()` binds the card: with none, the first engine use raises the
    engine's error, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        d = T.change(T.init("card"), lambda x: x.__setitem__("t",
                                                             T.Text("hi")))
        assert T.frontend.get_backend_state(d)._core.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.change(T.init("nocard"), lambda x: x.__setitem__("t",
                                                           T.Text("hi")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.load(T.save(T.change(T.init({"actorId": "c", "backend": CPU}),
                               lambda x: x.__setitem__("k", 1))))
    assert T.backend.Backend is T.backend.facade.Backend
    assert T.backend.backend_for(None) is T.backend.DeviceBackend
    assert T.backend.backend_for("cpu") is CPU


@pytest.mark.parametrize("graduated", [False, True])
def test_backend_state_carried_from_jax_agrees_after_more_changes(graduated):
    """A JAX lineage (pending write-behind rounds, undo stack, a nested
    tree, optionally graduated) carried into the port: both packages then
    take the same local, remote and undo steps and agree exactly."""
    from automerge_tpu.backend import device as jdev
    jd = J.change(J.init("carry"), lambda d: d.update(
        {"t": J.Text("abcdef"), "m": {"k": 1}, "c": J.Counter(2)}))
    jd = J.change(jd, lambda d: d["t"].insert_at(3, *"XY"))
    jd = J.change(jd, lambda d: d["m"].__setitem__("k", 2))
    peer = J.change(J.merge(J.init("peer"), jd),
                    lambda d: d["t"].delete_at(0))
    jd = J.merge(jd, peer)
    jd = J.change(jd, lambda d: d["t"].insert_at(0, "Q"))   # write-behind
    if graduated:
        jstate = J.frontend.get_backend_state(jd)
        bad = {"actor": "zed", "seq": 1, "deps": {}, "ops": [
            {"action": "ins", "obj": J.frontend.get_object_id(jd["m"]),
             "key": "_head", "elem": 1}]}
        gstate, _ = jdev.apply_changes(jstate, [bad])
        assert type(gstate).__name__ == "BackendState"
        jstates = [gstate]
    else:
        jstates = [J.frontend.get_backend_state(jd)]
    jstate = jstates[0]
    tstate = backend_state_from_jax(jstate, "cpu")
    assert type(tstate).__name__ == type(jstate).__name__
    assert tstate.clock == jstate.clock and tstate.deps == jstate.deps
    assert tstate.history() == jstate.history()

    (jmod, tmod) = ((j_facade, t_facade) if graduated else
                    (j_device, t_device))
    assert tmod.get_patch(tstate) == jmod.get_patch(jstate)
    clock = dict(jstate.clock)
    steps = [
        ("local", {"requestType": "change", "actor": "carry",
                   "seq": clock["carry"] + 1, "deps": {},
                   "ops": [{"action": "set", "obj": J.ROOT_ID,
                            "key": "after", "value": 1}]}),
        ("remote", [{"actor": "late", "seq": 1, "deps": clock, "ops": [
            {"action": "set", "obj": J.ROOT_ID, "key": "late",
             "value": "x"}]}]),
        ("undo", {"requestType": "undo", "actor": "carry",
                  "seq": clock["carry"] + 2, "deps": {}}),
    ]
    for kind, arg in steps:
        if kind == "remote":
            jstate, jp = jmod.apply_changes(jstate, arg)
            tstate, tp = tmod.apply_changes(tstate, arg)
        else:
            jstate, jp = jmod.apply_local_change(jstate, arg)
            tstate, tp = tmod.apply_local_change(tstate, arg)
        jp.pop("state", None)
        tp.pop("state", None)
        assert tp == jp, kind
    assert tmod.get_patch(tstate) == jmod.get_patch(jstate)
    assert tstate.history() == jstate.history()
    if not graduated:
        core = tstate._core
        assert core.device.type == "cpu"
        for w in core.objects.values():
            assert all(t.device.type == "cpu"
                       for t in w.doc._ensure_dev().values())


def test_public_api_on_the_cpu_imports_neither_jax_nor_the_jax_package():
    """The README's one-line check: a Text document made through the
    port's API on the CPU backend loads no JAX module."""
    import os
    import subprocess
    import sys
    code = (
        "import automerge_tpu_torch as am, sys\n"
        "d = am.change(am.init({'backend': am.backend.backend_for('cpu')}),"
        " lambda d: d.__setitem__('t', am.Text('hi')))\n"
        "assert am.to_json(d) == {'t': 'hi'}\n"
        "assert 'jax' not in sys.modules and not any(m == 'automerge_tpu' "
        "or m.startswith('automerge_tpu.') for m in sys.modules)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
