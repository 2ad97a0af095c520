"""The port's learned-index registry (automerge_tpu_torch/engine/
learned_index.py: per-site counters, the miss-rate demotion window,
re-arm on refit, the ``amtpu_index_*`` families and the describe block)
and its ``ops/scan.py`` against the JAX package's, on the CPU.

The same probes run through both packages' models and sites, and the
per-site snapshots must be equal. Through the engines, a single-document
stream gives exactly the JAX package's counts at every site. Two counts
differ by design, and the tests that meet them name them:

- ``cross_doc_seed`` refits: the port's cross-document rank join probes
  each doc's cached actor model (fitted once per interning generation
  and counted as an ``actor_rank`` refit), where the JAX package fits a
  fresh model on every seeding call. Its lookups, keys and hits are
  equal.
- ``range_index`` on ``DeviceTextDocSet`` builds: the port's DocSet
  planner probes its staged index through the learned path (counted),
  where the JAX package's DocSet calls the exact lookup (not counted).

Everywhere: the schema is equal, ``hits + misses == keys`` and
``wrong == 0``. A demoted site takes its exact path with unchanged
results.
"""

import random

import numpy as np
import pytest
import torch

from automerge_tpu.engine import learned_index as JL
from automerge_tpu.ops import scan as jscan
from automerge_tpu_torch.engine import learned_index as TL
from automerge_tpu_torch.ops import scan as tscan
from test_shard import text_change

PACKAGES = (JL, TL)


@pytest.fixture(autouse=True)
def _fresh_stats(monkeypatch):
    monkeypatch.setenv("AMTPU_STACKED_MIN_OPS", "1")
    for L in PACKAGES:
        L.reset_stats()
    yield
    for L in PACKAGES:
        L.reset_stats()


def snaps():
    return JL.stats_snapshot(), TL.stats_snapshot()


def check_sane(snap):
    for name, s in snap.items():
        assert s["hits"] + s["misses"] == s["keys"], name
        assert s["wrong"] == 0, name


# ---------------------------------------------------------------------------
# the registry and the models, probe for probe
# ---------------------------------------------------------------------------


def test_registry_surface_matches_the_jax_package():
    assert set(TL.SITES) == set(JL.SITES) == {
        "actor_rank", "cross_doc_seed", "range_index", "residency_clock"}
    assert TL.RANGE_SITE is TL.SITES["range_index"]
    assert TL._DEMOTE_RATE == JL._DEMOTE_RATE == 0.25
    assert TL._DEMOTE_WINDOW == JL._DEMOTE_WINDOW
    j, t = snaps()
    assert t == j
    assert TL.describe() == JL.describe()
    assert TL.describe()["enabled"] is True
    st = TL.site_state("a_new_site")
    assert TL.site_state("a_new_site") is st
    assert JL.site_state("a_new_site").snapshot() == st.snapshot()
    del TL.SITES["a_new_site"], JL.SITES["a_new_site"]


@pytest.mark.parametrize("seed", range(6))
def test_model_probes_count_the_same(seed):
    """tests/test_learned_index.py's random tables: the same fit and
    queries give the same positions and the same site counters."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(16, 4000))
    keys = np.cumsum(np.maximum(1, rng.lognormal(2.0, 2.0, n))
                     .astype(np.int64))
    q = np.concatenate([rng.choice(keys, 50),
                        keys[rng.integers(0, n, 50)]
                        + rng.integers(-3, 4, 50),
                        rng.integers(0, int(keys[-1]) + 10, 50)])
    out = []
    for L in PACKAGES:
        m = L.fit_model(keys, "range_index")
        got = None
        if m is not None:
            got = [m.searchsorted(q, side=s).tolist()
                   for s in ("left", "right")]
            for side, pos in zip(("left", "right"), got):
                assert pos == np.searchsorted(keys, q, side).tolist()
        out.append((None if m is None else m.eps, got))
    assert out[1] == out[0]
    j, t = snaps()
    assert t == j
    check_sane(t)


def test_below_threshold_and_refused_fits_count_nothing():
    small = np.arange(10, dtype=np.int64)
    dup = np.asarray([1, 2, 2, 3] * 8, np.int64)
    for L in PACKAGES:
        assert L.fit_model(small, "range_index") is None
        assert L.fit_model(np.sort(dup), "range_index") is None
    j, t = snaps()
    assert t == j and t["range_index"]["refits"] == 0


def test_drifted_model_misses_stay_exact_then_demote_and_refit_rearms():
    """A model whose ε under-states its error misses; the windowed miss
    rate demotes the site after the same number of probes in both
    packages, and a refit re-arms it."""
    rng = np.random.default_rng(3)
    keys = np.cumsum(np.maximum(1, rng.lognormal(3.0, 2.5, 2000))
                     .astype(np.int64))
    q = rng.integers(0, int(keys[-1]), 300)
    trace = {}
    for L in PACKAGES:
        st = L.SITES["range_index"]
        good = L.fit_model(keys, "range_index")
        drifted = L.PositionModel(good.padded, good.anchor_keys,
                                  good.anchor_pos, 0, "range_index")
        seen = []
        while not st.demoted and len(seen) < 40:
            got = drifted.searchsorted(q, side="left")
            np.testing.assert_array_equal(got, np.searchsorted(keys, q))
            seen.append(st.snapshot())
        assert st.demoted and not L.site_enabled("range_index")
        assert st.misses > 0 and st.wrong == 0
        L.fit_model(keys, "range_index")
        assert not st.demoted and L.site_enabled("range_index")
        trace[L] = (seen, st.snapshot())
    assert trace[TL] == trace[JL]


def test_window_below_the_rate_never_demotes():
    keys = np.arange(0, 64_000, 7, dtype=np.int64)
    q = np.arange(0, 64_000, 13, dtype=np.int64)
    for L in PACKAGES:
        m = L.fit_model(keys, "range_index")
        assert m.eps == 0
        for _ in range(5):
            m.searchsorted(q)
        assert not L.SITES["range_index"].demoted
    j, t = snaps()
    assert t == j and t["range_index"]["misses"] == 0


def test_actor_positions_counts_and_full_key_gate():
    table = sorted(f"w{i:07d}" for i in range(64))
    q = np.asarray(["w0000003", "w0000003x", "w9999999"], object)
    small = sorted(["alice", "bob", "carol"])
    out = []
    for L in PACKAGES:
        tk = L.pack_str_keys(table)
        pair = (tk, L.fit_model(tk, "actor_rank"))
        if L is JL:
            got = L.actor_positions(table, q, "actor_rank", model=pair)
            got_small = L.actor_positions(
                small, np.asarray(["bob", "dave"], object), "actor_rank",
                model=(L.pack_str_keys(small), None))
            bad = L.actor_positions(table, np.asarray(["café"], object),
                                    "actor_rank", model=pair)
        else:
            got = L.actor_positions(table, q, "actor_rank", pair)
            got_small = L.actor_positions(
                small, np.asarray(["bob", "dave"], object), "actor_rank",
                (L.pack_str_keys(small), None))
            bad = L.actor_positions(table, np.asarray(["café"], object),
                                    "actor_rank", pair)
        assert got[1].tolist() == [True, False, False] and got[0][0] == 3
        assert got_small[1].tolist() == [True, False]
        assert bad is None
        out.append((got[0].tolist(), got_small[0].tolist()))
    assert out[1] == out[0]
    j, t = snaps()
    assert t == j
    assert t["actor_rank"]["exact_fallbacks"] == 1
    check_sane(t)


def test_families_are_prom_clean_and_equal():
    from automerge_tpu.obs import prom as jprom
    from automerge_tpu_torch.obs import prom as tprom
    keys = np.cumsum(np.arange(1, 200, dtype=np.int64))
    for L in PACKAGES:
        m = L.fit_model(keys, "residency_clock")
        m.searchsorted(keys[::3] + 1)
    tpage = tprom.expose(TL.families("amtpu_index"))
    jpage = jprom.expose(JL.families("amtpu_index"))
    assert tprom.validate_prom(tpage)["families"] == 11
    assert tpage == jpage
    assert TL.describe() == JL.describe()


# ---------------------------------------------------------------------------
# through the engines
# ---------------------------------------------------------------------------


def _text_stream(n_actors, rounds, obj="t", seed=0):
    """Causal rounds of 3-char inserts by `n_actors` actors into one
    text object (each actor appends after its own last element)."""
    rng = random.Random(seed)
    out = []
    for r in range(rounds):
        chs = []
        for a in rng.sample(range(n_actors), n_actors):
            actor = f"act{a:03d}"
            ctr0 = r * 3 + 1
            chs.append(text_change(
                actor, r + 1, "abc", start_ctr=ctr0, obj=obj,
                after=None if r == 0 else f"{actor}:{ctr0 - 1}",
                deps={} if r == 0 else {actor: r}))
        out.append(chs)
    return out


def _run_doc(pkg, rounds, **kw):
    mod = __import__(f"{pkg}.engine.text_doc", fromlist=["DeviceTextDoc"])
    doc = mod.DeviceTextDoc("t", **kw)
    for chs in rounds:
        doc.apply_changes(chs)
    return doc.text()


@pytest.mark.parametrize("n_actors", [4, 12, 40])
def test_single_document_stream_counts_equal_the_jax_package(n_actors):
    """One document through the engines: every site's counters equal the
    JAX package's (4 actors: below the model threshold; 12: the dict
    scan under 8-key batches and the packed probe above; 40: fitted
    actor models)."""
    rounds = _text_stream(n_actors, 6)
    want = _run_doc("automerge_tpu", rounds)
    got = _run_doc("automerge_tpu_torch", rounds, device="cpu")
    assert got == want
    j, t = snaps()
    assert t == j
    check_sane(t)
    assert t["range_index"]["lookups"] > 0


def test_api_stream_counts_equal_the_jax_package():
    """The public API: a 14-change text stream by 12 actors merged into
    one document."""
    import automerge_tpu as J
    import automerge_tpu_torch as T
    d = J.change(J.init("aaaa"),
                 lambda d: d.__setitem__("t", J.Text("hello world")))
    changes = [J.get_all_changes(d)]
    for r in range(14):
        e = J.merge(J.init(f"actor{r % 12:03d}"), d)
        e2 = J.change(e, lambda x, r=r: x["t"].insert_at(r % 5, *"xy" * 8))
        changes.append(J.get_changes(e, e2))
        d = J.merge(d, e2)
    for L in PACKAGES:
        L.reset_stats()
    jd = J.init("zzzz")
    td = T.init({"actorId": "zzzz",
                 "backend": T.backend.backend_for("cpu")})
    for c in changes:
        jd = J.apply_changes(jd, c)
    for c in changes:
        td = T.apply_changes(td, c)
    assert T.to_json(td) == J.to_json(jd)
    j, t = snaps()
    assert t == j
    check_sane(t)


def test_stacked_population_counts_name_the_cross_doc_difference():
    """A stacked multi-document round: every count equal except the
    ``cross_doc_seed`` refits and ε (see the module note: the port's join
    probes each doc's cached actor model)."""
    from automerge_tpu.engine import stacked as js
    from automerge_tpu.engine.text_doc import DeviceTextDoc as JD
    from automerge_tpu_torch.engine import stacked as ts
    from automerge_tpu_torch.engine.text_doc import DeviceTextDoc as TD
    streams = [_text_stream(20, 4, obj=f"doc{d}") for d in range(4)]
    texts = []
    for St, D, kw in ((js, JD, {}), (ts, TD, {"device": "cpu"})):
        docs = [D(f"doc{d}", **kw) for d in range(4)]
        for r in range(4):
            assert St.apply_stacked([(docs[d], streams[d][r])
                                     for d in range(4)])
        texts.append([doc.text() for doc in docs])
    assert texts[1] == texts[0]
    j, t = snaps()
    check_sane(t)
    differs = ("refits", "eps_last")
    jc, tc = j.pop("cross_doc_seed"), t.pop("cross_doc_seed")
    assert t == j
    assert {k: v for k, v in tc.items() if k not in differs} == \
        {k: v for k, v in jc.items() if k not in differs}
    assert tc["lookups"] > 0 and jc["refits"] > tc["refits"] == 0


def test_docset_build_counts_name_the_range_index_difference():
    """``DeviceTextDocSet``: the port's planner probes its staged index
    through the learned path (``range_index`` counted), the JAX
    package's through the exact lookup; every other site is equal. One
    typist a doc, so each staged index is one affine range (the probe
    form that counts)."""
    from automerge_tpu.engine import TextChangeBatch as JBatch
    from automerge_tpu.engine.doc_set import DeviceTextDocSet as JSet
    from automerge_tpu_torch.engine import TextChangeBatch as TBatch
    from automerge_tpu_torch.engine.doc_set import DeviceTextDocSet as TSet
    from test_doc_set_engine import typing_change
    ids = [f"d{i}" for i in range(6)]
    rounds = [{d: [typing_change(f"a{k}", r + 1, "xyz",
                                 start_ctr=3 * r + 1, obj=d,
                                 after=None if r == 0
                                 else f"a{k}:{3 * r}",
                                 deps={} if r == 0 else {f"a{k}": r})
                   for k in range(1)] for d in ids} for r in range(3)]
    jds = JSet(ids, capacity=256)
    tds = TSet(ids, capacity=256, device="cpu")
    for rnd in rounds:
        jds.apply_batches({o: JBatch.from_changes(c, o)
                           for o, c in rnd.items()})
        tds.apply_batches({o: TBatch.from_changes(c, o)
                           for o, c in rnd.items()})
    assert tds.texts() == jds.texts()
    j, t = snaps()
    check_sane(t)
    jr, tr = j.pop("range_index"), t.pop("range_index")
    assert t == j
    assert tr["keys"] > jr["keys"] == 0


def test_demoted_sites_take_the_exact_path_with_unchanged_results():
    """Every site demoted: the engines take their exact probes (no new
    lookups on a demoted site until a refit re-arms it) and the text is
    unchanged."""
    rounds = _text_stream(40, 5)
    want = _run_doc("automerge_tpu_torch", rounds, device="cpu")
    TL.reset_stats()
    for st in TL.SITES.values():
        st.demoted = True
    TL.RANGE_SITE.refits = 0
    got = _run_doc("automerge_tpu_torch", rounds, device="cpu")
    assert got == want
    snap = TL.stats_snapshot()
    assert snap["range_index"]["lookups"] == 0
    assert snap["cross_doc_seed"]["lookups"] == 0
    assert snap["actor_rank"]["lookups"] == 0
    assert all(s["demoted"] for s in snap.values())
    assert TL.describe()["demoted_sites"] == sorted(TL.SITES)


def test_refit_on_intern_gen_bump():
    from automerge_tpu_torch.engine.text_doc import DeviceTextDoc
    doc = DeviceTextDoc("t", device="cpu")
    doc.apply_changes([{"actor": f"a{i:02d}", "seq": 1,
                        "deps": {}, "ops": []} for i in range(20)])
    st = TL.SITES["actor_rank"]
    m1 = TL.doc_actor_model(doc)
    r1 = st.refits
    assert r1 >= 1 and TL.doc_actor_model(doc) is m1
    assert st.refits == r1
    gen0 = doc._intern_gen
    doc.apply_changes([{"actor": "zz99", "seq": 1, "deps": {},
                        "ops": []}])
    assert doc._intern_gen != gen0
    assert TL.doc_actor_model(doc) is not m1
    assert st.refits > r1


def test_store_member_mask_counts_equal_and_demotion_goes_exact():
    from automerge_tpu.residency.store import BundleStore as JB
    from automerge_tpu_torch.residency.store import BundleStore as TB
    masks = []
    for B in (JB, TB):
        s = B()
        for i in range(48):
            s.put(f"doc{i:04d}", b"b" * 4)
        q = [f"doc{i:04d}" for i in range(0, 96, 5)]
        m1 = s.member_mask(q).tolist()
        s.pop("doc0005")
        m2 = s.member_mask(q).tolist()
        assert m1 == [True] * 10 + [False] * 10
        assert m2 == [d in s for d in q]
        masks.append((m1, m2))
    assert masks[1] == masks[0]
    j, t = snaps()
    assert t == j and t["residency_clock"]["refits"] == 2
    TL.SITES["residency_clock"].demoted = True
    s = TB()
    s.put("d1", b"x")
    assert s.member_mask(["d1"]) is None


# ---------------------------------------------------------------------------
# ops/scan.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n", [1, 7, 256, 1000])
def test_visible_index_matches_the_jax_function(seed, n):
    rng = np.random.default_rng(seed * 131 + n)
    pos = rng.permutation(n).astype(np.int32)
    pos[rng.random(n) < 0.1] = -1                   # head slots
    pos[rng.random(n) < 0.05] = n + 50              # padding, clipped
    visible = rng.random(n) < 0.6
    for cap in (None, n + 8):
        jr, jn = jscan.visible_index(pos, visible, cap)
        tr, tn = tscan.visible_index(torch.from_numpy(pos),
                                     torch.from_numpy(visible), cap)
        assert tr.dtype == torch.int32 and tr.device.type == "cpu"
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        assert int(tn) == int(jn)


@pytest.mark.parametrize("n", [0, 1, 2, 50, 3000])
def test_segment_starts_matches_the_jax_function(n):
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, max(1, n // 3), n)).astype(np.int32)
    want = np.asarray(jscan.segment_starts(keys))
    got = tscan.segment_starts(torch.from_numpy(keys))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_scan_functions_are_exported_like_the_jax_package():
    import automerge_tpu.ops as jops
    import automerge_tpu_torch.ops as tops
    assert tops.visible_index is tscan.visible_index
    assert tops.segment_starts is tscan.segment_starts
    assert hasattr(jops, "visible_index") and hasattr(jops, "segment_starts")
