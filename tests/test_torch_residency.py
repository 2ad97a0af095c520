"""The port's device-residency tier (automerge_tpu_torch/residency/)
against the JAX package's, on the CPU.

Every scenario runs twice: once through the JAX package's
`ShardedDocSet.attach_residency` on its 8 virtual CPU devices, once
through the port's with ``devices=[cpu]``. Tolerance is zero: every
doc's tier (`tier_of`), `accounting()` (the tier lists, parked counts
and the resident, warm and cold bytes), the manager's and the bundle
store's `stats`, the doc-kind peak footprint gauge, captures and texts
must be equal, and each run must pass the JAX test's own assertions.
Only the page-in dwell (a timing) is left out.

A budget of k docs' bytes gives both packages the same page-in,
page-out and eviction sequence because a doc's ``device_bytes`` is the
same number in both after every lane round and restore
(`test_per_doc_bytes_equal_the_jax_package`): a stacked round hands
each doc buffers of its own, and a lane's docs compact at every commit.

- Twins of tests/test_residency.py's bundle store, policy, eviction
  under pressure, demote/promote round trip, paging and observability
  tests (the service integration waits for the port's service tier).
- The bench.py measure_residency (cfg18) schedule at its quick and its
  full settings: the tier ledger after every round equal to the JAX
  package's, and every capture equal to an unbounded reference.
- The batched stored-membership probe (`BundleStore.member_mask`)
  against the JAX package's and the exact ``in``.
"""

import random
from types import SimpleNamespace

import pytest
import torch

import automerge_tpu.residency as JRES
import automerge_tpu.shard as JSH
import automerge_tpu_torch.residency as TRES
import automerge_tpu_torch.shard as TSH
from automerge_tpu.engine import accounting as J_acct
from automerge_tpu.obs import device_truth as J_dt
from automerge_tpu.obs import lineage as J_lineage
from automerge_tpu.obs import prom as J_prom
from automerge_tpu_torch.engine import accounting as T_acct
from automerge_tpu_torch.obs import device_truth as T_dt
from automerge_tpu_torch.obs import lineage as T_lineage
from automerge_tpu_torch.obs import prom as T_prom
from test_residency import doc_stream, text_change
from test_torch_soak_docs import threads_checked

CPU = torch.device("cpu")

J = SimpleNamespace(
    name="jax", res=JRES, shard=JSH, dt=J_dt, acct=J_acct,
    lineage=J_lineage, prom=J_prom,
    mesh=lambda **kw: _opened(JSH.ShardedDocSet(**kw)))
T = SimpleNamespace(
    name="port", res=TRES, shard=TSH, dt=T_dt, acct=T_acct,
    lineage=T_lineage, prom=T_prom,
    mesh=lambda **kw: _opened(TSH.ShardedDocSet(devices=[CPU], **kw)))


def same(run):
    """Run `run(P)` through both packages; the results must be equal."""
    want = run(J)
    got = run(T)
    assert got == want
    return got


@pytest.fixture(autouse=True)
def _small_gate(monkeypatch):
    monkeypatch.setenv("AMTPU_STACKED_MIN_OPS", "1")


@pytest.fixture(autouse=True)
def _fresh_gauges():
    """Each test starts from a clean footprint session in both packages."""
    for P in (J, T):
        P.dt.REGISTRY.clear_session()
    yield
    for P in (J, T):
        P.dt.REGISTRY.clear_session()


#: every mesh a test opened through `J.mesh` / `T.mesh`
_OPEN = []


def _opened(mesh):
    _OPEN.append(mesh)
    return mesh


@pytest.fixture(autouse=True)
def no_leaked_threads():
    """Every mesh a test opened is closed after it (the JAX package's
    lanes on its virtual devices run worker threads), and a test that
    still leaves a new live thread behind fails, naming it."""
    with threads_checked():
        yield
        while _OPEN:
            _OPEN.pop().close()


def build_mesh(P, n_shards=2, budget=0, spill_dir=None, capacity=256,
               **res_kw):
    mesh = P.mesh(n_shards=n_shards, capacity=capacity)
    res = mesh.attach_residency(budget_bytes=budget, spill_dir=spill_dir,
                                **res_kw)
    return mesh, res


def prime(mesh, res):
    """Teach the manager the per-doc footprint, then drop the primer."""
    mesh.deliver_round({"__prime__": [text_change(
        "pa", 1, "x", obj="__prime__")]})
    if res.tier_of("__prime__") == "hot":
        assert res.demote("__prime__")
    res.store.pop("__prime__")
    res.model.forget("__prime__")


def res_state(P, mesh, res, docs) -> dict:
    """Everything the contract compares of one managed mesh."""
    m = res.metrics()
    m.pop("page_in_p99_ms")
    return {"tiers": {d: res.tier_of(d) for d in docs},
            "accounting": res.accounting(), "metrics": m,
            "store": dict(res.store.stats),
            "peak_gauge": P.dt.REGISTRY.footprint()["peak_device_bytes"],
            "placement": mesh.placement.table(),
            "quarantined": {d: mesh.quarantined(d) for d in docs}}


def _spill(tmp_path, P):
    path = tmp_path / P.name
    path.mkdir(exist_ok=True)
    return str(path)


# ---------------------------------------------------------------------------
# the bundle store (warm / cold tiers)
# ---------------------------------------------------------------------------


class TestBundleStore:
    def test_put_peek_pop_warm(self):
        def run(P):
            st = P.res.BundleStore()
            st.put("d", b"bundle-bytes")
            assert "d" in st and st.tier("d") == "warm"
            assert st.peek("d") == b"bundle-bytes"
            assert st.tier("d") == "warm"
            assert st.pop("d") == b"bundle-bytes"
            assert "d" not in st and st.pop("d") is None
            return dict(st.stats), st.tiers()
        same(run)

    def test_age_to_disk_and_cold_pop(self, tmp_path):
        def run(P):
            spill = tmp_path / P.name
            st = P.res.BundleStore(str(spill))
            st.put("d", b"payload")
            assert st.age("d") is True
            assert st.tier("d") == "cold" and st.warm_bytes == 0
            files = list(spill.glob("*.amtpuckpt"))
            assert len(files) == 1 and files[0].read_bytes() == b"payload"
            names = [f.name for f in files]
            assert st.peek("d") == b"payload"
            assert st.tier("d") == "cold"
            assert st.pop("d") == b"payload"
            assert not list(spill.glob("*.amtpuckpt"))
            assert st.stats["loads"] == 1
            return names, dict(st.stats)
        same(run)

    def test_age_without_spill_dir_is_noop(self):
        def run(P):
            st = P.res.BundleStore()
            st.put("d", b"x")
            assert st.age("d") is False and st.tier("d") == "warm"
            return dict(st.stats)
        same(run)

    def test_redemote_overwrites_and_drops_cold(self, tmp_path):
        def run(P):
            st = P.res.BundleStore(_spill(tmp_path, P))
            st.put("d", b"v1")
            st.age("d")
            st.put("d", b"v2")
            assert st.tier("d") == "warm" and st.peek("d") == b"v2"
            return dict(st.stats), st.tiers()
        same(run)

    def test_accounting_is_exact(self, tmp_path):
        def run(P):
            st = P.res.BundleStore(_spill(tmp_path, P))
            st.put("a", b"aa")
            st.put("b", b"bbbb")
            st.age("a")
            t = st.tiers()
            assert t == {"warm": ["b"], "cold": ["a"],
                         "warm_bytes": 4, "cold_bytes": 2}
            return t, dict(st.stats)
        same(run)

    @pytest.mark.parametrize("n_ids", [3, 40, 300])
    def test_member_mask_is_exact(self, n_ids, tmp_path):
        """The batched probe answers exactly what ``in`` answers, in both
        packages, whether the fitted model or the packed search serves
        it; a query sharing a stored id's 8-byte prefix is gated out by
        the full-key comparison."""
        def run(P):
            st = P.res.BundleStore(_spill(tmp_path, P))
            ids = [f"{i:05d}-doc" for i in range(n_ids)]
            for d in ids[::2]:
                st.put(d, b"x")
            for d in ids[::6]:
                st.age(d)
            queries = ids + ["zzzzz", "nope", "00000-do", "00000-doc-x"]
            mask = st.member_mask(queries)
            assert mask is not None
            assert [bool(v) for v in mask] == [q in st for q in queries]
            st.pop(ids[0])
            mask = st.member_mask(queries)
            assert not bool(mask[0])
            assert [bool(v) for v in mask] == [q in st for q in queries]
            assert st.member_mask(["dóc"]) is None
            return [bool(v) for v in mask]
        same(run)

    def test_member_mask_declines_colliding_prefixes(self):
        """Stored ids whose packed 8-byte prefixes collide cannot order
        the packed table: the probe declines (None) and the caller takes
        the exact per-doc ``in``."""
        def run(P):
            st = P.res.BundleStore()
            for i in range(4):
                st.put(f"doc-0000{i}", b"x")
            return st.member_mask(["doc-00001", "doc-00009"])
        assert same(run) is None


# ---------------------------------------------------------------------------
# eviction policy
# ---------------------------------------------------------------------------


class TestPolicy:
    def test_config_rejects_unknown_policy(self):
        def run(P):
            with pytest.raises(ValueError):
                P.res.ResidencyConfig(eviction="clairvoyant")
            c = P.res.ResidencyConfig(eviction="lru", budget_bytes=7)
            return [getattr(c, k) for k in c.__slots__]
        same(run)

    def test_make_model(self):
        def run(P):
            assert isinstance(P.res.make_model("learned"),
                              P.res.WorkingSetModel)
            assert isinstance(P.res.make_model("lru"), P.res.LruModel)
            return (P.res.make_model("learned").describe(),
                    P.res.make_model("lru").describe())
        same(run)

    def test_learned_inverts_lru_for_mixed_rhythms(self):
        def run(P):
            learned, lru = P.res.WorkingSetModel(), P.res.LruModel()
            for m in (learned, lru):
                for r in (8, 9, 10, 11):
                    m.note_touch("A", r)
                for r in (0, 5, 10):
                    m.note_touch("B", r)
            now = 14
            assert lru.score("B", now) > lru.score("A", now)
            assert learned.score("A", now) > learned.score("B", now)
            return [m.score(d, now) for m in (learned, lru)
                    for d in ("A", "B")]
        same(run)

    def test_cold_start_uses_population_prior(self):
        def run(P):
            m = P.res.WorkingSetModel()
            for r in range(0, 40, 4):
                m.note_touch("veteran", r)
            m.note_touch("rookie", 36)
            assert m.predicted_gap("rookie") > 1.0
            return m.predicted_gap("rookie"), m.predicted_gap("veteran")
        same(run)

    def test_forget_drops_per_doc_state(self):
        def run(P):
            m = P.res.WorkingSetModel()
            m.note_touch("d", 1)
            m.note_touch("d", 3)
            m.forget("d")
            assert m.describe()["tracked_docs"] == 0
            return m.describe()
        same(run)

    def test_lane_pressure_reads_the_rebalance_windows(self):
        def run(P):
            mesh = P.mesh(n_shards=3, capacity=64)
            for i in range(6):
                mesh.deliver_round({f"p{i}": doc_stream(f"p{i}", 2)})
            return P.res.policy.lane_pressure(mesh.telemetry, mesh.lanes)
        same(run)


# ---------------------------------------------------------------------------
# eviction under pressure: the budget invariant
# ---------------------------------------------------------------------------


class TestEvictionUnderPressure:
    def test_population_10x_budget_peak_gauge_bounded(self, tmp_path):
        def run(P):
            mesh, res = build_mesh(P, n_shards=2,
                                   spill_dir=_spill(tmp_path, P),
                                   budget=0, cold_after=3)
            prime(mesh, res)
            per_doc = res._est_bytes
            assert per_doc > 0
            budget = 3 * per_doc
            res.config.budget_bytes = budget
            n_docs = 30
            seqs = {i: 0 for i in range(n_docs)}
            rng = random.Random(18)
            trail = []
            for rnd in range(40):
                touched = rng.sample(range(n_docs), 2)
                deliveries = {}
                for i in touched:
                    seqs[i] += 1
                    a = f"a-doc{i}"
                    deliveries[f"doc{i}"] = [text_change(
                        a, seqs[i], "x", start_ctr=seqs[i], obj=f"doc{i}",
                        after=(None if seqs[i] == 1
                               else f"{a}:{seqs[i]-1}"))]
                mesh.deliver_round(deliveries)
                fp = P.dt.REGISTRY.footprint()
                assert fp["peak_device_bytes"] <= budget
                acct = res.accounting()
                trail.append((acct["hot"], acct["warm"], acct["cold"],
                              acct["resident_bytes"]))
            m = res.metrics()
            assert m["budget_overruns"] == 0
            assert m["page_outs"] > 0 and m["page_ins"] > 0
            assert m["cold_ages"] > 0
            docs = [f"doc{i}" for i in range(n_docs) if seqs[i]]
            acct = res.accounting()
            assert sorted(acct["hot"] + acct["warm"] + acct["cold"]) == \
                sorted(docs)
            before = res_state(P, mesh, res, docs)
            texts = {}
            for d in docs:
                res.ensure_resident(d)
                lane = mesh.lane_of(d)
                with lane.device_ctx():
                    texts[d] = lane.docs[d].text()
                assert texts[d] == "x" * seqs[int(d[3:])]
            assert P.dt.REGISTRY.footprint()["peak_device_bytes"] <= budget
            return (per_doc, trail, before, texts,
                    res_state(P, mesh, res, docs))
        same(run)

    def test_unbounded_budget_meters_but_never_evicts(self):
        def run(P):
            mesh, res = build_mesh(P, budget=0)
            for i in range(6):
                mesh.deliver_round({f"doc{i}": doc_stream(f"doc{i}", 1)})
            assert res.metrics()["evictions"] == 0
            assert len(res.accounting()["hot"]) == 6
            assert res.resident_bytes() > 0
            return (res.resident_bytes(),
                    res_state(P, mesh, res, [f"doc{i}" for i in range(6)]))
        same(run)

    def test_protected_working_set_over_budget_counts_overrun(self):
        def run(P):
            mesh, res = build_mesh(P, budget=1)
            mesh.deliver_round({"d0": doc_stream("d0", 1)})
            mesh.deliver_round({"d0": [doc_stream("d0", 2)[1]]})
            assert res.metrics()["budget_overruns"] > 0
            return res_state(P, mesh, res, ["d0"])
        same(run)


# ---------------------------------------------------------------------------
# demote -> promote round trip
# ---------------------------------------------------------------------------


class TestRoundTrip:
    def test_chaotic_stream_with_churn_restores_saves_and_footprint(self):
        def run(P):
            def leg(churn):
                mesh, res = build_mesh(P, n_shards=2, budget=0)
                rng = random.Random(7)
                streams = {f"doc{i}": doc_stream(f"doc{i}", 6, piece="ab")
                           for i in range(4)}
                pending = [(d, ch) for d, chs in streams.items()
                           for ch in chs]
                pending += rng.sample(pending, 5)
                rng.shuffle(pending)
                footprints = {}
                for n, (doc_id, ch) in enumerate(pending):
                    mesh.deliver_round({doc_id: [ch]})
                    if churn and n % 3 == 2:
                        victim = f"doc{rng.randrange(4)}"
                        if res.demote(victim):
                            res.ensure_resident(victim)
                            f1 = mesh.lane_of(victim).docs[
                                victim].device_footprint()
                            assert res.demote(victim)
                            res.ensure_resident(victim)
                            f2 = mesh.lane_of(victim).docs[
                                victim].device_footprint()
                            assert f1["device_bytes"] == f2["device_bytes"]
                            assert f1["table_bytes"] == f2["table_bytes"]
                            footprints[victim] = (f2["device_bytes"],
                                                  f2["table_bytes"])
                assert all(not len(q) for q in mesh._quarantine.values())
                return ({d: mesh.capture(d) for d in streams},
                        mesh.texts(), footprints,
                        res_state(P, mesh, res, list(streams)))

            ref = leg(churn=False)
            churn = leg(churn=True)
            assert churn[1] == ref[1]
            assert churn[0] == ref[0]
            assert churn[2]
            return ref, churn
        same(run)

    def test_capture_of_demoted_doc_is_stored_bundle(self):
        def run(P):
            mesh, res = build_mesh(P, budget=0)
            mesh.deliver_round({"d": doc_stream("d", 3)})
            live = mesh.capture("d")
            assert res.demote("d")
            assert mesh.capture("d") == live
            assert res.tier_of("d") == "warm"
            return live, res_state(P, mesh, res, ["d"])
        same(run)

    def test_demote_refuses_queued_and_migrating_docs(self):
        def run(P):
            mesh, res = build_mesh(P, budget=0)
            mesh.deliver_round({"d": doc_stream("d", 1)})
            mesh._migrating["d"] = []
            assert res.demote("d") is False
            del mesh._migrating["d"]
            lane = mesh.lane_of("q")
            lane.ensure_doc("q").apply_changes([doc_stream("q", 2)[1]])
            assert res.demote("q") is False
            assert res.demote("d") is True
            return res_state(P, mesh, res, ["d", "q"])
        same(run)


# ---------------------------------------------------------------------------
# demand paging + admission-aware prefetch
# ---------------------------------------------------------------------------


class TestPaging:
    def test_premature_change_prefetches_demoted_doc(self):
        def run(P):
            mesh, res = build_mesh(P, budget=0)
            chs = doc_stream("d", 3)
            mesh.deliver_round({"d": [chs[0]]})
            assert res.demote("d")
            mesh.deliver_round({"d": [chs[2]]})
            assert res.tier_of("d") == "hot"
            assert res.stats["prefetches"] == 1
            assert mesh.quarantined("d") == 1
            mid = res_state(P, mesh, res, ["d"])
            mesh.deliver_round({"d": [chs[1]]})
            assert mesh.quarantined("d") == 0
            lane = mesh.lane_of("d")
            with lane.device_ctx():
                assert lane.docs["d"].text() == "xxx"
            return mid, res_state(P, mesh, res, ["d"])
        same(run)

    def test_prefetch_off_defers_page_in_to_release(self):
        def run(P):
            mesh, res = build_mesh(P, budget=0, prefetch=False)
            chs = doc_stream("d", 3)
            mesh.deliver_round({"d": [chs[0]]})
            assert res.demote("d")
            mesh.deliver_round({"d": [chs[2]]})
            assert res.tier_of("d") == "warm"
            mid = res_state(P, mesh, res, ["d"])
            mesh.deliver_round({"d": [chs[1]]})
            assert res.tier_of("d") == "hot"
            lane = mesh.lane_of("d")
            with lane.device_ctx():
                assert lane.docs["d"].text() == "xxx"
            return mid, res_state(P, mesh, res, ["d"])
        same(run)

    def test_page_in_places_on_lightest_lane(self):
        def run(P):
            mesh, res = build_mesh(P, n_shards=2, budget=0)
            for i in range(6):
                mesh.deliver_round({f"doc{i}": doc_stream(f"doc{i}", 1)})
            target = "doc0"
            assert res.demote(target)
            home = mesh.placement.shard_of(target)
            bytes_before = [lane.device_footprint()["device_bytes"]
                            for lane in mesh.lanes]
            lane = res.page_in(target)
            assert lane is not None
            expect = min(range(2), key=lambda i: (bytes_before[i], i))
            assert lane.index == expect
            assert mesh.placement.shard_of(target) == expect
            if expect != home:
                assert res.stats["placement_moves"] >= 1
            return bytes_before, lane.index, res_state(
                P, mesh, res, [f"doc{i}" for i in range(6)])
        same(run)

    def test_mesh_texts_after_heavy_churn_converge(self, tmp_path):
        def run(P):
            mesh, res = build_mesh(P, n_shards=2, budget=0, cold_after=1,
                                   spill_dir=_spill(tmp_path, P))
            seqs = {}
            for rnd in range(10):
                doc = f"doc{rnd % 3}"
                seqs[doc] = seqs.get(doc, 0) + 1
                a = f"a-{doc}"
                mesh.deliver_round({doc: [text_change(
                    a, seqs[doc], "y", start_ctr=seqs[doc], obj=doc,
                    after=(None if seqs[doc] == 1
                           else f"{a}:{seqs[doc]-1}"))]})
                for d in list(seqs):
                    if d != doc:
                        res.demote(d)
                res.tick()
            mid = res_state(P, mesh, res, list(seqs))
            for d in seqs:
                res.ensure_resident(d)
            assert mesh.texts() == {d: "y" * n for d, n in seqs.items()}
            return mid, res_state(P, mesh, res, list(seqs))
        same(run)

    def test_premature_change_for_stored_doc_parks_without_page_in(self):
        """Stored-clock routing: a premature change for a demoted doc
        with prefetch off parks at the router and leaves the doc stored;
        the missing seq drains it and pages it in."""
        def run(P):
            mesh, res = build_mesh(P, budget=0, prefetch=False)
            chs = doc_stream("s", 4)
            mesh.deliver_round({"s": chs[:2]})
            assert res.demote("s")
            mesh.deliver_round({"s": [chs[3]]})
            assert mesh.quarantined("s") == 1
            assert res.tier_of("s") == "warm"
            mesh.deliver_round({"s": [chs[2]]})
            assert mesh.quarantined("s") == 0
            assert res.tier_of("s") == "hot"
            return mesh.texts(), res_state(P, mesh, res, ["s"])
        same(run)


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


class TestObservability:
    def test_restore_staging_meters_exact_h2d_bytes(self):
        def run(P):
            mesh, res = build_mesh(P, budget=0)
            mesh.deliver_round({"d": doc_stream("d", 4)})
            assert res.demote("d")
            before = P.acct.snapshot()["h2d_bytes"]
            res.ensure_resident("d")
            staged = P.acct.snapshot()["h2d_bytes"] - before
            doc = mesh.lane_of("d").docs["d"]
            table_bytes = doc.device_footprint()["table_bytes"]
            assert staged >= table_bytes > 0
            assert res.demote("d")
            before = P.acct.snapshot()["h2d_bytes"]
            res.ensure_resident("d")
            assert P.acct.snapshot()["h2d_bytes"] - before == staged
            return staged, table_bytes
        same(run)

    def test_page_in_lineage_hops_and_paired_dwell(self):
        def run(P):
            lin = P.lineage
            lin.enable(rate=1)
            try:
                mesh, res = build_mesh(P, budget=0)
                chs = doc_stream("d", 2)
                mesh.deliver_round({"d": [chs[0]]})
                assert res.demote("d")
                mesh.deliver_round({"d": [chs[1]]})
                led = lin.ledger()
                chain = led.chain("a-d", 2)
                assert chain is not None
                stages = [h[0] for h in chain["hops"]]
                wait_i = stages.index("res/page_wait")
                in_i = stages.index("res/page_in")
                assert wait_i < in_i
                assert chain["hops"][wait_i][1] == chain["hops"][in_i][1]
                assert lin.LineageLedger.PAIRED_DWELL[
                    "res/page_in"] == "res/page_wait"
                agg = led.telemetry.span_aggregates()
                assert agg[("lineage", "dwell:res/page_wait")]["count"] >= 1
                return [(h[0], h[1]) for h in chain["hops"]]
            finally:
                lin.disable()
                lin.clear()
        same(run)

    def test_prom_families_expose_clean(self, tmp_path):
        def run(P):
            mesh, res = build_mesh(P, n_shards=2, budget=0, cold_after=1,
                                   spill_dir=_spill(tmp_path, P))
            mesh.deliver_round({"d": doc_stream("d", 2)})
            res.demote("d")
            res.tick()
            res.ensure_resident("d")
            fams = res.families()
            page = P.prom.expose(fams)
            P.prom.validate_prom(page)
            for needle in ("amtpu_residency_docs", "amtpu_residency_bytes",
                           "amtpu_residency_budget_bytes",
                           "amtpu_residency_peak_resident_bytes",
                           "amtpu_residency_hit_rate",
                           "amtpu_residency_page_in_p99_ms",
                           "amtpu_residency_events_total"):
                assert needle in page, needle
            return [f for f in fams
                    if f[0] != "amtpu_residency_page_in_p99_ms"]
        same(run)

    def test_describe_rides_mesh_snapshot(self):
        def run(P):
            mesh, res = build_mesh(P, budget=0)
            mesh.deliver_round({"d": doc_stream("d", 1)})
            d = mesh.describe()["residency"]
            assert d["schema"] == "amtpu-residency-v1"
            assert d["tier_counts"]["hot"] == 1
            assert d["model"]["kind"] == "learned"
            d.pop("page_in_p99_ms")
            return d
        same(run)


# ---------------------------------------------------------------------------
# per-doc bytes, and cfg18's schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["text", "map"])
@pytest.mark.parametrize("capacity", [256, 2048])
def test_per_doc_bytes_equal_the_jax_package(kind, capacity):
    """A doc's ``device_bytes`` after a stacked lane round, a per-object
    lane round, a restore and a round after the restore is the JAX
    package's dtype x shape count, and the residency probe's fresh-doc
    reservation is the largest of them (it never under-reserves)."""
    from test_shard import map_change

    def chs(d, seq=1):
        if kind == "text":
            return [text_change("w", seq, "xy" if seq == 1 else "z",
                                start_ctr=1 if seq == 1 else 3,
                                after=None if seq == 1 else "w:2", obj=d)]
        return [map_change("w", seq, d, [("k", seq)])]

    def run(P):
        lane = lambda i: P.shard.ShardLane(  # noqa: E731
            i, doc_kind=kind, capacity=capacity,
            **({"device": CPU} if P is T else {}))
        stacked, solo, dst = lane(0), lane(1), lane(2)
        stacked.ingest({"a": chs("a"), "b": chs("b")})
        solo.ingest({"s": chs("s")})
        assert stacked.stats["stacked_applies"] == 1
        assert solo.stats["per_object_applies"] == 1
        out = {"stacked": stacked.docs["a"].device_footprint(),
               "per_object": solo.docs["s"].device_footprint()}
        dst.adopt("a", stacked.export("a"))
        out["restored"] = dst.docs["a"].device_footprint()
        dst.ingest({"a": chs("a", 2), "c": chs("c")})
        out["restored+round"] = dst.docs["a"].device_footprint()
        nbytes = {k: v["device_bytes"] for k, v in out.items()}
        if P is T:
            assert all(v["storage_bytes"] == v["table_bytes"]
                       for v in out.values())
        mesh = P.mesh(n_shards=1, doc_kind=kind, capacity=capacity)
        fresh = mesh.attach_residency()._fresh_doc_bytes()
        assert fresh >= max(nbytes["stacked"], nbytes["per_object"])
        return nbytes, fresh
    same(run)


def cfg18_schedule(n_docs, budget_docs, rounds_per_rep, reps,
                   ops_per_doc=8, revisit_lag=10, warmup=1):
    """bench.py measure_residency's schedule: two rotating hot docs, one
    fresh cold-tail doc and the cold doc first touched `revisit_lag`
    rounds ago, every touch one causally-ready text change."""
    n_hot = max(2, budget_docs // 2)
    doc_ids = [f"rz-{i:05d}" for i in range(n_docs)]
    hot_ids, cold_ids = doc_ids[:n_hot], doc_ids[n_hot:]
    run = ops_per_doc // 2
    seqs = {d: 0 for d in doc_ids}
    ctrs = {d: 0 for d in doc_ids}
    rounds = []
    for r in range((warmup + reps) * rounds_per_rep):
        picks = [hot_ids[(r + k) % n_hot] for k in range(2)]
        picks.append(cold_ids[r % len(cold_ids)])
        if r >= revisit_lag:
            picks.append(cold_ids[(r - revisit_lag) % len(cold_ids)])
        chunk = {}
        for d in dict.fromkeys(picks):
            s = seqs[d] = seqs[d] + 1
            base = ctrs[d] + 1
            ops, key = [], ("_head" if s == 1 else f"a:{ctrs[d]}")
            for k in range(run):
                ctr = base + k
                ops.append({"action": "ins", "obj": d, "key": key,
                            "elem": ctr})
                ops.append({"action": "set", "obj": d, "key": f"a:{ctr}",
                            "value": chr(97 + ctr % 26)})
                key = f"a:{ctr}"
            ctrs[d] += run
            chunk[d] = [{"actor": "a", "seq": s, "deps": {}, "ops": ops}]
        rounds.append(chunk)
    return rounds, [d for d in doc_ids if seqs[d]]


@pytest.mark.parametrize("size", ["quick", "full"])
def test_cfg18_schedule_pages_like_the_jax_package(size, tmp_path):
    """cfg18 (bench.py measure_residency) at its quick and its full
    settings: a budget of `budget_docs` docs' bytes, each package's own
    per-doc bytes from its unbounded reference. The tier ledger after
    every round, the paging counters and every capture are equal, and
    the captures equal the unbounded reference's."""
    n_docs, budget_docs, rounds_per_rep, reps = (
        (70, 4, 20, 2) if size == "quick" else (140, 8, 32, 3))
    rounds, touched = cfg18_schedule(n_docs, budget_docs, rounds_per_rep,
                                     reps)

    def run(P):
        ref = P.mesh(n_shards=2, capacity=1024)
        for chunk in rounds:
            ref.deliver_round(chunk)
        ref_caps = {d: ref.capture(d) for d in touched}
        per_doc = max(doc.device_footprint()["device_bytes"]
                      for lane in ref.lanes for doc in lane.docs.values())
        budget = budget_docs * per_doc
        assert len(touched) * per_doc >= 10 * budget
        P.dt.REGISTRY.clear_session()
        mesh = P.mesh(n_shards=2, capacity=1024)
        res = mesh.attach_residency(budget_bytes=budget,
                                    spill_dir=_spill(tmp_path, P),
                                    cold_after=6)
        trail = []
        for chunk in rounds:
            mesh.deliver_round(chunk)
            acct = res.accounting()
            trail.append((len(acct["hot"]), len(acct["warm"]),
                          len(acct["cold"]), acct["resident_bytes"]))
            assert P.dt.REGISTRY.footprint()["peak_device_bytes"] <= budget
        m = res.metrics()
        assert m["budget_overruns"] == 0
        assert m["page_ins"] and m["page_outs"]
        assert m["cold_ages"] and m["cold_loads"]
        for d in touched:
            assert mesh.capture(d) == ref_caps[d]
        return (per_doc, trail, res_state(P, mesh, res, touched),
                ref_caps)
    same(run)
