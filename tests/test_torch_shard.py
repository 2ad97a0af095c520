"""The port's sharded serving tier (automerge_tpu_torch/shard/) against
the JAX package's, on the CPU.

Every scenario runs twice: once through the JAX package's
`ShardedDocSet` / `ShardLane` on its 8 virtual CPU devices (tests/
conftest.py), once through the port's with ``devices=[cpu]`` /
``device="cpu"``. Tolerance is zero: checkpoint-bundle bytes
(`capture`), texts, map values, placement (`hash_shard`, `spread`, the
override table and its epoch), `quarantined` counts, the set's and
every lane's `stats` (the stacked / per-object split, `admitted_ops`,
migrations) and the rebalancer's stats must be equal, and each run must
pass the JAX test's own assertions.

- Twins of tests/test_shard.py's placement, lane, shard-count
  invariance (1, 2 and 8 lanes against the JAX package's 8, over
  seeds, and with forced migrations mid-stream), migration (the
  quarantine handshake, the pen and its replay, deferral on an unready
  engine queue, a failed adopt restoring the source, table-entry moves
  of unmaterialized docs) and telemetry-triggered rebalance tests.
- The twin of tests/test_lineage.py's router quarantine and lane commit
  hops: `quar/park` -> `quar/release` -> `commit@lane0`.
- No fallback: without a card `ShardedDocSet()` and `ShardLane(i)` raise.
- On the card (marked `cuda`): an 8-lane mesh on one card, with the
  lane workers and sequentially, holds every capture and text equal to
  the CPU run for 24 rounds, and none of its lanes holds a CPU table.
"""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import automerge_tpu.shard as JSH
import automerge_tpu_torch.shard as TSH
from automerge_tpu.engine import stacked as J_stacked
from automerge_tpu.obs import lineage as J_lineage
from automerge_tpu_torch.engine import stacked as T_stacked
from automerge_tpu_torch.obs import lineage as T_lineage
from test_shard import chaotic_stream, map_change, text_change
from test_torch_soak_docs import threads_checked

CPU = torch.device("cpu")

J = SimpleNamespace(
    name="jax", shard=JSH, stacked=J_stacked, lineage=J_lineage,
    mesh=lambda **kw: _opened(JSH.ShardedDocSet(**kw)),
    lane=lambda i, **kw: JSH.ShardLane(i, **kw))
T = SimpleNamespace(
    name="port", shard=TSH, stacked=T_stacked, lineage=T_lineage,
    mesh=lambda **kw: _opened(TSH.ShardedDocSet(devices=[CPU], **kw)),
    lane=lambda i, **kw: TSH.ShardLane(i, device=CPU, **kw))


def same(run):
    """Run `run(P)` through both packages; the results must be equal."""
    want = run(J)
    got = run(T)
    assert got == want
    return got


@pytest.fixture(autouse=True)
def _small_gate(monkeypatch):
    """Engage the stacked path at test scale on both packages."""
    monkeypatch.setenv("AMTPU_STACKED_MIN_OPS", "1")


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


def mesh_state(mesh, docs) -> dict:
    """Everything the contract compares of one mesh."""
    return {"captures": {d: mesh.capture(d) for d in docs},
            "texts": mesh.texts(),
            "quarantined": {d: mesh.quarantined(d) for d in docs},
            "stats": dict(mesh.stats),
            "lanes": [dict(lane.stats) for lane in mesh.lanes],
            "placement": (mesh.placement.epoch, mesh.placement.table())}


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


class TestPlacement:
    def test_hash_is_process_stable_and_in_range(self):
        def run(P):
            h = P.shard.hash_shard
            assert h("doc-00042", 8) == h("doc-00042", 8)
            for n in (1, 2, 8, 13):
                assert 0 <= h("any-doc", n) < n
            assert h("doc-00042", 8) == int.from_bytes(
                hashlib.sha1(b"doc-00042").digest()[:8], "big") % 8
            return [h(f"doc-{i:05d}", n) for i in range(500)
                    for n in (1, 2, 3, 8, 13)]
        same(run)

    def test_hash_spreads_a_population(self):
        def run(P):
            table = P.shard.PlacementTable(8)
            spread = table.spread(f"doc-{i:04d}" for i in range(800))
            assert sum(spread) == 800
            assert all(c > 0 for c in spread)
            assert max(spread) < 3 * min(spread)
            return spread
        same(run)

    def test_overrides_move_epoch_and_drop(self):
        def run(P):
            table = P.shard.PlacementTable(4)
            doc = "mover"
            home = table.shard_of(doc)
            away = (home + 1) % 4
            trail = [(table.epoch, table.table())]
            table.move(doc, away)
            assert table.shard_of(doc) == away
            trail.append((table.epoch, table.table()))
            table.move(doc, home)
            assert table.table() == {} and table.epoch == 2
            trail.append((table.epoch, table.table()))
            with pytest.raises(ValueError):
                table.move(doc, 4)
            with pytest.raises(ValueError):
                P.shard.PlacementTable(0)
            with pytest.raises(ValueError):
                P.shard.PlacementTable(2, overrides={"x": 5})
            return home, trail
        same(run)


# ---------------------------------------------------------------------------
# the lane
# ---------------------------------------------------------------------------


class TestLane:
    def test_map_lane_ingest_is_one_stacked_apply(self):
        def run(P):
            lane = P.lane(0, doc_kind="map")
            deliveries = {f"m{i}": [map_change(
                "a", 1, f"m{i}", [(f"k{j}", i * 10 + j) for j in range(4)])]
                for i in range(6)}
            n = lane.ingest(deliveries)
            assert n == 24
            assert lane.stats["stacked_applies"] == 1
            assert lane.stats["per_object_applies"] == 0
            assert lane.docs["m3"].to_dict()["k2"] == 32
            return (dict(lane.stats),
                    {d: doc.to_dict() for d, doc in lane.docs.items()})
        same(run)

    def test_text_lane_seeds_positions_from_the_packed_fetch(self):
        def run(P):
            lane = P.lane(0)
            lane.ingest({f"t{i}": [text_change("a", 1, f"hello-{i}",
                                               obj=f"t{i}")]
                         for i in range(4)})
            s = P.stacked.LAST_STATS
            assert s["text_docs"] == 4
            assert s["pos_seeded"] == s["text_finalized"] == 4
            out = {}
            for i in range(4):
                doc = lane.docs[f"t{i}"]
                assert doc._pos_cache is not None
                assert len(doc._pos_cache) == doc.n_elems + 1
                assert doc.text() == f"hello-{i}"
                out[f"t{i}"] = (np.asarray(doc._pos_cache).tolist(),
                                doc.text())
            return out, dict(lane.stats), {
                k: s[k] for k in ("text_docs", "pos_seeded",
                                  "text_finalized", "passes")}
        same(run)

    def test_single_doc_round_falls_back_per_object(self):
        def run(P):
            lane = P.lane(0)
            lane.ingest({"solo": [text_change("a", 1, "only", obj="solo")]})
            assert lane.stats["per_object_applies"] == 1
            assert lane.stats["stacked_applies"] == 0
            assert lane.docs["solo"].text() == "only"
            return dict(lane.stats)
        same(run)

    def test_hottest_doc_tracks_lifetime_ops(self):
        def run(P):
            lane = P.lane(0, doc_kind="map")
            assert lane.hottest_doc() is None
            lane.ingest({"cold": [map_change("a", 1, "cold", [("k", 1)])],
                         "hot": [map_change("a", 1, "hot",
                                            [(f"k{j}", j)
                                             for j in range(8)])]})
            doc_id, ops = lane.hottest_doc()
            assert doc_id == "hot" and ops == 8
            return lane.hottest_doc(), dict(lane.doc_ops)
        same(run)

    def test_export_adopt_round_trip_between_lanes(self):
        """A doc exported from one lane and adopted by another captures
        to the same bytes, and the lane counters record the move."""
        def run(P):
            a, b = P.lane(0), P.lane(1)
            a.ingest({"mv": [text_change("w", 1, "move me", obj="mv")]})
            bundle = a.export("mv")
            assert "mv" not in a.docs
            b.adopt("mv", bundle)
            assert b.docs["mv"].text() == "move me"
            b.ingest({"mv": [text_change("w", 2, "!", start_ctr=8,
                                         after="w:7", obj="mv")]})
            return (bundle, b.texts(), dict(a.stats), dict(b.stats),
                    a.device_footprint()["n_docs"],
                    b.device_footprint()["n_docs"])
        same(run)

    def test_lane_ring_streams_under_the_lane_context(self):
        """The lane's pipelined ring over a hot doc commits every fed
        batch and leaves the same text as a plain lane ingest."""
        from automerge_tpu_torch.engine.columnar import TextChangeBatch
        lane = T.lane(0)
        chs = [text_change("w", s, "ab", start_ctr=2 * s - 1,
                           after=None if s == 1 else f"w:{2 * s - 2}",
                           obj="hot") for s in range(1, 5)]
        with lane.device_ctx():
            with lane.ring("hot", slots=2) as ring:
                for ch in chs:
                    ring.feed(TextChangeBatch.from_changes([ch], "hot"))
            assert ring.stats["committed"] == 4
        plain = T.lane(1)
        plain.ingest({"hot": chs})
        assert lane.texts() == plain.texts() == {"hot": "ab" * 4}


# ---------------------------------------------------------------------------
# shard-count invariance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shard_count_invariance(seed):
    """The port on 1, 2 and 8 lanes lands byte-identical with the JAX
    package's 8-shard run of the same seeded chaotic session: bundle
    bytes, texts, quarantine counts and (per shard count) stats."""
    def run(P, n_shards):
        docs, rounds = chaotic_stream(seed)
        mesh = P.mesh(n_shards=n_shards, capacity=64)
        for chunk in rounds:
            mesh.deliver_round(chunk)
        for doc in docs:
            assert mesh.quarantined(doc) == 0
        out = mesh_state(mesh, docs)
        mesh.close()
        return out

    want = run(J, 8)
    got = {n: run(T, n) for n in (1, 2, 8)}
    assert got[8] == want
    for n in (1, 2):
        assert got[n]["captures"] == want["captures"]
        assert got[n]["texts"] == want["texts"]
        assert got[n]["quarantined"] == want["quarantined"]
    assert same(lambda P: run(P, 2)) == got[2]


def test_invariance_with_forced_migration_mid_stream(seed=7):
    def run(P):
        docs, rounds = chaotic_stream(seed, n_chunks=4)
        ref = P.mesh(n_shards=1, capacity=64)
        for chunk in rounds:
            ref.deliver_round(chunk)
        mesh = P.mesh(n_shards=8, capacity=64)
        moved = 0
        for i, chunk in enumerate(rounds):
            mesh.deliver_round(chunk)
            victim = docs[i % len(docs)]
            if mesh.doc(victim) is not None:
                dst = (mesh.placement.shard_of(victim) + 3) % 8
                moved += mesh.migrate(victim, dst)
        assert moved >= 2, "migrations never engaged"
        assert mesh.texts() == ref.texts()
        for doc in docs:
            assert mesh.quarantined(doc) == 0
            assert mesh.capture(doc) == ref.capture(doc)
        out = (moved, mesh_state(mesh, docs))
        mesh.close()
        ref.close()
        return out
    same(run)


# ---------------------------------------------------------------------------
# migration: the quarantine handshake
# ---------------------------------------------------------------------------


class TestMigration:
    def test_migration_under_premature_quarantine(self, monkeypatch):
        # the JAX package's 4 lanes on 4 devices default to the lane
        # workers, whose counters describe() carries; the port's 4 lanes
        # on one device are asked for them
        monkeypatch.setenv("AMTPU_PARALLEL_LANES", "1")

        def run(P):
            mesh = P.mesh(n_shards=4, capacity=64)
            doc = "handshake"
            ch1 = text_change("w0", 1, "ab", obj=doc)
            ch2 = text_change("w0", 2, "cd", start_ctr=3, after="w0:2",
                              obj=doc)
            mesh.deliver(doc, [ch1])
            ch3 = text_change("w0", 3, "ef", start_ctr=5, after="w0:4",
                              obj=doc)
            mesh.deliver(doc, [ch3])
            assert mesh.quarantined(doc) == 1
            src = mesh.placement.shard_of(doc)
            dst = (src + 1) % 4
            assert mesh.migrate(doc, dst)
            assert mesh.placement.shard_of(doc) == dst
            assert mesh.lanes[src].docs.get(doc) is None
            assert mesh.quarantined(doc) == 1
            mid = mesh.describe()
            mesh.deliver(doc, [ch2])
            assert mesh.quarantined(doc) == 0
            assert mesh.texts()[doc] == "abcdef"
            assert mesh.stats["migrations"] == 1
            mid.pop("devices")
            for lane in mid["lanes"]:
                lane.pop("device")
            return mid, mesh_state(mesh, [doc])
        same(run)

    def test_deliveries_during_the_move_pen_and_replay(self):
        def run(P):
            mesh = P.mesh(n_shards=2, capacity=64)
            doc = "pen"
            mesh.deliver(doc, [text_change("w0", 1, "xy", obj=doc)])
            ready = text_change("w0", 2, "zz", start_ctr=3, after="w0:2",
                                obj=doc)
            premature = text_change("w0", 4, "!!", start_ctr=7,
                                    after="w0:6", obj=doc)

            def mid_move():
                mesh.deliver_round({doc: [ready]})
                mesh.deliver_round({doc: [premature]})

            src = mesh.placement.shard_of(doc)
            assert mesh.migrate(doc, 1 - src, _mid_migration=mid_move)
            assert mesh.stats["migration_parked"] == 2
            assert mesh.texts()[doc] == "xyzz"
            assert mesh.quarantined(doc) == 1
            mesh.deliver(doc, [text_change("w0", 3, "..", start_ctr=5,
                                           after="w0:4", obj=doc)])
            assert mesh.quarantined(doc) == 0
            assert mesh.texts()[doc] == "xyzz..!!"
            return mesh_state(mesh, [doc])
        same(run)

    def test_migrate_defers_on_causally_unready_engine_queue(self):
        def run(P):
            mesh = P.mesh(n_shards=2, capacity=64)
            doc = "defer"
            lane = mesh.lane_of(doc)
            engine = lane.ensure_doc(doc)
            engine.apply_changes([text_change(
                "w0", 2, "late", start_ctr=9, after="w0:8", obj=doc)])
            assert engine.queue
            src = mesh.placement.shard_of(doc)
            assert mesh.migrate(doc, 1 - src) is False
            assert mesh.stats["migrations_deferred"] == 1
            assert mesh.placement.shard_of(doc) == src
            return dict(mesh.stats), len(engine.queue)
        same(run)

    def test_unmaterialized_doc_moves_as_a_table_entry(self):
        def run(P):
            mesh = P.mesh(n_shards=4, capacity=64)
            assert mesh.migrate("never-seen", 2)
            assert mesh.placement.shard_of("never-seen") == 2
            assert mesh.stats["migrations"] == 0
            with pytest.raises(ValueError):
                mesh.migrate("never-seen", 9)
            return mesh.placement.table(), dict(mesh.stats)
        same(run)

    def test_failed_adopt_restores_the_source_and_replays_the_pen(self):
        def run(P):
            mesh = P.mesh(n_shards=2, capacity=64)
            doc = "atomic"
            mesh.deliver(doc, [text_change("w0", 1, "ab", obj=doc)])
            src = mesh.placement.shard_of(doc)
            dst = 1 - src
            penned = text_change("w0", 2, "cd", start_ctr=3, after="w0:2",
                                 obj=doc)

            def exploding_adopt(doc_id, bundle):
                mesh.deliver_round({doc: [penned]})
                raise RuntimeError("destination device lost")

            mesh.lanes[dst].adopt = exploding_adopt
            with pytest.raises(RuntimeError):
                mesh.migrate(doc, dst)
            assert mesh.placement.shard_of(doc) == src
            assert mesh.lanes[src].docs.get(doc) is not None
            assert mesh.stats["migrations"] == 0
            assert mesh.texts()[doc] == "abcd"
            assert mesh.quarantined(doc) == 0
            return mesh_state(mesh, [doc])
        same(run)

    def test_migrate_to_home_shard_is_a_noop(self):
        def run(P):
            mesh = P.mesh(n_shards=4, capacity=64)
            doc = "homer"
            mesh.deliver(doc, [text_change("w0", 1, "hi", obj=doc)])
            assert mesh.migrate(doc, mesh.placement.shard_of(doc)) is False
            return mesh_state(mesh, [doc])
        same(run)


# ---------------------------------------------------------------------------
# the rebalance policy
# ---------------------------------------------------------------------------


def _hot_pair(P, n_shards=4):
    """(mesh, hot_doc, co_tenant): two docs sharing a lane."""
    mesh = P.mesh(n_shards=n_shards, doc_kind="map", capacity=64)
    by_shard = {}
    i = 0
    while True:
        doc = f"reb-{i}"
        shard = mesh.placement.shard_of(doc)
        if shard in by_shard:
            return mesh, doc, by_shard[shard]
        by_shard[shard] = doc
        i += 1


class TestRebalancer:
    def test_telemetry_triggered_hot_doc_migration(self):
        def run(P):
            mesh, hot, co = _hot_pair(P)
            reb = mesh.attach_rebalancer(ratio=2.0, min_ops=32, cooldown=2)
            mesh.deliver_round({co: [map_change("a", 1, co, [("k", 0)])]})
            home = mesh.placement.shard_of(hot)
            rounds = 0
            for s in range(1, 12):
                mesh.deliver_round({hot: [map_change(
                    "a", s, hot, [(f"k{j}", s) for j in range(16)])]})
                rounds += 1
                if reb.stats["migrations"]:
                    break
            assert reb.stats["migrations"] == 1, \
                (reb.stats, reb.window_loads())
            assert mesh.placement.shard_of(hot) != home
            assert mesh.placement.table()
            assert mesh.stats["migrations"] == 1
            assert reb._cooling > 0
            return (hot, co, rounds, dict(reb.stats), reb.window_loads(),
                    mesh.placement.table(), dict(mesh.stats),
                    mesh.doc(hot).to_dict())
        same(run)

    def test_idle_mesh_never_migrates_on_noise(self):
        def run(P):
            mesh, hot, co = _hot_pair(P)
            reb = mesh.attach_rebalancer(ratio=2.0, min_ops=10_000,
                                         cooldown=0)
            for s in range(1, 6):
                mesh.deliver_round({hot: [map_change("a", s, hot,
                                                     [("k", s)])]})
            assert reb.stats["migrations"] == 0
            return dict(reb.stats), reb.window_loads()
        same(run)

    def test_single_resident_doc_is_never_relabeled(self):
        def run(P):
            mesh = P.mesh(n_shards=2, doc_kind="map", capacity=64)
            reb = mesh.attach_rebalancer(ratio=1.5, min_ops=8, cooldown=0)
            doc = "lonely"
            for s in range(1, 8):
                mesh.deliver_round({doc: [map_change(
                    "a", s, doc, [(f"k{j}", s) for j in range(8)])]})
            assert reb.stats["migrations"] == 0
            return dict(reb.stats), reb.window_loads()
        same(run)


# ---------------------------------------------------------------------------
# router lineage hops (twin of tests/test_lineage.py's router test)
# ---------------------------------------------------------------------------


def test_router_quarantine_and_lane_commit_hops():
    def run(P):
        lin = P.lineage
        led = lin.enable(rate=1, capacity=256)
        led.clear()
        try:
            sds = P.mesh(n_shards=1, assert_budget=False)
            late = {"actor": "y", "seq": 1, "deps": {"x": 1},
                    "ops": [{"action": "ins", "obj": "d", "key": "_head",
                             "elem": 1}]}
            dep = {"actor": "x", "seq": 1, "deps": {},
                   "ops": [{"action": "ins", "obj": "d", "key": "_head",
                            "elem": 1}]}
            led.record("y", 1, "origin", site="y")
            led.record("x", 1, "origin", site="x")
            sds.deliver("d", [late])
            assert sds.quarantined("d") == 1
            c = led.chain("y", 1)
            assert ("quar/park", "router") in {(h[0], h[1])
                                               for h in c["hops"]}
            sds.deliver("d", [dep])
            assert sds.quarantined("d") == 0
            stages = [(h[0], h[1]) for h in led.chain("y", 1)["hops"]]
            assert ("quar/release", "router") in stages
            assert ("commit", "lane0") in stages
            assert led.visible_sites(led.chain("x", 1)) == {"lane0"}
            return (stages,
                    [(h[0], h[1]) for h in led.chain("x", 1)["hops"]],
                    sorted(led.visible_sites(led.chain("y", 1))))
        finally:
            lin.disable()
            lin.clear()
    same(run)


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------


def test_no_card_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default binds it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSH.ShardedDocSet()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSH.ShardedDocSet(n_shards=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSH.ShardLane(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSH.ShardLane(0, device=None)


def test_cpu_lanes_have_no_stream_and_a_null_context():
    mesh = T.mesh(n_shards=3, capacity=64)
    assert [lane.device for lane in mesh.lanes] == [CPU] * 3
    assert all(lane.stream is None for lane in mesh.lanes)
    with mesh.lanes[0].device_ctx():
        pass
    assert mesh.describe()["devices"] == ["cpu"] * 3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_stream(n_docs=48, n_rounds=24, seed=5):
    """A chaotic multi-doc text session: per-doc two-actor chains,
    shuffled across docs (premature arrivals park at the router)."""
    rng = np.random.default_rng(seed)
    docs = [f"card-{i:03d}" for i in range(n_docs)]
    flat = []
    for di, doc in enumerate(docs):
        for s in range(1, n_rounds // 4 + 2):
            for a in range(2):
                base = (s - 1) * 3 + 1
                flat.append((doc, text_change(
                    f"w{a}", s, chr(97 + (s + a + di) % 26) * 3,
                    start_ctr=base, obj=doc,
                    after=None if s == 1 else f"w{a}:{base - 1}",
                    deps={} if s == 1 else {f"w{1 - a}": s - 1})))
    rng.shuffle(flat)
    per = -(-len(flat) // n_rounds)
    rounds = []
    for c in range(0, len(flat), per):
        chunk = {}
        for doc, ch in flat[c: c + per]:
            chunk.setdefault(doc, []).append(ch)
        rounds.append(chunk)
    return docs, rounds


def _card_run(devices, flag, monkeypatch, docs, rounds):
    monkeypatch.setenv("AMTPU_PARALLEL_LANES", flag)
    mesh = TSH.ShardedDocSet(n_shards=8, capacity=256, devices=devices)
    try:
        for chunk in rounds:
            mesh.deliver_round(chunk)
        for lane in mesh.lanes:
            for doc in lane.docs.values():
                assert all(t.device.type == lane.device.type
                           for t in doc._dev.values())
        out = mesh_state(mesh, docs)
        ex = mesh._executor
        parallel = ex is not None and ex.stats["barriers"] > 0
    finally:
        mesh.close()
    return out, parallel


@pytest.mark.cuda
def test_lane_streams_parallel_and_sequential_equal_the_cpu(cuda_device,
                                                          monkeypatch):
    """Stream ordering across the lane boundary: 8 lanes, 8 streams of
    one card, 24 rounds with the workers on and off, every capture and
    text equal to the CPU mesh's."""
    docs, rounds = _card_stream()
    assert len(rounds) >= 20
    cpu, _ = _card_run([CPU], "0", monkeypatch, docs, rounds)
    par, engaged = _card_run([cuda_device], "1", monkeypatch, docs, rounds)
    seq, _ = _card_run([cuda_device], "0", monkeypatch, docs, rounds)
    assert engaged
    assert par == seq == cpu


@pytest.mark.cuda
def test_cuda_lanes_are_distinct_streams_of_one_card(cuda_device):
    mesh = TSH.ShardedDocSet(n_shards=8, capacity=64)
    streams = {lane.stream.cuda_stream for lane in mesh.lanes}
    assert len(streams) == 8
    assert {lane.device for lane in mesh.lanes} == {
        torch.device("cuda", i) for i in range(torch.cuda.device_count())}
    with mesh.lanes[3].device_ctx():
        assert torch.cuda.current_stream() == mesh.lanes[3].stream
    assert torch.cuda.current_stream() != mesh.lanes[3].stream
