"""The port's mesh tier (automerge_tpu_torch/parallel, the sharded segment
scans of ops/scan_kernels.py, DeviceTextDocSet(mesh=), shard/audit.py)
against the JAX package on its 8-device virtual CPU mesh
(tests/conftest.py).

The port's mesh here is eight virtual shards of the CPU
(`make_mesh(..., devices=[cpu] * 8)`): the same code a grid of cards
runs, through the plain versions of the kernels. Inputs are made by numpy
from a seed and go through both packages; integer outputs are held bit
for bit (tolerance zero), texts exactly, and every sharded output lives
on as many shards as the mesh has. The CUDA kernel pair is held against
its plain version on a card (marked `cuda`; it skips without one)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from automerge_tpu.engine import DeviceTextDoc as JDoc
from automerge_tpu.engine import DeviceTextDocSet as JSet
from automerge_tpu.engine import TextChangeBatch as JBatch
from automerge_tpu.ops import scan_pallas as P
from automerge_tpu.parallel import mesh as JM
from automerge_tpu_torch.engine import DeviceTextDoc as TDoc
from automerge_tpu_torch.engine import DeviceTextDocSet as TSet
from automerge_tpu_torch.engine import TextChangeBatch as TBatch
from automerge_tpu_torch.ops import ingest as TI
from automerge_tpu_torch.ops import scan_kernels as S
from automerge_tpu_torch.parallel import _dryrun
from automerge_tpu_torch.parallel import mesh as TM
from automerge_tpu_torch.shard import audit as TA

from test_doc_set_engine import typing_change
from test_parallel import reference_order, typing_run

CPU = torch.device("cpu")
KEYS = ("parent", "ctr", "actor", "value", "has_value", "win_actor",
        "win_seq", "win_counter", "chain")


def cpu_mesh(n=8, doc_axis=None):
    return TM.make_mesh(n, doc_axis, devices=[CPU] * n)


def jax_mesh(n=None, doc_axis=None):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh of conftest.py")
    return JM.make_mesh(n, doc_axis)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _columns(shape, seed, p_chain=0.7, p_has=0.8):
    rng = np.random.default_rng(seed)
    chain = rng.random(shape) < p_chain
    chain[..., 0] = False
    return chain, rng.random(shape) < p_has


def _gathered(triple):
    return [np.asarray(x) for x in triple]


# ------------------------------------------------------ sharded_fused_scans

@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_scans_match_jax(seed, n_shards):
    """Twin of test_scan_pallas.py::test_sharded_carries_match_unsharded:
    the per-shard scans + one all_gather carry exchange over the elem
    axis, against the JAX package's (Pallas in interpret mode), at 2, 4
    and 8 shards."""
    rng = np.random.default_rng(seed)
    C = P.TILE * n_shards            # one tile per shard
    n_elems = int(rng.integers(C // 2, C - 1))
    chain, has = _columns(C, seed + 100)
    want = P.sharded_fused_scans(jax_mesh(n_shards, doc_axis=1),
                                 jnp.asarray(chain), jnp.asarray(has),
                                 n_elems, interpret=True)
    mesh = cpu_mesh(n_shards, doc_axis=1)
    got = S.sharded_fused_scans(mesh, torch.from_numpy(chain),
                                torch.from_numpy(has), n_elems)
    for g, w in zip(got, want):
        assert g.n_shards == n_shards == len(w.sharding.device_set)
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    plain = S.sharded_fused_scans_plain(torch.from_numpy(chain),
                                        torch.from_numpy(has), n_elems,
                                        n_shards)
    for p, w in zip(plain, want):
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(3))
def test_sharded_scans_ragged_shard(seed):
    """A shard that is not a whole number of the 8,192-slot tile (the JAX
    kernel pads each shard internally), n_elems past the last shard's
    start, and a device-scalar count."""
    C = 8 * 1000 + 8 * 3
    rng = np.random.default_rng(seed)
    n_elems = int(rng.integers(7 * C // 8, C))
    chain, has = _columns(C, seed)
    want = P.sharded_fused_scans(jax_mesh(8, doc_axis=1), jnp.asarray(chain),
                                 jnp.asarray(has), n_elems, interpret=True)
    got = S.sharded_fused_scans(cpu_mesh(8, doc_axis=1),
                                torch.from_numpy(chain),
                                torch.from_numpy(has),
                                torch.tensor(n_elems, dtype=torch.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("seed", range(3))
def test_sharded_scans_row_form(seed):
    """The row form over (doc, elem) blocks of a (2, 4) mesh, one count
    per row: equal to the unsharded row-form scans, and a random row
    equal to the JAX package's sharded scan of that row over 4 elem
    shards (its rows of count 0 and C too, for seed 0)."""
    D, C = 4, 4 * 1000
    rng = np.random.default_rng(seed)
    chain, has = _columns((D, C), seed + 7)
    n = rng.integers(0, C + 1, D).astype(np.int32)
    n[0], n[-1] = 0, C
    got = _gathered(S.sharded_fused_scans(
        cpu_mesh(8), torch.from_numpy(chain), torch.from_numpy(has),
        torch.from_numpy(n)))
    whole = S.fused_segment_scans_plain(torch.from_numpy(chain),
                                        torch.from_numpy(has),
                                        torch.from_numpy(n))
    for g, w in zip(got, whole):
        np.testing.assert_array_equal(g, w.numpy())
    jmesh = jax_mesh(4, doc_axis=1)
    for d in (range(D) if seed == 0 else [1]):
        want = P.sharded_fused_scans(jmesh, jnp.asarray(chain[d]),
                                     jnp.asarray(has[d]), int(n[d]),
                                     interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[d], np.asarray(w))


@pytest.mark.parametrize("D,C", [(4, 384), (1000, 768)])
def test_sharded_scans_rows_over_a_2x4_mesh(D, C):
    """The mesh path's row shapes over a (2, 4) mesh (per-shard (D / 2,
    C / 4): the dry run's (2, 96) and the mesh DocSet's (500, 192)), random
    per-row counts with a row of 0 and a full row: every row equal to the
    unsharded scans, and rows equal to the JAX package's sharded scan of
    that row over 4 elem shards (every row of (4, 384); three of
    (1000, 768), the empty and the full one among them)."""
    rng = np.random.default_rng(D + C)
    chain, has = _columns((D, C), D)
    n = rng.integers(0, C + 1, D).astype(np.int32)
    n[0], n[-1] = 0, C
    mesh = cpu_mesh(8)
    assert dict(mesh.shape) == {"doc": 2, "elem": 4}
    got = S.sharded_fused_scans(mesh, torch.from_numpy(chain),
                                torch.from_numpy(has), torch.from_numpy(n))
    assert all(g.n_shards == 8 for g in got)
    got = _gathered(got)
    whole = S.fused_segment_scans_plain(torch.from_numpy(chain),
                                        torch.from_numpy(has),
                                        torch.from_numpy(n))
    for g, w in zip(got, whole):
        np.testing.assert_array_equal(g, w.numpy())
    jmesh = jax_mesh(4, doc_axis=1)
    for d in (range(D) if D <= 4 else (0, int(rng.integers(1, D - 1)),
                                        D - 1)):
        want = P.sharded_fused_scans(jmesh, jnp.asarray(chain[d]),
                                     jnp.asarray(has[d]), int(n[d]),
                                     interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[d], np.asarray(w))


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_fs_totals_and_carry_plain(n_shards):
    """The pair's plain versions: a shard's totals are its scans' last
    values, and the carry-in scan of every shard rebuilds the unsharded
    scans."""
    C, ne = 8 * 999, 7000
    chain, has = (torch.from_numpy(a) for a in _columns(C, 3))
    want = S.fused_segment_scans_plain(chain, has, ne)
    w = C // n_shards
    tot = torch.stack([S.fs_totals(chain[i * w:(i + 1) * w],
                                   has[i * w:(i + 1) * w], ne, i * w)
                       for i in range(n_shards)])
    for i in range(n_shards):
        sl = slice(i * w, (i + 1) * w)
        loc = S.fused_segment_scans_plain(chain[sl], has[sl], ne, i * w)
        assert tot[i].tolist() == [int(loc[0][-1]), int(loc[1][-1]),
                                   int(loc[2][-1])]
        got = S.fused_segment_scans_carry(chain[sl], has[sl], ne, i * w, tot,
                                          i)
        for g, x in zip(got, want):
            assert torch.equal(g, x[sl])


# ------------------------------------------------- test_parallel.py twins

def test_batched_merge_matches_shadow_model():
    tables = JM.example_doc_tables(6, 32, seed=1)
    pos, out, n_vis = TM.batched_merge_step(*tables, device="cpu")
    jpos, jout, jn = JM.batched_merge_step(*[np.asarray(t) for t in tables])
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n_vis.numpy(), np.asarray(jn))
    for d in range(6):
        expected = reference_order(*[t[d] for t in tables])
        assert [v for v in out[d].tolist() if v >= 0] == expected
        assert int(n_vis[d]) == len(expected)
    one = TM.merge_step(*[t[2] for t in tables], device="cpu")
    for a, b in zip(one, (pos[2], out[2], n_vis[2])):
        assert torch.equal(a, b)


def test_example_doc_tables_match_jax():
    for a, b in zip(TM.example_doc_tables(3, 40, seed=5),
                    JM.example_doc_tables(3, 40, seed=5)):
        np.testing.assert_array_equal(a, b)


def test_sharded_merge_on_virtual_mesh():
    mesh = cpu_mesh()
    n_docs = mesh.shape["doc"] * 2
    cap = mesh.shape["elem"] * 16
    tables = JM.example_doc_tables(n_docs, cap, seed=2)
    pos_s, out_s, nvis_s = TM.sharded_merge_step(mesh, *tables)
    pos_j, out_j, nvis_j = JM.sharded_merge_step(jax_mesh(), *tables)
    np.testing.assert_array_equal(np.asarray(pos_s), np.asarray(pos_j))
    np.testing.assert_array_equal(np.asarray(out_s), np.asarray(out_j))
    np.testing.assert_array_equal(np.asarray(nvis_s), np.asarray(nvis_j))
    # outputs actually live sharded across the mesh
    assert out_s.n_shards == mesh.size == len(out_j.sharding.device_set)
    assert out_s.spec == ("doc", "elem")


def test_one_document_larger_than_a_shard():
    """A SINGLE document whose element table spans every elem shard many
    times over: sharded == unsharded == JAX, the outputs distributed."""
    mesh = cpu_mesh(8, doc_axis=1)
    assert mesh.shape["elem"] == 8
    cap = 8 * 512                          # per-shard block = 512 elements
    tables = JM.example_doc_tables(1, cap, seed=7)
    pos_s, out_s, nvis_s = TM.sharded_merge_step(mesh, *tables)
    pos_b, out_b, nvis_b = TM.batched_merge_step(*tables, device="cpu")
    pos_j, out_j, _ = JM.sharded_merge_step(jax_mesh(8, doc_axis=1), *tables)
    assert torch.equal(pos_s.gather("cpu"), pos_b)
    assert torch.equal(out_s.gather("cpu"), out_b)
    np.testing.assert_array_equal(np.asarray(out_s), np.asarray(out_j))
    np.testing.assert_array_equal(np.asarray(pos_s), np.asarray(pos_j))
    assert int(np.asarray(nvis_s)[0]) == int(nvis_b[0])
    assert out_s.n_shards == 8
    assert out_s.shard_shape()[1] == cap // 8


def _base_and_forks(n_dev):
    base_len = n_dev * 96                  # >> one shard at capacity 2048/8
    return [typing_run("base", 1, {}, "a" * base_len, 1, "_head"),
            typing_run("alice", 1, {"base": 1}, "HELLO", 10_000, "base:5"),
            typing_run("bob", 1, {"base": 1}, "WORLD", 20_000, "base:5")]


def test_sharded_engine_merge_exceeding_shard():
    """The REAL engine path (DeviceTextDocSet sharded tables) with one
    document whose elements exceed a single shard: text equal to the
    single-doc engine's and to the JAX mesh DocSet's."""
    changes = _base_and_forks(8)
    single = TDoc("t", device="cpu")
    for ch in changes:
        single.apply_changes([ch])
    ds = TSet(["t"], capacity=2048, mesh=cpu_mesh(8, doc_axis=1))
    ds.apply_batches({"t": TBatch.from_changes(changes, "t")})
    jds = JSet(["t"], capacity=2048, mesh=jax_mesh(doc_axis=1))
    jds.apply_batches({"t": JBatch.from_changes(changes, "t")})
    assert ds.texts()["t"] == single.text() == jds.texts()["t"]
    assert ds._dev["chain"].n_shards == 8


def _planned_doc(doc_cls, n_dev, **kw):
    doc = doc_cls("t", capacity=n_dev * 256, **kw)
    doc.apply_changes([typing_run("base", 1, {}, "x" * (n_dev * 128), 1,
                                  "_head")])
    doc.apply_changes([
        typing_run("alice", 1, {"base": 1}, "HELLO", 10_000, "base:7"),
        typing_run("bob", 1, {"base": 1}, "WORLD", 20_000, "base:7"),
        {"actor": "carol", "seq": 1, "deps": {"base": 1}, "ops": [
            {"action": "del", "obj": "t", "key": "base:2"}]},
    ])
    return doc


@pytest.mark.parametrize("as_u8", [False, True])
def test_sharded_planned_materialize_matches_engine(as_u8):
    """Elem-sharded codes-only materialization with the host-planned
    segment structure: codes and scalars equal to the JAX package's on
    its mesh, the text equal to the single-device engine's, on a
    document spanning every shard."""
    n_dev = 8
    doc = _planned_doc(TDoc, n_dev, device="cpu")
    jdoc = _planned_doc(JDoc, n_dev)
    expected = doc.text()
    assert expected == jdoc.text()
    S_ = TI.bucket(doc.seg_mirror.n_segs + 2, 64)
    segplan = doc.seg_mirror.plan(S_, doc.n_elems)
    dev = doc._ensure_dev()
    cols = [dev[k] for k in ("parent", "ctr", "actor", "value", "has_value",
                             "chain")]
    codes, scalars = TM.sharded_planned_materialize(
        cpu_mesh(8, doc_axis=1), *cols, doc.n_elems, segplan, S=S_,
        as_u8=as_u8)
    jdev = jdoc._ensure_dev()
    jcodes, jscalars = JM.sharded_planned_materialize(
        jax_mesh(doc_axis=1), *(jdev[k] for k in (
            "parent", "ctr", "actor", "value", "has_value", "chain")),
        jdoc.n_elems, jdoc.seg_mirror.plan(S_, jdoc.n_elems), S=S_,
        as_u8=as_u8)
    np.testing.assert_array_equal(np.asarray(codes), np.asarray(jcodes))
    np.testing.assert_array_equal(np.asarray(scalars), np.asarray(jscalars))
    scal = np.asarray(scalars)
    assert int(scal[1]) == int(scal[2]) == doc.seg_mirror.n_segs
    assert int(scal[3]) == doc.seg_mirror.head_checksum()
    assert int(scal[4]) == doc.seg_mirror.aux_checksum()
    got = "".join(chr(v) for v in np.asarray(codes)[: int(scal[0])])
    assert got == expected
    assert codes.n_shards == 8 and codes.spec == ("elem",)
    # the same call through the single-device program
    want = TI.materialize_codes_planned(*cols, doc.n_elems,
                                        torch.from_numpy(segplan), S=S_,
                                        as_u8=as_u8)
    assert torch.equal(codes.gather("cpu"), want[0])
    assert torch.equal(scalars.gather("cpu"), want[1])


# ---------------------------------------------- DeviceTextDocSet(mesh=)

def _rounds(ids, n_rounds=2):
    for rnd in range(n_rounds):
        yield {o: [typing_change(
            f"w{a}", rnd + 1, f"r{rnd}a{a}d{i % 7}xy",
            start_ctr=16 * rnd + 1, after="w0:8" if rnd else None,
            deps={"w0": rnd} if rnd and a != 0 else {}, obj=o)
            for a in range(2)] for i, o in enumerate(ids)}


def _feed(sets, changes):
    for ds in sets:
        B = JBatch if isinstance(ds, JSet) else TBatch
        ds.apply_batches({o: B.from_changes(c, o)
                          for o, c in changes.items()})


def _assert_tables_equal(jds, tds):
    """Texts, capacity, overlay and the live prefix of every stacked
    row's tables."""
    assert tds.texts() == jds.texts()
    assert tds._cap == jds._cap
    assert sorted(tds._overlay) == sorted(jds._overlay)
    jd, td = jds._ensure_dev(), tds._ensure_dev()
    for k in KEYS:
        a, b = np.asarray(jd[k]), np.asarray(td[k])
        for d in range(jds.n_docs):
            if d not in jds._overlay:
                n = jds._meta[d].n_elems + 1
                np.testing.assert_array_equal(b[d, :n], a[d, :n], err_msg=k)


def test_sharded_docset_matches_unsharded():
    """Twin of test_doc_set_engine.py::test_sharded_docset_matches_
    unsharded: the same merges on a (doc, elem)-sharded set equal the
    JAX package's mesh set and the port's unsharded set."""
    mesh = cpu_mesh(8)
    ids = [f"m{i}" for i in range(mesh.shape["doc"] * 2)]
    plain = TSet(ids, device="cpu")
    sharded = TSet(ids, mesh=mesh)
    jds = JSet(ids, mesh=jax_mesh(8))
    for changes in _rounds(ids):
        _feed((plain, sharded, jds), changes)
    texts = sharded.texts()
    assert texts == plain.texts() == jds.texts()
    assert all(len(t) == 32 for t in texts.values())
    _assert_tables_equal(jds, sharded)
    assert sharded._dev["parent"].n_shards == mesh.size
    assert sharded._dev["parent"].spec == ("doc", "elem")


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (4, 2)])
def test_sharded_docset_self_contained_and_graduation(shape, monkeypatch):
    """The mesh set's heal path (a corrupted mirror: the self-contained
    materialization over sharded scans) and a graduated document (on its
    group's first device, applied one by one), against the JAX mesh
    set."""
    n = shape[0] * shape[1]
    mesh = cpu_mesh(n, doc_axis=shape[0])
    ids = [f"g{i}" for i in range(shape[0] * 3)]
    sharded = TSet(ids, capacity=256, mesh=mesh)
    jds = JSet(ids, capacity=256, mesh=jax_mesh(n, doc_axis=shape[0]))
    for changes in _rounds(ids):
        _feed((sharded, jds), changes)
    # a delete graduates the last doc in both sets
    last = ids[-1]
    _feed((sharded, jds), {last: [{"actor": "w0", "seq": 3,
                                   "deps": {"w1": 2}, "ops": [{
                                       "action": "del", "obj": last,
                                       "key": "w0:3"}]}]})
    assert list(sharded._overlay) == [len(ids) - 1]
    grad = sharded._overlay[len(ids) - 1]
    assert grad.device == mesh.device(sharded._group(len(ids) - 1)[0])
    _assert_tables_equal(jds, sharded)
    # corrupt one stacked row's mirror: the call heals through the
    # self-contained program on the sharded scans
    sharded._meta[0].mirror.heads[1] += 1
    sharded._codes_cache = None
    healed = []
    run = TSet._mesh_self_contained
    monkeypatch.setattr(TSet, "_mesh_self_contained",
                        lambda self, *a: healed.append(1) or run(self, *a))
    assert sharded.texts() == jds.texts()
    assert healed == [1]
    assert sharded._meta[0].mirror is not None
    sharded._codes_cache = None
    assert sharded.texts() == jds.texts() and healed == [1]   # planned


def test_docset_on_mesh_exchanges_through_the_mesh():
    """A mesh set's round and texts() move their bytes through the
    exchange functions: per round one gather and one scatter per table,
    and texts() runs the carry all_gather and the codes reduce_scatter."""
    mesh = cpu_mesh(8)
    ids = [f"x{i}" for i in range(4)]
    ds = TSet(ids, mesh=mesh)
    TM.reset_counts()
    changes = next(_rounds(ids, 1))
    ds.apply_batches({o: TBatch.from_changes(c, o)
                      for o, c in changes.items()})
    assert TM.calls["gather"] == len(KEYS)
    assert TM.calls["scatter"] == len(KEYS)
    ds.texts()
    assert TM.calls["all_gather"] == 2      # the carries, the partials
    assert TM.calls["reduce_scatter"] == 1
    assert TM.moved_bytes["scatter"] > 0


def test_docset_mesh_constructor_errors():
    with pytest.raises(ValueError, match="doc axis"):
        TSet(["a", "b", "c"], mesh=cpu_mesh(8))           # doc axis 2
    with pytest.raises(ValueError, match="elem axis"):
        TSet(["a"], capacity=256, mesh=cpu_mesh(3, doc_axis=1))
    with pytest.raises(ValueError, match="device or a mesh"):
        TSet(["a", "b"], device="cpu", mesh=cpu_mesh(8))


def test_make_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.doc_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _dryrun.run(8)


@pytest.mark.parametrize("n,doc_axis", [(8, None), (4, None), (8, 1),
                                        (6, 2)])
def test_make_mesh_factorization_matches_jax(n, doc_axis):
    got = TM.make_mesh(n, doc_axis, devices=[CPU] * n)
    want = jax_mesh(n, doc_axis)
    assert got.shape == dict(want.shape)
    assert got.size == n


def test_exchange_functions_count_and_move():
    mesh = cpu_mesh(8)
    x = torch.arange(4 * 16, dtype=torch.int32).reshape(4, 16)
    TM.reset_counts()
    s = TM.shard(mesh, x, ("doc", "elem"))
    assert s.shard_shape() == (2, 4) and s.n_shards == 8
    assert torch.equal(s.gather("cpu"), x)
    g = TM.all_gather(s, "elem", tiled=True)
    assert torch.equal(g.blocks[(1, 3)], x[2:])
    rows = TM.gather(s, "elem")
    assert sorted(rows) == [(0, 0), (1, 0)]
    assert torch.equal(rows[(1, 0)], x[2:])
    back = TM.scatter(mesh, rows, "elem", ("doc", "elem"))
    assert torch.equal(back.gather("cpu"), x)
    red = TM.reduce_scatter(g, "elem", 1)
    assert torch.equal(red.gather("cpu"), x * 4)
    assert TM.calls == {"shard": 1, "unshard": 3, "all_gather": 1,
                        "gather": 1, "scatter": 1, "reduce_scatter": 1}
    assert TM.moved_bytes["all_gather"] == 8 * 3 * 2 * 4 * 4
    assert TM.moved_bytes["gather"] == 2 * 3 * 2 * 4 * 4


# --------------------------------------------------- test_shard.py twins

def test_commit_path_runs_with_zero_exchanges():
    """The commit-path programs, run with every operand sharded over a
    doc-only mesh of 8 virtual shards, move nothing between shards."""
    audit = TA.commit_path_collectives(TA.doc_mesh(8, devices=[CPU] * 8))
    assert set(audit) == {"fused_stacked_round", "fused_scatter_registers",
                          "fused_mixed_round", "fused_commit_round",
                          "fused_commit_round_planned"}
    TA.assert_zero_collectives(audit)


def test_audit_counts_a_real_collective():
    """The auditor is not a rubber stamp: a program that all_gathers over
    the doc axis is reported."""
    mesh = TA.doc_mesh(8, devices=[CPU] * 8)
    x = TM.shard(mesh, np.ones((mesh.shape["doc"] * 2, 8), np.float32),
                 ("doc",))

    def cross_doc_sum(a):
        return TM.map_shards(lambda _c, b: b.sum(), TM.all_gather(a, "doc"),
                             out=())
    counts = TA.count_collectives(cross_doc_sum, (x,))
    assert counts == {"all_gather": 1}
    with pytest.raises(AssertionError):
        TA.assert_zero_collectives({"bad_kernel": counts})


# --------------------------------------------------- the dry run

@pytest.mark.parametrize("n_shards", [8, 4])
def test_dryrun_on_virtual_shards(n_shards):
    """Twin of test_graft_entry.py's multichip dry runs: the engine over
    a mesh of n virtual CPU shards."""
    _dryrun.run(n_shards, "cpu")


# --------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("C,n_shards", [(6_291_456, 2), (6_291_456, 4),
                                        (6_291_456, 8), (1_048_576, 8),
                                        (8 * 8192 + 8 * 3, 8)])
def test_kernel_pair_matches_plain(cuda_device, C, n_shards):
    """`fs_totals` + carry-in `fs_scan` over virtual shards of the card,
    bit-exact against the plain sharded version and the unsharded
    kernel, at the shapes of chip_smoke.py phase 15(a)."""
    chain, has = (torch.from_numpy(a).to(cuda_device)
                  for a in _columns(C, C + n_shards, 0.9, 0.95))
    ne = C - C // 20
    mesh = TM.make_mesh(n_shards, doc_axis=1,
                        devices=[cuda_device] * n_shards)
    got = S.sharded_fused_scans(mesh, chain, has, ne)
    plain = S.sharded_fused_scans_plain(chain, has, ne, n_shards)
    whole = S.fused_segment_scans(chain, has, ne)
    torch.cuda.synchronize()
    for g, p, w in zip(got, plain, whole):
        assert torch.equal(g.gather(cuda_device), p)
        assert torch.equal(p, w)


@pytest.mark.cuda
@pytest.mark.parametrize("D,C", [(1000, 768), (4, 384), (64, 4 * 1025),
                                 (8, 4 * 8193)])
def test_kernel_pair_row_form_matches_plain(cuda_device, D, C):
    """The pair's row forms over 4 elem shards: the mesh DocSet's and the
    dry run's shapes (warp form a shard), a shard row past 1,024 slots
    (block form) and one past 8,192 (look-back form)."""
    rng = np.random.default_rng(5)
    chain, has = (torch.from_numpy(a).to(cuda_device)
                  for a in _columns((D, C), 11, 0.9, 0.95))
    ne = torch.from_numpy(rng.integers(0, C + 1, D).astype(np.int32)).to(
        cuda_device)
    mesh = TM.make_mesh(4, doc_axis=1, devices=[cuda_device] * 4)
    got = S.sharded_fused_scans(mesh, chain, has, ne)
    want = S.fused_segment_scans(chain, has, ne)
    plain = S.sharded_fused_scans_plain(chain, has, ne, 4)
    torch.cuda.synchronize()
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g.gather(cuda_device), w)
        assert torch.equal(w, p)


def test_mesh_devices_are_what_their_blocks_report():
    """A mesh holds each device as a tensor made there reports it, so an
    exchange never copies a block its coordinate already holds."""
    mesh = TM.make_mesh(4, devices=["cpu"] * 4)
    assert all(mesh.device(c) == torch.zeros(1).device
               for c in mesh.coords())


@pytest.mark.cuda
def test_bare_cuda_mesh_exchanges_without_copies(cuda_device):
    """A mesh of virtual shards named by a bare "cuda" holds the card's
    index: `all_gather` of blocks already on the card stacks them (one
    operation a coordinate) and copies none."""
    from torch.profiler import ProfilerActivity, profile
    mesh = TM.make_mesh(8, doc_axis=1, devices=[torch.device("cuda")] * 8)
    assert mesh.device((0, 3)) == torch.zeros(1, device="cuda").device
    x = TM.shard(mesh, torch.arange(24, dtype=torch.int32,
                                    device="cuda").view(8, 3), ("elem",))
    TM.all_gather(x, "elem")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = TM.all_gather(x, "elem")
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not any("memcpy" in o.lower() for o in ops), ops
    assert len(ops) == 8, ops
    assert torch.equal(got.blocks[(0, 5)].view(-1).cpu(),
                       torch.arange(24, dtype=torch.int32))
