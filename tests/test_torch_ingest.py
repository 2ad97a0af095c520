"""Module parity of the port's round programs (automerge_tpu_torch/ops:
ingest.py, fused_round.py, linearize.py) against the JAX package.

Both packages start from ONE document state (`state.host_state` of a JAX
document loaded into the port with `state.load_text_doc_state`), plan the
same batch, and run the same round program on the same staged inputs; the
live prefix of every output must be equal bit for bit (int32/bool/uint8
throughout, so the tolerance is zero). The JAX side runs its fused tier
with the lax scan (`mode="lax"`), plus one case through the Pallas kernel
in interpret mode. The last tests pin the JAX -> PyTorch semantic traps:
out-of-range scatters and gathers, sort and search ties, uint32 hashing,
int32 scans and duplicate scatter indices."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench as B
from automerge_tpu.engine import DeviceTextDoc as JDoc
from automerge_tpu.engine import TextChangeBatch as JBatch
from automerge_tpu.ops import fused_round as JF
from automerge_tpu.ops import ingest as JK
from automerge_tpu.ops import linearize as JL
from automerge_tpu_torch.engine import DeviceTextDoc as TDoc
from automerge_tpu_torch.engine import TextChangeBatch as TBatch
from automerge_tpu_torch.ops import fused_round as TF
from automerge_tpu_torch.ops import ingest as TK
from automerge_tpu_torch.ops import linearize as TL
from automerge_tpu_torch.state import (host_state, load_text_doc_state,
                                       tables_from_numpy)

KEYS = JDoc._TABLE_KEYS


def as_port(batch):
    return TBatch(**{k: getattr(batch, k)
                     for k in batch.__dataclass_fields__})


def np_of(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def twin_docs(base_n=600, planned=True, jax_batches=()):
    """A JAX doc after `base_n` typed chars (+ extra batches), and a port
    doc loaded from its state."""
    jdoc = JDoc("t")
    jdoc.eager_materialize = True
    jdoc.prefer_planned = planned
    jdoc.apply_batch(B.base_batch("t", base_n))
    for b in jax_batches:
        jdoc.apply_batch(b)
    tdoc = load_text_doc_state(TDoc("t", device="cpu"), host_state(jdoc))
    tdoc.eager_materialize = True
    tdoc.prefer_planned = planned
    return jdoc, tdoc


def first_plans(jdoc, tdoc, jbatch):
    jp = jdoc.prepare_batch(jbatch)
    tp = tdoc.prepare_batch(as_port(jbatch))
    jplan, tplan = jp.rounds[0][3], tp.rounds[0][3]
    for name in ("desc", "blob", "res", "touch", "seg_plan"):
        a, b = getattr(jplan, name), getattr(tplan, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(np_of(b), np_of(a), err_msg=name)
    return jplan, tplan


def tables(doc):
    dev = doc._ensure_dev()
    return tuple(dev[k] for k in KEYS)


def assert_tables_equal(j_out, t_out, live: int):
    for k, a, b in zip(KEYS, j_out, t_out):
        np.testing.assert_array_equal(np_of(b)[:live], np_of(a)[:live],
                                      err_msg=k)
        assert np_of(b).dtype == np_of(a).dtype, k


def merge(n_actors=8, ops=40, base_n=600, seed=0):
    return B.merge_batch("t", n_actors, ops, base_n, seed=seed)


def residual_batch(base_n, seed):
    """Deletes, overwrites (two of them conflicting) and concurrent
    inserts — a round that stages residual ops and a touch matrix."""
    rng = np.random.default_rng(seed)
    tg = rng.choice(np.arange(1, base_n), size=12, replace=False).tolist()
    ch = [{"actor": "del", "seq": 1, "deps": {"base": 1}, "ops": [
        {"action": "del", "obj": "t", "key": f"base:{t}"} for t in tg[:5]]}]
    for k in range(2):
        ch.append({"actor": f"set{k}", "seq": 1, "deps": {"base": 1},
                   "ops": [{"action": "set", "obj": "t",
                            "key": f"base:{t}", "value": "QRST"[k]}
                           for t in tg[5:9]]})
        ch.append({"actor": f"ins{k}", "seq": 1, "deps": {"base": 1},
                   "ops": [{"action": "ins", "obj": "t",
                            "key": f"base:{tg[9]}", "elem": 5000 + k},
                           {"action": "ins", "obj": "t",
                            "key": f"ins{k}:{5000 + k}", "elem": 6000}]})
    return JBatch.from_changes(ch, "t")


# ------------------------------------------------------------ fused tier

@pytest.mark.parametrize("planned,mode", [(True, "lax"), (False, "lax"),
                                          (True, "interpret")])
def test_fused_commit_round_matches_jax(planned, mode):
    jdoc, tdoc = twin_docs(planned=planned)
    jplan, tplan = first_plans(jdoc, tdoc, merge())
    assert jplan.dense and jplan.n_res == 0
    assert (jplan.seg_plan is not None) == planned
    out_cap = jplan.out_cap
    S_fit = jdoc._seg_bound + jplan.seg_inc
    S, L, as_u8 = jdoc._mat_params(
        seg_bound=jplan.seg_S if planned else S_fit,
        n_elems=jplan.n_elems_after, cap=out_cap, ascii_=True)
    if planned:
        S = jplan.seg_S
        j_out = JF.fused_commit_round_planned(
            *tables(jdoc), jplan.desc, jplan.blob, jplan.seg_plan,
            out_cap=out_cap, S=S, as_u8=as_u8, L=L, mode=mode)
        t_out = TF.fused_commit_round_planned(
            *tables(tdoc), tplan.desc, tplan.blob, tplan.seg_plan,
            out_cap=out_cap, S=S, as_u8=as_u8, L=L)
    else:
        j_out = JF.fused_commit_round(
            *tables(jdoc), jplan.desc, jplan.blob, out_cap=out_cap, S=S,
            as_u8=as_u8, L=L, mode=mode)
        t_out = TF.fused_commit_round(
            *tables(tdoc), tplan.desc, tplan.blob, out_cap=out_cap, S=S,
            as_u8=as_u8, L=L)
    live = jplan.n_elems_after + 1
    assert_tables_equal(j_out[:9], t_out[:9], live)
    j_sc, t_sc = np_of(j_out[10]), np_of(t_out[10])
    np.testing.assert_array_equal(t_sc, j_sc)
    n_vis = int(j_sc[0])
    assert n_vis == 600 + 8 * 20
    np.testing.assert_array_equal(np_of(t_out[9])[:n_vis],
                                  np_of(j_out[9])[:n_vis])
    if planned:   # the plan-consistency hashes match the host mirror
        assert int(t_sc[3]) == jplan.mirror_after.head_checksum()
        assert int(t_sc[4]) == jplan.mirror_after.aux_checksum()


@pytest.mark.parametrize("seed,mode", [(0, "lax"), (1, "lax"),
                                       (2, "interpret")])
def test_fused_mixed_round_matches_jax(seed, mode):
    jdoc, tdoc = twin_docs(jax_batches=[merge(4, 20, seed=seed)])
    jplan, tplan = first_plans(jdoc, tdoc, residual_batch(600, seed))
    assert jplan.n_res and jplan.touch is not None
    out_cap = jplan.out_cap
    conflicts = np.full(64, out_cap, np.int32)
    j_d = JF.round_dummies(out_cap)
    t_d = TF.round_dummies(out_cap, "cpu")
    j_out = JF.fused_mixed_round(
        *tables(jdoc), jplan.desc if jplan.desc is not None else j_d[0],
        jplan.blob if jplan.blob is not None else j_d[1], jplan.res,
        jnp.asarray(conflicts), jplan.touch, out_cap=out_cap, mode=mode)
    t_out = TF.fused_mixed_round(
        *tables(tdoc), tplan.desc if tplan.desc is not None else t_d[0],
        tplan.blob if tplan.blob is not None else t_d[1], tplan.res,
        torch.from_numpy(conflicts), tplan.touch, out_cap=out_cap)
    assert_tables_equal(j_out[:9], t_out[:9], jplan.n_elems_after + 1)
    np.testing.assert_array_equal(np_of(t_out[9])[:, :jplan.n_res],
                                  np_of(j_out[9])[:, :jplan.n_res])


def test_round_dummies_are_no_ops():
    """Absent phases ride padding conventions: a round of nothing but
    dummies leaves every table unchanged."""
    _, tdoc = twin_docs()
    cap = tdoc._cap
    out = TF.fused_mixed_round(*tables(tdoc), *TF.round_dummies(cap, "cpu"),
                               out_cap=cap)
    for a, b in zip(tables(tdoc), out[:9]):
        assert torch.equal(a, b)
    assert not out[9][0].any()


# ----------------------------------------------------------- materialize

def mixed_state(seed):
    """A JAX doc after a merge and a residual round (tombstones, split
    segments, conflicts), and its port twin."""
    return twin_docs(jax_batches=[merge(6, 30, seed=seed),
                                  residual_batch(600, seed)])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_pos,as_u8", [(True, False), (False, True)])
def test_materialize_matches_jax(seed, with_pos, as_u8):
    jdoc, tdoc = mixed_state(seed)
    n = jdoc.n_elems
    S, L, _ = jdoc._mat_params()
    args = lambda d: (d["parent"], d["ctr"], d["actor"], d["value"],  # noqa
                      d["has_value"], d["chain"], n)
    jfn = JK.materialize_text if with_pos else JK.materialize_codes
    tfn = TK.materialize_text if with_pos else TK.materialize_codes
    j_out = jfn(*args(jdoc._ensure_dev()), S=S, as_u8=as_u8, L=L)
    t_out = tfn(*args(tdoc._ensure_dev()), S=S, as_u8=as_u8, L=L)
    _check_materialized(j_out, t_out, n, with_pos)

    segplan = jdoc.seg_mirror.plan(S, n)
    jfn = JK.materialize_text_planned if with_pos \
        else JK.materialize_codes_planned
    tfn = TK.materialize_text_planned if with_pos \
        else TK.materialize_codes_planned
    j_out = jfn(*args(jdoc._ensure_dev()), jnp.asarray(segplan), S=S,
                as_u8=as_u8, L=L)
    t_out = tfn(*args(tdoc._ensure_dev()), torch.from_numpy(segplan), S=S,
                as_u8=as_u8, L=L)
    _check_materialized(j_out, t_out, n, with_pos)
    sc = np_of(t_out[-1])
    assert int(sc[2]) == int(sc[1])
    assert int(sc[3]) == tdoc.seg_mirror.head_checksum()
    assert int(sc[4]) == tdoc.seg_mirror.aux_checksum()


def _check_materialized(j_out, t_out, n, with_pos):
    j_sc, t_sc = np_of(j_out[-1]), np_of(t_out[-1])
    np.testing.assert_array_equal(t_sc, j_sc)
    n_vis = int(j_sc[0])
    jc, tc = np_of(j_out[-2]), np_of(t_out[-2])
    assert tc.dtype == jc.dtype
    np.testing.assert_array_equal(tc[:n_vis], jc[:n_vis])
    if with_pos:
        np.testing.assert_array_equal(np_of(t_out[0])[:n + 1],
                                      np_of(j_out[0])[:n + 1])


def test_segment_visible_counts_matches_jax():
    jdoc, tdoc = mixed_state(3)
    n = jdoc.n_elems
    S, L, _ = jdoc._mat_params()
    segplan = jdoc.seg_mirror.plan(S, n)
    want = JK.segment_visible_counts(jdoc._ensure_dev()["has_value"], n,
                                     jnp.asarray(segplan), S=S, L=L)
    got = TK.segment_visible_counts(tdoc._ensure_dev()["has_value"], n,
                                    torch.from_numpy(segplan), S=S, L=L)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(3))
def test_gather_spans_matches_jax(seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 128, 3000).astype(np.uint8)
    D = 64
    n = int(rng.integers(1, 40))
    spans = np.zeros((2, D), np.int32)
    spans[0, :n] = rng.integers(0, 2900, n)
    spans[1, :n] = rng.integers(0, 60, n)       # zero lengths included
    P = 4096
    want = JL.gather_spans(jnp.asarray(codes), jnp.asarray(spans), P=P)
    got = TL.gather_spans(torch.from_numpy(codes), torch.from_numpy(spans),
                          P=P)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rga_linearize_matches_jax():
    jdoc, tdoc = mixed_state(4)
    h = jdoc._mirrors()
    n = jdoc.n_elems + 1
    cap = TL.pad_capacity(n)
    assert cap == JL.pad_capacity(n)

    def padded(a):
        out = np.zeros(cap, a.dtype)
        out[:n] = a[:n]
        return out
    valid = np.arange(cap) < n
    cols = [padded(h[k]) for k in ("parent", "ctr", "actor")]
    want = JL.rga_linearize(*map(jnp.asarray, cols), jnp.asarray(valid))
    got = TL.rga_linearize(*map(torch.from_numpy, cols),
                           torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(2))
def test_scatter_registers_packed_matches_jax(seed):
    rng = np.random.default_rng(seed)
    C = 500
    regs = (rng.integers(0, 99, C).astype(np.int32), rng.random(C) < 0.5,
            rng.integers(-1, 9, C).astype(np.int32),
            rng.integers(0, 9, C).astype(np.int32), rng.random(C) < 0.2)
    S = 64
    wb = np.zeros((6, S), np.int32)
    wb[0] = C                                     # padding: OOB sentinel
    k = 40
    wb[0, :k] = rng.choice(C, k, replace=False)
    wb[1:, :k] = rng.integers(0, 2, (5, k))
    want = JK.scatter_registers_packed(*map(jnp.asarray, regs),
                                       jnp.asarray(wb))
    got = TK.scatter_registers_packed(*map(torch.from_numpy, regs),
                                      torch.from_numpy(wb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = JK.scatter_registers(*map(jnp.asarray, regs),
                                *map(jnp.asarray, (wb[0], wb[1],
                                                   wb[2].astype(bool), wb[3],
                                                   wb[4],
                                                   wb[5].astype(bool))))
    got = TK.scatter_registers(*map(torch.from_numpy, regs),
                               *map(torch.from_numpy,
                                    (wb[0], wb[1], wb[2].astype(bool), wb[3],
                                     wb[4], wb[5].astype(bool))))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_remap_actors_matches_jax():
    rng = np.random.default_rng(5)
    C = 300
    actor = rng.integers(0, 10, C).astype(np.int32)
    wa = rng.integers(-1, 10, C).astype(np.int32)
    remap = rng.permutation(10).astype(np.int32)
    want = JK.remap_actors(jnp.asarray(actor), jnp.asarray(wa),
                           jnp.asarray(remap), np.int32(200))
    got = TK.remap_actors(torch.from_numpy(actor), torch.from_numpy(wa),
                          torch.from_numpy(remap), 200)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tables_from_numpy_keeps_dtypes_and_fills():
    jdoc, _ = twin_docs()
    host = {k: np.asarray(v) for k, v in jdoc._dev.items()}
    out = tables_from_numpy(host, "cpu")
    for k in KEYS:
        assert out[k].numpy().dtype == host[k].dtype
        np.testing.assert_array_equal(out[k].numpy(), host[k])
    assert int(out["win_actor"][-1]) == -1      # padding fill survives
    host["ctr"] = host["ctr"].astype(np.int64)
    with pytest.raises(TypeError):
        tables_from_numpy(host, "cpu")


# --------------------------------------------- JAX -> PyTorch semantics

@pytest.mark.parametrize("seed", range(3))
def test_uint32_mix_matches_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    x[:4] = [0, -1, 2**31 - 1, -2**31]
    want = TK.mix32_np(x)
    np.testing.assert_array_equal(
        TK._mix32(torch.from_numpy(x)).numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(np.asarray(JK._mix32(jnp.asarray(x))),
                                  want)
    assert TK.mix32_np is not JK.mix32_np
    np.testing.assert_array_equal(JK.mix32_np(x), want)
    s = TK._as_i32(TK._mix32(torch.from_numpy(x)).sum())
    assert int(s) == int(np.int32(np.uint32(want.sum(dtype=np.uint32))))


def test_out_of_range_scatter_drops_like_jax():
    dst = np.arange(10, dtype=np.int32)
    idx = np.array([3, 10, 11, -1, -11, 2**20], np.int32)
    vals = np.array([100, 101, 102, 103, 104, 105], np.int32)
    want = jnp.asarray(dst).at[jnp.asarray(idx)].set(jnp.asarray(vals),
                                                     mode="drop")
    got = TK._set_drop(torch.from_numpy(dst), torch.from_numpy(idx),
                       torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mat = np.zeros((4, 3), np.int32)
    got = TK._set_drop(torch.from_numpy(mat), torch.tensor([1, 4]),
                       torch.ones((2, 3), dtype=torch.int32))
    assert got.shape == (4, 3) and got.sum() == 3
    # the column form: rows padded with their fills, columns dropped alike
    rows = (torch.from_numpy(dst), torch.from_numpy(dst[::-1].copy()))
    got = TK._set_drop_rows(rows, (0, -1), torch.from_numpy(idx),
                            (torch.from_numpy(vals), -torch.from_numpy(vals)),
                            12)
    want2 = jnp.asarray(np.concatenate([dst[::-1], [-1, -1]])).at[
        jnp.asarray(idx)].set(-jnp.asarray(vals), mode="drop")
    want1 = jnp.asarray(np.concatenate([dst, [0, 0]])).at[
        jnp.asarray(idx)].set(jnp.asarray(vals), mode="drop")
    assert got.shape == (2, 12) and got[0].is_contiguous()
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want1))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want2))


def test_out_of_range_gather_clamps_like_jax():
    a = np.arange(10, 20, dtype=np.int32)
    idx = np.array([0, 9, 10, 55, -1, -10, -11, -99], np.int32)
    want = jnp.asarray(a)[jnp.asarray(idx)]
    got = TK._take(torch.from_numpy(a), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(3))
def test_multi_key_sort_matches_lax_sort(seed):
    import jax
    rng = np.random.default_rng(seed)
    n = 500
    keys = [rng.integers(0, 4, n).astype(np.int32) for _ in range(3)]
    keys.append(rng.permutation(n).astype(np.int32))   # total order
    idx = np.arange(n, dtype=np.int32)
    want = jax.lax.sort(tuple(map(jnp.asarray, keys + [idx])),
                        num_keys=4)[-1]
    got = TK._lexsort([torch.from_numpy(k) for k in keys])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # with ties on every key the order is stable (input order)
    tied = [torch.from_numpy(k) for k in keys[:3]]
    order = TK._lexsort(tied).numpy()
    np.testing.assert_array_equal(
        order, np.lexsort([k.numpy() for k in reversed(tied)]))


def test_searchsorted_tie_rules_match_jax():
    a = np.array([0, 1, 1, 1, 3, 3, 7], np.int32)
    v = np.arange(-1, 9, dtype=np.int32)
    for side, right in (("left", False), ("right", True)):
        want = jnp.searchsorted(jnp.asarray(a), jnp.asarray(v), side=side)
        got = torch.searchsorted(torch.from_numpy(a), torch.from_numpy(v),
                                 right=right, out_int32=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int32_scans_stay_int32():
    x = torch.tensor([2**31 - 1, 1], dtype=torch.int32)
    out = TK._cumsum(x)
    assert out.dtype == torch.int32
    assert int(out[1]) == -2**31                  # wraps like jnp.cumsum
    assert int(np.asarray(jnp.cumsum(jnp.asarray(x.numpy())))[1]) == -2**31


def test_live_scatter_indices_are_unique(monkeypatch):
    """Every scatter of a real round writes each in-range index at most
    once (or the same value each time): only the dropped sentinel rows may
    collide, so CUDA's unordered index_put_ stays deterministic."""
    seen = []
    real = TK._set_drop
    real_rows = TK._set_drop_rows

    def checked(dst, idx, vals):
        n = dst.shape[0]
        i = idx.to(torch.int64)
        i = torch.where(i < 0, i + n, i)
        keep = (i >= 0) & (i < n)
        v = vals if torch.is_tensor(vals) else torch.tensor(vals)
        v = v.expand((idx.shape[0],) + tuple(dst.shape[1:])) \
            if v.dim() < 1 + dst.dim() - 1 or v.shape[0] != idx.shape[0] \
            else v
        ik, vk = i[keep], v[keep]
        for u in torch.unique(ik).tolist():
            rows = vk[ik == u]
            assert (rows == rows[0]).all(), f"conflicting writes at {u}"
        seen.append(int(keep.sum()))
        return real(dst, idx, vals)

    def checked_rows(rows, fills, idx, updates, n):
        checked(torch.zeros((n, len(rows)), dtype=torch.int32), idx,
                torch.stack([u.to(torch.int32) for u in updates], dim=1))
        return real_rows(rows, fills, idx, updates, n)

    monkeypatch.setattr(TK, "_set_drop_rows", checked_rows)
    monkeypatch.setattr(TK, "_set_drop", checked)
    monkeypatch.setattr(TF, "_set_drop", checked)
    monkeypatch.setattr(TL, "_set_drop", checked)
    jdoc, tdoc = twin_docs(planned=False)
    tdoc.apply_batch(as_port(merge(6, 30)))
    tdoc.apply_batch(as_port(residual_batch(600, 0)))
    tdoc._positions()
    assert len(seen) > 10 and max(seen) > 0
