"""The port's scan kernels (automerge_tpu_torch/ops/scan_kernels.py)
against the JAX package's Pallas kernels run in interpret mode.

The plain PyTorch versions are what a CPU tensor runs; they must equal the
Pallas kernels bit for bit (int32 throughout, so the tolerance is zero).
The CUDA kernels themselves are held against the plain versions on a card
(marked `cuda`; they skip without one)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from automerge_tpu.ops import scan_pallas as P
from automerge_tpu_torch.ops import scan_kernels as S


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _channels(K, N, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-7, 8, size=(K, N)).astype(np.int32)


def _columns(C, seed, p_chain=0.7, p_has=0.8):
    rng = np.random.default_rng(seed)
    return rng.random(C) < p_chain, rng.random(C) < p_has


@pytest.mark.parametrize("shape", [(1, 1), (6, 5), (6, 513), (6, 1025),
                                   (2, 3000)])
def test_multi_scan_plain_matches_pallas(shape):
    x = _channels(*shape, seed=shape[0] * 7919 + shape[1])
    want = np.asarray(P.multi_scan(jnp.asarray(x), interpret=True))
    got = S.multi_scan_plain(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("C,n_elems,base", [
    (1, 1, 0), (1000, 700, 0), (1025, 1025, 0), (1025, 900, 5),
    (3000, 5000, 0), (2048, 2000, 1024)])
def test_fused_segment_scans_plain_matches_pallas(C, n_elems, base):
    chain, has = _columns(C, seed=C + n_elems + base)
    want = P.fused_segment_scans(jnp.asarray(chain), jnp.asarray(has),
                                 n_elems, base, interpret=True)
    got = S.fused_segment_scans_plain(torch.from_numpy(chain),
                                      torch.from_numpy(has), n_elems, base)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fused_segment_scans_empty_doc():
    C = P.TILE
    z = np.zeros(C, bool)
    want = P.fused_segment_scans(jnp.asarray(z), jnp.asarray(z), 0,
                                 interpret=True)
    got = S.fused_segment_scans(torch.from_numpy(z), torch.from_numpy(z), 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(g[-1]) == 0


def test_n_elems_as_device_scalar():
    """The fused commit passes n_elems as a tensor computed on the device;
    the result equals the Python-int form."""
    chain, has = _columns(777, seed=3)
    a = S.fused_segment_scans(torch.from_numpy(chain), torch.from_numpy(has),
                              torch.tensor(600, dtype=torch.int32))
    b = S.fused_segment_scans(torch.from_numpy(chain), torch.from_numpy(has),
                              600)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _row_columns(D, C, seed):
    rng = np.random.default_rng(seed)
    return rng.random((D, C)) < 0.7, rng.random((D, C)) < 0.8


@pytest.mark.parametrize("D,C,n_elems", [
    (3, 1000, [999, 0, 500]), (4, 768, [767, 1, 300, 767]),
    (2, 8193, [8192, 8000]), (5, 64, [0, 0, 63, 10, 40])])
def test_fused_segment_scans_rows_match_pallas(D, C, n_elems):
    """The row form: every row of (D, C) scanned on its own with its own
    count (an all-padding row included) equals the JAX kernel on that
    row."""
    chain, has = _row_columns(D, C, seed=D * C)
    got = S.fused_segment_scans(torch.from_numpy(chain),
                                torch.from_numpy(has),
                                torch.tensor(n_elems, dtype=torch.int32))
    for d in range(D):
        want = P.fused_segment_scans(jnp.asarray(chain[d]),
                                     jnp.asarray(has[d]), n_elems[d],
                                     interpret=True)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and g.shape == (D, C)
            np.testing.assert_array_equal(g[d].numpy(), np.asarray(w))


def test_fused_segment_scans_row_equals_one_column():
    """A row of the row form equals the one-column form on that row; the
    counts must be one int32 per row."""
    chain, has = _row_columns(3, 200, seed=4)
    ch, hv = torch.from_numpy(chain), torch.from_numpy(has)
    a = S.fused_segment_scans(ch, hv, torch.tensor([150, 0, 199],
                                                   dtype=torch.int32))
    one = S.fused_segment_scans(ch[2], hv[2], 199)
    for x, y in zip(a, one):
        assert torch.equal(x[2], y)
    for bad in (torch.tensor([1, 2], dtype=torch.int32), [150, 0, 199],
                torch.tensor([150, 0, 199])):
        with pytest.raises(ValueError, match="per-row n_elems"):
            S.fused_segment_scans(ch, hv, bad)


@pytest.mark.parametrize("D,N", [(4, 256), (2, 512), (1, 256)])
def test_multi_scan_plain_matches_pallas_short_rows(D, N):
    """The stacked round's expansion shape: (D * 6, N) with short rows."""
    x = _channels(D * 6, N, seed=D + N)
    want = np.asarray(P.multi_scan(jnp.asarray(x), interpret=True))
    got = S.multi_scan_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    S.reset_launches()
    x = torch.from_numpy(_channels(6, 100, seed=1))
    assert torch.equal(S.multi_scan(x), S.multi_scan_plain(x))
    chain, has = _columns(100, seed=2)
    S.fused_segment_scans(torch.from_numpy(chain), torch.from_numpy(has), 50)
    tot = S.fs_totals(torch.from_numpy(chain), torch.from_numpy(has), 50)
    S.fused_segment_scans_carry(torch.from_numpy(chain),
                                torch.from_numpy(has), 50, 100, tot[None], 1)
    assert S.launches == {"multi_scan": 0, "fused_segment_scans": 0,
                          "fs_totals": 0, "sharded_fused_scans": 0}


def test_other_devices_raise():
    """Only a CPU tensor takes the plain version; anything else must be a
    CUDA tensor or the wrapper raises (no silent fallback)."""
    x = torch.empty((6, 10), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        S.multi_scan(x)
    c = torch.empty(10, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        S.fused_segment_scans(c, c, 5)


def test_library_name_tracks_the_source():
    assert S.library_path().parent == S.BUILD_DIR
    assert S.library_path().name.startswith("libamt_scan_")
    assert "arch=compute_90a,code=sm_90a" in S.NVCC_FLAGS


def test_library_name_is_a_digest_of_the_source():
    """An edit of csrc/scan.cu rebuilds: the name carries its digest."""
    import hashlib
    digest = hashlib.sha256(S.SOURCE.read_bytes()).hexdigest()[:16]
    assert S.library_path().name == f"libamt_scan_{digest}.so"


def _sweep():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "scripts" / \
        "sweep_scan_tiles.py"
    spec = importlib.util.spec_from_file_location("sweep_scan_tiles", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("i", range(10))
def test_sweep_variants_edit_only_their_constants(i):
    """scripts/sweep_scan_tiles.py builds each variant from the shipped
    source by editing one tile constant or the store; each edit must still
    find its target."""
    W = _sweep()
    assert len(W.VARIANTS) == 10
    _, _, consts, store = W.VARIANTS[i]
    text = S.SOURCE.read_text()
    out = W.variant_source(text, consts, store)
    for name, value in consts.items():
        assert f"constexpr int {name} = {value};" in out
    if store is not None:
        assert store[1] in out and store[0] not in out
    assert (out == text) == (not consts and store is None)


@pytest.mark.parametrize("length,tile,tiles", [
    (1, 4096, 1), (4095, 4096, 1), (4096, 4096, 1), (4097, 4096, 2),
    (6_291_456, 4096, 1536), (6_291_456, 8192, 768), (8195, 8192, 2)])
def test_n_tiles(length, tile, tiles):
    assert S.n_tiles(length, tile) == tiles


@pytest.mark.parametrize("tiles,words", [(1, 1), (9216, 1), (768, 6),
                                         (1, 6)])
def test_scratch_words(tiles, words):
    """One ticket word, then `words` status words per tile; the C entry
    points refuse a smaller scratch."""
    assert S.scratch_words(tiles, words) == 1 + tiles * words
    assert S.MS_STATUS_WORDS == 1 and S.FS_STATUS_WORDS == 6


def test_cpu_tensors_record_no_launch_shapes():
    S.reset_launches()
    S.multi_scan(torch.zeros((2, 8), dtype=torch.int32))
    assert S.launch_shapes == {"multi_scan": {}, "fused_segment_scans": {},
                               "fs_totals": {}, "sharded_fused_scans": {}}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 1), (6, 1000), (6, 1025), (6, 4097),
                                   (6, 1_048_576)])
def test_multi_scan_kernel_matches_plain(cuda_device, shape):
    x = torch.from_numpy(_channels(*shape, seed=shape[1])).to(cuda_device)
    got = S.multi_scan(x)
    torch.cuda.synchronize()
    assert torch.equal(got, S.multi_scan_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("C,n_elems,base", [
    (1, 1, 0), (1025, 900, 0), (1025, 2000, 7), (100_003, 90_000, 4096)])
def test_fused_segment_scans_kernel_matches_plain(cuda_device, C, n_elems,
                                                  base):
    chain, has = _columns(C, seed=C)
    ch = torch.from_numpy(chain).to(cuda_device)
    hv = torch.from_numpy(has).to(cuda_device)
    got = S.fused_segment_scans(ch, hv, n_elems, base)
    torch.cuda.synchronize()
    for g, w in zip(got, S.fused_segment_scans_plain(ch, hv, n_elems, base)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 6, 13])
@pytest.mark.parametrize("edge", [-1, 0, 1, 3])
def test_multi_scan_kernel_tile_edges(cuda_device, K, edge):
    """N around one and two tiles, K in {1, 6, 13}; ragged N (not a
    multiple of 4) takes the scalar path."""
    tile = S.load().amt_multi_scan_tile()
    for N in (tile + edge, 2 * tile + edge):
        x = torch.from_numpy(_channels(K, N, seed=N + K)).to(cuda_device)
        got = S.multi_scan(x)
        torch.cuda.synchronize()
        assert torch.equal(got, S.multi_scan_plain(x)), (K, N)


@pytest.mark.cuda
def test_multi_scan_kernel_unaligned_rows(cuda_device):
    """A (K, N) view 4 bytes off 16-byte alignment takes the scalar path."""
    K, N = 6, 8192
    buf = torch.from_numpy(_channels(1, K * N + 1, seed=5)).to(cuda_device)
    x = buf[0, 1:].view(K, N)
    assert x.data_ptr() % 16 != 0
    got = S.multi_scan(x)
    torch.cuda.synchronize()
    assert torch.equal(got, S.multi_scan_plain(x))


@pytest.mark.cuda
def test_fused_segment_scans_kernel_unaligned_view(cuda_device):
    """A bool view one byte off 16-byte alignment (t[1:])."""
    C = 50_001
    chain, has = _columns(C + 1, seed=11)
    ch = torch.from_numpy(chain).to(cuda_device)[1:]
    hv = torch.from_numpy(has).to(cuda_device)[1:]
    assert ch.data_ptr() % 16 != 0
    got = S.fused_segment_scans(ch, hv, 45_000, 3)
    torch.cuda.synchronize()
    for g, w in zip(got, S.fused_segment_scans_plain(ch, hv, 45_000, 3)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_kernels_reuse_their_scratch(cuda_device):
    """Two calls in a row on the same shapes: the second must not see the
    first call's look-back flags on a reused allocation."""
    x = torch.from_numpy(_channels(6, 100_000, seed=7)).to(cuda_device)
    want = S.multi_scan_plain(x)
    chain, has = _columns(100_000, seed=8)
    ch, hv = (torch.from_numpy(a).to(cuda_device) for a in (chain, has))
    want_fs = S.fused_segment_scans_plain(ch, hv, 90_000)
    for _ in range(2):
        got = S.multi_scan(x)
        got_fs = S.fused_segment_scans(ch, hv, 90_000)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        for g, w in zip(got_fs, want_fs):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_kernels_repeat_bit_exact(cuda_device):
    """Look-back races show only sometimes: 20 repeats at a size of many
    tiles, every one bit-exact."""
    x = torch.from_numpy(_channels(6, 1_048_576, seed=9)).to(cuda_device)
    want = S.multi_scan_plain(x)
    chain, has = _columns(1_048_576, seed=10)
    ch, hv = (torch.from_numpy(a).to(cuda_device) for a in (chain, has))
    want_fs = S.fused_segment_scans_plain(ch, hv, 1_000_000)
    for _ in range(20):
        assert torch.equal(S.multi_scan(x), want)
        for g, w in zip(S.fused_segment_scans(ch, hv, 1_000_000), want_fs):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_one_kernel_launch_per_call(cuda_device):
    """Each wrapper runs one kernel per call (its scratch memset aside)."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros((6, 10_000), dtype=torch.int32, device=cuda_device)
    c = torch.zeros(10_000, dtype=torch.bool, device=cuda_device)
    n = torch.full((), 9_000, dtype=torch.int32, device=cuda_device)
    S.multi_scan(x)
    S.fused_segment_scans(c, c, n)
    torch.cuda.synchronize()
    for fn in (lambda: S.multi_scan(x),
               lambda: S.fused_segment_scans(c, c, n)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "memset" not in e.name.lower()]
        assert len(kernels) == 1, [e.name for e in kernels]


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    with pytest.raises(TypeError):
        S.multi_scan(torch.zeros((2, 8), dtype=torch.int64,
                                 device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        S.multi_scan(torch.zeros((8, 2), dtype=torch.int32,
                                 device=cuda_device).t())
    c = torch.zeros(8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        S.fused_segment_scans(c, c[:4], 3)


@pytest.mark.cuda
@pytest.mark.parametrize("D,C", [(1000, 768), (64, 2048), (3, 100_003),
                                 (7, 1001), (2, 16)])
def test_fused_segment_scans_rows_kernel_matches_plain(cuda_device, D, C):
    """Row form on the card at the DocSet shapes, rows of a length that is
    not a multiple of 16 (the scalar path) and many-tile rows included;
    one launch per call."""
    chain, has = _row_columns(D, C, seed=C)
    rng = np.random.default_rng(D)
    n = rng.integers(0, C, D).astype(np.int32)
    n[0] = 0
    n[-1] = C - 1
    ch, hv = (torch.from_numpy(a).to(cuda_device) for a in (chain, has))
    ne = torch.from_numpy(n).to(cuda_device)
    S.reset_launches()
    got = S.fused_segment_scans(ch, hv, ne)
    torch.cuda.synchronize()
    assert S.launches["fused_segment_scans"] == 1
    assert S.launch_shapes["fused_segment_scans"] == {(D, C): 1}
    for g, w in zip(got, S.fused_segment_scans_plain(ch, hv, ne)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("D,N", [(192, 256), (64, 256), (4, 256),
                                 (192, 512)])
def test_multi_scan_kernel_short_rows(cuda_device, D, N):
    """The stacked text lane's (D * 6, N) expansion scan: many short rows
    (most of a tile's lanes idle), bit-exact and one launch."""
    x = torch.from_numpy(_channels(D * 6, N, seed=D * N)).to(cuda_device)
    S.reset_launches()
    got = S.multi_scan(x)
    torch.cuda.synchronize()
    assert S.launches["multi_scan"] == 1
    assert torch.equal(got, S.multi_scan_plain(x))
