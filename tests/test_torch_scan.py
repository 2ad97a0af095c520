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
from automerge_tpu.parallel import mesh as JM
from automerge_tpu_torch.ops import scan_kernels as S
from automerge_tpu_torch.parallel import mesh as TM


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
                                   (2, 3000), (6, 1024), (1, 1025),
                                   (2, 8193)])
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


@pytest.mark.parametrize("D,N", [(4, 256), (2, 512), (1, 256), (1, 1024),
                                 (1, 1025), (1, 8193)])
def test_multi_scan_plain_matches_pallas_short_rows(D, N):
    """The stacked round's expansion shape: (D * 6, N) with short rows, and
    (6, N) rows on each side of the warp and block forms' edges."""
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


def test_sweep_bounds_take_a_column_length():
    """scripts/sweep_scan_tiles.py passes the merge column's length, not a
    shape, to chip_smoke's segment-scan bound."""
    CS = _sweep().CS
    assert CS._fs_bound(CS.N_MERGE) == CS._fs_bound((CS.N_MERGE,))
    assert CS._fs_bound((1000, 768)) != CS._fs_bound(768)


@pytest.mark.parametrize("length,tile,tiles", [
    (1, 4096, 1), (4095, 4096, 1), (4096, 4096, 1), (4097, 4096, 2),
    (6_291_456, 4096, 1536), (6_291_456, 8192, 768), (8195, 8192, 2)])
def test_n_tiles(length, tile, tiles):
    assert S.n_tiles(length, tile) == tiles


@pytest.mark.parametrize("rows,n,words", [
    (1, 8193, 2), (6, 6_291_456, 4608), (3, 20_000, 9),
    (1, 3 * 8192 + 5, 4)])
def test_scratch_words(rows, n, words):
    """multi_scan's look-back scratch: one status word a tile, after the
    header of both families (ticket, arrivals, epoch) and no row
    counters; the C entry point refuses a smaller scratch."""
    assert S.MS_STATUS_WORDS == 1 and S.FS_STATUS_WORDS == 6
    geo = S.ms_geometry(rows, n)
    assert S.FORMS[geo.form] == "lookback"
    assert (geo.counters, geo.words) == (0, words)
    assert S.fs_scratch_words(geo.counters, geo.words) == 2 + words


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
    """Each wrapper runs one kernel per call and nothing else (no memset:
    test_each_call_is_one_kernel_and_no_memset checks every form)."""
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
        ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(ops) == 1, [e.name for e in ops]


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


# ------------------------------------------- the segment scans' three forms

#: per-row lengths on each form boundary (warp <= 1,024 < block <= 8,192
#: < look-back), and a row of several tiles
FORM_EDGES = [96, 1023, 1024, 1025, 8191, 8192, 8193, 3 * 8192 + 5]


@pytest.mark.parametrize("n,form", [
    (1, "warp"), (96, "warp"), (1023, "warp"), (1024, "warp"),
    (1025, "block"), (8191, "block"), (8192, "block"),
    (8193, "lookback"), (3 * 8192 + 5, "lookback")])
@pytest.mark.parametrize("rows", [1, 7, 500])
def test_fs_geometry_at_the_form_boundaries(n, form, rows):
    """The host's form choice: a warp a row up to 1,024 slots, a block a
    row up to 8,192, then the look-back over tiles, and only the
    look-back form takes scratch (fs_scan: 6 status words a tile;
    fs_totals: 3 partial words a tile and a counter a row)."""
    tiles = rows * -(-n // S.FS_TILE)
    for kernel in ("fs_scan", "fs_totals"):
        g = S.fs_geometry(kernel, rows, n)
        assert S.FORMS[g.form] == form
        if form != "lookback":
            assert (g.counters, g.words) == (0, 0)
        elif kernel == "fs_scan":
            assert (g.counters, g.words) == (0, 6 * tiles)
        else:
            assert (g.counters, g.words) == (rows, 3 * tiles)


def test_fs_geometry_follows_the_library_constants():
    """A variant build (scripts/sweep_scan_tiles.py) with another tile
    moves the boundaries with it; an empty launch or an unknown kernel
    raises."""
    assert S.FORMS[S.fs_geometry("fs_scan", 2, 3000, 2048,
                                    1024).form] == "lookback"
    assert S.FORMS[S.fs_geometry("fs_scan", 2, 2000, 2048,
                                    1024).form] == "block"
    for bad in (("fs_scan", 0, 10), ("fs_scan", 3, 0), ("scan", 1, 10)):
        with pytest.raises(ValueError):
            S.fs_geometry(*bad)


@pytest.mark.parametrize("counters,words,total", [
    (0, 0, 2), (1, 0, 3), (2, 6, 9), (5, 36, 41)])
def test_fs_scratch_words(counters, words, total):
    """Header (ticket, arrivals, epoch), u32 row counters two a word, then
    the status words."""
    assert S.fs_scratch_words(counters, words) == total


class _FakeAlloc:
    """Stands in for the zeroed allocation of a card: records each call."""

    def __init__(self):
        self.calls = []

    def __call__(self, n_words, device):
        self.calls.append((n_words, device))
        return torch.zeros(n_words, dtype=torch.int64)


def test_scratch_cache_one_buffer_per_stream():
    alloc = _FakeAlloc()
    cache = S.ScratchCache(alloc, capturing=lambda: False)
    a = cache.get((0, 111), "cuda:0", 0, 36)
    b = cache.get((0, 222), "cuda:0", 0, 36)
    assert a[0] is not b[0] and a[0].data_ptr() != b[0].data_ptr()
    assert cache.get((0, 111), "cuda:0", 0, 20) is a      # fits: reused
    assert cache.get((1, 111), "cuda:1", 0, 20) is not a  # another device
    assert [c[1] for c in alloc.calls] == ["cuda:0", "cuda:0", "cuda:1"]
    # powers of two of what was asked, after the header
    assert a[1:3] == (0, 64) and alloc.calls[0][0] == S.fs_scratch_words(
        0, 64)
    assert a[3] == a[0].data_ptr()


def test_scratch_cache_growth_keeps_streams_apart():
    alloc = _FakeAlloc()
    cache = S.ScratchCache(alloc, capturing=lambda: False)
    a = cache.get((0, 1), "cuda:0", 0, 6)
    b = cache.get((0, 2), "cuda:0", 0, 6)
    a2 = cache.get((0, 1), "cuda:0", 3, 100)     # stream 1 grows
    assert a2[0] is not a[0] and a2[1:3] == (4, 128)
    assert cache.buffers[(0, 2)] is b            # stream 2 untouched
    assert cache.retired == [a[0]]               # a graph may replay a
    a3 = cache.get((0, 1), "cuda:0", 0, 120)     # smaller: the grown one
    assert a3 is a2
    a4 = cache.get((0, 1), "cuda:0", 9, 0)       # more counters only
    assert a4[1:3] == (16, 128)
    assert len({id(e[0]) for e in cache.buffers.values()}) == 2


def test_scratch_cache_refuses_to_grow_inside_a_capture():
    alloc = _FakeAlloc()
    capturing = [False]
    cache = S.ScratchCache(alloc, capturing=lambda: capturing[0])
    a = cache.get((0, 1), "cuda:0", 0, 64)
    capturing[0] = True
    assert cache.get((0, 1), "cuda:0", 0, 64) is a   # sized before: fine
    with pytest.raises(RuntimeError, match="before a CUDA graph"):
        cache.get((0, 1), "cuda:0", 0, 65)
    with pytest.raises(RuntimeError, match="before a CUDA graph"):
        cache.get((0, 9), "cuda:0", 0, 6)
    assert len(alloc.calls) == 1


def test_int_counts_go_by_value():
    """An int count needs no device tensor: the kernels take it by value
    (stride -1); a scalar tensor is read on the device (stride 0), per-row
    counts at their own stride (no copy of a strided count)."""
    c = torch.zeros(10, dtype=torch.bool)
    assert S._fs_counts("x", c, 7, False) == (None, -1, 7)
    t = torch.tensor(7, dtype=torch.int32)
    assert S._fs_counts("x", c, t, False) == (t.data_ptr(), 0, 0)
    rows = torch.zeros((3, 10), dtype=torch.bool)
    every_other = torch.arange(6, dtype=torch.int32)[::2]
    assert S._fs_counts("x", rows, every_other, True) == (
        every_other.data_ptr(), 2, 0)
    with pytest.raises(ValueError, match="one int32"):
        S._fs_counts("x", c, torch.tensor([1, 2], dtype=torch.int32), False)


def _form_inputs(D, n, lead, seed, device):
    """(chain, has_value) of D rows of n slots (a column when D is None),
    views `lead` bytes into longer tensors on `device`."""
    rng = np.random.default_rng(seed)
    m = (D or 1) * n
    chain = torch.from_numpy(rng.random(m + lead) < 0.8).to(device)[lead:]
    has = torch.from_numpy(rng.random(m + lead) < 0.9).to(device)[lead:]
    if D is not None:
        chain, has = chain.view(D, n), has.view(D, n)
    return chain, has


def _carry(D, shards, n, seed, device):
    """A (shards + 1, [D,] 3) carry of plausible totals."""
    rng = np.random.default_rng(seed)
    lead = (shards + 1,) + ((D,) if D is not None else ())
    t = np.stack([rng.integers(0, n, lead), rng.integers(0, 50 * n, lead),
                  rng.integers(0, n, lead)], -1).astype(np.int32)
    return torch.from_numpy(t).to(device)


def _check_three(ch, hv, ne, base, carry, shard):
    """fs_totals, the carry-in fs_scan and fused_segment_scans against
    their plain versions, bit-exact."""
    got = S.fs_totals(ch, hv, ne, base)
    want = S.fs_totals_plain(ch, hv, ne, base)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    got = S.fused_segment_scans_carry(ch, hv, ne, base, carry, shard)
    want = S.fused_segment_scans_carry_plain(ch, hv, ne, base, carry, shard)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = S.fused_segment_scans(ch, hv, ne, base)
    want = S.fused_segment_scans_plain(ch, hv, ne, base)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", FORM_EDGES)
@pytest.mark.parametrize("lead", [0, 1, 16])
@pytest.mark.parametrize("D", [None, 5])
def test_forms_bit_exact_at_the_boundaries(cuda_device, n, lead, D):
    """Each form at its edges, on aligned views and views one byte off 16
    (the scalar path), rows of a length off a multiple of 16 included:
    the three wrappers equal their plain versions, with int, device-scalar
    and per-row counts and a carry-in of 3 earlier shards."""
    ch, hv = _form_inputs(D, n, lead, n + lead, cuda_device)
    carry = _carry(D, 3, n, n, cuda_device)
    if D is None:
        for ne in (n - n // 7, torch.tensor(n, dtype=torch.int32,
                                            device=cuda_device)):
            _check_three(ch, hv, ne, 5, carry, 3)
    else:
        rng = np.random.default_rng(n)
        cnt = rng.integers(0, n + 1, D).astype(np.int32)
        cnt[0], cnt[-1] = 0, n
        ne = torch.from_numpy(cnt).to(cuda_device)
        _check_three(ch, hv, ne, 3 * n, carry, 3)
        # a strided per-row count is read in place
        ne2 = torch.from_numpy(np.repeat(cnt, 2)).to(cuda_device)[::2]
        _check_three(ch, hv, ne2, 0, carry, 2)


@pytest.mark.cuda
def test_back_to_back_mixed_shapes_on_one_stream(cuda_device):
    """50 calls of mixed shapes and forms on one stream, no sync between
    them: the self-resetting ticket and counters and the epoch carry every
    call right, whatever ran before it."""
    shapes = [(None, 100_003), (5, 8193), (None, 96), (3, 3 * 8192 + 5),
              (None, 8192), (500, 192), (2, 20_000), (None, 9000)]
    cases = []
    for i in range(50):
        D, n = shapes[(i * 3) % len(shapes)]
        ch, hv = _form_inputs(D, n, i % 2, i, cuda_device)
        ne = (n - i if D is None else torch.full(
            (D,), n - i, dtype=torch.int32, device=cuda_device))
        carry = _carry(D, 2, n, i, cuda_device)
        kind = i % 3
        if kind == 0:
            out = (S.fs_totals(ch, hv, ne, i),)
            want = (S.fs_totals_plain(ch, hv, ne, i),)
        elif kind == 1:
            out = S.fused_segment_scans_carry(ch, hv, ne, i, carry, 2)
            want = S.fused_segment_scans_carry_plain(ch, hv, ne, i, carry, 2)
        else:
            out = S.fused_segment_scans(ch, hv, ne, i)
            want = S.fused_segment_scans_plain(ch, hv, ne, i)
        cases.append((out, want))
    torch.cuda.synchronize()
    for i, (out, want) in enumerate(cases):
        for g, w in zip(out, want):
            assert torch.equal(g, w), i


@pytest.mark.cuda
def test_replayed_graph_stays_bit_exact(cuda_device):
    """A CUDA graph of 10 calls (every kernel, the look-back form among
    them), captured after one warm-up on its stream, replayed 20 times:
    the epoch and counters live on the device, so every replay is right."""
    inputs = []
    for i, (D, n) in enumerate([(None, 100_003), (4, 20_000), (500, 192),
                                (3, 5000), (None, 8193)]):
        ch, hv = _form_inputs(D, n, 0, 40 + i, cuda_device)
        ne = (n - 3 if D is None else torch.full(
            (D,), n - 3, dtype=torch.int32, device=cuda_device))
        inputs.append((ch, hv, ne, _carry(D, 1, n, i, cuda_device)))

    def calls():
        outs = []
        for ch, hv, ne, carry in inputs:
            outs.append((S.fs_totals(ch, hv, ne, 7),))
            outs.append(S.fused_segment_scans_carry(ch, hv, ne, 7, carry, 1))
        return outs
    want = []
    for ch, hv, ne, carry in inputs:
        want.append((S.fs_totals_plain(ch, hv, ne, 7),))
        want.append(S.fused_segment_scans_carry_plain(ch, hv, ne, 7, carry,
                                                      1))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()                              # sizes this stream's scratch
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = calls()
    for r in range(20):
        graph.replay()
        torch.cuda.synchronize()
        for o, w in zip(outs, want):
            for g, x in zip(o, w):
                assert torch.equal(g, x), r


@pytest.mark.cuda
def test_eight_streams_at_once(cuda_device):
    """8 streams launching look-back calls at once, with no sync between
    them: each has its own scratch."""
    streams = [torch.cuda.Stream() for _ in range(8)]
    jobs = []
    for i, st in enumerate(streams):
        D, n = ((None, 1_000_003 + i) if i % 2 else (6, 50_000 + 16 * i))
        ch, hv = _form_inputs(D, n, 0, 80 + i, cuda_device)
        ne = (n - i if D is None else torch.full(
            (D,), n - i, dtype=torch.int32, device=cuda_device))
        carry = _carry(D, 1, n, i, cuda_device)
        jobs.append((st, ch, hv, ne, carry))
    torch.cuda.synchronize()
    outs = []
    for st, ch, hv, ne, carry in jobs:
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append([S.fs_totals(ch, hv, ne, 1)]
                        + list(S.fused_segment_scans_carry(ch, hv, ne, 1,
                                                           carry, 1))
                        + list(S.fused_segment_scans(ch, hv, ne, 1)))
    torch.cuda.synchronize()
    for (st, ch, hv, ne, carry), out in zip(jobs, outs):
        want = ([S.fs_totals_plain(ch, hv, ne, 1)]
                + list(S.fused_segment_scans_carry_plain(ch, hv, ne, 1,
                                                         carry, 1))
                + list(S.fused_segment_scans_plain(ch, hv, ne, 1)))
        for g, w in zip(out, want):
            assert torch.equal(g, w)
    keys = {k for k in S._SCRATCH.buffers
            if k[1] in {s.cuda_stream for s in streams} and k[2] == "fs"}
    assert len(keys) == len({s.cuda_stream for s in streams})


@pytest.mark.cuda
@pytest.mark.parametrize("D,n", [(None, 96), (None, 5000), (None, 100_003),
                                 (500, 192), (7, 1025), (3, 20_000)])
def test_each_call_is_one_kernel_and_no_memset(cuda_device, D, n):
    """Every call of the four wrappers runs exactly one device operation,
    its kernel: no memset, no fill, no copy (int counts by value, the
    scratch persistent). multi_scan runs on (D or 6, n): the warp, block
    and look-back forms among the cases."""
    from torch.profiler import ProfilerActivity, profile
    ch, hv = _form_inputs(D, n, 0, 3, cuda_device)
    ne = (n - 5 if D is None else torch.full(
        (D,), n - 5, dtype=torch.int32, device=cuda_device))
    carry = _carry(D, 2, n, 3, cuda_device)
    x = torch.from_numpy(_channels(D or 6, n, seed=n)).to(cuda_device)
    for fn, kernel in (
            (lambda: S.fs_totals(ch, hv, ne, 0), "fs_totals"),
            (lambda: S.fused_segment_scans_carry(ch, hv, ne, 0, carry, 2),
             "fs_scan"),
            (lambda: S.fused_segment_scans(ch, hv, ne, 0), "fs_scan"),
            (lambda: S.multi_scan(x), "ms_scan")):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(ops) == 1 and kernel in ops[0], ops


# ------------------------------------------------------ multi_scan's forms

#: multi_scan row lengths on each form edge (warp <= 1,024 < block <=
#: 8,192 < look-back) and inside the warp form's first round
MS_EDGES = [1, 31, 32, 33, 1023, 1024, 1025, 8191, 8192, 8193]


@pytest.mark.parametrize("n", MS_EDGES)
@pytest.mark.parametrize("rows", [1, 7, 8, 9])
def test_ms_geometry_at_the_form_boundaries(n, rows):
    """The host's form choice for multi_scan: a warp a row up to 1,024
    columns, a block a row up to 8,192, then the look-back over tiles,
    the only form with a scratch (one status word a tile, no counters)."""
    g = S.ms_geometry(rows, n)
    form = "warp" if n <= 1024 else ("block" if n <= 8192 else "lookback")
    assert S.FORMS[g.form] == form
    words = rows * -(-n // S.MS_TILE) if form == "lookback" else 0
    assert (g.counters, g.words) == (0, words)


def test_ms_geometry_refuses_empty_launches_and_follows_the_library():
    """No launch of no rows or no columns; a variant build with another
    tile or warp row moves the edges with it."""
    for bad in ((0, 10), (3, 0), (-1, 5)):
        with pytest.raises(ValueError, match="no multi_scan launch"):
            S.ms_geometry(*bad)
    assert S.FORMS[S.ms_geometry(2, 3000, 2048, 256).form] == "lookback"
    assert S.FORMS[S.ms_geometry(2, 2000, 2048, 256).form] == "block"
    assert S.FORMS[S.ms_geometry(2, 256, 2048, 256).form] == "warp"
    assert S.ms_geometry(2, 3000, 2048, 256).words == 4


def test_scratch_cache_keeps_the_families_apart(monkeypatch):
    """multi_scan and the segment scans on one stream: each family gets a
    buffer of its own (they tag status words differently), growing one
    leaves the other in place, and a form without look-back takes no
    scratch and allocates nothing."""
    alloc = _FakeAlloc()
    monkeypatch.setattr(S, "_SCRATCH",
                        S.ScratchCache(alloc, capturing=lambda: False))
    dev = torch.device("cuda", 0)
    fs = S._scratch_entry("fs", dev, 111,
                          S.fs_geometry("fs_scan", 1, 100_003))
    ms = S._scratch_entry("multi_scan", dev, 111,
                          S.ms_geometry(6, 100_003))
    assert fs[0] is not ms[0] and fs[3] != ms[3]
    assert ms[1:3] == (0, 128)              # 6 x 13 tiles, to a power of 2
    assert fs[1:3] == (0, 128)              # 13 tiles x 6 words
    assert S._scratch_entry("multi_scan", dev, 111,
                            S.ms_geometry(3, 20_000)) is ms    # fits
    ms2 = S._scratch_entry("multi_scan", dev, 111,
                           S.ms_geometry(6, 6_291_456))        # grows
    assert ms2[1:3] == (0, 8192) and S._SCRATCH.retired == [ms[0]]
    assert S._SCRATCH.buffers[(0, 111, "fs")] is fs
    for geo in (S.ms_geometry(6, 256), S.ms_geometry(6, 8192),
                S.fs_geometry("fs_totals", 500, 192)):
        assert S._scratch_entry("multi_scan", dev, 111, geo) == \
            S._NO_SCRATCH
    assert len(alloc.calls) == 3
    assert {k[2] for k in S._SCRATCH.buffers} == {"fs", "multi_scan"}


def _ms_input(K, N, lead, seed, device, low=-7, high=8):
    """A seeded int32 (K, N) view `lead` int32 into a longer tensor."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(low, high, K * N + lead).astype(np.int32)
    return torch.from_numpy(buf).to(device)[lead:].view(K, N)


@pytest.mark.cuda
@pytest.mark.parametrize("n", MS_EDGES)
@pytest.mark.parametrize("K", [1, 7, 8, 9])
@pytest.mark.parametrize("lead", [0, 1])
def test_multi_scan_forms_bit_exact_at_the_edges(cuda_device, n, K, lead):
    """Each form at its edges, on aligned views and views 4 bytes off 16
    (the scalar path), K rows around the warp form's 8 rows a block:
    bit-exact, one launch at its shape, the host's form the library's."""
    x = _ms_input(K, n, lead, n * 10 + K + lead, cuda_device)
    assert (x.data_ptr() % 16 != 0) == bool(lead)
    lib = S.load()
    assert lib.amt_ms_form(n) == S.ms_geometry(K, n).form
    S.reset_launches()
    got = S.multi_scan(x)
    torch.cuda.synchronize()
    assert S.launch_shapes["multi_scan"] == {(K, n): 1}
    assert torch.equal(got, S.multi_scan_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("K,n", [(6, 256), (5, 1), (6, 5000), (2, 33),
                                 (6, 100_003)])
def test_multi_scan_wraps_around_like_cumsum(cuda_device, K, n):
    """Values near the int32 limits, every other row negative: the sums
    wrap, in every form, as torch.cumsum(..., dtype=torch.int32) does."""
    x = _ms_input(K, n, 0, n + K, cuda_device, 2**30, 2**31 - 1)
    x[1::2] = -x[1::2]
    got = S.multi_scan(x)
    want = S.multi_scan_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    wide = x.long().cumsum(1)
    assert n == 1 or not torch.equal(want.long(), wide)   # it did wrap
    assert torch.equal(want.long(), (wide + 2**31) % 2**32 - 2**31)


@pytest.mark.cuda
def test_multi_scan_epoch_wrap_clears_stale_words(cuda_device):
    """The launch that takes the last tag (2^31 - 1) clears every status
    word and restarts the epoch at 0: planted words published under tag 1
    are gone before the next launch, tagged 1, could read them."""
    x = _ms_input(6, 100_003, 0, 7, cuda_device)
    want = S.multi_scan_plain(x)
    assert torch.equal(S.multi_scan(x), want)
    torch.cuda.synchronize()
    key = (cuda_device.index or 0, S._stream_handle(x.device), "multi_scan")
    buf = S._SCRATCH.buffers[key][0]
    hdr = int(buf[0])
    assert hdr & 0xFFFFFFFF == 0 and hdr >> 32 >= 1     # ticket 0, epoch on
    buf[0] = 0x7FFFFFFE << 32                # the next launch's tag is last
    buf[2:] = (1 << 33) | (1 << 32) | 5      # prefixes of tag 1, value 5
    assert torch.equal(S.multi_scan(x), want)
    torch.cuda.synchronize()
    assert int(buf[0]) == 0 and not buf[2:].any()
    assert torch.equal(S.multi_scan(x), want)           # tag 1
    assert int(buf[0]) == 1 << 32


def _ms_fs_cases(device, count, seed):
    """`count` calls, alternating multi_scan and fs_scan look-back calls
    with short-row calls of both: (thunk, want) pairs."""
    ms_shapes = [(6, 100_003), (6, 256), (3, 8193), (6, 20_000), (1000, 512),
                 (6, 8192)]
    fs_shapes = [(None, 100_003), (3, 3 * 8192 + 5), (500, 192),
                 (None, 9000)]
    cases = []
    for i in range(count):
        if i % 2 == 0:
            K, n = ms_shapes[(i // 2) % len(ms_shapes)]
            x = _ms_input(K, n, (i // 2) % 2, seed + i, device)
            cases.append((lambda x=x: (S.multi_scan(x),),
                          (S.multi_scan_plain(x),)))
        else:
            D, n = fs_shapes[(i // 2) % len(fs_shapes)]
            ch, hv = _form_inputs(D, n, 0, seed + i, device)
            ne = (n - i if D is None else torch.full(
                (D,), n - i, dtype=torch.int32, device=device))
            cases.append((lambda ch=ch, hv=hv, ne=ne:
                          S.fused_segment_scans(ch, hv, ne, 1),
                          S.fused_segment_scans_plain(ch, hv, ne, 1)))
    return cases


@pytest.mark.cuda
def test_multi_scan_and_segment_scans_interleaved_on_one_stream(
        cuda_device):
    """50 calls on one stream, no sync between them: multi_scan look-back
    launches between fs_scan look-back launches (a commit's expansion and
    its self-contained read), short rows of both among them. Each family's
    epoch and ticket carry every call right."""
    cases = _ms_fs_cases(cuda_device, 50, 300)
    outs = [fn() for fn, _ in cases]
    torch.cuda.synchronize()
    for i, (out, (_, want)) in enumerate(zip(outs, cases)):
        for g, w in zip(out, want):
            assert torch.equal(g, w), i


@pytest.mark.cuda
def test_replayed_graph_of_both_families_stays_bit_exact(cuda_device):
    """A CUDA graph of 10 calls, multi_scan and fs_scan alternating in
    every form, captured after one warm-up on its stream, replayed 20
    times: every replay bit-exact."""
    cases = _ms_fs_cases(cuda_device, 10, 500)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn, _ in cases:
            fn()                            # sizes this stream's scratch
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [fn() for fn, _ in cases]
    for r in range(20):
        graph.replay()
        torch.cuda.synchronize()
        for out, (_, want) in zip(outs, cases):
            for g, w in zip(out, want):
                assert torch.equal(g, w), r


@pytest.mark.cuda
def test_multi_scan_eight_streams_at_once(cuda_device):
    """8 streams launching multi_scan look-back and short-row calls at
    once, with no sync between them: each stream has its own buffer and
    its own ticket."""
    streams = [torch.cuda.Stream() for _ in range(8)]
    xs = [_ms_input(6, 1_000_003 + i if i % 2 else 256, 0, 900 + i,
                    cuda_device) for i in range(8)]
    big = [_ms_input(6, 50_000 + 16 * i, 0, 950 + i, cuda_device)
           for i in range(8)]
    torch.cuda.synchronize()
    outs = []
    for st, x, y in zip(streams, xs, big):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append((S.multi_scan(x), S.multi_scan(y), S.multi_scan(x)))
    torch.cuda.synchronize()
    for (a, b, c), x, y in zip(outs, xs, big):
        want = S.multi_scan_plain(x)
        assert torch.equal(a, want) and torch.equal(c, want)
        assert torch.equal(b, S.multi_scan_plain(y))
    handles = {s.cuda_stream for s in streams}
    keys = {k for k in S._SCRATCH.buffers
            if k[1] in handles and k[2] == "multi_scan"}
    assert len(keys) == len(handles)


@pytest.mark.parametrize("w", [96, 1023, 1024, 1025, 8191, 8192, 8193])
def test_sharded_rows_at_the_form_boundaries_match_jax(w):
    """Rows whose per-shard length w sits on each form boundary: (2, 4 w)
    over a (2, 4) mesh of virtual CPU shards (one row of w slots a shard),
    random per-row counts, against the JAX package's sharded scan of each
    row over 4 elem shards of its 8-device virtual CPU mesh."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh of conftest.py")
    rng = np.random.default_rng(w)
    C = 4 * w
    chain, has = _row_columns(2, C, seed=w)
    n = rng.integers(C // 2, C + 1, 2).astype(np.int32)
    mesh = TM.make_mesh(8, devices=[torch.device("cpu")] * 8)
    got = S.sharded_fused_scans(mesh, torch.from_numpy(chain),
                                torch.from_numpy(has), torch.from_numpy(n))
    assert all(g.blocks[(0, 0)].shape == (1, w) for g in got)
    got = [np.asarray(g) for g in got]
    jmesh = JM.make_mesh(4, 1)
    for d in range(2):
        want = P.sharded_fused_scans(jmesh, jnp.asarray(chain[d]),
                                     jnp.asarray(has[d]), int(n[d]),
                                     interpret=True)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g[d], np.asarray(x))
