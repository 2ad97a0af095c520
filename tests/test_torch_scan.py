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


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    S.reset_launches()
    x = torch.from_numpy(_channels(6, 100, seed=1))
    assert torch.equal(S.multi_scan(x), S.multi_scan_plain(x))
    chain, has = _columns(100, seed=2)
    S.fused_segment_scans(torch.from_numpy(chain), torch.from_numpy(has), 50)
    assert S.launches == {"multi_scan": 0, "fused_segment_scans": 0}


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
