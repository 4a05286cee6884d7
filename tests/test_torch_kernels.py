"""The port's IMDCT+window kernel wrapper (glc_tpu_torch.ops.kernels) against
the JAX package's Pallas kernel (glc_tpu.ops.pallas_kernels.imdct_fused,
run in interpret mode as tests/test_pallas.py runs it).

On the CPU the wrapper computes its plain version.  The test marked
`cuda` runs the hand-written kernel and needs a card: it skips here.  On
the card's machine, which has no JAX, run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

(`--noconftest`, because tests/conftest.py imports JAX; this module imports
the JAX package only inside the fixture that the CPU tests use).
"""

import numpy as np
import pytest
import torch

import glc_tpu_torch  # noqa: F401  (full-f32 matmul settings)
from glc_tpu_torch.codec.tables import get_codec_tables
from glc_tpu_torch.ops import kernels
from glc_tpu_torch.ops.kernels import imdct_window, imdct_window_reference

N = 1024
TOL = 2e-5  # the bar of tests/test_pallas.py


@pytest.fixture(scope="module")
def mdct():
    from glc_tpu.ops.mdct import get_mdct_tables

    return get_mdct_tables(N, 2 * N)


def _coeffs(B: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N)) * 0.1).astype(np.float32)


def _torch_args(coeffs, t):
    return (torch.from_numpy(coeffs), torch.from_numpy(t.cos_table),
            torch.from_numpy(t.window), float(t.norm))


def test_cpu_matches_pallas_kernel(mdct):
    from glc_tpu.ops.pallas_kernels import imdct_fused

    coeffs = _coeffs(256)
    want = np.asarray(imdct_fused(
        coeffs, mdct.cos_table, mdct.window, np.float32(mdct.norm),
        tile_b=256, interpret=True,
    ))
    before = imdct_window.launches
    got = imdct_window(*_torch_args(coeffs, mdct))
    assert got.dtype == torch.float32 and got.shape == (256, 2 * N)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert imdct_window.launches == before  # the plain version is no launch


def test_cpu_accepts_ragged_batch(mdct):
    """B=100 is no multiple of the TPU's 128-row tile; the port takes it."""
    from glc_tpu.ops.mdct import imdct

    coeffs = _coeffs(100, seed=2)
    want = np.asarray(imdct(coeffs, mdct.cos_table, mdct.norm)) * mdct.window
    got = imdct_window(*_torch_args(coeffs, mdct)).numpy()
    assert got.shape == (100, 2 * N)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_reference_keeps_rounding_order(mdct):
    """(acc * norm) * window, never acc * (norm * window)."""
    c, table, window, norm = _torch_args(_coeffs(8, seed=4), mdct)
    acc = torch.matmul(c, table)
    want = (acc * np.float32(norm)) * window
    assert torch.equal(imdct_window_reference(c, table, window, norm), want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2816, 1000, 1])
def test_cuda_kernel_matches_plain(cuda_device, B):
    tables = get_codec_tables(N, 2 * N, 44100, cuda_device)
    coeffs = torch.from_numpy(_coeffs(B, seed=B)).to(cuda_device)
    args = (coeffs, tables.cos_table, tables.window, tables.norm_value)
    before = imdct_window.launches
    out = imdct_window(*args)
    assert imdct_window.launches == before + 1
    ref = imdct_window_reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    tables = get_codec_tables(N, 2 * N, 44100, cuda_device)
    good = torch.zeros((4, N), device=cuda_device)
    bad = [
        good.double(),                                      # dtype
        torch.zeros((4, N + 64), device=cuda_device),       # shape vs table
        torch.zeros((N, 4), device=cuda_device).T,          # not contiguous
    ]
    for coeffs in bad:
        with pytest.raises((TypeError, ValueError)):
            imdct_window(coeffs, tables.cos_table, tables.window,
                         tables.norm_value)
    with pytest.raises(ValueError):  # table off the card
        imdct_window(good, tables.cos_table.cpu(), tables.window,
                     tables.norm_value)
    assert kernels.load_library() is kernels.load_library()
