"""The port's IMDCT+window kernel wrapper (glc_tpu_torch.ops.kernels) against
the JAX package's Pallas kernel (glc_tpu.ops.pallas_kernels.imdct_fused,
run in interpret mode as tests/test_pallas.py runs it).

On the CPU the wrapper computes its plain version; the 3xTF32 arithmetic
of the kernel is held to the same bars through `split_tf32` and a CPU
emulation of its three products.  The tests marked `cuda` run the
hand-written kernel and need a card: they skip here.  On the card's
machine, which has no JAX, run them with

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
from glc_tpu_torch.ops.kernels import (
    imdct_window, imdct_window_reference, split_tf32, table_split,
)

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


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("x, want", [
    (0x3F801000, 0x3F802000),  # tie above an even kept part: away, not even
    (0xBF801000, 0xBF802000),  # the same, negative
    (0x3F803000, 0x3F804000),  # tie above an odd kept part
    (0x3F800FFF, 0x3F800000),  # just below the tie
    (0xBF801001, 0xBF802000),  # just above it, negative
    (0x3F7FF000, 0x3F800000),  # the carry runs into the exponent
], ids=lambda v: f"{v:08X}")
def test_split_tf32_rounds_to_nearest_ties_away(x, want):
    t = torch.from_numpy(np.array([x], np.uint32).view(np.float32))
    hi, lo = split_tf32(t)
    assert _bits(hi)[0] == want
    assert not (_bits(lo) & 0x1FFF).any()
    assert abs(t.item() - hi.item() - lo.item()) <= 2.0 ** -22 * abs(t.item())


def test_split_tf32_halves_are_tf32_and_sum_to_x(mdct):
    x = torch.from_numpy(np.ascontiguousarray(mdct.cos_table))
    hi, lo = split_tf32(x)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    x64 = x.double()
    resid = (x64 - hi.double() - lo.double()).abs()
    assert (resid <= 2.0 ** -22 * x64.abs()).all()
    assert resid.max().item() > 0  # lo*lo really is dropped somewhere


def _emulate_3xtf32(coeffs, table, window, norm):
    """The kernel's arithmetic on the CPU: a_hi*b_lo + a_lo*b_hi + a_hi*b_hi
    as f32 products of the split halves, then (acc * norm) * window."""
    a_hi, a_lo = split_tf32(coeffs)
    b_hi, b_lo = split_tf32(table)
    acc = a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi
    return (acc * np.float32(norm)) * window


def test_3xtf32_emulation_matches_pallas_kernel(mdct):
    from glc_tpu.ops.pallas_kernels import imdct_fused

    coeffs = _coeffs(256)
    want = np.asarray(imdct_fused(
        coeffs, mdct.cos_table, mdct.window, np.float32(mdct.norm),
        tile_b=256, interpret=True,
    ))
    got = _emulate_3xtf32(*_torch_args(coeffs, mdct))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_3xtf32_emulation_error_within_twice_plain(mdct):
    args = _torch_args(_coeffs(256, seed=5), mdct)
    c, table, window, norm = args
    exact = ((c.double() @ table.double()) * norm) * window.double()
    err_emul = (_emulate_3xtf32(*args).double() - exact).abs().max().item()
    err_plain = (imdct_window_reference(*args).double() - exact).abs().max().item()
    assert err_emul <= 2 * err_plain


def test_table_split_is_made_once_per_table(mdct):
    table = torch.from_numpy(np.ascontiguousarray(mdct.cos_table))
    before = table_split.splits
    hi, lo = table_split(table)
    assert hi.shape == lo.shape == (2 * N, N) and hi.is_contiguous()
    assert torch.equal(hi, split_tf32(table.T.contiguous())[0])
    again = table_split(table)
    assert again[0] is hi and again[1] is lo
    assert table_split.splits == before + 1
    table.mul_(1.0)  # an in-place change re-splits
    table_split(table)
    assert table_split.splits == before + 2


def test_library_name_covers_flags_and_every_source(monkeypatch, tmp_path):
    base = kernels.library_path()
    assert base == kernels.library_path()
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ["-lcuda"])
    assert kernels.library_path() != base
    monkeypatch.undo()
    for f in kernels.CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC_DIR", tmp_path)
    assert kernels.library_path() == base
    (tmp_path / "extra.cuh").write_text("// a new header\n")
    assert kernels.library_path() != base


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 63, 64, 65, 127, 128, 129, 1000, 2816])
def test_cuda_kernel_matches_plain(cuda_device, B):
    """Every edge of the 128-row tile, and the decode's 2816 rows."""
    tables = get_codec_tables(N, 2 * N, 44100, cuda_device)
    coeffs = torch.from_numpy(_coeffs(B, seed=B)).to(cuda_device)
    args = (coeffs, tables.cos_table, tables.window, tables.norm_value)
    before = imdct_window.launches
    out = imdct_window(*args)
    assert imdct_window.launches == before + 1
    ref = imdct_window_reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
    exact = ((coeffs.double() @ tables.cos_table.double())
             * tables.norm_value) * tables.window.double()
    err_kernel = (out.double() - exact).abs().max().item()
    err_plain = (ref.double() - exact).abs().max().item()
    assert err_kernel <= 2 * err_plain


@pytest.mark.cuda
def test_cuda_second_launch_does_not_split_again(cuda_device):
    tables = get_codec_tables(N, 2 * N, 44100, cuda_device)
    coeffs = torch.from_numpy(_coeffs(64)).to(cuda_device)
    args = (coeffs, tables.cos_table, tables.window, tables.norm_value)
    before = table_split.splits
    first = imdct_window(*args)
    assert table_split.splits == before + 1
    second = imdct_window(*args)
    assert table_split.splits == before + 1
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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
