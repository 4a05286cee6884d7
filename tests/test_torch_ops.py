"""Parity of the port's device math (glc_tpu_torch.ops) with the JAX
package's (glc_tpu.ops), on the CPU: tables, rounding, masking thresholds
and the whole per-frame encode math."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glc_tpu.ops import encode as jenc
from glc_tpu.ops import mdct as jmdct
from glc_tpu.ops import psycho as jpsy
from glc_tpu_torch.codec.tables import tables_from_numpy
from glc_tpu_torch.ops import encode as tenc
from glc_tpu_torch.ops import mdct as tmdct
from glc_tpu_torch.ops import psycho as tpsy

sys.path.insert(0, "tests")
from utils import generate_sine_wave, generate_white_noise  # noqa: E402

N, FRAME, RATE = 1024, 2048, 44100
# The pair contract: keep-gate or ±1 flips on at most 1% of kept positions.
# The JAX package recorded 0.19% between its TPU and CPU runs.
MAX_FLIP_RATE = 0.01


@pytest.mark.parametrize("n,frame", [(1024, 2048), (256, 512)])
def test_mdct_tables_bit_identical(n, frame):
    a, b = jmdct.get_mdct_tables(n, frame), tmdct.get_mdct_tables(n, frame)
    assert a.cos_table.dtype == b.cos_table.dtype == np.float32
    assert np.array_equal(a.cos_table, b.cos_table)
    assert np.array_equal(a.window, b.window)
    assert a.norm == b.norm and a.norm.dtype == b.norm.dtype


@pytest.mark.parametrize("rate", [44100, 48000, 22050])
def test_perceptual_tables_bit_identical(rate):
    a, b = jpsy.get_perceptual_tables(N, rate), tpsy.get_perceptual_tables(N, rate)
    for name in ("weights", "band_edges", "band_mask", "band_inv_count",
                 "band_pf", "band_of", "inv_w"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert np.array_equal(x, y), name


def _round_cases():
    below_half = np.nextafter(np.float32(0.5), np.float32(0.0))
    base = np.array(
        [0.5, 1.5, 2.5, 3.5, 0.49999997, below_half, 1.0 - 2 ** -24,
         2 ** 22 + 0.5, 32767.5, 0.0, 1e-30, 123.456],
        np.float32,
    )
    rng = np.random.default_rng(3)
    rand = (rng.standard_normal(4096) * 300).astype(np.float32)
    ties = (rng.integers(-5000, 5000, 512) + 0.5).astype(np.float32)
    return np.concatenate([base, -base, rand, ties])


def test_round_half_away_exact():
    x = _round_cases()
    want = np.asarray(jenc.round_half_away(jnp.asarray(x)))
    got = tenc.round_half_away(torch.from_numpy(x)).numpy()
    assert np.array_equal(want, got)
    # ties go away from zero, and one ulp below .5 goes to zero
    assert got[0] == 1.0 and got[2] == 3.0 and got[5] == 0.0
    # torch.round is half-to-even, which is why the port does not use it
    assert torch.round(torch.tensor(2.5)).item() == 2.0


def _torch_tables():
    mt = jmdct.get_mdct_tables(N, FRAME)
    pt = jpsy.get_perceptual_tables(N, RATE)
    return tables_from_numpy(
        mt.cos_table, mt.window, mt.norm, pt.band_mask, pt.band_inv_count,
        pt.band_pf, pt.band_of, pt.inv_w, "cpu",
    )


def test_masking_thresholds_match():
    pt = jpsy.get_perceptual_tables(N, RATE)
    tb = _torch_tables()
    rng = np.random.default_rng(5)
    coeffs = (rng.standard_normal((64, 2, N)) * 0.05).astype(np.float32)
    gmax = np.maximum(np.abs(coeffs).max(-1, keepdims=True), np.float32(1e-10))
    for quality in (0.7, 0.3, 0.995):
        want = np.asarray(jpsy.masking_thresholds(
            coeffs, gmax, pt.band_mask, pt.band_inv_count, pt.band_pf,
            pt.band_of, pt.inv_w, quality))
        got = tpsy.masking_thresholds(
            torch.from_numpy(coeffs), torch.from_numpy(gmax), tb.band_mask,
            tb.band_inv_count, tb.band_pf, tb.band_of, tb.inv_w,
            quality).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _blocks_from_pcm(x: np.ndarray, frames: int) -> np.ndarray:
    """[frames, 1, 2n] 50%-overlap blocks of a mono signal."""
    idx = np.arange(frames)[:, None] * N + np.arange(FRAME)[None, :]
    return x[idx][:, None, :].astype(np.float32)


def _block_sets():
    import __graft_entry__

    _fwd, (example,) = __graft_entry__.entry()
    sine = _blocks_from_pcm(generate_sine_wave(440.0, RATE, 1, 1.5), 60)
    noise = _blocks_from_pcm(generate_white_noise(RATE, 1, 1.0, 7), 40)
    return {"graft_entry": example, "sine": sine, "white_noise": noise}


@pytest.fixture(scope="module")
def encode_results():
    """(blocks, JAX encode_math outputs) per block set, computed once."""
    mt = jmdct.get_mdct_tables(N, FRAME)
    pt = jpsy.get_perceptual_tables(N, RATE)
    jtabs = (mt.cos_table, mt.window, np.float32(mt.norm), pt.band_mask,
             pt.band_inv_count, pt.band_pf, pt.band_of, pt.inv_w)
    fn = jax.jit(lambda b: jenc.encode_math(b, *jtabs))
    return {name: (blocks, [np.asarray(o) for o in fn(blocks)])
            for name, blocks in _block_sets().items()}


def q_flips(qa: np.ndarray, qb: np.ndarray):
    """(gate flips, ±1 flips, kept positions, max |dq| where both kept)."""
    ka, kb = qa != 0, qb != 0
    both = ka & kb
    dq = np.abs(qa.astype(np.int32) - qb.astype(np.int32))[both]
    return (int(np.count_nonzero(ka != kb)), int(np.count_nonzero(dq == 1)),
            int(np.count_nonzero(ka | kb)), int(dq.max(initial=0)))


@pytest.mark.parametrize("name", ["graft_entry", "sine", "white_noise"])
def test_encode_math_matches(encode_results, name):
    blocks, (q_j, nnz_j, scale_j, raw_j, use_raw_j) = encode_results[name]
    tb = _torch_tables()
    q_t, nnz_t, scale_t, raw_t, use_raw_t = (
        t.numpy() for t in tenc.encode_math(
            torch.from_numpy(blocks), tb.cos_table, tb.window, tb.norm,
            tb.band_mask, tb.band_inv_count, tb.band_pf, tb.band_of,
            tb.inv_w))
    assert q_t.dtype == np.int16 and q_t.shape == q_j.shape
    np.testing.assert_allclose(scale_t, scale_j, rtol=1e-6, atol=0)
    assert np.array_equal(raw_t, raw_j)
    assert np.array_equal(use_raw_t, use_raw_j)
    gate, pm1, kept, max_dq = q_flips(q_j, q_t)
    rate = (gate + pm1) / max(kept, 1)
    print(f"{name}: {gate} keep-gate + {pm1} +-1 flips of {kept} kept "
          f"(rate {rate:.4%})")
    assert max_dq <= 1
    assert rate <= MAX_FLIP_RATE
    assert np.array_equal(nnz_t, (q_t != 0).sum(-1))
