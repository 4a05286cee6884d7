"""The encode's two kernels (glc_tpu_torch.ops.kernels.mdct_rows and
band_energy) against the JAX package's einsums, and the encode's
independence of how the frames are cut into segments, on both packages.

`mdct_rows` replaces the XLA einsum of glc_tpu/ops/mdct.py:67 and
`band_energy` the one of glc_tpu/ops/psycho.py:155.  On the CPU each
wrapper computes its plain version, and the CPU encode runs its products
in fixed row blocks (ops/mdct.py::fixed_rows_matmul); the tests here hold
the plain versions to the JAX package, a numpy model of band_energy's
arithmetic (`band_energy_model`: 33-bin compensated items folded in
order) to the plain version, to float64 and to the earlier in-order sum,
its plan (`band_plan`), its NaN and +Inf bands on rows with non-finite
squares to the plain version's and the JAX einsum's, mdct_rows' tile
plans (`mdct_rows_plan`: every row and column covered once, within the
launch limits, the card filled from 646 rows), the wrappers' input
checks, and tests/test_chunking.py's encode cases on both packages.
Bounds, each with its reason:
- mdct_rows_reference against the JAX mdct: atol = rtol = 2e-5, the bar of
  tests/test_pallas.py (both are full-f32 products, summed in other
  orders);
- band_energy_reference against the JAX einsum: rtol 1e-5 (sums of
  squares are positive, so no cancellation), and the model against the
  plain version the same; the model's error against float64 no more than
  twice plain's;
- the model against the in-order sum: bits equal on bands of <= 33 bins,
  rtol 4 * 2**-24 on the wider ones (compensated sums in another order);
  the kernel against the model: bits equal;
- the port's container against itself at other segment sizes: bytes
  equal; against the JAX package's: the pair contract (parity.py).

The tests marked `cuda` run the kernels and need a card: they skip here.
On the card's machine, which has no JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_encode_kernels.py

(this module imports the JAX package only inside the tests that use it).
"""

import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from utils import (  # noqa: E402
    generate_frequency_sweep, generate_sine_wave, generate_white_noise,
)

import glc_tpu_torch  # noqa: E402,F401  (full-f32 matmul settings)
from glc_tpu_torch import DEFAULT_CONFIG, Encoder, serialize_encoded  # noqa: E402
from glc_tpu_torch.codec.tables import get_codec_tables  # noqa: E402
from glc_tpu_torch.ops import kernels  # noqa: E402
from glc_tpu_torch.ops.kernels import (  # noqa: E402
    MdctPlan, band_energy, band_energy_reference, band_plan, cos_split,
    mdct_rows, mdct_rows_reference, mdct_unit, row_pitch, split_tf32,
    table_split,
)
from glc_tpu_torch.parity import check_containers  # noqa: E402

N, FRAME, RATE = 1024, 2048, 44100
TOL = 2e-5
ROWS = [1, 63, 129, 1292]
EDGES = [1, 63, 64, 65, 127, 128, 129, 1000, 8192]
CHUNKS = [4096, 512, 1000]  # tests/test_chunking.py's two, and a ragged one
# n (the hop size) the kernels take besides 1024: the f64 path's (1, 8,
# 120, 128, 256 and 441, 10 ms at 44.1 kHz), both sides of its cut (456,
# 457, kernels._F64_MAX_N) and of the parent's small tile hops (256, 257),
# 20 ms at 48 kHz (960), ragged column and k tails (496: an odd k-tile
# count, 500, 735: odd, 1000), and the wide ones
GEOMETRY_NS = [1, 8, 120, 128, 256, 257, 441, 456, 457, 496, 500, 735, 960,
               1000, 4096, 8192]
GEOMETRY_ROWS = [1, 63, 64, 65, 646, 1292, 8192]


@pytest.fixture(scope="module")
def tables():
    return get_codec_tables(N, FRAME, RATE, "cpu")


def _win(M: int, tb, seed: int = 0) -> torch.Tensor:
    """Windowed blocks [M, 2n]: seeded normal samples times the window."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, FRAME)) * 0.1).astype(np.float32)
    return torch.from_numpy(x) * tb.window.cpu()


def _coeffs(M: int, seed: int = 1) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((M, N)) * 0.05)
                            .astype(np.float32))


# --- the plain versions against the JAX package ---

@pytest.mark.parametrize("M", ROWS)
def test_mdct_rows_reference_matches_jax_mdct(tables, M):
    from glc_tpu.ops.mdct import get_mdct_tables, mdct

    mt = get_mdct_tables(N, FRAME)
    win = _win(M, tables, seed=M)
    want = np.asarray(mdct(win.numpy(), mt.cos_table, mt.norm))
    got = mdct_rows_reference(win, tables.cos_table, tables.norm)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # the wrapper takes the plain version on the CPU, and launches nothing
    before = mdct_rows.launches
    assert torch.equal(mdct_rows(win, tables.cos_table, tables.norm), got)
    assert mdct_rows.launches == before


@pytest.mark.parametrize("M", ROWS)
def test_band_energy_reference_matches_jax_einsum(tables, M):
    import jax.numpy as jnp
    from jax.lax import Precision

    from glc_tpu.ops.psycho import get_perceptual_tables

    pt = get_perceptual_tables(N, RATE)
    c = _coeffs(M, seed=M)
    sq = c.numpy() * c.numpy()
    want = np.asarray(jnp.einsum("...n,bn->...b", sq, pt.band_mask,
                                 precision=Precision.HIGHEST))
    got = band_energy_reference(c, tables.band_mask)
    assert got.shape == (M, pt.band_mask.shape[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    before = band_energy.launches
    assert torch.equal(band_energy(c, tables.band_mask), got)
    assert band_energy.launches == before


# --- band_energy's arithmetic, modelled on the CPU ---

F32_MAX = np.finfo(np.float32).max


def _two_sum_add(s, err, x):
    """s + x == t + e exactly (TwoSum), in float32: returns (t, err + e)."""
    t = s + x
    xv = t - s
    e = (s - (t - xv)) + (x - xv)
    return t, err + e


def inorder_model(coeffs: np.ndarray, ranges: np.ndarray) -> np.ndarray:
    """The earlier band_energy kernel (one thread a band) in numpy float32:
    each band's squares added in ascending k, each square and add rounded on
    its own, the rounding error of each add found by TwoSum and summed
    beside it; the band is s + err.  The yardstick of the chunked sum."""
    f32 = np.float32
    out = np.zeros((coeffs.shape[0], len(ranges)), f32)
    with np.errstate(invalid="ignore", over="ignore"):
        for b, (lo, hi) in enumerate(ranges):
            s = np.zeros(coeffs.shape[0], f32)
            err = np.zeros(coeffs.shape[0], f32)
            for k in range(lo, hi):
                s, err = _two_sum_add(s, err, coeffs[:, k] * coeffs[:, k])
            out[:, b] = s + err
    return out


def band_energy_model(coeffs: np.ndarray, ranges: np.ndarray,
                      chunk: int = kernels.BAND_CHUNK) -> np.ndarray:
    """csrc/band_energy.cu in numpy float32, op for op: each band cut into
    items of `chunk` bins from its lo; an item the in-order compensated sum
    (s, e); a band's items folded in ascending order (E += e_i, then
    S += s_i by TwoSum, its error into E); the band S + E, or S where S is
    +Inf.  A row with a NaN or Inf square: a band is +Inf if every such
    square lies in it and none is NaN, else NaN."""
    f32 = np.float32
    M, n = coeffs.shape
    out = np.zeros((M, len(ranges)), f32)
    with np.errstate(invalid="ignore", over="ignore"):
        sq = coeffs * coeffs
        for b, (lo, hi) in enumerate(ranges):
            S = E = np.zeros(M, f32)
            for i, start in enumerate(range(lo, hi, chunk)):
                s = e = np.zeros(M, f32)
                for k in range(start, min(start + chunk, hi)):
                    s, e = _two_sum_add(s, e, sq[:, k])
                if i == 0:
                    S, E = s, e
                else:
                    S, E = _two_sum_add(S, E + e, s)
            out[:, b] = np.where(np.isinf(S), S, S + E)
        bad = ~(sq <= F32_MAX)
        rows = bad.any(axis=1)
        k = np.arange(n)
        bad_lo = np.where(bad, k, n).min(axis=1)[:, None]
        bad_hi = np.where(bad, k, -1).max(axis=1)[:, None]
        inside = (~np.isnan(sq).any(axis=1)[:, None]
                  & (bad_lo >= ranges[:, 0]) & (bad_hi < ranges[:, 1]))
        out[rows] = np.where(inside, np.inf, np.nan)[rows].astype(f32)
    return out


def _ranges(mask: torch.Tensor) -> np.ndarray:
    return band_plan(mask.cpu()).ranges


def test_band_ranges_are_the_band_edges(tables):
    from glc_tpu_torch.ops.psycho import get_perceptual_tables

    edges = get_perceptual_tables(N, RATE).band_edges
    plan = band_plan(tables.band_mask)
    r = plan.ranges
    assert r.dtype == np.int32 and r.shape == (tables.band_mask.shape[0], 2)
    nb = len(edges) - 1
    np.testing.assert_array_equal(r[:nb, 0], edges[:-1])
    np.testing.assert_array_equal(r[:nb, 1], edges[1:])
    assert not r[nb:].any()  # the padding bands are empty
    assert band_plan(tables.band_mask) is plan  # made once per mask


def test_band_ranges_refuse_a_split_band(tables):
    mask = tables.band_mask.clone()
    lo, hi = band_plan(mask).ranges[3].tolist()
    mask[3, (lo + hi) // 2] = 0.0
    with pytest.raises(ValueError, match="run of ones"):
        band_plan(mask)


def _check_model(c: torch.Tensor, mask: torch.Tensor) -> np.ndarray:
    """The model against plain (rtol 1e-5) and float64 (no more than
    twice plain's error); returns the model's sums."""
    model = band_energy_model(c.numpy(), _ranges(mask))
    plain = band_energy_reference(c, mask).numpy()
    np.testing.assert_allclose(model, plain, rtol=1e-5, atol=0)
    exact = (c.double() ** 2 @ mask.double().T).numpy()
    err_model = np.abs(model - exact).max()
    err_plain = np.abs(plain - exact).max()
    assert err_model <= 2 * err_plain
    return model


@pytest.mark.parametrize("M", [1, 129, 1292])
def test_band_energy_model_matches_plain_and_float64(tables, M):
    _check_model(_coeffs(M, seed=7 + M), tables.band_mask)


@pytest.mark.parametrize("M", [129, 1292])
def test_band_energy_model_matches_plain_and_float64_at_48khz(M):
    """The 48 kHz tables: 49 bands of <= 11 bins and a 683-bin top band."""
    tb = get_codec_tables(N, FRAME, 48000, "cpu")
    assert (np.diff(_ranges(tb.band_mask), axis=1).max()) == 683
    _check_model(_coeffs(M, seed=3 + M), tb.band_mask)


@pytest.mark.parametrize("rate", [44100, 48000])
def test_narrow_bands_keep_the_inorder_bits(rate):
    """A band of <= BAND_CHUNK bins is one item: the in-order sum, bit for
    bit (49 of the 50 bands); the wide top band within an ulp or so."""
    tb = get_codec_tables(N, FRAME, rate, "cpu")
    ranges = _ranges(tb.band_mask)
    c = _coeffs(257, seed=rate).numpy()
    model = band_energy_model(c, ranges)
    inorder = inorder_model(c, ranges)
    narrow = (ranges[:, 1] - ranges[:, 0]) <= kernels.BAND_CHUNK
    assert narrow.sum() == 49
    np.testing.assert_array_equal(model[:, narrow], inorder[:, narrow])
    np.testing.assert_allclose(model[:, ~narrow], inorder[:, ~narrow],
                               rtol=4 * 2.0 ** -24, atol=0)


def _synthetic_mask() -> torch.Tensor:
    """Bands of exactly W, W + 1 and n bins, an empty padding band, and a
    band that leaves bins 800-1023 out of every band but the n-bin one."""
    W = kernels.BAND_CHUNK
    mask = torch.zeros(5, N)
    for b, (lo, hi) in enumerate([(0, W), (W, 2 * W + 1), (0, N), (0, 0),
                                  (2 * W + 1, 800)]):
        mask[b, lo:hi] = 1.0
    return mask


def test_band_energy_model_on_a_synthetic_mask():
    W = kernels.BAND_CHUNK
    mask = _synthetic_mask()
    c = _coeffs(129, seed=11)
    model = _check_model(c, mask)
    inorder = inorder_model(c.numpy(), _ranges(mask))
    np.testing.assert_array_equal(model[:, 0], inorder[:, 0])  # W bins: one item
    assert not model[:, 3].any()  # the empty band
    plan = band_plan(mask)
    assert np.diff(plan.band_first).tolist() == [1, 2, -(-N // W), 0,
                                                 -(-(800 - 2 * W - 1) // W)]


@pytest.mark.parametrize("rate", [44100, 48000])
def test_band_plan_cuts_every_band_and_fills_the_lanes(rate):
    tb = get_codec_tables(N, FRAME, rate, "cpu")
    plan = band_plan(tb.band_mask)
    W = kernels.BAND_CHUNK
    want = [(k, min(k + W, hi)) for lo, hi in _ranges(tb.band_mask)
            for k in range(lo, hi, W)]
    assert [tuple(i) for i in plan.items] == want  # the bands cover every bin
    for b, (lo, hi) in enumerate(plan.ranges):
        its = plan.items[plan.band_first[b]:plan.band_first[b + 1]]
        assert (its[:, 0] == np.arange(lo, hi, W)).all() or lo == hi
    assert sorted(plan.order) == list(range(len(plan.items)))
    lens = plan.items[:, 1] - plan.items[:, 0]
    for lane in range(kernels.BAND_LANES):
        mine = plan.order[plan.lane_first[lane]:plan.lane_first[lane + 1]]
        assert plan.lane_bins[lane] == lens[mine].sum()
    # the lanes share the row's bins to within an item
    assert plan.lane_bins.max() <= -(-N // kernels.BAND_LANES) + W
    # the kernel's table: the same arrays, back to back
    table = plan.table.numpy()
    parts = [plan.items[:, 0], plan.items[:, 1], plan.order, plan.lane_first,
             plan.lane_bins, plan.band_first, plan.ranges[:, 0],
             plan.ranges[:, 1]]
    np.testing.assert_array_equal(table, np.concatenate(parts))
    assert table.dtype == np.int32


def test_band_plan_covers_the_bins_no_band_holds():
    """Bins outside every band get items of their own, after the bands'."""
    mask = torch.zeros(3, N)
    mask[0, 10:20] = 1.0
    mask[1, 100:200] = 1.0
    plan = band_plan(mask)
    assert plan.band_first[-1] == 1 + 4
    gaps = [tuple(i) for i in plan.items[plan.band_first[-1]:]]
    W = kernels.BAND_CHUNK
    want = [(0, 10)] + [(k, min(k + W, 100)) for k in range(20, 100, W)] + \
        [(k, min(k + W, N)) for k in range(200, N, W)]
    assert gaps == want


def test_band_plan_is_made_once_and_follows_an_edit(tables):
    mask = tables.band_mask.clone()
    before = band_plan.plans
    plan = band_plan(mask)
    assert band_plan(mask) is plan and band_plan.plans == before + 1
    mask[49, 1000:] = 0.0  # the top band ends at bin 1000 now
    edited = band_plan(mask)
    assert band_plan.plans == before + 2
    assert edited.ranges[49].tolist() == [371, 1000]
    assert edited.items[edited.band_first[50] - 1].tolist() == [998, 1000]
    assert band_plan(mask) is edited


def test_band_plan_refuses_too_many_items():
    mask = torch.zeros(kernels.BAND_MAX_ITEMS + 1, N)
    for b in range(kernels.BAND_MAX_ITEMS + 1):
        mask[b, b % N] = 1.0
    with pytest.raises(ValueError, match="work items"):
        band_plan(mask)


@pytest.mark.parametrize("rate", [44100, 48000])
@pytest.mark.parametrize("n", GEOMETRY_NS)
def test_band_plan_at_every_n(n, rate):
    """The plan of the codec's tables at any n: items within [0, n) that
    cover each bin once, cut from each band's lo, lanes that share the
    bins to within an item, and a table that one of the kernel's two
    builds holds."""
    from glc_tpu_torch.ops.psycho import get_perceptual_tables

    mask = torch.from_numpy(get_perceptual_tables(n, rate).band_mask)
    plan = band_plan(mask)
    items = plan.items
    assert (items[:, 0] >= 0).all() and (items[:, 1] <= n).all()
    assert (items[:, 1] > items[:, 0]).all()
    covered = np.zeros(n, np.int32)
    for lo, hi in items:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    W = kernels.BAND_CHUNK
    for b, (lo, hi) in enumerate(plan.ranges):
        its = items[plan.band_first[b]:plan.band_first[b + 1]]
        assert [tuple(i) for i in its] == [(k, min(k + W, hi))
                                           for k in range(lo, hi, W)]
    lens = items[:, 1] - items[:, 0]
    assert plan.lane_bins.sum() == n
    assert plan.lane_bins.max() <= -(-n // kernels.BAND_LANES) + W
    for lane in range(kernels.BAND_LANES):
        mine = plan.order[plan.lane_first[lane]:plan.lane_first[lane + 1]]
        assert plan.lane_bins[lane] == lens[mine].sum()
    assert any(len(items) <= its and plan.table.numel() <= ints
               for its, ints in kernels.BAND_BUILDS)


@pytest.mark.parametrize("rate", [44100, 48000])
@pytest.mark.parametrize("n", GEOMETRY_NS)
def test_band_energy_model_at_every_n(n, rate):
    """The model of the kernel's arithmetic at any n: within rtol 1e-5 of
    plain, no more than twice plain's error against float64, and the
    in-order sum's bits on bands of <= BAND_CHUNK bins."""
    from glc_tpu_torch.ops.psycho import get_perceptual_tables

    mask = torch.from_numpy(get_perceptual_tables(n, rate).band_mask)
    rng = np.random.default_rng(n + rate)
    c = torch.from_numpy((rng.standard_normal((5, n)) * 0.05)
                         .astype(np.float32))
    model = _check_model(c, mask)
    ranges = _ranges(mask)
    narrow = (ranges[:, 1] - ranges[:, 0]) <= kernels.BAND_CHUNK
    np.testing.assert_array_equal(
        model[:, narrow], inorder_model(c.numpy(), ranges)[:, narrow])


def test_band_plan_refuses_a_table_no_build_holds():
    """Items within the large build, but bands enough (each one bin, an
    item) that the plan's table outgrows it."""
    bands = 210
    mask = torch.zeros(bands, 2)
    mask[:, 0] = 1.0
    items = bands + 1  # and one for the bin no band holds
    assert items <= kernels.BAND_MAX_ITEMS
    assert 3 * items + 2 * kernels.BAND_LANES + 2 + 3 * bands > \
        kernels.BAND_PLAN_CAP
    with pytest.raises(ValueError, match="ints"):
        band_plan(mask)


# rows of 0.01 with non-finite squares: {name: {bin: value}}
NON_FINITE = {
    "inf_in_top_band": {500: np.inf},
    "minus_inf_in_band_2": {10: -np.inf},
    "square_overflows": {700: 3e19},
    "nan": {200: np.nan},
    "two_infs_one_band": {400: np.inf, 900: -np.inf},
    "infs_in_two_bands": {5: np.inf, 600: np.inf},
    "inf_and_nan": {500: np.inf, 501: np.nan},
    "finite_sum_overflows": {400: 1.5e19, 401: 1.5e19},
    "finite": {},
}


def _non_finite_rows() -> torch.Tensor:
    rows = np.full((len(NON_FINITE), N), 0.01, np.float32)
    for r, spots in enumerate(NON_FINITE.values()):
        for k, v in spots.items():
            rows[r, k] = v
    return torch.from_numpy(rows)


def _assert_same_pattern(got: np.ndarray, want: np.ndarray) -> None:
    """The same NaN and +Inf bands, and the finite sums within rtol 1e-5."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=0)


def test_non_finite_rows_plain_matches_jax_einsum(tables):
    import jax.numpy as jnp
    from jax.lax import Precision

    from glc_tpu.ops.psycho import get_perceptual_tables

    c = _non_finite_rows().numpy()
    with np.errstate(over="ignore", invalid="ignore"):
        want = np.asarray(jnp.einsum(
            "...n,bn->...b", c * c, get_perceptual_tables(N, RATE).band_mask,
            precision=Precision.HIGHEST))
    plain = band_energy_reference(torch.from_numpy(c), tables.band_mask).numpy()
    _assert_same_pattern(plain, want)
    assert np.isnan(plain[0]).sum() == 49 and np.isposinf(plain[0, 49])


def test_non_finite_rows_model_matches_plain(tables):
    """The model (the kernel's arithmetic) gives plain's NaN and +Inf bands
    on every crafted row; the in-order sum did not: NaN in the band of an
    Inf, finite sums in the others."""
    c = _non_finite_rows()
    plain = band_energy_reference(c, tables.band_mask).numpy()
    model = band_energy_model(c.numpy(), _ranges(tables.band_mask))
    _assert_same_pattern(model, plain)
    names = list(NON_FINITE)
    assert np.isposinf(model[names.index("finite_sum_overflows"), 49])
    assert np.isfinite(model[names.index("finite_sum_overflows"), :49]).all()
    inorder = inorder_model(c.numpy(), _ranges(tables.band_mask))
    assert np.isnan(inorder[0, 49]) and np.isfinite(inorder[0, :49]).all()


def test_non_finite_rows_on_a_synthetic_mask():
    """Overlapping bands, an empty band and bins no band holds: an Inf in
    bins 800-1023 lies only in the n-bin band; an Inf in bin 5 lies in
    bands 0 and 2."""
    mask = _synthetic_mask()
    rows = np.full((3, N), 0.01, np.float32)
    rows[0, 900] = np.inf
    rows[1, 5] = np.inf
    rows[2, 5], rows[2, 900] = np.inf, np.inf
    c = torch.from_numpy(rows)
    plain = band_energy_reference(c, mask).numpy()
    model = band_energy_model(rows, _ranges(mask))
    _assert_same_pattern(model, plain)
    assert np.isposinf(model[0, 2]) and np.isposinf(model[1, [0, 2]]).all()


# --- the wrappers' checks, the same on either device ---

def _misaligned(shape) -> torch.Tensor:
    """A contiguous f32 tensor whose data starts 4 bytes past 16."""
    flat = torch.zeros(int(np.prod(shape)) + 4)
    start = next(i for i in range(1, 4) if (flat[i:].data_ptr() % 16) == 4)
    return flat[start : start + int(np.prod(shape))].view(shape)


def test_mdct_rows_rejects_bad_inputs(tables):
    table, norm = tables.cos_table, tables.norm
    good = _win(4, tables)
    bad = [
        (good.double(), table, norm, TypeError),          # dtype
        (good[:, :N].contiguous(), table, norm, ValueError),  # width
        (good.reshape(2, 2, FRAME), table, norm, ValueError),   # not rows
        (_win(8, tables)[::2], table, norm, ValueError),   # not contiguous
        (_misaligned((4, FRAME)), table, norm, ValueError),  # alignment
        (good.to("meta"), table.to("meta"), norm, ValueError),  # device
        (good, table.to("meta"), norm, ValueError),        # table elsewhere
        (good, table, norm.double(), ValueError),          # norm dtype
    ]
    for win, t, s, err in bad:
        with pytest.raises(err):
            mdct_rows(win, t, s)


def test_band_energy_rejects_bad_inputs(tables):
    mask = tables.band_mask
    good = _coeffs(4)
    bad = [
        (good.double(), mask, TypeError),                 # dtype
        (good[:, : N // 2].contiguous(), mask, ValueError),  # width
        (good[None], mask, ValueError),                   # not rows
        (_coeffs(8)[::2], mask, ValueError),              # not contiguous
        (_misaligned((4, N)), mask, ValueError),          # alignment
        (good.to("meta"), mask.to("meta"), ValueError),   # device
        (good, mask.to("meta"), ValueError),              # mask elsewhere
        (good, mask[0], ValueError),                      # mask not 2-D
    ]
    for c, m, err in bad:
        with pytest.raises(err):
            band_energy(c, m)


def test_mdct_rows_rejects_a_bad_plan(tables):
    """A plan must be a built tile shape with a grid of 1 to its units; the
    check runs on either device (on the CPU the plan is otherwise unused)."""
    win = _win(100, tables)
    args = (win, tables.cos_table, tables.norm)
    units = kernels.mdct_units(100, N, 64, 32)[1]
    for plan in (MdctPlan(128, 64, 1), MdctPlan(64, 96, 1),
                 MdctPlan(32, 32, 1), MdctPlan(64, 32, 0),
                 MdctPlan(64, 32, units + 1)):
        with pytest.raises(ValueError):
            mdct_rows(*args, plan=plan)
    plan = MdctPlan(64, 32, units)
    assert torch.equal(mdct_rows(*args, plan=plan),
                       mdct_rows_reference(*args))


# --- mdct_rows' plans (ops/kernels.py::mdct_rows_plan) ---

SMS = 132  # an H100 SXM's SMs
PLAN_ROWS = {"1-2048": range(1, 2049), "2049-4096": range(2049, 4097),
             "4097-6144": range(4097, 6145), "6145-8192": range(6145, 8193),
             "65536": [65536]}


def _check_cover(M: int, plan: MdctPlan, n: int = N) -> None:
    """The plan's warpgroup tiles cover every row below M and every column
    below n exactly once, each from an aligned corner, and every block has
    a unit; a unit starts below n (its tiles may reach past it)."""
    rows, cols, grid = plan
    t = kernels.mdct_rows_tiles(M, n, plan)
    block, wg, row0, col0, held, held_cols = t.T
    assert (row0 % 64 == 0).all() and (col0 % cols == 0).all()
    assert (col0[wg == 0] < n).all()
    width = -(-n // mdct_unit(rows, cols)[1]) * mdct_unit(rows, cols)[1]
    corners = row0 * width + col0
    assert len(np.unique(corners)) == len(t)  # aligned and distinct: disjoint
    assert (held == np.clip(M - row0, 0, 64)).all()
    assert (held_cols == np.clip(n - col0, 0, cols)).all()
    assert int((held * held_cols).sum()) == M * n  # every element once
    assert set(block.tolist()) == set(range(grid))


@pytest.mark.parametrize("span", list(PLAN_ROWS))
def test_mdct_rows_plan_covers_every_row_and_column_once(span):
    for M in PLAN_ROWS[span]:
        _check_cover(M, kernels.mdct_rows_plan(M, N, SMS))


def test_mdct_rows_tiles_cover_by_painting():
    """The cover, counted element by element, for every tile shape at the
    tile edges and at a grid of 1, 7 and the chooser's."""
    for M in (1, 63, 64, 65, 127, 128, 129, 646, 1000, 1292):
        for rows, cols in kernels.MDCT_TILES:
            units = kernels.mdct_units(M, N, rows, cols)[1]
            for grid in {1, min(7, units), min(SMS, units)}:
                plan = MdctPlan(rows, cols, grid)
                _check_cover(M, plan)
                count = np.zeros((-(-M // 64) * 64 + 64, N), np.int32)
                for _b, _w, r0, c0, *_held in kernels.mdct_rows_tiles(M, N, plan):
                    count[r0:r0 + 64, c0:c0 + cols] += 1
                assert (count[:M] == 1).all(), (M, plan)


COVER_ROWS = [1, 63, 64, 65, 127, 128, 129, 646, 1000, 1292, 2816, 8192,
              65536]


@pytest.mark.parametrize("n", GEOMETRY_NS)
def test_mdct_rows_plan_covers_every_row_and_column_once_at_every_n(n):
    """The chooser's plan at any n: every row and column below n once, a
    grid of min(units, SMs), within the launch limits."""
    for M in COVER_ROWS:
        plan = kernels.mdct_rows_plan(M, n, SMS)
        _check_cover(M, plan, n)
        kernels.check_mdct_plan(plan, M, n)
        assert plan.grid == min(kernels.mdct_units(M, n, *plan[:2])[1], SMS)


@pytest.mark.parametrize("n", GEOMETRY_NS)
def test_mdct_rows_tiles_cover_by_painting_at_every_n(n):
    """The cover at any n, counted element by element: every tile shape
    at a grid of 1, 7 and the chooser's; the tiles' parts past n are
    computed on zeros and not stored, so only [M, n] is painted."""
    for M in (1, 63, 65, 129, 646):
        for rows, cols in kernels.MDCT_TILES:
            units = kernels.mdct_units(M, n, rows, cols)[1]
            for grid in {1, min(7, units), min(SMS, units)}:
                plan = MdctPlan(rows, cols, grid)
                _check_cover(M, plan, n)
                count = np.zeros((M, n), np.int32)
                for _b, _w, r0, c0, held, held_cols in \
                        kernels.mdct_rows_tiles(M, n, plan):
                    count[r0:r0 + held, c0:c0 + held_cols] += 1
                assert (count == 1).all(), (M, n, plan)


def test_mdct_ktiles_pad_the_k_loop_to_even():
    """Every plan walks ceil(2n / 32) k-tiles rounded up to even (the
    narrow consumers take them in pairs): 64 at the default n, one zero
    tile more where the count is odd."""
    assert kernels.mdct_ktiles(N) == 64
    for n in [*GEOMETRY_NS, *range(1, 300)]:
        k = -(-2 * n // kernels.MDCT_K_TILE)
        assert kernels.mdct_ktiles(n) == k + k % 2
    assert kernels.mdct_ktiles(496) == 32 and kernels.mdct_ktiles(500) == 32


@pytest.mark.parametrize("span", list(PLAN_ROWS))
def test_mdct_rows_plan_stays_within_the_launch_limits(span):
    for M in PLAN_ROWS[span]:
        plan = kernels.mdct_rows_plan(M, N, SMS)
        assert (plan.rows, plan.cols) in kernels.MDCT_TILES
        units = kernels.mdct_units(M, N, plan.rows, plan.cols)[1]
        assert plan.grid == min(units, SMS) and units < 2 ** 31
        kernels.check_mdct_plan(plan, M, N)
    for rows, cols in kernels.MDCT_TILES:
        # dynamic + the ring's barriers within a block's 227 KB
        assert kernels.mdct_smem_bytes(rows, cols) + 64 <= 232448
        assert mdct_unit(rows, cols)[1] <= 256  # a TMA box's rows
        assert N % mdct_unit(rows, cols)[1] == 0


@pytest.mark.parametrize("sms", [SMS, 114])
def test_mdct_rows_plan_fills_the_card_from_646_rows(sms):
    """At 646 rows and more, at least as many busy warpgroup tiles as the
    card has SMs (there are always enough: 11 row tiles x 16 at 64
    columns)."""
    for M in [*range(646, 8193), 65536]:
        plan = kernels.mdct_rows_plan(M, N, sms)
        busy = (kernels.mdct_rows_tiles(M, N, plan)[:, 4] > 0).sum()
        assert busy >= sms, (M, plan, busy)


def test_mdct_rows_plan_refuses_what_no_kernel_takes():
    for M, n, sms in ((0, N, SMS), (5, 8193, SMS), (5, N, 0)):
        with pytest.raises(ValueError):
            kernels.mdct_rows_plan(M, n, sms)


def test_product_path_takes_f64_up_to_the_cut_and_tiles_above():
    """The products' path by n: f64 from 1 to the cut the path sweep
    measured (kernels._F64_MAX_N), the 3xTF32 tile product above it and at
    the codec's default n, whose bits stay the tile product's."""
    cut = kernels._F64_MAX_N
    assert kernels.PRODUCT_PATHS == ("tiles", "f64")
    assert [kernels.product_path(n) for n in (1, 441, cut)] == ["f64"] * 3
    assert [kernels.product_path(n) for n in (cut + 1, 500, 960, N, 8192)] \
        == ["tiles"] * 5


def test_wrappers_refuse_an_unknown_path_on_either_device():
    """`path` is one of PRODUCT_PATHS or None, checked before the CPU's
    plain version runs; a CPU call with a named path is the plain
    version's."""
    tb = get_codec_tables(441, 882, RATE, "cpu")
    win = torch.zeros((3, 882))
    coeffs = torch.zeros((3, 441))
    with pytest.raises(ValueError, match="path"):
        mdct_rows(win, tb.cos_table, tb.norm, path="tf32")
    with pytest.raises(ValueError, match="path"):
        kernels.imdct_window(coeffs, tb.cos_table, tb.window, tb.norm_value,
                             path="f32")
    for path in kernels.PRODUCT_PATHS:
        assert torch.equal(
            mdct_rows(win, tb.cos_table, tb.norm, path=path),
            mdct_rows_reference(win, tb.cos_table, tb.norm))


def plan_thresholds(sms: int, top: int = 8192) -> list:
    """Row counts on both sides of every change of the chooser's tile shape
    from 1 to `top` rows."""
    out, last = [], None
    for M in range(1, top + 1):
        shape = kernels.mdct_rows_plan(M, N, sms)[:2]
        if last is not None and shape != last:
            out += [M - 1, M]
        last = shape
    return out


def test_plan_thresholds_cross_every_tile_shape_change():
    edges = plan_thresholds(SMS)
    assert edges and len(edges) % 2 == 0
    for below, above in zip(edges[::2], edges[1::2]):
        assert above == below + 1
        assert (kernels.mdct_rows_plan(below, N, SMS)[:2]
                != kernels.mdct_rows_plan(above, N, SMS)[:2])


def test_cos_split_is_its_own_cache(tables):
    """mdct_rows reads the table's own split, imdct_window the transposed
    one; each is made once per table, and neither is the other's."""
    table = tables.cos_table.clone()
    before = (cos_split.splits, table_split.splits)
    hi, lo = cos_split(table)
    assert hi.shape == lo.shape == (N, FRAME)
    assert torch.equal(hi, split_tf32(table)[0])
    t_hi, _t_lo = table_split(table)
    assert t_hi.shape == (FRAME, N)
    assert cos_split(table)[0] is hi
    assert (cos_split.splits, table_split.splits) == (before[0] + 1,
                                                      before[1] + 1)


@pytest.mark.parametrize("n", [1, 441, 1023])
def test_cos_split_pads_its_rows(n):
    """At an odd n the split's rows are row_pitch(2n) floats, 16-byte
    multiples for the kernel's TMA map: the table's split, then zeros;
    made once per table like the others."""
    table = get_codec_tables(n, 2 * n, RATE, "cpu").cos_table.clone()
    before = cos_split.splits
    hi, lo = cos_split(table)
    assert hi.shape == lo.shape == (n, row_pitch(2 * n)) == (n, 2 * n + 2)
    assert hi.is_contiguous() and lo.is_contiguous()
    want_hi, want_lo = split_tf32(table)
    assert torch.equal(hi[:, :2 * n], want_hi)
    assert torch.equal(lo[:, :2 * n], want_lo)
    assert not hi[:, 2 * n:].any() and not lo[:, 2 * n:].any()
    assert cos_split(table)[0] is hi and cos_split.splits == before + 1


def test_padded_rows_copies_only_widths_off_16_bytes():
    """Rows whose width is a multiple of 4 floats go to the kernel as
    they are; others are copied once to row_pitch(width), zeros after."""
    x = torch.arange(12.0).reshape(3, 4)
    assert kernels.padded_rows(x) is x
    y = torch.arange(15.0).reshape(3, 5)
    z = kernels.padded_rows(y)
    assert z.shape == (3, 8) and z.is_contiguous()
    assert torch.equal(z[:, :5], y) and not z[:, 5:].any()
    assert [row_pitch(w) for w in (1, 4, 441, 882, 883)] == [4, 4, 444, 884,
                                                            884]


# --- tests/test_chunking.py's encode cases, on both packages ---

def _sweep():
    return generate_frequency_sweep(100.0, 8000.0, RATE, 1, 30.0)


def _tone_noise_tone():
    tone = generate_frequency_sweep(200.0, 2000.0, RATE, 1, 10.0)
    noise = generate_white_noise(RATE, 1, 10.0, 11)
    return np.concatenate([tone, noise, tone]).astype(np.float32)


SIGNALS = {"sweep": _sweep, "with_raw_frames": _tone_noise_tone}


@pytest.fixture(scope="module")
def chunked():
    """signal -> {encode_chunk_frames: (port container, glc_tpu container)},
    each a mono encode on the CPU."""
    from glc_tpu import CodecConfig as JaxConfig
    from glc_tpu import Encoder as JaxEncoder

    out = {}
    for name, make in SIGNALS.items():
        samples = make()
        out[name] = {
            k: (Encoder(RATE, config=replace(DEFAULT_CONFIG,
                                             encode_chunk_frames=k),
                        device="cpu").encode(samples, 1),
                JaxEncoder(RATE, config=JaxConfig(encode_chunk_frames=k))
                .encode(samples, 1))
            for k in CHUNKS}
    return out


@pytest.mark.parametrize("name", list(SIGNALS))
def test_port_encode_is_segmentation_invariant(chunked, name):
    """tests/test_chunking.py:11-32 on the port: the same bytes at every
    segment size (4096 frames: one segment; 512 and 1000: several, the
    last one ragged)."""
    ports = {k: serialize_encoded(p) for k, (p, _j) in chunked[name].items()}
    assert len(set(ports.values())) == 1
    if name == "with_raw_frames":
        assert int(chunked[name][4096][0].frame_set.raw_mask.sum()) > 0


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", list(SIGNALS))
def test_port_encode_matches_jax_at_segment_size(chunked, name, chunk):
    from glc_tpu import serialize_encoded as jax_serialize

    from glc_tpu_torch import deserialize_encoded

    port, jax_ea = chunked[name][chunk]
    jax_ea = deserialize_encoded(jax_serialize(jax_ea))
    flips = check_containers(port, jax_ea)
    assert flips["rate"] <= 0.01


# --- on the card ---

@pytest.fixture
def cuda_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return get_codec_tables(N, FRAME, RATE, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M", EDGES)
def test_cuda_mdct_rows_matches_plain(cuda_tables, M):
    tb = cuda_tables
    win = _win(M, tb, seed=M).cuda()
    before = mdct_rows.launches
    out = mdct_rows(win, tb.cos_table, tb.norm)
    assert mdct_rows.launches == before + 1
    ref = mdct_rows_reference(win, tb.cos_table, tb.norm)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
    exact = (win.double() @ tb.cos_table.double().T) * tb.norm_value
    err_kernel = (out.double() - exact).abs().max().item()
    err_plain = (ref.double() - exact).abs().max().item()
    assert err_kernel <= 2 * err_plain
    # a float norm gives the same bits as the table's norm tensor
    assert torch.equal(mdct_rows(win, tb.cos_table, tb.norm_value), out)


@pytest.mark.cuda
@pytest.mark.parametrize("M", EDGES)
def test_cuda_band_energy_matches_plain(cuda_tables, M):
    tb = cuda_tables
    c = _coeffs(M, seed=M).cuda()
    before = band_energy.launches
    out = band_energy(c, tb.band_mask)
    assert band_energy.launches == before + 1
    ref = band_energy_reference(c, tb.band_mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=0)
    exact = c.double() ** 2 @ tb.band_mask.double().T
    err_kernel = (out.double() - exact).abs().max().item()
    err_plain = (ref.double() - exact).abs().max().item()
    assert err_kernel <= 2 * err_plain
    model = band_energy_model(c.cpu().numpy(), _ranges(tb.band_mask))
    np.testing.assert_array_equal(out.cpu().numpy(), model)


@pytest.mark.cuda
@pytest.mark.parametrize("M", EDGES)
def test_cuda_band_energy_matches_the_model_at_48khz(cuda_tables, M):
    tb = get_codec_tables(N, FRAME, 48000, "cuda")
    c = _coeffs(M, seed=2 * M).cuda()
    out = band_energy(c, tb.band_mask)
    model = band_energy_model(c.cpu().numpy(), _ranges(tb.band_mask))
    np.testing.assert_array_equal(out.cpu().numpy(), model)


@pytest.mark.cuda
def test_cuda_band_energy_on_a_synthetic_mask(cuda_tables):
    """Bands of W, W + 1 and n bins, an empty band and bins no band holds,
    with finite and non-finite rows: the model's bits."""
    mask = _synthetic_mask().cuda()
    rows = _coeffs(130, seed=5).numpy()
    rows[0, 900] = rows[1, 5] = np.inf
    rows[2, 5], rows[2, 900] = np.inf, np.nan
    out = band_energy(torch.from_numpy(rows).cuda(), mask)
    model = band_energy_model(rows, _ranges(mask))
    np.testing.assert_array_equal(out.cpu().numpy(), model)


@pytest.mark.cuda
def test_cuda_band_energy_non_finite_rows(cuda_tables):
    """The crafted rows on the card: plain's NaN and +Inf bands (plain on
    the card and on the CPU), and the model's bits, at any offset in a
    larger launch."""
    tb = cuda_tables
    rows = _non_finite_rows()
    c = torch.cat([_coeffs(300, seed=9), rows, _coeffs(41, seed=10)]).cuda()
    out = band_energy(c, tb.band_mask).cpu().numpy()
    alone = band_energy(rows.cuda(), tb.band_mask).cpu().numpy()
    np.testing.assert_array_equal(out[300:300 + len(rows)], alone)
    _assert_same_pattern(alone, band_energy_reference(
        rows.cuda(), tb.band_mask).cpu().numpy())
    _assert_same_pattern(alone, band_energy_reference(
        rows, tb.band_mask.cpu()).numpy())
    np.testing.assert_array_equal(
        out, band_energy_model(c.cpu().numpy(), _ranges(tb.band_mask)))


@pytest.mark.cuda
@pytest.mark.parametrize("M", EDGES)
def test_cuda_mdct_rows_every_plan_gives_the_default_bits(cuda_tables, M):
    """Each tile shape, at the chooser's grid for it and at one block
    (which walks every unit), gives the default plan's bits."""
    tb = cuda_tables
    args = (_win(M, tb, seed=M + 17).cuda(), tb.cos_table, tb.norm)
    want = mdct_rows(*args)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rows, cols in kernels.MDCT_TILES:
        units = kernels.mdct_units(M, N, rows, cols)[1]
        for grid in {1, min(units, sms)}:
            got = mdct_rows(*args, plan=MdctPlan(rows, cols, grid))
            assert torch.equal(got, want), (rows, cols, grid)


@pytest.mark.cuda
def test_cuda_kernels_are_row_invariant(cuda_tables):
    """Rows taken from an 8192-row launch equal the same rows launched at
    1, 127 and 1292 rows and on both sides of every tile-shape change of
    the chooser, bit for bit, at any offset; band_energy's rows also those
    of a 65536-row launch."""
    tb = cuda_tables
    win = _win(8192, tb, seed=3).cuda()
    coeffs = mdct_rows(win, tb.cos_table, tb.norm)
    sums = band_energy(coeffs, tb.band_mask)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for M in sorted({1, 127, 1292, *plan_thresholds(sms)}):
        for start in (0, 8192 - M, 4001 % (8192 - M + 1)):
            rows = slice(start, start + M)
            c = mdct_rows(win[rows].contiguous(), tb.cos_table, tb.norm)
            assert torch.equal(c, coeffs[rows]), M
            s = band_energy(coeffs[rows].contiguous(), tb.band_mask)
            assert torch.equal(s, sums[rows])
    big_win = torch.cat([_win(20000, tb, seed=8), win.cpu(),
                         _win(65536 - 28192, tb, seed=9)]).cuda()
    assert torch.equal(mdct_rows(big_win, tb.cos_table, tb.norm)[20000:28192],
                       coeffs)
    big = torch.cat([_coeffs(20000, seed=4).cuda(), coeffs,
                     _coeffs(65536 - 28192, seed=6).cuda()])
    sums_big = band_energy(big, tb.band_mask)
    assert torch.equal(sums_big[20000:28192], sums)
    for M in (1, 127, 1292, 8192):
        for start in (0, 65536 - M, 31337):
            rows = slice(start, start + M)
            s = band_energy(big[rows].contiguous(), tb.band_mask)
            assert torch.equal(s, sums_big[rows])


def _rows_on_card(M: int, width: int, seed: int, scale: float = 0.1,
                  window=None) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((M, width)) * scale)
                         .astype(np.float32)).cuda()
    return x if window is None else x * window


@pytest.mark.cuda
@pytest.mark.parametrize("n", GEOMETRY_NS)
def test_cuda_mdct_rows_at_every_n(cuda_tables, n):
    """Any n: the kernel against plain at every row count (TOL; its error
    against float64 no more than twice plain's), one launch a call (of the
    f64 path where `kernels.product_path` says so), and each row the bits
    of the same row in an 8192-row launch."""
    tb = get_codec_tables(n, 2 * n, RATE, "cuda")
    every = _rows_on_card(8192, 2 * n, n, window=tb.window)
    all_rows = mdct_rows(every, tb.cos_table, tb.norm)
    table64 = tb.cos_table.double()
    f64 = kernels.product_path(n) == "f64"
    for M in GEOMETRY_ROWS:
        win = every[-M:].clone()
        before, f64_before = mdct_rows.launches, mdct_rows.f64_launches
        out = mdct_rows(win, tb.cos_table, tb.norm)
        assert mdct_rows.launches == before + 1
        assert mdct_rows.f64_launches == f64_before + f64
        ref = mdct_rows_reference(win, tb.cos_table, tb.norm)
        torch.cuda.synchronize()
        assert torch.equal(out, all_rows[-M:]), M
        torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
        exact = (win.double() @ table64.T) * tb.norm_value
        err_kernel = (out.double() - exact).abs().max().item()
        err_plain = (ref.double() - exact).abs().max().item()
        assert err_kernel <= 2 * err_plain, (M, err_kernel, err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("n", GEOMETRY_NS)
def test_cuda_f64_path_at_every_n(cuda_tables, n):
    """The f64 path of mdct_rows and imdct_window, asked for at any n: each
    element the exact result rounded once, so its error against float64
    is at most the plain version's at every row count (up to float64's
    own rounding), one launch of the f64 kernel a call, and each row the
    bits of the same row in an 8192-row launch."""
    tb = get_codec_tables(n, 2 * n, RATE, "cuda")
    table64, window64 = tb.cos_table.double(), tb.window.double()
    cases = {
        "mdct_rows": (
            kernels.mdct_rows, mdct_rows_reference, (tb.cos_table, tb.norm),
            lambda x: (x.double() @ table64.T) * tb.norm_value,
            _rows_on_card(8192, 2 * n, n + 1, window=tb.window)),
        "imdct_window": (
            kernels.imdct_window, kernels.imdct_window_reference,
            (tb.cos_table, tb.window, tb.norm_value),
            lambda x: ((x.double() @ table64) * tb.norm_value) * window64,
            _rows_on_card(8192, n, n + 2)),
    }
    for name, (wrapper, plain, rest, exact_of, every) in cases.items():
        all_rows = wrapper(every, *rest, path="f64")
        for M in GEOMETRY_ROWS:
            x = every[-M:].clone()
            before, f64_before = wrapper.launches, wrapper.f64_launches
            out = wrapper(x, *rest, path="f64")
            assert (wrapper.launches, wrapper.f64_launches) == (
                before + 1, f64_before + 1)
            ref = plain(x, *rest)
            torch.cuda.synchronize()
            assert torch.equal(out, all_rows[-M:]), (name, M)
            torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
            exact = exact_of(x)
            err_kernel = (out.double() - exact).abs().max().item()
            err_plain = (ref.double() - exact).abs().max().item()
            assert err_kernel <= err_plain * (1 + 1e-6), (
                name, M, err_kernel, err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("n", GEOMETRY_NS)
def test_cuda_band_energy_at_every_n(cuda_tables, n):
    """Any n, at 44.1 and 48 kHz: the kernel against plain at every row
    count (rtol 1e-5; its error against float64 no more than twice
    plain's), each row the bits of the same row in an 8192-row launch and
    of the model."""
    for rate in (44100, 48000):
        mask = get_codec_tables(n, 2 * n, rate, "cuda").band_mask
        every = _rows_on_card(8192, n, n + rate, scale=0.05)
        all_rows = band_energy(every, mask)
        for M in GEOMETRY_ROWS:
            c = every[-M:].clone()
            before = band_energy.launches
            out = band_energy(c, mask)
            assert band_energy.launches == before + 1
            ref = band_energy_reference(c, mask)
            torch.cuda.synchronize()
            assert torch.equal(out, all_rows[-M:]), (rate, M)
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=0)
            exact = c.double() ** 2 @ mask.double().T
            err_kernel = (out.double() - exact).abs().max().item()
            err_plain = (ref.double() - exact).abs().max().item()
            assert err_kernel <= 2 * err_plain, (rate, M)
        model = band_energy_model(every[:646].cpu().numpy(), _ranges(mask))
        np.testing.assert_array_equal(all_rows[:646].cpu().numpy(), model)


@pytest.mark.cuda
@pytest.mark.parametrize("n, rate", [(441, 44100), (960, 48000)])
def test_cuda_rows_are_invariant_in_rows_and_plan_at_other_hops(
        cuda_tables, n, rate):
    """At the 10 ms hop of 44.1 kHz and the 20 ms hop of 48 kHz: rows
    taken from an 8192-row launch equal the same rows launched alone at
    every row count, at any offset, and, for mdct_rows, under every tile
    shape at a grid of 1, 7 and the chooser's."""
    tb = get_codec_tables(n, 2 * n, rate, "cuda")
    win = _rows_on_card(8192, 2 * n, 7, window=tb.window)
    coeffs = mdct_rows(win, tb.cos_table, tb.norm)
    sums = band_energy(coeffs, tb.band_mask)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for M in (1, 63, 64, 65, 127, 646, 1292):
        for start in (0, 8192 - M, 4001 % (8192 - M + 1)):
            rows = slice(start, start + M)
            part = win[rows].clone()
            assert torch.equal(mdct_rows(part, tb.cos_table, tb.norm),
                               coeffs[rows]), M
            assert torch.equal(band_energy(coeffs[rows].clone(), tb.band_mask),
                               sums[rows]), M
            for shape in kernels.MDCT_TILES:
                units = kernels.mdct_units(M, n, *shape)[1]
                for grid in {1, min(7, units), min(units, sms)}:
                    got = mdct_rows(part, tb.cos_table, tb.norm,
                                    plan=MdctPlan(*shape, grid))
                    assert torch.equal(got, coeffs[rows]), (M, shape, grid)


@pytest.mark.cuda
def test_cuda_kernels_refuse_n_above_the_largest(cuda_tables):
    """n = MAX_N + 1: each wrapper raises ValueError, and each C entry
    returns cudaErrorInvalidValue (1) before it reads a pointer."""
    n = kernels.MAX_N + 1
    table = torch.zeros((n, 2 * n), device="cuda")
    rows = torch.zeros((2, n), device="cuda")
    mask = torch.zeros((3, n), device="cuda")
    mask[0, :10] = 1.0
    with pytest.raises(ValueError, match=str(kernels.MAX_N)):
        mdct_rows(torch.zeros((2, 2 * n), device="cuda"), table, 1.0)
    with pytest.raises(ValueError, match=str(kernels.MAX_N)):
        kernels.imdct_window(rows, table, torch.zeros(2 * n, device="cuda"),
                             1.0)
    with pytest.raises(ValueError, match=str(kernels.MAX_N)):
        band_energy(rows, mask)
    lib = kernels.load_library()
    assert lib.glc_mdct_rows(0, 0, 0, 0, 0, 1, n, 128, 128, 1, 0) == 1
    assert lib.glc_mdct_rows_f64(0, 0, 0, 0, 1, n, 0) == 1
    assert lib.glc_imdct_window(0, 0, 0, 0, 0, 1, n, 1.0, 0) == 1
    assert lib.glc_imdct_window_f64(0, 0, 0, 0, 1, n, 1.0, 0) == 1
    plan_len = 3 * 1 + 2 * kernels.BAND_LANES + 1 + 3 * 1 + 1
    assert lib.glc_band_energy(0, 0, 0, 1, n, 1, 1, plan_len, 0) == 1


# NaN/Inf samples: tests/test_torch_quirks.py's, and the same without the
# NaN (there the card's 3xTF32 MDCT gives NaN where the CPU's gives +-Inf)
HOSTILE = {"nan_inf": {100: np.nan, 200: np.inf, 300: -np.inf},
           "inf_only": {200: np.inf, 300: -np.inf}}


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("case", list(HOSTILE))
def test_cuda_encode_nan_inf_input(cuda_tables, case, channels):
    """tests/test_torch_quirks.py::test_encode_nan_inf_input on the card:
    a valid container that round-trips to the input's length, within the
    pair contract of the CPU port's."""
    from glc_tpu_torch import Decoder, deserialize_encoded

    s = generate_sine_wave(440.0, RATE, channels, 0.2)
    for k, v in HOSTILE[case].items():
        s[k] = v
    encoded = {}
    for dev in ("cuda", "cpu"):
        ea = Encoder(RATE, device=dev).encode(s, channels)
        fs = ea.frame_set
        assert len(fs.pairs) == int(fs.nnz.sum())
        back = deserialize_encoded(serialize_encoded(ea))
        out = Decoder(channels, RATE, device=dev).decode(back)
        assert len(out) == len(s)
        encoded[dev] = ea
    check_containers(encoded["cuda"], encoded["cpu"])


@pytest.mark.cuda
def test_cuda_encode_is_segmentation_invariant(cuda_tables):
    """tests/test_chunking.py's encode cases on the card: the same bytes at
    every segment size, and within the pair contract of the CPU's."""
    for name, make in SIGNALS.items():
        samples = make()
        datas = {}
        for k in CHUNKS:
            cfg = replace(DEFAULT_CONFIG, encode_chunk_frames=k)
            datas[k] = Encoder(RATE, config=cfg, device="cuda").encode(
                samples, 1)
        assert len({serialize_encoded(ea) for ea in datas.values()}) == 1, name
        cpu = Encoder(RATE, device="cpu").encode(samples, 1)
        assert check_containers(datas[4096], cpu)["rate"] <= 0.01


@pytest.mark.cuda
def test_cuda_sharded_album_encode_equals_serial(cuda_tables, tmp_path):
    """encode_album_sharded on a 1 x 1 mesh (one [B, K] block of 4 x 1024
    frames a launch) against the serial Encoder.encode (one segment a
    track, of its own row count): the same bytes."""
    import torch.distributed as dist

    from glc_tpu_torch import parallel

    rng = np.random.default_rng(5)
    tracks = [generate_frequency_sweep(f0, 6000.0, RATE, 2, s)
              + (rng.standard_normal(2 * RATE * s) * 0.01).astype(np.float32)
              for f0, s in ((100.0, 3), (300.0, 7), (60.0, 12))]
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh(1, device_type="cuda")
        encs = parallel.encode_album_sharded(mesh, tracks, 2, RATE)
    finally:
        dist.destroy_process_group()
    enc = Encoder(RATE, device="cuda")
    for x, ea in zip(tracks, encs, strict=True):
        assert serialize_encoded(ea) == serialize_encoded(enc.encode(x, 2))


def test_kernel_names_match_the_sources():
    """Each kernel the loader binds has a source under csrc/ and a wrapper
    with a launch count."""
    assert {p.stem for p in kernels.sources()} == set(kernels.KERNELS)
    for name in kernels.KERNELS:
        assert getattr(kernels, name).launches >= 0
        assert callable(getattr(kernels, f"{name}_reference"))
