"""The port at every sample rate and channel count the JAX package's suites
use (tests/test_comprehensive.py:90-114, tests/test_torture.py:22): 8000,
11025, 22050, 44100, 48000 and 96000 Hz, 1 to 6 channels.

The masking model's bands depend on the rate (glc_tpu/ops/psycho.py:46-67,
at most MAX_BANDS = 50): 33 bands at 8 kHz, 40 at 11.025 kHz, 50 from
22.05 kHz up, and with them band_energy's work plan
(glc_tpu_torch/ops/kernels.py::band_plan).  On the CPU, against the JAX
package, with each bound's reason:
- codec/tables.py (`get_codec_tables`, and `tables_from_numpy` of the JAX
  package's tables) at hop 1024: every table equal exactly (the same numpy
  code);
- band_plan at the plans of `PLANS`: the bands and work items counted
  below, and the kernel's numpy model (band_energy_model of
  tests/test_torch_encode_kernels.py) within rtol 1e-5 of plain, its error
  against float64 at most twice plain's;
- ops/psycho.py's masking_thresholds (the plain version serves on the
  CPU) against the JAX package's: rtol 1e-5 (the band sums are the same
  f32 sums of squares taken in another order; the thresholds are their
  square roots times exact constants);
- encode_pcm16 -> decode_i16 of `program_material` at 5 rates x 1, 2, 4
  and 6 channels: the containers within the pair contract
  (glc_tpu_torch/parity.py), decode_i16 of the JAX package's container by
  both packages within 1 LSB (glc_tpu/codec/decoder.py, decode_i16's
  docstring), the port's own decode of the input's length.

The tests marked `cuda` run the same matrix through the card's three
kernels, held to the port's CPU run under the same contract; each kernel
launch's row count is recorded and each kernel is held against its plain
version at those rows and that rate's tables (error against float64 at
most twice plain's, rows bit-invariant in M).  The JAX package is imported
inside the tests that use it; on the card's machine, which has no JAX, run
them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_rates.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_encode_kernels import band_energy_model  # noqa: E402

import glc_tpu_torch  # noqa: E402,F401  (full-f32 matmul settings)
from glc_tpu_torch import Decoder, Encoder  # noqa: E402
from glc_tpu_torch.bench import seeded_rows  # noqa: E402
from glc_tpu_torch.codec.tables import (  # noqa: E402
    get_codec_tables, tables_from_numpy,
)
from glc_tpu_torch.ops import decode as decode_ops  # noqa: E402
from glc_tpu_torch.ops import mdct as mdct_ops  # noqa: E402
from glc_tpu_torch.ops import psycho as psycho_ops  # noqa: E402
from glc_tpu_torch.ops.kernels import (  # noqa: E402
    band_energy, band_energy_reference, band_plan, imdct_window,
    imdct_window_reference, mdct_rows, mdct_rows_reference,
)
from glc_tpu_torch.parity import check_containers  # noqa: E402

N = 1024
RATES = [8000, 11025, 22050, 44100, 48000, 96000]
BANDS = {8000: 33, 11025: 40}  # 50 at every other rate
# (rate, hop) -> (bands, work items) of band_plan: the plans of the round
# trips below and of the longest hops the codec takes at the low rates
PLANS = {(8000, 1024): (33, 41), (8000, 8192): (33, 273),
         (11025, 8192): (40, 274), (22050, 2048): (50, 91),
         (96000, 1024): (50, 75), (96000, 2048): (50, 101)}
MATRIX_RATES = [8000, 22050, 44100, 48000, 96000]
MATRIX_CHANNELS = [1, 2, 4, 6]
MATRIX = [(r, c) for r in MATRIX_RATES for c in MATRIX_CHANNELS]
SECONDS = 1.0
THRESHOLD_RTOL = 1e-5
KERNEL_TOL = 2e-5
BAND_RTOL = 1e-5
TABLE_FIELDS = ("cos_table", "window", "norm", "band_mask", "band_inv_count",
                "band_pf", "band_of", "inv_w")


def program_material(seconds: float, rate: int, channels: int,
                     seed: int = 0) -> np.ndarray:
    """Interleaved int16 program material after bench.make_signal (a
    C-major third, a rising sweep whose clock wraps every 60 s, a noise
    bed) at `rate` and any channel count: channel c carries the chord and
    sweep at gain 1 - 0.1·c and its own noise from
    numpy.random.default_rng(seed + c) at 0.01."""
    t = np.arange(int(rate * seconds), dtype=np.float32) / np.float32(rate)
    ts = np.mod(t, np.float32(60.0))
    base = (0.30 * np.sin(2 * np.pi * 261.63 * t)
            + 0.20 * np.sin(2 * np.pi * 329.63 * t)
            + 0.15 * np.sin(2 * np.pi * (440.0 + 100.0 * ts) * ts))
    x = np.empty((len(t), channels), np.float32)
    for c in range(channels):
        noise = np.random.default_rng(seed + c).standard_normal(len(t))
        x[:, c] = base * (1.0 - 0.1 * c) + noise.astype(np.float32) * 0.01
    return (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16).reshape(-1)


# --- codec/tables.py and band_plan ---

@pytest.mark.parametrize("rate", RATES)
def test_tables_match_jax(rate):
    """Every table of the port equals the JAX package's at hop 1024, from
    its own numpy code and carried across by tables_from_numpy; the rate
    gives its band count."""
    from glc_tpu.codec.tables import get_device_tables

    want = get_device_tables(N, 2 * N, rate)
    own = get_codec_tables(N, 2 * N, rate, "cpu")
    carried = tables_from_numpy(*(np.array(getattr(want, f))
                                  for f in TABLE_FIELDS), device="cpu")
    for field in TABLE_FIELDS:
        w = np.asarray(getattr(want, field))
        for tables in (own, carried):
            got = getattr(tables, field).numpy()
            assert got.shape == w.shape, field
            np.testing.assert_array_equal(got, w.astype(got.dtype), field)
    bands = int((np.asarray(want.band_inv_count) > 0).sum())
    assert bands == BANDS.get(rate, 50)
    assert int(own.band_of.max()) == bands - 1


@pytest.mark.parametrize("rate,hop", list(PLANS))
def test_band_plan_at_rate(rate, hop):
    """band_plan's bands and work items at the rate's band layout; the
    kernel's numpy model against plain (rtol 1e-5) and float64 (at most
    twice plain's error) on seeded rows."""
    mask = get_codec_tables(hop, 2 * hop, rate, "cpu").band_mask
    plan = band_plan(mask)
    bands = int((plan.ranges[:, 1] > plan.ranges[:, 0]).sum())
    assert (bands, len(plan.items)) == PLANS[rate, hop]
    rng = np.random.default_rng(rate + hop)
    c = torch.from_numpy((rng.standard_normal((65, hop)) * 0.05)
                         .astype(np.float32))
    model = band_energy_model(c.numpy(), plan.ranges)
    plain = band_energy_reference(c, mask).numpy()
    np.testing.assert_allclose(model, plain, rtol=BAND_RTOL, atol=0)
    exact = (c.double() ** 2 @ mask.double().T).numpy()
    assert np.abs(model - exact).max() <= 2 * np.abs(plain - exact).max()


# --- ops/psycho.py ---

@pytest.mark.parametrize("rate", RATES)
def test_masking_thresholds_match_jax(rate):
    """The thresholds of seeded coefficients (129 rows, a few peaks over
    30% of the global max) at the rate's tables, within rtol 1e-5 of the
    JAX package's."""
    import jax.numpy as jnp
    from glc_tpu.codec.tables import get_device_tables
    from glc_tpu.ops.psycho import masking_thresholds as jax_thresholds

    rng = np.random.default_rng(rate)
    coeffs = (rng.standard_normal((129, N)) * 0.05).astype(np.float32)
    coeffs[:, rng.integers(0, N, 8)] *= 40.0
    gmax = np.maximum(np.abs(coeffs).max(axis=1, keepdims=True),
                      np.float32(1e-10))
    jt = get_device_tables(N, 2 * N, rate)
    want = np.asarray(jax_thresholds(
        jnp.asarray(coeffs), jnp.asarray(gmax), jt.band_mask,
        jt.band_inv_count, jt.band_pf, jt.band_of, jt.inv_w, 0.5))
    tb = get_codec_tables(N, 2 * N, rate, "cpu")
    got = psycho_ops.masking_thresholds(
        torch.from_numpy(coeffs), torch.from_numpy(gmax), tb.band_mask,
        tb.band_inv_count, tb.band_pf, tb.band_of, tb.inv_w, 0.5).numpy()
    assert (np.abs(coeffs) > gmax * 0.3).any()  # the cap is exercised
    np.testing.assert_allclose(got, want, rtol=THRESHOLD_RTOL, atol=0)


# --- the round trip at every rate and channel count ---

@pytest.fixture(scope="module")
def encoded():
    """(rate, channels) -> (pcm, JAX container, port container), each
    encoded once per module."""
    import glc_tpu

    cache = {}

    def get(rate, channels):
        if (rate, channels) not in cache:
            pcm = program_material(SECONDS, rate, channels, seed=rate)
            cache[rate, channels] = (
                pcm, glc_tpu.Encoder(rate).encode_pcm16(pcm, channels),
                Encoder(rate, device="cpu").encode_pcm16(pcm, channels))
        return cache[rate, channels]

    return get


def max_lsb(a: np.ndarray, b: np.ndarray) -> int:
    assert len(a) == len(b)
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max(initial=0))


@pytest.mark.parametrize("rate,channels", MATRIX)
def test_round_trip_matches_jax(encoded, rate, channels):
    """The port's container within the pair contract of the JAX
    package's; the JAX package's container decoded by both within 1 LSB;
    the port's own container decoded to the input's length."""
    import glc_tpu

    pcm, ej, et = encoded(rate, channels)
    flips = check_containers(ej, et)
    assert flips["kept"] > 0
    assert et.header.sample_rate == rate and et.header.channels == channels
    want = glc_tpu.Decoder(channels, rate).decode_i16(ej)
    dec = Decoder(channels, rate, device="cpu")
    assert len(want) == len(pcm)
    assert max_lsb(dec.decode_i16(ej), want) <= 1
    own = dec.decode_i16(et)
    assert len(own) == len(pcm) and np.abs(own).max() > 1000  # not silence


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def launched_rows(monkeypatch):
    """kernel -> the row counts the paths launch it with on the card,
    recorded at the modules that call the wrappers (the wrappers and their
    counts stay as they are; a CPU call runs the plain version and is not
    recorded)."""
    rows = {"mdct_rows": set(), "band_energy": set(), "imdct_window": set()}
    for module, name in ((mdct_ops, "mdct_rows"), (psycho_ops, "band_energy"),
                         (decode_ops, "imdct_window")):
        wrapper = getattr(module, name)

        def recorded(x, *args, _name=name, _wrapper=wrapper, **kwargs):
            if x.is_cuda:
                rows[_name].add(x.shape[0])
            return _wrapper(x, *args, **kwargs)

        monkeypatch.setattr(module, name, recorded)
    return rows


def check_kernel_rows(rate: int, rows: dict, n: int = N) -> dict:
    """Each kernel against its plain version at `rate`'s tables (hop n) on
    every row count in `rows[kernel]`, the last M of one largest launch of
    seeded rows (`bench.seeded_rows`: windowed blocks from seed 2,
    coefficients from seed 1): within KERNEL_TOL (band_energy BAND_RTOL),
    the error against float64 at most twice plain's, the rows the bits of
    the same rows of the largest launch.  Returns each kernel's largest
    |kernel - plain|.  chip_smoke.py's geometry and conformance phases
    hold their launches to plain with it too."""
    tb = get_codec_tables(n, 2 * n, rate, "cuda")
    table64, window64 = tb.cos_table.double(), tb.window.double()
    top = max(max(r) for r in rows.values())
    win_all = seeded_rows(top, 2 * n, 2, tb.window)
    coeffs_all = mdct_rows(win_all, tb.cos_table, tb.norm)
    sums_all = band_energy(coeffs_all, tb.band_mask)
    dec_all = seeded_rows(top, n, 1)
    blocks_all = imdct_window(dec_all, tb.cos_table, tb.window, tb.norm_value)
    worst = dict.fromkeys(rows, 0.0)
    for name, counts in rows.items():
        for M in sorted(counts):
            if name == "mdct_rows":
                x = win_all[-M:].clone()
                out = mdct_rows(x, tb.cos_table, tb.norm)
                ref = mdct_rows_reference(x, tb.cos_table, tb.norm)
                exact = (x.double() @ table64.T) * tb.norm_value
                whole, tol = coeffs_all, dict(atol=KERNEL_TOL, rtol=KERNEL_TOL)
            elif name == "band_energy":
                x = coeffs_all[-M:].clone()
                out = band_energy(x, tb.band_mask)
                ref = band_energy_reference(x, tb.band_mask)
                exact = x.double() ** 2 @ tb.band_mask.double().T
                whole, tol = sums_all, dict(atol=0.0, rtol=BAND_RTOL)
            else:
                x = dec_all[-M:].clone()
                args = (x, tb.cos_table, tb.window, tb.norm_value)
                out = imdct_window(*args)
                ref = imdct_window_reference(*args)
                exact = ((x.double() @ table64) * tb.norm_value) * window64
                whole, tol = blocks_all, dict(atol=KERNEL_TOL, rtol=KERNEL_TOL)
            torch.cuda.synchronize()
            assert torch.equal(out, whole[-M:]), (
                f"{name} n={n} M={M}: rows differ from the same rows of the "
                f"{top}-row launch")
            torch.testing.assert_close(out, ref, **tol)
            err_kernel = (out.double() - exact).abs().max().item()
            err_plain = (ref.double() - exact).abs().max().item()
            assert err_kernel <= 2 * err_plain, (
                f"{name} n={n} M={M} at {rate} Hz: error vs float64 "
                f"{err_kernel:.3e} exceeds twice the plain version's "
                f"{err_plain:.3e}")
            worst[name] = max(worst[name], (out - ref).abs().max().item())
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("rate,channels", MATRIX)
def test_cuda_round_trip_matches_cpu(cuda_device, launched_rows, rate,
                                     channels):
    """encode_pcm16 -> decode_i16 on the card through all three kernels:
    the container within the pair contract of the CPU port's, the decode
    within 1 LSB of the CPU port's decode of the same container; each
    kernel held to plain at every row count the round trip launched it
    with, at this rate's tables."""
    pcm = program_material(SECONDS, rate, channels, seed=rate)
    before = [fn.launches for fn in (mdct_rows, band_energy, imdct_window)]
    ea = Encoder(rate, device="cuda").encode_pcm16(pcm, channels)
    out = Decoder(channels, rate, device="cuda").decode_i16(ea)
    launched = [fn.launches - b for fn, b in
                zip((mdct_rows, band_energy, imdct_window), before)]
    assert all(launched), launched
    check_containers(ea, Encoder(rate, device="cpu").encode_pcm16(
        pcm, channels))
    want = Decoder(channels, rate, device="cpu").decode_i16(ea)
    assert len(out) == len(pcm)
    assert max_lsb(out, want) <= 1
    assert all(launched_rows.values()), launched_rows
    check_kernel_rows(rate, launched_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("rate,hop", list(PLANS))
def test_cuda_band_energy_at_rate_plans(cuda_device, rate, hop):
    """band_energy at the rate's band plan: against plain (rtol 1e-5, its
    error against float64 at most twice plain's) at 1, 63, 129 and 646
    rows, each row the bits of the same row of an 8192-row launch and of
    the kernel's numpy model."""
    mask = get_codec_tables(hop, 2 * hop, rate, "cuda").band_mask
    assert band_plan(mask).items.shape[0] == PLANS[rate, hop][1]
    rng = np.random.default_rng(rate + hop)
    every = torch.from_numpy((rng.standard_normal((8192, hop)) * 0.05)
                             .astype(np.float32)).cuda()
    all_rows = band_energy(every, mask)
    for M in (1, 63, 129, 646):
        c = every[-M:].clone()
        out = band_energy(c, mask)
        ref = band_energy_reference(c, mask)
        torch.cuda.synchronize()
        assert torch.equal(out, all_rows[-M:]), M
        torch.testing.assert_close(out, ref, rtol=BAND_RTOL, atol=0)
        exact = c.double() ** 2 @ mask.double().T
        assert ((out.double() - exact).abs().max()
                <= 2 * (ref.double() - exact).abs().max()), M
    model = band_energy_model(every[:129].cpu().numpy(), band_plan(mask).ranges)
    np.testing.assert_array_equal(all_rows[:129].cpu().numpy(), model)
