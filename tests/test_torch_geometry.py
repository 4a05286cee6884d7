"""The port at frame geometries other than the default hop of 1024: hop 441
(10 ms at 44.1 kHz), 500, 960 (20 ms at 48 kHz) and 2048, each with
frame_size = 2·hop, which both packages' decodes assume
(glc_tpu/ops/decode.py:232).

Both packages encode the same seeded stereo signal at each geometry, on
the CPU.  Bounds, each with its reason:
- the containers: the pair contract (glc_tpu_torch/parity.py): the same
  headers, gapless info, frame counts and raw masks, at most 1% flipped
  kept positions (the port's f32 products sum in another order than
  XLA's);
- decode_i16 of the JAX package's container by both packages: within
  1 LSB (glc_tpu/codec/decoder.py, decode_i16's docstring);
- frame_plan and upload_geometry (tests/test_geometry.py's sweep of
  lengths and channel counts, at hops 1024, 960 and 441): equal to the
  JAX package's, or both raise.  The JAX package's bucket_upload has no
  counterpart in the port (it uploads the samples as they are), so its
  case is left out.

The tests marked `cuda` run the same geometries through the card's three
kernels and hold them to the CPU port.  On the card's machine, which has no
JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_geometry.py
"""

import dataclasses
from dataclasses import replace

import numpy as np
import pytest
import torch

import glc_tpu_torch
from glc_tpu_torch import DEFAULT_CONFIG, Decoder, Encoder
from glc_tpu_torch.codec import encoder as tencoder
from glc_tpu_torch.ops import kernels
from glc_tpu_torch.ops.kernels import band_energy, imdct_window, mdct_rows
from glc_tpu_torch.parity import check_containers

# name -> (hop size, sample rate)
GEOMETRIES = {
    "hop441_44k1": (441, 44100),
    "hop500_44k1": (500, 44100),
    "hop960_48k": (960, 48000),
    "hop2048_44k1": (2048, 44100),
}
SECONDS = 1.2


def make_signal(rate: int, seconds: float = SECONDS,
                seed: int = 0) -> np.ndarray:
    """Interleaved f32 stereo from numpy.random.default_rng(seed): in each
    channel three tones of random pitch under a decaying envelope, and a
    quiet noise bed."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    x = np.zeros((len(t), 2))
    for c in range(2):
        for f in rng.uniform(110.0, 3000.0, size=3):
            x[:, c] += 0.2 * np.sin(2 * np.pi * f * t)
        x[:, c] *= np.exp(-1.5 * t)
        x[:, c] += rng.standard_normal(len(t)) * 0.003
    return x.astype(np.float32).reshape(-1)


def port_config(hop: int):
    return replace(DEFAULT_CONFIG, hop_size=hop, frame_size=2 * hop)


@pytest.fixture(scope="module")
def encoded():
    """name -> (samples, JAX config, JAX container, port container), each
    geometry encoded once per module."""
    import glc_tpu

    cache = {}

    def get(name):
        if name not in cache:
            hop, rate = GEOMETRIES[name]
            samples = make_signal(rate)
            jcfg = glc_tpu.CodecConfig(hop_size=hop, frame_size=2 * hop)
            tcfg = glc_tpu_torch.config_from_dict(dataclasses.asdict(jcfg))
            cache[name] = (
                samples, jcfg,
                glc_tpu.Encoder(rate, jcfg).encode(samples, 2),
                Encoder(rate, tcfg, device="cpu").encode(samples, 2))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_encode_matches_jax(encoded, name):
    hop, _rate = GEOMETRIES[name]
    samples, _jcfg, ej, et = encoded(name)
    flips = check_containers(ej, et, n=hop)
    fj, ft = ej.frame_set, et.frame_set
    assert ft.frame_size == fj.frame_size == 2 * hop
    assert ft.num_frames == fj.num_frames
    assert et.header.total_samples == len(samples)
    assert len(ft.pairs) > 0 and flips["kept"] > 0
    np.testing.assert_allclose(ft.scales, fj.scales, rtol=1e-5, atol=0)
    assert np.array_equal(ft.raw_pcm, fj.raw_pcm)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_decode_matches_jax(encoded, name):
    """Both packages decode the JAX package's container within 1 LSB; the
    port's own container decodes to the input's length."""
    import glc_tpu

    hop, rate = GEOMETRIES[name]
    samples, jcfg, ej, et = encoded(name)
    tdec = Decoder(2, rate, port_config(hop), device="cpu")
    i16_j = glc_tpu.Decoder(2, rate, jcfg).decode_i16(ej)
    i16_t = tdec.decode_i16(ej)
    assert len(i16_t) == len(i16_j) == len(samples)
    lsb = np.abs(i16_t.astype(np.int32) - i16_j.astype(np.int32))
    assert lsb.max(initial=0) <= 1
    own = tdec.decode(et)
    assert own.dtype == np.float32 and len(own) == len(samples)
    assert np.isfinite(own).all() and np.abs(own).max() > 0.1  # not silence


# --- tests/test_geometry.py's sweep, on the port against the JAX package ---

LENGTHS = [1, 2, 3, 511, 512, 513, 1023, 1024, 1025, 2047, 2048, 2049,
           4096, 44100, 88200, 88201, 1_000_000]
SWEEP_HOPS = [1024, 960, 441]


def _both(fn_port, fn_jax, *args):
    """(port result, JAX result), or (None, None) when both raise
    ValueError; fails when only one raises."""
    try:
        want = fn_jax(*args)
    except ValueError:
        with pytest.raises(ValueError):
            fn_port(*args)
        return None, None
    return fn_port(*args), want


@pytest.mark.parametrize("hop", SWEEP_HOPS)
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("total", LENGTHS)
def test_frame_plan_matches_jax(total, channels, hop):
    """The port's frame_plan equals the JAX package's, and its own
    frame_signal (the array-building original), on ragged inputs too."""
    from glc_tpu.codec.encoder import frame_plan as jax_frame_plan

    cfg = port_config(hop)
    got, want = _both(tencoder.frame_plan, jax_frame_plan, total, channels,
                      cfg)
    if want is None:
        with pytest.raises(ValueError):
            tencoder.frame_signal(np.zeros(total, np.float32), channels, cfg)
        return
    assert got == tuple(want)
    padded, F, padding, T = tencoder.frame_signal(
        np.zeros(total, np.float32), channels, cfg)
    assert (T, F, padding) == got
    assert padded.shape == (channels, hop // 2 + T + padding)


@pytest.mark.parametrize("hop", SWEEP_HOPS)
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("total", LENGTHS)
def test_upload_geometry_matches_jax(total, channels, hop):
    """The port's upload_geometry is the JAX package's less its bucketed
    upload length, with tests/test_geometry.py's invariants: the plan
    tiles [0, F), its segments fit the planar signal."""
    from glc_tpu.codec.encoder import upload_geometry as jax_upload_geometry

    cfg = port_config(hop)
    got, want = _both(tencoder.upload_geometry, jax_upload_geometry, total,
                      channels, cfg)
    if want is None:
        return
    assert got == tuple(want[:5])
    T, F, _padding, plan, need_hops = got
    assert plan[0][0] == 0
    for (s0, k0), (s1, _k1) in zip(plan, plan[1:]):
        assert s1 == s0 + k0
    last_start, last_k = plan[-1]
    assert last_start + last_k >= F
    assert all(k <= cfg.encode_chunk_frames for _s, k in plan)
    assert need_hops >= last_start + last_k + 1
    lead = hop // 2
    assert need_hops * hop >= lead + T + lead - hop + 1


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _launches():
    return [fn.launches for fn in (mdct_rows, band_energy, imdct_window)]


def _f64_launches():
    return [fn.f64_launches for fn in (mdct_rows, imdct_window)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_cuda_round_trip_matches_cpu(cuda_device, name):
    """The encode and decode on the card, through the three kernels (the
    two products' launches all of their f64 path where
    `kernels.product_path` says so, else none), within the pair contract
    of the CPU port's encode and 1 LSB of its decode."""
    hop, rate = GEOMETRIES[name]
    samples = make_signal(rate)
    cfg = port_config(hop)
    before, f64_before = _launches(), _f64_launches()
    ea = Encoder(rate, cfg, device="cuda").encode(samples, 2)
    out = Decoder(2, rate, cfg, device="cuda").decode_i16(ea)
    launched = [a - b for a, b in zip(_launches(), before)]
    assert all(launched), launched
    f64 = kernels.product_path(hop) == "f64"
    assert [a - b for a, b in zip(_f64_launches(), f64_before)] == [
        launched[0] * f64, launched[2] * f64]
    check_containers(ea, Encoder(rate, cfg, device="cpu").encode(samples, 2),
                     n=hop)
    want = Decoder(2, rate, cfg, device="cpu").decode_i16(ea)
    assert len(out) == len(want) == len(samples)
    lsb = np.abs(out.astype(np.int32) - want.astype(np.int32))
    assert lsb.max(initial=0) <= 1


@pytest.mark.cuda
def test_cuda_refuses_frame_size_not_twice_hop_where_the_cpu_does(
        cuda_device):
    """frame_size != 2·hop is no geometry of either package's decode: the
    encode fails on the card with the CPU port's error, before any
    kernel launch."""
    cfg = replace(DEFAULT_CONFIG, hop_size=441, frame_size=3 * 441)
    samples = make_signal(44100, seconds=0.3)
    errors = {}
    for dev in ("cpu", "cuda"):
        before = _launches()
        with pytest.raises(RuntimeError) as info:
            Encoder(44100, cfg, device=dev).encode(samples, 2)
        assert _launches() == before
        errors[dev] = str(info.value)
    assert errors["cuda"] == errors["cpu"]
