"""The port's encode → .glc → decode slice against the JAX package's, on the
CPU, over the signal set of tests/utils.py.

Each case encodes the same input with both packages, compares the
containers within the pair contract (glc_tpu_torch/parity.py), loads each
package's .glc in the other, and decodes the JAX package's container with
both, under reference_compat True and False.  Bounds: decode_i16 within
1 LSB (glc_tpu/codec/decoder.py, decode_i16's docstring), decode within
atol=3e-6, rtol=3e-5 (tests/test_pallas.py).
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import glc_tpu
import glc_tpu_torch
from glc_tpu.codec.encoder import frame_signal as jax_frame_signal
from glc_tpu_torch.codec import encoder as tencoder
from glc_tpu_torch.ops.encode import planarize
from glc_tpu_torch.parity import check_containers

sys.path.insert(0, "tests")
from utils import (  # noqa: E402
    generate_frequency_sweep,
    generate_sine_wave,
    generate_white_noise,
)

RATE = 44100
CHUNKED = {"encode_chunk_frames": 32, "decode_chunk_frames": 32}


def _signal(name):
    """(samples, channels, config overrides)."""
    if name == "sine_mono":
        return generate_sine_wave(440.0, RATE, 1, 1.0), 1, {}
    if name == "sine_stereo":
        return generate_sine_wave(440.0, RATE, 2, 1.0), 2, {}
    if name == "white_noise":
        return generate_white_noise(RATE, 1, 0.5, 42), 1, {}
    if name == "short_0.05s":
        return generate_sine_wave(1000.0, RATE, 2, 0.05), 2, {}
    if name == "odd_stereo":
        return generate_sine_wave(660.0, RATE, 2, 0.5)[:-1], 2, {}
    if name == "sweep_chunked":
        s = generate_frequency_sweep(100.0, 8000.0, RATE, 2, 1.5)
        return s, 2, CHUNKED
    if name == "pcm16_stereo":
        s = generate_frequency_sweep(200.0, 4000.0, RATE, 2, 1.0)
        return (s * 32767.0).astype(np.int16), 2, {}
    raise KeyError(name)


CASES = ["sine_mono", "sine_stereo", "white_noise", "short_0.05s",
         "odd_stereo", "sweep_chunked", "pcm16_stereo"]


def _encode(pkg, samples, channels, cfg):
    enc = (pkg.Encoder(RATE, cfg) if pkg is glc_tpu
           else pkg.Encoder(RATE, cfg, device="cpu"))
    if samples.dtype == np.int16:
        return enc.encode_pcm16(samples, channels)
    return enc.encode(samples, channels)


@pytest.fixture(scope="module")
def encoded():
    """name -> (samples, channels, overrides, JAX container, port
    container), each case encoded once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            samples, C, over = _signal(name)
            jcfg = glc_tpu.CodecConfig(**over)
            tcfg = glc_tpu_torch.config_from_dict(dataclasses.asdict(jcfg))
            cache[name] = (samples, C, over,
                           _encode(glc_tpu, samples, C, jcfg),
                           _encode(glc_tpu_torch, samples, C, tcfg))
        return cache[name]

    return get


@pytest.mark.parametrize("name", CASES)
def test_encode_matches(encoded, name):
    samples, C, _over, ej, et = encoded(name)
    flips = check_containers(ej, et)
    print(f"{name}: {flips}")
    fj, ft = ej.frame_set, et.frame_set
    assert ft.num_frames == fj.num_frames and ft.frame_size == fj.frame_size
    # a scale is the largest |MDCT coefficient|, a 2048-term f32 dot product
    # that the port's 2-D sgemm sums in another order than XLA's dot
    np.testing.assert_allclose(ft.scales, fj.scales, rtol=1e-5, atol=0)
    assert np.array_equal(ft.raw_pcm, fj.raw_pcm)
    assert et.header.total_samples == len(samples)
    if name == "white_noise":
        assert ft.raw_mask.all() and len(ft.pairs) == 0
    else:
        assert len(ft.pairs) > 0


def _fields(ea):
    fs = ea.frame_set
    # a raw frame's scale is not on the wire: it reads back as 0
    coded = fs.scales[~fs.raw_mask]
    return (dataclasses.astuple(ea.header), dataclasses.astuple(ea.gapless_info),
            fs.nnz, fs.pairs, coded, fs.raw_mask, fs.raw_pcm, fs.frame_size)


def _same(a, b):
    for x, y in zip(_fields(a), _fields(b), strict=True):
        if isinstance(x, np.ndarray):
            assert np.array_equal(np.asarray(x), np.asarray(y))
        else:
            assert x == y


@pytest.mark.parametrize("name", CASES)
def test_containers_load_across_packages(encoded, name):
    """The wire format is shared: each package loads the other's .glc."""
    *_, ej, et = encoded(name)
    from_port = glc_tpu.deserialize_encoded(glc_tpu_torch.serialize_encoded(et))
    from_jax = glc_tpu_torch.deserialize_encoded(glc_tpu.serialize_encoded(ej))
    _same(from_port, et)
    _same(from_jax, ej)
    assert (glc_tpu_torch.serialize_encoded(from_jax)
            == glc_tpu.serialize_encoded(ej))


@pytest.mark.parametrize("compat", [True, False], ids=["compat", "clean"])
@pytest.mark.parametrize("name", CASES)
def test_decode_matches(encoded, name, compat):
    """Both packages decode the JAX package's container."""
    samples, C, over, ej, _et = encoded(name)
    jcfg = glc_tpu.CodecConfig(reference_compat=compat, **over)
    tcfg = glc_tpu_torch.config_from_dict(dataclasses.asdict(jcfg))
    jdec = glc_tpu.Decoder(C, RATE, jcfg)
    tdec = glc_tpu_torch.Decoder(C, RATE, tcfg, device="cpu")

    i16_j, i16_t = jdec.decode_i16(ej), tdec.decode_i16(ej)
    assert i16_t.dtype == np.int16
    assert len(i16_t) == len(i16_j) == len(samples) == tdec.decoded_length(ej)
    lsb = np.abs(i16_t.astype(np.int32) - i16_j.astype(np.int32))
    assert lsb.max(initial=0) <= 1

    f_j, f_t = jdec.decode(ej), tdec.decode(ej)
    assert f_t.dtype == np.float32 and len(f_t) == len(samples)
    np.testing.assert_allclose(f_t, f_j, atol=3e-6, rtol=3e-5)


def test_ragged_input_the_reference_panics_on_raises():
    """Stereo with 2T-1 samples where T-1 pads to one hop fewer than T."""
    samples = np.zeros(1025, np.float32)  # T = 513: lead + 512 = one hop
    with pytest.raises(ValueError):
        glc_tpu.Encoder(RATE).encode(samples, 2)
    with pytest.raises(ValueError):
        glc_tpu_torch.Encoder(RATE, device="cpu").encode(samples, 2)


@pytest.mark.parametrize("total,channels", [(5000, 2), (4999, 2), (3001, 3),
                                            (100, 1)])
def test_planarize_matches_frame_signal(total, channels):
    """The device deinterleave + pad equals the host frame_signal of both
    packages (ragged inputs zero-completed on the host first)."""
    cfg = glc_tpu_torch.DEFAULT_CONFIG
    x = np.random.default_rng(total).standard_normal(total).astype(np.float32)
    padded, F, padding, T = tencoder.frame_signal(x, channels, cfg)
    jpadded, jF, jpadding, jT = jax_frame_signal(x, channels, cfg)
    assert (F, padding, T) == (jF, jpadding, jT)
    assert np.array_equal(padded, jpadded)
    assert tencoder.frame_plan(total, channels, cfg) == (T, F, padding)

    _T, F2, _p, _plan, need_hops = tencoder.upload_geometry(total, channels, cfg)
    xup = np.zeros(T * channels, np.float32)
    xup[:total] = x
    planar = planarize(torch.from_numpy(xup), channels, cfg.hop_size // 2,
                       cfg.n, need_hops).numpy()
    assert F2 == F and planar.shape == (channels, need_hops * cfg.n)
    assert np.array_equal(planar[:, : padded.shape[1]], padded)
    assert not planar[:, padded.shape[1]:].any()
