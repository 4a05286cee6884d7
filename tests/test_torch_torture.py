"""tests/test_torture.py's seeded random-configuration sweep on the port:
thirty (waveform mix, duration, channels, rate) draws from
numpy.random.default_rng(1000 + case), each held to the JAX test's
invariants on the port's CPU run: structure, byte-stable serialization,
exact decoded length, finite output, decode chunk-size invariance
(decode_chunk_frames=128 within atol 3e-6, rtol 3e-5: on the CPU a
product of at most 128 rows rounds differently, tests/test_torch_stream.py),
and decode_i16 within 1 LSB of the f32 decode's int16 conversion.

Then the cross contract against the JAX package on the same draw: the
containers within the pair contract (glc_tpu_torch/parity.py), the JAX
package's container decoded by both within 1 LSB as int16
(glc_tpu/codec/decoder.py, decode_i16's docstring), the port's bytes read
back by the JAX package unchanged.

The test marked `cuda` runs the same draws on the card: the same
invariants, chunk-size invariance bit for bit (the card's IMDCT kernel
rounds a row alike at any row count), each container within the pair
contract of the CPU port's.  The JAX package is imported inside the
tests, so the module collects without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_torture.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_rates import (  # noqa: E402,F401  (fixtures of the cuda twin)
    check_kernel_rows, cuda_device, launched_rows,
)

import glc_tpu_torch  # noqa: E402
from glc_tpu_torch import (  # noqa: E402
    CodecConfig,
    Decoder,
    Encoder,
    deserialize_encoded,
    serialize_encoded,
)
from glc_tpu_torch.io.audio import convert_f32_to_i16  # noqa: E402
from glc_tpu_torch.parity import check_containers  # noqa: E402

RATES = [8000, 22050, 44100, 48000]
CASES = 30
SMALL_CHUNK = 128


def random_signal(rng: np.random.Generator, total: int) -> np.ndarray:
    """tests/test_torture.py's random mix of tones, noise bursts, silence
    and DC segments, copied (that module imports the JAX package)."""
    t = np.arange(total, dtype=np.float32)
    out = np.zeros(total, np.float32)
    for _ in range(int(rng.integers(1, 4))):
        f = float(rng.uniform(30, 8000))
        out += float(rng.uniform(0.05, 0.4)) * np.sin(
            2 * np.pi * f * t / 44100.0
        ).astype(np.float32)
    kind = int(rng.integers(0, 4))
    if kind == 0:  # a noise burst in the middle
        a, b = sorted(rng.integers(0, total, 2))
        out[a:b] += rng.standard_normal(b - a).astype(np.float32) * 0.3
    elif kind == 1:  # hard clipping
        out = np.clip(out * 3.0, -0.9, 0.9)
    elif kind == 2:  # leading and trailing silence
        out[: total // 4] = 0.0
        out[-total // 4:] = 0.0
    return out


def torture_case(case: int):
    """(samples, channels, rate) of tests/test_torture.py's draw `case`,
    the same draws in the same order."""
    rng = np.random.default_rng(1000 + case)
    channels = int(rng.integers(1, 4))
    rate = int(rng.choice(RATES))
    dur = float(rng.choice([0.03, 0.1, 0.25, 0.7, 1.5]))
    total = max(int(rate * dur), 1)
    per = random_signal(rng, total)
    samples = np.repeat(per, channels).astype(np.float32)
    # ragged interleaved input, where the shorter channels still pad to
    # channel 0's length
    if case % 5 == 0 and channels > 1 and (512 + total) % 1024 != 1:
        samples = samples[:-1]
    return samples, channels, rate


def check_invariants(samples, channels: int, rate: int, device: str,
                     exact_chunks: bool):
    """The JAX test's invariants on the port at `device`; returns the
    container.  `exact_chunks`: the small-chunk decode equal bit for bit,
    else within the JAX test's atol 3e-6, rtol 3e-5."""
    ea = Encoder(rate, device=device).encode(samples, channels)
    fs = ea.frame_set
    # structure
    assert len(fs.pairs) == int(fs.nnz.sum())
    assert len(fs.raw_pcm) == int(fs.raw_mask.sum())
    assert (fs.nnz[fs.raw_mask] == 0).all()
    assert (fs.nnz >= 0).all() and (fs.nnz <= 1024).all()
    assert (fs.pairs["k"] < 1024).all()
    # a byte-stable round trip
    data = serialize_encoded(ea)
    ea2 = deserialize_encoded(data)
    assert serialize_encoded(ea2) == data
    # the exact length, finite output
    dec = Decoder(channels, rate, device=device)
    out = dec.decode(ea2)
    assert len(out) == len(samples)
    assert np.isfinite(out).all()
    assert dec.decoded_length(ea2) == len(out)
    # decode chunk-size invariance
    small = Decoder(channels, rate, device=device,
                    config=CodecConfig(decode_chunk_frames=SMALL_CHUNK))
    out_small = small.decode(ea2)
    if exact_chunks:
        np.testing.assert_array_equal(out, out_small)
    else:
        np.testing.assert_allclose(out, out_small, atol=3e-6, rtol=3e-5)
    # the i16 surface within 1 LSB of the f32 surface's conversion
    i16 = dec.decode_i16(ea2)
    ref = convert_f32_to_i16(out)
    assert np.abs(i16.astype(np.int32) - ref.astype(np.int32)).max() <= 1
    return ea


@pytest.mark.parametrize("case", range(CASES))
def test_random_config_invariants(case):
    """The JAX test's invariants on the port's CPU run, and the cross
    contract against the JAX package on the same draw."""
    import glc_tpu

    samples, channels, rate = torture_case(case)
    et = check_invariants(samples, channels, rate, "cpu", exact_chunks=False)
    ej = glc_tpu.Encoder(rate).encode(samples, channels)
    check_containers(ej, et)
    want = glc_tpu.Decoder(channels, rate).decode_i16(ej)
    got = Decoder(channels, rate, device="cpu").decode_i16(ej)
    assert len(got) == len(want) == len(samples)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    data = serialize_encoded(et)
    assert glc_tpu.serialize_encoded(glc_tpu.deserialize_encoded(data)) == data


def test_draws_are_the_jax_tests():
    """The copied draw gives tests/test_torture.py's inputs."""
    import test_torture

    for case in (0, 5, 17):
        rng = np.random.default_rng(1000 + case)
        channels = int(rng.integers(1, 4))
        rate = int(rng.choice(test_torture.RATES))
        dur = float(rng.choice([0.03, 0.1, 0.25, 0.7, 1.5]))
        total = max(int(rate * dur), 1)
        per = test_torture.random_signal(rng, total)
        samples, ch, r = torture_case(case)
        assert (ch, r) == (channels, rate)
        np.testing.assert_array_equal(samples[: len(per) * ch - 1],
                                      np.repeat(per, ch)[: len(per) * ch - 1])
    assert glc_tpu_torch.DEFAULT_CONFIG.decode_chunk_frames > SMALL_CHUNK


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(CASES))
def test_cuda_random_config_invariants(cuda_device, launched_rows, case):
    """The same draws on the card: the invariants, chunk-size invariance
    bit for bit, the container within the pair contract of the CPU
    port's; each kernel held to plain at every row count the draw
    launched it with, at the rate's tables (tests/test_torch_rates.py's
    `check_kernel_rows`)."""
    samples, channels, rate = torture_case(case)
    ea = check_invariants(samples, channels, rate, "cuda", exact_chunks=True)
    check_containers(ea, Encoder(rate, device="cpu").encode(samples, channels))
    check_kernel_rows(rate, launched_rows)
