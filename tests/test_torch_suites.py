"""The JAX package's codec-level suites on the port: tests/test_simple.py,
tests/test_codec.py, tests/test_comprehensive.py, tests/test_file_size.py,
tests/test_compression_ratio.py, and the cases of
tests/test_performance.py and tests/test_micro_benchmark.py that assert
an output.

Each case encodes the JAX test's input with both packages on the CPU (the
port with `device="cpu"`) and decodes it, then asserts the JAX test's own
assertion on the port's output, and the cross contract against the JAX
package (`Codecs.run`), with its bounds:
- the containers within the pair contract (glc_tpu_torch/parity.py): the
  same headers, gapless info, frame counts and raw masks, at most 1% of
  kept positions flipped;
- the JAX package's container decoded by both packages within 1 LSB as
  int16 (glc_tpu/codec/decoder.py, decode_i16's docstring);
- the port's .glc bytes read and written back unchanged by the JAX
  package.
Cases that repeat each other (the same input under several JAX tests) are
one case of one parametrised test, each JAX test's assertion on it.

The test marked `cuda` runs the matrix's inputs (a case of each waveform,
sweep, rate and channel count) on the card, held to the port's CPU run:
the containers within the pair contract, the decodes within 1 LSB, the
JAX test's length and SNR floor.  The JAX package is imported inside the
tests, so the module collects without JAX.

Left out, with the reason: the timed cases of tests/test_performance.py
and tests/test_micro_benchmark.py (test_encoder_construction_cost,
test_encode_speed_by_duration, test_waveform_complexity,
test_stereo_vs_mono, test_mesh_scaling, test_encode_many_pipelining,
test_device_compute_regression_gate, test_mdct_cost,
test_full_stage_cost) time or print the JAX package's programs and assert
no output of the port; the port's timings belong to
glc_tpu_torch.bench.  test_warmup_compiles_shipped_paths has its port in
tests/test_torch_warmup.py.  test_streaming_export_timing's assertion
(streamed FLAC == batch FLAC) is in tests/test_torch_streaming_export.py.
"""

import dataclasses
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from utils import (  # noqa: E402
    calculate_snr,
    calculate_snr_range,
    generate_frequency_sweep,
    generate_sawtooth_wave,
    generate_sine_wave,
    generate_square_wave,
    generate_white_noise,
)

import glc_tpu_torch  # noqa: E402
from glc_tpu_torch import Decoder, Encoder, save_encoded  # noqa: E402
from glc_tpu_torch.container.bincode import serialize_encoded  # noqa: E402
from glc_tpu_torch.io.wav import convert_f32_to_i16  # noqa: E402
from glc_tpu_torch.parity import check_containers  # noqa: E402
from test_torch_rates import (  # noqa: E402,F401  (fixtures of the cuda twin)
    check_kernel_rows, cuda_device, launched_rows,
)


@dataclasses.dataclass
class Run:
    """One input through both packages."""

    samples: np.ndarray
    ej: object          # the JAX package's container
    et: object          # the port's container
    out: np.ndarray     # the port's decode of its own container
    flips: dict


class Codecs:
    """Both packages' encode and decode of an input, once per input: the
    JAX package's as the JAX suites run it, the port's on the CPU."""

    def __init__(self):
        import glc_tpu

        self.jax = glc_tpu
        self.runs = {}

    def configs(self, compat: bool):
        jcfg = self.jax.CodecConfig(reference_compat=compat)
        return jcfg, glc_tpu_torch.config_from_dict(dataclasses.asdict(jcfg))

    def run(self, samples, rate: int, channels: int,
            compat: bool = True) -> Run:
        """Encode and decode `samples` with both packages and hold the port
        to the cross contract (the module docstring)."""
        key = (hashlib.sha1(samples.tobytes()).hexdigest(), samples.dtype.str,
               rate, channels, compat)
        if key in self.runs:
            return self.runs[key]
        jcfg, tcfg = self.configs(compat)
        pcm16 = samples.dtype == np.int16
        jenc = self.jax.Encoder(rate, config=jcfg)
        tenc = Encoder(rate, config=tcfg, device="cpu")
        ej = (jenc.encode_pcm16 if pcm16 else jenc.encode)(samples, channels)
        et = (tenc.encode_pcm16 if pcm16 else tenc.encode)(samples, channels)
        flips = check_containers(ej, et)
        tdec = Decoder(channels, rate, config=tcfg, device="cpu")
        jout = self.jax.Decoder(channels, rate, config=jcfg).decode(ej)
        assert_lsb(tdec.decode(ej), jout)
        data = serialize_encoded(et)
        assert self.jax.serialize_encoded(
            self.jax.deserialize_encoded(data)) == data
        run = Run(samples, ej, et, tdec.decode(et), flips)
        self.runs[key] = run
        return run


def assert_lsb(a: np.ndarray, b: np.ndarray) -> None:
    """Two f32 decodes within 1 LSB as int16 (the exporters' conversion),
    of equal length."""
    assert len(a) == len(b)
    d = np.abs(convert_f32_to_i16(a).astype(np.int32)
               - convert_f32_to_i16(b).astype(np.int32))
    assert d.max(initial=0) <= 1


@pytest.fixture(scope="module")
def codecs():
    return Codecs()


# --- tests/test_simple.py ---

SINE_440 = ("sine", 440.0, 44100, 1)  # (generator, freq, rate, channels)


def _gen(kind: str, freq: float, rate: int, channels: int, duration: float):
    gens = {"sine": generate_sine_wave, "square": generate_square_wave,
            "sawtooth": generate_sawtooth_wave}
    return gens[kind](freq, rate, channels, duration)


def test_basic_encode_decode(codecs):
    """test_simple.py:16-43: frames, SNR over [1000, min_len - 1000) above
    -10 dB; length and speed ratios within 1% (test_simple.py:45-96)."""
    samples = _gen(*SINE_440, 2.0)
    r = codecs.run(samples, 44100, 1)
    assert len(r.et.frames) > 0
    min_len = min(len(samples), len(r.out))
    assert min_len > 1000
    snr = calculate_snr_range(samples, r.out, 1000,
                              min(min_len, len(samples) - 1000))
    assert snr > -10.0, f"SNR too low: {snr} dB"
    assert abs(len(r.out) / len(samples) - 1.0) < 0.01
    assert abs((len(r.out) / 44100) / (len(samples) / 44100) - 1.0) < 0.01


@pytest.mark.parametrize("frequency", [100.0, 440.0, 1000.0, 2000.0])
def test_multiple_frequencies(codecs, frequency):
    """test_simple.py:98-122: 1 s mono at each frequency, exact length."""
    samples = generate_sine_wave(frequency, 44100, 1, 1.0)
    assert len(codecs.run(samples, 44100, 1).out) == len(samples)


@pytest.mark.parametrize("duration", [0.5, 1.0, 2.0, 5.0])
def test_various_durations(codecs, duration):
    """test_simple.py:124-149, test_codec.py:111-137 (0.5 s and 5 s):
    exact length."""
    samples = generate_sine_wave(440.0, 44100, 1, duration)
    assert len(codecs.run(samples, 44100, 1).out) == len(samples)


def test_tiny_input_single_frame(codecs):
    """100 samples: one frame, exact length through the trim."""
    samples = generate_sine_wave(440.0, 44100, 1, 1.0)[:100].copy()
    r = codecs.run(samples, 44100, 1)
    assert len(r.et.frames) == 1
    assert len(r.out) == 100


def test_integer_input_rejected():
    """encode() of int16 raises TypeError in both packages."""
    import glc_tpu

    for enc in (Encoder(44100, device="cpu"), glc_tpu.Encoder(44100)):
        with pytest.raises(TypeError):
            enc.encode(np.zeros(1000, np.int16), 1)


def test_ragged_interleaved_input(codecs):
    """44101 interleaved samples as stereo (the reference deinterleaves by
    i % ch): total_samples and the decoded length are 44101."""
    samples = generate_sine_wave(440.0, 44100, 1, 1.2)[:44101].copy()
    r = codecs.run(samples, 44100, 2)
    assert r.et.header.total_samples == 44101
    assert len(r.out) == 44101


# --- tests/test_codec.py ---

@pytest.mark.parametrize("kind,freq,channels,floor", [
    ("sine", 440.0, 1, -10.0),       # test_codec.py:17-24
    ("square", 1000.0, 1, -15.0),    # :26-44
    ("sawtooth", 440.0, 1, -10.0),   # :46-64
    ("sine", 440.0, 2, -10.0),       # :91-109, stereo (quirk Q1 applies)
])
def test_waveform_round_trip(codecs, kind, freq, channels, floor):
    """2 s of each waveform: exact length, whole-signal SNR above the JAX
    test's floor."""
    samples = _gen(kind, freq, 44100, channels, 2.0)
    r = codecs.run(samples, 44100, channels)
    assert len(r.out) == len(samples)
    snr = calculate_snr(samples, r.out)
    assert snr > floor, f"SNR too low: {snr} dB"


@pytest.mark.parametrize("rate", [44100, 48000])
def test_sample_rate_variations(codecs, rate):
    """test_codec.py:66-89: 1 s mono at 44.1 and 48 kHz, exact length."""
    samples = generate_sine_wave(440.0, rate, 1, 1.0)
    assert len(codecs.run(samples, rate, 1).out) == len(samples)


def test_gapless_multiple_files(codecs):
    """test_codec.py:139-170: three 2 s files, the decoded lengths sum to
    the originals'."""
    files = [generate_sine_wave(440.0, 44100, 1, 2.0),
             generate_sine_wave(880.0, 44100, 1, 2.0),
             generate_square_wave(440.0, 44100, 1, 2.0)]
    total = sum(len(codecs.run(f, 44100, 1).out) for f in files)
    assert total == sum(len(f) for f in files)


# --- tests/test_comprehensive.py ---

@pytest.mark.parametrize("kind,freq,rate,ch,dur,floor", [
    # test_comprehensive.py:23-190: (waveform, freq, rate, channels,
    # duration, SNR floor)
    ("sine", 100.0, 44100, 1, 4.0, -10.0),
    ("sine", 440.0, 44100, 1, 4.0, -10.0),
    ("sine", 1000.0, 44100, 1, 4.0, -10.0),
    ("sine", 2000.0, 44100, 1, 4.0, -10.0),
    ("sine", 4000.0, 44100, 1, 4.0, -10.0),
    ("sine", 440.0, 48000, 1, 5.0, -10.0),
    ("sine", 440.0, 44100, 2, 5.0, -10.0),
    ("sine", 440.0, 44100, 1, 1.0, -10.0),
    ("sine", 440.0, 44100, 1, 10.0, -10.0),
    ("square", 440.0, 44100, 1, 5.0, -15.0),
    ("square", 1000.0, 48000, 2, 4.0, -15.0),
    ("sawtooth", 440.0, 44100, 1, 5.0, -15.0),
])
def test_waveform_matrix(codecs, kind, freq, rate, ch, dur, floor):
    samples = _gen(kind, freq, rate, ch, dur)
    r = codecs.run(samples, rate, ch)
    snr = calculate_snr(samples, r.out)
    assert snr > floor, f"SNR too low: {snr} dB"
    assert len(r.out) == len(samples)


@pytest.mark.parametrize("f0,f1,rate,ch,dur", [
    (100.0, 1000.0, 44100, 1, 6.0),
    (440.0, 2000.0, 44100, 1, 7.0),
    (200.0, 8000.0, 48000, 1, 8.0),
    (1000.0, 100.0, 44100, 1, 6.0),
    (440.0, 880.0, 44100, 2, 6.0),
])
def test_sweep_matrix(codecs, f0, f1, rate, ch, dur):
    samples = generate_frequency_sweep(f0, f1, rate, ch, dur)
    r = codecs.run(samples, rate, ch)
    snr = calculate_snr(samples, r.out)
    assert snr > -10.0, f"SNR too low: {snr} dB"
    assert len(r.out) == len(samples)


def test_amplitude_consistency(codecs):
    """test_comprehensive.py:193-230: RMS amplitude within 5%."""
    samples = generate_sine_wave(440.0, 44100, 1, 2.0)
    out = codecs.run(samples, 44100, 1).out
    e0 = float(np.mean(np.square(samples, dtype=np.float64)))
    e1 = float(np.mean(np.square(out, dtype=np.float64)))
    assert abs(np.sqrt(e1) - np.sqrt(e0)) / np.sqrt(e0) < 0.05


@pytest.mark.parametrize("rate", [8000, 22050, 96000])
def test_uncommon_sample_rates(codecs, rate):
    """The band layout follows the rate (33 bands at 8 kHz): exact length,
    SNR above -10 dB."""
    samples = generate_sine_wave(440.0, rate, 1, 0.5)
    r = codecs.run(samples, rate, 1)
    assert len(r.out) == len(samples)
    snr = calculate_snr(samples, r.out)
    assert snr > -10.0, f"SNR too low at {rate} Hz: {snr} dB"


def test_four_channel_audio(codecs):
    """Four channels: exact length; with quirk Q1's residual delay of
    (512 - 512 // 4) x 4 interleaved samples compensated, SNR above
    15 dB."""
    base = generate_sine_wave(440.0, 44100, 1, 0.5)
    C = 4
    samples = np.empty(len(base) * C, np.float32)
    for c in range(C):
        samples[c::C] = base * np.float32(0.5 + 0.1 * c)
    out = codecs.run(samples, 44100, C).out
    assert len(out) == len(samples)
    shift = (512 - 512 // C) * C
    snr = calculate_snr(samples[:-shift], out[shift:])
    assert snr > 15.0, f"4ch shift-compensated SNR: {snr}"


def test_clean_mode_beats_compat_stereo_quality(codecs):
    """Clean mode beats compat by 20 dB on stereo program material, above
    25 dB, its peak error under 10% and under compat's."""
    rate = 44100
    t = np.arange(2 * rate, dtype=np.float32) / rate
    left = (0.3 * np.sin(2 * np.pi * 261.63 * t)
            + 0.15 * np.sin(2 * np.pi * 440.0 * t))
    sig = np.empty(2 * len(t), np.float32)
    sig[0::2] = left
    sig[1::2] = left * 0.9

    def snr_and_maxerr(compat):
        out = codecs.run(sig, rate, 2, compat=compat).out
        n = min(len(out), len(sig))
        a = sig[:n][1000:n - 1000].astype(np.float64)
        b = out[:n][1000:n - 1000].astype(np.float64)
        err = a - b
        snr = 10 * np.log10(np.sum(a * a) / max(np.sum(err * err), 1e-20))
        return snr, float(np.max(np.abs(err)) / np.max(np.abs(a)))

    snr_compat, err_compat = snr_and_maxerr(True)
    snr_clean, err_clean = snr_and_maxerr(False)
    assert snr_clean > snr_compat + 20.0, (snr_clean, snr_compat)
    assert snr_clean > 25.0, snr_clean
    assert err_clean < 0.1, err_clean
    assert err_compat > err_clean, (err_compat, err_clean)


# --- tests/test_file_size.py ---

TONAL = {
    "sine": lambda: generate_sine_wave(440.0, 44100, 2, 10.0),
    "square": lambda: generate_square_wave(440.0, 44100, 2, 10.0),
    "sawtooth": lambda: generate_sawtooth_wave(440.0, 44100, 2, 10.0),
    "sweep": lambda: generate_frequency_sweep(100.0, 10000.0, 44100, 2, 10.0),
    "chord": lambda: (sum(generate_sine_wave(f, 44100, 2, 10.0)
                          for f in (261.63, 329.63, 392.00))
                      / np.float32(3.0)).astype(np.float32),
}


def file_ratio(tmp_path, samples, encoded, name) -> float:
    """Input f32 bytes over the saved .glc's bytes."""
    p = tmp_path / f"test_{name}.glc"
    save_encoded(encoded, p)
    return len(samples) * 4 / p.stat().st_size


@pytest.mark.parametrize("name", list(TONAL))
def test_compression_tonal(codecs, tmp_path, name):
    """test_file_size.rs:40-109: tonal stereo 10 s (and the C-major chord)
    compress 2x or better on disk."""
    samples = TONAL[name]()
    r = codecs.run(samples, 44100, 2)
    ratio = file_ratio(tmp_path, samples, r.et, name)
    assert ratio >= 2.0, f"Compression ratio too low: {ratio:.2f}x"


def test_compression_white_noise(codecs, tmp_path):
    """White noise takes the raw-PCM fallback on every frame, and the file
    is the input's f32 size within 5% (tests/test_file_size.py:111-127)."""
    samples = generate_white_noise(44100, 2, 10.0, 12345)
    r = codecs.run(samples, 44100, 2)
    assert bool(r.et.frame_set.raw_mask.all())
    ratio = file_ratio(tmp_path, samples, r.et, "white_noise")
    assert 0.95 <= ratio <= 1.05, f"unexpected white-noise ratio: {ratio:.2f}x"
    # all raw: nothing for a flip to move, so the containers are equal
    assert serialize_encoded(r.et) == codecs.jax.serialize_encoded(r.ej)


# --- tests/test_compression_ratio.py, tests/test_micro_benchmark.py ---

def test_compression_effectiveness(codecs):
    """A 440 Hz sine keeps under 50% of the MDCT coefficients."""
    fs = codecs.run(generate_sine_wave(440.0, 44100, 1, 2.0), 44100, 1).et.frame_set
    total_possible = int((~fs.raw_mask).sum()) * fs.channels * 1024
    assert total_possible > 0
    assert int(fs.nnz.sum()) / total_possible < 0.5


def test_sparsity_by_signal_type(codecs):
    """test_micro_benchmark.py:62-89: a sine keeps under 50% of its
    coefficients, white noise falls back to raw frames."""
    sine = codecs.run(generate_sine_wave(440.0, 44100, 1, 1.0), 44100, 1)
    for sig in (generate_square_wave(440.0, 44100, 1, 1.0),
                generate_frequency_sweep(100.0, 8000.0, 44100, 1, 1.0)):
        codecs.run(sig, 44100, 1)  # the contract on the other two classes
    noise = codecs.run(generate_white_noise(44100, 1, 1.0, 5), 44100, 1)
    fs = sine.et.frame_set
    assert 100.0 * fs.nnz.sum() / max((~fs.raw_mask).sum() * 1024, 1) < 50.0
    assert int(noise.et.frame_set.raw_mask.sum()) > 0


def test_decode_speed_and_roundtrip(codecs):
    """test_performance.py:74-84's assertion, untimed: 2 s mono decodes to
    its length."""
    samples = generate_sine_wave(440.0, 44100, 1, 2.0)
    assert len(codecs.run(samples, 44100, 1).out) == len(samples)


# --- on the card ---

def _sweep(f0, f1, rate, ch, dur):
    return lambda: generate_frequency_sweep(f0, f1, rate, ch, dur)


def _four_channel():
    base = generate_sine_wave(440.0, 44100, 1, 0.5)
    samples = np.empty(len(base) * 4, np.float32)
    for c in range(4):
        samples[c::4] = base * np.float32(0.5 + 0.1 * c)
    return samples


# name -> (input, rate, channels, the JAX test's SNR floor or None)
CUDA_MATRIX = {
    "sine_100_mono": (lambda: _gen("sine", 100.0, 44100, 1, 4.0), 44100, 1,
                      -10.0),
    "sine_440_48k": (lambda: _gen("sine", 440.0, 48000, 1, 5.0), 48000, 1,
                     -10.0),
    "sine_440_stereo": (lambda: _gen("sine", 440.0, 44100, 2, 5.0), 44100, 2,
                        -10.0),
    "square_1000_48k_stereo": (lambda: _gen("square", 1000.0, 48000, 2, 4.0),
                               48000, 2, -15.0),
    "sawtooth_440": (lambda: _gen("sawtooth", 440.0, 44100, 1, 5.0), 44100, 1,
                     -15.0),
    "sweep_200_8000_48k": (_sweep(200.0, 8000.0, 48000, 1, 8.0), 48000, 1,
                           -10.0),
    "sweep_440_880_stereo": (_sweep(440.0, 880.0, 44100, 2, 6.0), 44100, 2,
                             -10.0),
    "rate_8000": (lambda: generate_sine_wave(440.0, 8000, 1, 0.5), 8000, 1,
                  -10.0),
    "rate_22050": (lambda: generate_sine_wave(440.0, 22050, 1, 0.5), 22050,
                   1, -10.0),
    "rate_96000": (lambda: generate_sine_wave(440.0, 96000, 1, 0.5), 96000,
                   1, -10.0),
    "four_channel": (_four_channel, 44100, 4, None),
    "white_noise_stereo": (lambda: generate_white_noise(44100, 2, 2.0, 12345),
                           44100, 2, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_MATRIX))
def test_cuda_codec_matrix(cuda_device, launched_rows, name):
    """The codec matrix's inputs on the card: the container within the pair
    contract of the CPU port's, the decode within 1 LSB (as int16) of the
    CPU port's decode of the same container, the decoded length exact and
    the JAX test's SNR floor met; each kernel held to plain at every row
    count the case launched it with, at the rate's tables
    (tests/test_torch_rates.py's `check_kernel_rows`)."""
    make, rate, channels, floor = CUDA_MATRIX[name]
    samples = make()
    ea = Encoder(rate, device="cuda").encode(samples, channels)
    check_containers(ea, Encoder(rate, device="cpu").encode(samples, channels))
    out = Decoder(channels, rate, device="cuda").decode(ea)
    assert_lsb(out, Decoder(channels, rate, device="cpu").decode(ea))
    assert len(out) == len(samples)
    if floor is not None:
        assert calculate_snr(samples, out) > floor
    check_kernel_rows(rate, launched_rows)
