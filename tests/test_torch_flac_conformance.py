"""FLAC conformance of the port: the JAX package's tests/test_flac_spec_vectors.py,
tests/test_pydecoder.py and tests/test_flac_foreign.py on
glc_tpu_torch.flac and glc_tpu_torch.io, with multichannel WAV input at 4
and 6 channels.

Each case asserts the JAX test's own assertion on the port's decoders
(the native one, `decode_flac`, and the pure-Python twin,
`decode_flac_python`), encoder, CRCs and loaders, and then the cross
contract against the JAX package: FLAC bytes equal, decoded samples and
stream parameters exactly equal, error codes and exception types equal.
These are lossless host paths, so no tolerance applies anywhere.

The RFC 9639 byte literals are the ones of tests/test_flac_spec_vectors.py
(hand-derived there, field by field); the foreign streams are built by
`build_*` below with a package's own BitWriter and CRCs, passed in as a
module, so the same build function makes each stream with either package's
bitpack and the test holds the two to the same bytes.  The JAX package is
imported inside the tests that use it, so the module collects without JAX.
"""

import hashlib
import importlib
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from utils import generate_sine_wave, generate_white_noise  # noqa: E402

from glc_tpu_torch.flac import bitpack  # noqa: E402
from glc_tpu_torch.flac.decoder import FlacDecodeError, decode_flac  # noqa: E402
from glc_tpu_torch.flac.encoder import encode_flac_i16_with_level  # noqa: E402
from glc_tpu_torch.flac.pydecoder import decode_flac_python  # noqa: E402
from glc_tpu_torch.native import get_native  # noqa: E402

DECODERS = {"python": decode_flac_python}
if get_native() is not None:
    DECODERS["native"] = decode_flac
JAX_DECODERS = {"python": "glc_tpu.flac.pydecoder:decode_flac_python",
                "native": "glc_tpu.flac.decoder:decode_flac"}


def jax_fn(spec: str):
    module, name = spec.split(":")
    return getattr(importlib.import_module(module), name)


def outcome(decode, data: bytes):
    """(samples as int64, rate, channels, bps), or the exception's type
    name and message."""
    try:
        samples, rate, ch, bps = decode(data)
    except ValueError as e:
        return type(e).__name__, str(e)
    return np.asarray(samples, np.int64), rate, ch, bps


def assert_same_outcome(a, b):
    assert len(a) == len(b)
    if isinstance(a[0], np.ndarray):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
    else:
        assert a == b


# --- tests/test_flac_spec_vectors.py: RFC 9639 byte literals ---
# The streams of tests/test_flac_spec_vectors.py, byte for byte (that file
# derives each field from the RFC's text).

STREAM_A = bytes.fromhex(  # one CONSTANT subframe, value 42
    "664c6143800000220010001000000000"
    "00000ac440f000000010fc1f0eb1bdd4"
    "020cc1f5879b079e5342fff86908000f"
    "3000002ac67f")
STREAM_B = bytes.fromhex(  # one VERBATIM subframe, samples -8..7
    "664c6143800000220010001000000000"
    "00000ac440f000000010f07a1d9d17fc"
    "b0a078ea2dddf783d142fff86908000f"
    "3002fff8fff9fffafffbfffcfffdfffe"
    "ffff0000000100020003000400050006"
    "000740aa")
STREAM_C = bytes.fromhex(  # FIXED order 2 over i², Rice k = 1
    "664c6143800000220010001000000000"
    "00000ac440f00000001013fce363a1d5"
    "5cfee5df7c0486a313e8fff86908000f"
    "301400000001004888888888888880b6"
    "c1")
STREAM_D = bytes.fromhex(  # independent stereo, two frames of constants
    "664c6143800000220010001000000000"
    "00000ac442f0000000200bf4e24bb07f"
    "adafe801fa276880d046fff86918000f"
    "9200006400ff9cfd53fff86918010f87"
    "00006400ff9cef63")
STREAM_E = bytes.fromhex(  # FIXED order 1, partition order 1
    "664c614380000022001000100000000000000ac440f000000010ff4368299c50"
    "dbff7a7bd15e91f91a76fff86908000f301200000402108421089111111100ec"
    "9f")
STREAM_F = bytes.fromhex(  # FIXED order 0, an escape-coded partition
    "664c614380000022001000100000000000000ac440f000000010f07a1d9d17fc"
    "b0a078ea2dddf783d142fff86908000f301003cb8ceb7cefbe008864298e5d33")

# name -> (stream, expected interleaved samples, channels)
SPEC_VECTORS = {
    "constant": (STREAM_A, [42] * 16, 1),
    "verbatim": (STREAM_B, list(range(-8, 8)), 1),
    "fixed_order2_rice": (STREAM_C, [i * i for i in range(16)], 1),
    "stereo_two_frames": (STREAM_D, [100, -100] * 32, 2),
    "fixed_order1_two_partitions": (STREAM_E, [2 * i for i in range(16)], 1),
    "escape_coded_partition": (STREAM_F, list(range(-8, 8)), 1),
}


@pytest.mark.parametrize("decoder", sorted(DECODERS))
@pytest.mark.parametrize("name", list(SPEC_VECTORS))
def test_spec_vector_decodes(name, decoder):
    """The stream's exact samples and parameters (44.1 kHz, 16-bit), from
    the port's decoder and the JAX package's same decoder alike."""
    stream, expected, channels = SPEC_VECTORS[name]
    got = outcome(DECODERS[decoder], stream)
    assert got[1:] == (44100, channels, 16)
    np.testing.assert_array_equal(got[0], np.asarray(expected, np.int64))
    assert_same_outcome(got, outcome(jax_fn(JAX_DECODERS[decoder]), stream))


def test_encoder_framing_golden_level0():
    """Level 0 on 16 mono samples emits exactly stream B (the block size
    clamps to the sample count, level 0 takes the verbatim subframe), as
    the JAX package's encoder does."""
    from glc_tpu.flac.encoder import encode_flac_i16_with_level as jax_encode

    pcm = np.arange(-8, 8, dtype=np.int16)
    got = encode_flac_i16_with_level(pcm, 44100, 1, 0)
    assert got == STREAM_B
    assert jax_encode(pcm, 44100, 1, 0) == got


@pytest.mark.parametrize("crc,check", [("crc8", 0xF4), ("crc16", 0xFEE8)])
def test_crc_published_check_values(crc, check):
    """CRC-8/SMBUS and CRC-16/UMTS, RFC 9639's frame CRCs:
    check("123456789") and the empty input, equal to the JAX package's."""
    from glc_tpu.flac import bitpack as jax_bitpack

    fn = getattr(bitpack, crc)
    assert fn(b"123456789") == check
    assert fn(b"") == 0
    data = np.random.default_rng(7).integers(0, 256, 4099, np.uint8).tobytes()
    assert fn(data) == getattr(jax_bitpack, crc)(data)


def test_md5_rfc1321_vectors():
    """RFC 1321's vectors, and the STREAMINFO MD5 of a known PCM buffer:
    the MD5 of its little-endian int16 bytes, in the JAX package's
    stream's bytes."""
    from glc_tpu.flac.encoder import encode_flac_i16_with_level as jax_encode

    assert hashlib.md5(b"").hexdigest() == "d41d8cd98f00b204e9800998ecf8427e"
    assert hashlib.md5(b"abc").hexdigest() == "900150983cd24fb0d6963f7d28e17f72"
    pcm = np.array([42] * 16, np.int16)
    stream = encode_flac_i16_with_level(pcm, 44100, 1, 5)
    md5_field = stream[4 + 4 + 18: 4 + 4 + 34]
    assert md5_field == hashlib.md5(pcm.astype("<i2").tobytes()).digest()
    assert md5_field.hex() == "fc1f0eb1bdd4020cc1f5879b079e5342"
    assert jax_encode(pcm, 44100, 1, 5) == stream


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_corrupt_crc_rejected(decoder):
    """The last CRC-16 byte flipped: a ValueError, of the JAX package's
    type and message."""
    bad = bytearray(STREAM_A)
    bad[-1] ^= 0xFF
    got = outcome(DECODERS[decoder], bytes(bad))
    assert isinstance(got[0], str)
    assert got == outcome(jax_fn(JAX_DECODERS[decoder]), bytes(bad))


# --- tests/test_pydecoder.py: the Python twin against the native decoder ---

def _i16(x):
    return np.clip(x * 32767.0, -32768, 32767).astype(np.int16)


PCM_CASES = {
    "sine_stereo": (lambda: _i16(generate_sine_wave(440.0, 44100, 2, 0.4)),
                    2, 44100),
    "noise_mono": (lambda: _i16(generate_white_noise(48000, 1, 0.3, 7)),
                   1, 48000),
    "silence": (lambda: np.zeros(4096, np.int16), 1, 44100),
    "minimum_16": (lambda: np.arange(16, dtype=np.int16), 1, 44100),
}


def native_or_skip():
    if get_native() is None:
        pytest.skip("native library unavailable: nothing to compare against")


@pytest.mark.parametrize("level", [0, 5, 8])
@pytest.mark.parametrize("name", list(PCM_CASES))
def test_python_decoder_matches_native(name, level):
    """The port's two decoders give the same samples and parameters, equal
    to the source PCM; the bytes equal the JAX package's encoder's."""
    from glc_tpu.flac.encoder import encode_flac_i16_with_level as jax_encode

    native_or_skip()
    make, ch, rate = PCM_CASES[name]
    pcm = make()
    data = bytes(encode_flac_i16_with_level(pcm, rate, ch, level))
    assert data == bytes(jax_encode(pcm, rate, ch, level))
    s_n, *fmt_n = decode_flac(data)
    s_p, *fmt_p = decode_flac_python(data)
    assert fmt_n == fmt_p == [rate, ch, 16]
    assert np.array_equal(s_n, s_p)
    assert np.array_equal(s_n.astype(np.int16), pcm)


@pytest.mark.parametrize("bad,code", [
    (b"", -1),
    (b"fLaC", -1),                   # < 8 bytes: the magic check fails first
    (b"fLaC\x80\x00\x00", -1),       # still < 8 bytes
    (b"fLaC\x00\x00\x00\xff", -2),   # a truncated metadata block
    (b"not-flac" + b"\x00" * 64, -1),
])
def test_python_decoder_error_codes(bad, code):
    """The Python twin's error codes, with the JAX twin's message."""
    with pytest.raises(ValueError, match=str(code)) as info:
        decode_flac_python(bad)
    with pytest.raises(ValueError) as jax_info:
        jax_fn(JAX_DECODERS["python"])(bad)
    assert (type(info.value).__name__, str(info.value)) == (
        type(jax_info.value).__name__, str(jax_info.value))


def test_truncated_stream_error_matches_native():
    """A stream cut by 3 bytes: both decoders raise with the same code, as
    the JAX package's decoders do."""
    native_or_skip()
    data = bytes(encode_flac_i16_with_level(np.zeros(4096, np.int16),
                                            44100, 1, 5))[:-3]
    errs = {}
    for name, decode in DECODERS.items():
        got = outcome(decode, data)
        assert isinstance(got[0], str)
        assert got == outcome(jax_fn(JAX_DECODERS[name]), data)
        errs[name] = got[1].split()[-1]
    assert errs["native"] == errs["python"]


def test_differential_fuzz_python_vs_native():
    """tests/test_pydecoder.py's 80 mutated streams (byte flips,
    truncations, short random injections, seed 11): the port's two
    decoders agree (same samples on acceptance, same error code on
    rejection), most mutations are rejected, and each outcome equals the
    JAX package's Python twin's."""
    native_or_skip()
    jax_python = jax_fn(JAX_DECODERS["python"])
    base = bytes(encode_flac_i16_with_level(
        _i16(generate_sine_wave(330.0, 44100, 2, 0.25)), 44100, 2, 5))
    rng = np.random.default_rng(11)
    rejected = 0
    for trial in range(80):
        buf = bytearray(base)
        kind = trial % 3
        if kind == 0:    # a byte flip anywhere
            i = int(rng.integers(0, len(buf)))
            buf[i] ^= int(rng.integers(1, 256))
        elif kind == 1:  # a truncation
            buf = buf[: int(rng.integers(0, len(buf)))]
        else:            # a short random injection
            i = int(rng.integers(0, len(buf) - 4))
            buf[i: i + 4] = rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
        data = bytes(buf)
        out_n = outcome(decode_flac, data)
        out_p = outcome(decode_flac_python, data)
        if isinstance(out_n[0], str):
            assert isinstance(out_p[0], str), f"trial {trial}"
            assert out_n[1].split()[-1] == out_p[1].split()[-1], f"trial {trial}"
            rejected += 1
        else:
            assert_same_outcome(out_n, out_p)
        assert_same_outcome(out_p, outcome(jax_python, data))
    assert rejected > 10


# --- tests/test_flac_foreign.py: streams the encoder never writes ---
# Each build_* function takes a package's bitpack module (BitWriter, crc8, crc16,
# write_utf8_number) and returns the stream's bytes.

BS = 16  # the block size of every built frame
RATE = 44100


def stream_header(bp, w, channels: int, total: int, bps: int = 16):
    w.write_bytes(b"fLaC")
    w.write_bits(1, 1)       # the last metadata block
    w.write_bits(0, 7)       # STREAMINFO
    w.write_bits(34, 24)
    w.write_bits(BS, 16)
    w.write_bits(BS, 16)
    w.write_bits(0, 24)
    w.write_bits(0, 24)
    w.write_bits(RATE, 20)
    w.write_bits(channels - 1, 3)
    w.write_bits(bps - 1, 5)
    w.write_bits(total, 36)
    w.write_bytes(b"\x00" * 16)  # MD5, unchecked by the decoders


def frame_header(bp, w, chan_assign: int, frame_no: int = 0,
                 size_code: int = 0b100):
    start = len(w.buf)
    w.write_bits(0x3FFE, 14)
    w.write_bits(0, 1)
    w.write_bits(0, 1)
    w.write_bits(0b0110, 4)          # an 8-bit block size - 1 follows
    w.write_bits(0b1001, 4)          # 44100
    w.write_bits(chan_assign, 4)
    w.write_bits(size_code, 3)       # 0b100 16-bit, 0b110 24-bit
    w.write_bits(0, 1)
    bp.write_utf8_number(w, frame_no)
    w.write_byte(BS - 1)
    w.write_byte(bp.crc8(bytes(w.buf[start:])))
    return start


def finish_frame(bp, w, start: int):
    w.byte_align()
    w.write_bits(bp.crc16(bytes(w.buf[start:])), 16)


def verbatim_subframe(w, samples, bps: int):
    w.write_bits(0, 1)
    w.write_bits(0b000001, 6)
    w.write_bits(0, 1)
    for s in samples:
        w.write_bits(int(s) & ((1 << bps) - 1), bps)


def rice_residual(w, residuals, k: int):
    w.write_bits(0, 2)   # the 4-bit method
    w.write_bits(0, 4)   # partition order 0
    w.write_bits(k, 4)
    for s in residuals:
        s = int(s)
        folded = (s << 1) if s >= 0 else (((-(s + 1)) << 1) | 1)
        w.write_unary(folded >> k)
        if k:
            w.write_bits(folded & ((1 << k) - 1), k)


def constant_frame(bp, w, frame_no: int = 0, value: int = 0):
    start = frame_header(bp, w, 0b0000, frame_no)
    w.write_bits(0, 1)
    w.write_bits(0b000000, 6)  # constant
    w.write_bits(0, 1)
    w.write_bits(value & 0xFFFF, 16)
    finish_frame(bp, w, start)


def build_constant(bp):
    w = bp.BitWriter()
    stream_header(bp, w, 1, BS)
    constant_frame(bp, w, 0, -1234)
    return w.get_bytes()


def _stereo_pair(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(-20000, 20000, BS).astype(np.int64),
            rng.integers(-20000, 20000, BS).astype(np.int64))


def _stereo(bp, chan_assign, ch0, ch1, bps0, bps1):
    w = bp.BitWriter()
    stream_header(bp, w, 2, BS)
    start = frame_header(bp, w, chan_assign)
    verbatim_subframe(w, ch0, bps0)
    verbatim_subframe(w, ch1, bps1)
    finish_frame(bp, w, start)
    return w.get_bytes()


def build_mid_side(bp):
    L, R = _stereo_pair(0)
    return _stereo(bp, 0b1010, (L + R) >> 1, L - R, 16, 17)


def build_left_side(bp):
    L, R = _stereo_pair(1)
    return _stereo(bp, 0b1000, L, L - R, 16, 17)


def build_right_side(bp):
    L, R = _stereo_pair(2)
    return _stereo(bp, 0b1001, L - R, R, 17, 16)


def lpc_signal():
    rng = np.random.default_rng(3)
    return np.cumsum(rng.integers(-50, 50, BS)).astype(np.int64)


def build_lpc(bp):
    """Order-1 LPC, coefficient 1, shift 0: pred = x[i-1]."""
    x = lpc_signal()
    w = bp.BitWriter()
    stream_header(bp, w, 1, BS)
    start = frame_header(bp, w, 0b0000)
    w.write_bits(0, 1)
    w.write_bits(0b100000, 6)        # LPC order 1
    w.write_bits(0, 1)
    w.write_bits(int(x[0]) & 0xFFFF, 16)
    w.write_bits(15 - 1, 4)          # precision 15
    w.write_bits(0, 5)               # shift 0
    w.write_bits(1, 15)              # coefficient +1
    rice_residual(w, x[1:] - x[:-1], 6)
    finish_frame(bp, w, start)
    return w.get_bytes()


WASTED = (np.arange(BS, dtype=np.int64) - 8) * 2   # all even


def build_wasted_bits(bp):
    """Verbatim samples stored at bps - 1 with one wasted bit."""
    w = bp.BitWriter()
    stream_header(bp, w, 1, BS)
    start = frame_header(bp, w, 0b0000)
    w.write_bits(0, 1)
    w.write_bits(0b000001, 6)        # verbatim
    w.write_bits(1, 1)               # the wasted-bits flag
    w.write_unary(0)                 # unary 0: one wasted bit
    for s in WASTED >> 1:
        w.write_bits(int(s) & 0x7FFF, 15)
    finish_frame(bp, w, start)
    return w.get_bytes()


ESCAPED = np.array([0, 5, -3, 7, 1, -8, 2, 0, 4, -6, 3, 1, -2, 5, 0, -1],
                   np.int64)


def build_escape(bp):
    """Fixed order 1, its residual partition escaped to 6-bit raws."""
    x = ESCAPED
    w = bp.BitWriter()
    stream_header(bp, w, 1, BS)
    start = frame_header(bp, w, 0b0000)
    w.write_bits(0, 1)
    w.write_bits(0b001001, 6)        # fixed order 1
    w.write_bits(0, 1)
    w.write_bits(int(x[0]) & 0xFFFF, 16)
    w.write_bits(0, 2)
    w.write_bits(0, 4)
    w.write_bits(0xF, 4)             # escape
    w.write_bits(6, 5)               # 6-bit raw residuals
    for s in x[1:] - x[:-1]:
        w.write_bits(int(s) & 0x3F, 6)
    finish_frame(bp, w, start)
    return w.get_bytes()


I24 = np.array([0, 1 << 20, -(1 << 20), (1 << 23) - 1, -(1 << 23), 42, -7,
                12345, -54321, 99, -99, 7, 1, -1, 2, -2], np.int64)


def build_24bit(bp):
    w = bp.BitWriter()
    stream_header(bp, w, 1, BS, bps=24)
    start = frame_header(bp, w, 0b0000, size_code=0b110)
    verbatim_subframe(w, I24, 24)
    finish_frame(bp, w, start)
    return w.get_bytes()


def _interleave(a, b):
    out = np.empty(2 * len(a), np.int64)
    out[0::2], out[1::2] = a, b
    return out


# name -> (build function, expected interleaved samples, channels, bits)
FOREIGN = {
    "constant": (build_constant, np.full(BS, -1234, np.int64), 1, 16),
    "mid_side": (build_mid_side, _interleave(*_stereo_pair(0)), 2, 16),
    "left_side": (build_left_side, _interleave(*_stereo_pair(1)), 2, 16),
    "right_side": (build_right_side, _interleave(*_stereo_pair(2)), 2, 16),
    "lpc": (build_lpc, lpc_signal(), 1, 16),
    "wasted_bits": (build_wasted_bits, WASTED, 1, 16),
    "escape": (build_escape, ESCAPED, 1, 16),
    "24bit": (build_24bit, I24, 1, 24),
}


@pytest.mark.parametrize("decoder", sorted(DECODERS))
@pytest.mark.parametrize("name", list(FOREIGN))
def test_foreign_stream_decodes(name, decoder):
    """Constant and LPC subframes, the three side-stereo modes, wasted
    bits, an escape-coded partition and 24-bit samples: the exact samples,
    from the port's decoder and the JAX package's alike; the port's
    bitpack builds the JAX package's bytes."""
    from glc_tpu.flac import bitpack as jax_bitpack

    build, expected, channels, bits = FOREIGN[name]
    data = build(bitpack)
    assert data == build(jax_bitpack)
    got = outcome(DECODERS[decoder], data)
    assert got[1:] == (RATE, channels, bits)
    np.testing.assert_array_equal(got[0], expected)
    assert_same_outcome(got, outcome(jax_fn(JAX_DECODERS[decoder]), data))


def test_foreign_build_functions_make_the_jax_tests_streams():
    """The build functions above make the streams tests/test_flac_foreign.py
    makes (with the JAX package's BitWriter) for the cases both have."""
    import test_flac_foreign as jf
    from glc_tpu.flac.bitpack import BitWriter

    w = BitWriter()
    jf.stream_header(w, 1, BS)
    start = jf.frame_header(w, 0b0000)
    w.write_bits(0, 1)
    w.write_bits(0, 6)
    w.write_bits(0, 1)
    w.write_bits(-1234 & 0xFFFF, 16)
    jf.finish_frame(w, start)
    assert w.get_bytes() == build_constant(bitpack)
    L, R = _stereo_pair(0)
    assert jf._stereo_frames(0b1010, (L + R) >> 1, L - R, 16, 17) == (
        build_mid_side(bitpack))


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_foreign_crc_mismatch_rejected(decoder):
    """A constant frame with its CRC-16 corrupted: FlacDecodeError from
    the native decoder (ValueError from the twin), as in the JAX
    package."""
    data = bytearray(build_constant(bitpack))
    data[-1] ^= 0xFF
    got = outcome(DECODERS[decoder], bytes(data))
    assert isinstance(got[0], str)
    if decoder == "native":
        with pytest.raises(FlacDecodeError):
            decode_flac(bytes(data))
    assert got == outcome(jax_fn(JAX_DECODERS[decoder]), bytes(data))


def test_24bit_flac_load_path(tmp_path):
    """A 24-bit FLAC loads through load_audio_for_encode's f32 branch,
    normalized by 2^23, as the JAX package's loader gives it."""
    from glc_tpu.io.audio import load_audio_for_encode as jax_load

    from glc_tpu_torch.io.audio import load_audio_for_encode

    p = tmp_path / "i24.flac"
    p.write_bytes(build_24bit(bitpack))
    samples, rate, ch, pcm16 = load_audio_for_encode(p)
    assert (rate, ch, pcm16) == (RATE, 1, False)
    assert samples.dtype == np.float32
    np.testing.assert_allclose(samples, I24 / float(1 << 23), atol=1e-9)
    jsamples, *jfmt = jax_load(p)
    assert jfmt == [rate, ch, pcm16]
    assert np.array_equal(samples, jsamples)


# --- multichannel WAV input: WAVE_FORMAT_EXTENSIBLE at 4 and 6 channels ---

KSDATAFORMAT = {1: bytes.fromhex("0100000000001000800000aa00389b71"),
                3: bytes.fromhex("0300000000001000800000aa00389b71")}


def extensible_wav(pcm: np.ndarray, rate: int, channels: int, bits: int,
                   sub_format: int = 1) -> bytes:
    """A WAVE_FORMAT_EXTENSIBLE file (the layout of multichannel files:
    a 40-byte fmt chunk whose SubFormat GUID names PCM or float) holding
    the interleaved `pcm` (int samples at `bits`, or f32)."""
    width = bits // 8
    if sub_format == 3:
        body = np.asarray(pcm, "<f4").tobytes()
    elif bits == 24:
        v = np.asarray(pcm, np.int64) & 0xFFFFFF
        body = np.stack([v & 0xFF, (v >> 8) & 0xFF, v >> 16], 1).astype(
            np.uint8).tobytes()
    else:
        body = np.asarray(pcm, f"<i{width}").tobytes()
    mask = (1 << channels) - 1  # FL FR FC LFE BL BR for 6 channels
    fmt = struct.pack("<HHIIHHHHI", 0xFFFE, channels, rate,
                      rate * channels * width, channels * width, bits, 22,
                      bits, mask) + KSDATAFORMAT[sub_format]
    chunks = (b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data"
              + struct.pack("<I", len(body)) + body)
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


@pytest.mark.parametrize("bits,sub_format", [(16, 1), (24, 1), (32, 3)],
                         ids=["pcm16", "pcm24", "float32"])
@pytest.mark.parametrize("channels", [4, 6])
def test_extensible_multichannel_wav(tmp_path, channels, bits, sub_format):
    """A 4- or 6-channel WAVE_FORMAT_EXTENSIBLE file (16-bit, 24-bit or
    float): read_wav, read_wav_pcm16 and load_audio_for_encode give the
    JAX package's samples, rate and channels exactly; 16-bit goes the
    int16 path, the others the f32 path."""
    from glc_tpu.io import audio as jax_audio
    from glc_tpu.io import wav as jax_wav

    from glc_tpu_torch.io import audio, wav

    rng = np.random.default_rng(channels * 100 + bits)
    frames = 3000
    if sub_format == 3:
        pcm = rng.uniform(-1.0, 1.0, frames * channels).astype(np.float32)
    else:
        lim = 1 << (bits - 1)
        pcm = rng.integers(-lim, lim, frames * channels)
    p = tmp_path / f"multi{channels}.wav"
    p.write_bytes(extensible_wav(pcm, 48000, channels, bits, sub_format))

    samples, rate, ch = wav.read_wav(p)
    assert (rate, ch) == (48000, channels) and len(samples) == len(pcm)
    scale = 1.0 if sub_format == 3 else float(1 << (bits - 1))
    np.testing.assert_array_equal(samples, (pcm / scale).astype(np.float32))
    js, jrate, jch = jax_wav.read_wav(p)
    assert (jrate, jch) == (rate, ch) and np.array_equal(js, samples)

    pcm16 = wav.read_wav_pcm16(p)
    jpcm16 = jax_wav.read_wav_pcm16(p)
    if bits == 16:
        assert np.array_equal(pcm16[0], pcm.astype(np.int16))
        assert pcm16[1:] == jpcm16[1:] and np.array_equal(pcm16[0], jpcm16[0])
    else:
        assert pcm16 is None and jpcm16 is None

    got = audio.load_audio_for_encode(p)
    want = jax_audio.load_audio_for_encode(p)
    assert got[1:] == want[1:] == (48000, channels, bits == 16)
    assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
