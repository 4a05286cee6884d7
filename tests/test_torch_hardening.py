"""The JAX package's native-layer hardening and container fuzz suites
(tests/test_native_hardening.py, tests/test_cross_writer_fuzz.py) on the
port's Python side of each native call: glc_tpu_torch.native,
glc_tpu_torch.container.{bincode,schema} and glc_tpu_torch.flac.

The port loads the same library (native/, built by make) as the JAX
package, so these cases check what the port passes to it and makes of
what comes back.  Each case asserts the JAX test's own assertion on the
port, then the cross contract: the same bytes as the JAX package's
writers, the same fields from its parsers, the same exception types and
messages on hostile input.  All of it is exact: no tolerance applies.

The JAX package is imported inside the tests that use it, so the module
collects without JAX.
"""

import ctypes as c
import hashlib
import importlib
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_flac_conformance import (  # noqa: E402
    BS,
    constant_frame,
    finish_frame,
    frame_header,
    outcome,
    rice_residual,
    stream_header,
)

from glc_tpu_torch.container import bincode, schema  # noqa: E402
from glc_tpu_torch.container.bincode import BincodeError  # noqa: E402
from glc_tpu_torch.flac import bitpack  # noqa: E402
from glc_tpu_torch.flac.decoder import FlacDecodeError, decode_flac  # noqa: E402
from glc_tpu_torch.native import get_native  # noqa: E402

NATIVE = get_native() is not None
needs_native = pytest.mark.skipif(not NATIVE,
                                  reason="native library unavailable")


def jax_module(name: str):
    return importlib.import_module(f"glc_tpu.{name}")


def raised(fn, *args):
    """(exception type name, message) of fn(*args), or None if it
    returns."""
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e)
    return None


# --- tests/test_native_hardening.py ---

def _truncated_raw_length():
    """A raw record whose 8-byte length sits in the gapless tail, with a
    hostile length (tests/test_native_hardening.py:28-50)."""
    buf = struct.pack("<IHQ", 44100, 1, 0)          # header (14 B)
    buf += struct.pack("<Q", 2)                      # F = 2
    buf += struct.pack("<Q", 0)                      # outer = 0 (raw)
    buf += struct.pack("<Q", 0)                      # sl = 0
    buf += b"\x01"                                   # the raw tag
    buf += struct.pack("<Q", (1 << 63) - (1 << 40))  # a hostile L
    buf += b"\x00" * 8
    assert len(buf) == 55
    milder = bytearray(buf)
    struct.pack_into("<Q", milder, 39, (1 << 63) - 4)
    return [buf, bytes(milder)]


@pytest.mark.parametrize("variant", [0, 1], ids=["hostile", "milder"])
def test_container_truncated_raw_length_no_crash(variant):
    """BincodeError from the port's parser, with the JAX package's type
    and message."""
    data = _truncated_raw_length()[variant]
    with pytest.raises(BincodeError):
        bincode.deserialize_encoded(data)
    assert raised(bincode.deserialize_encoded, data) == raised(
        jax_module("container.bincode").deserialize_encoded, data)


def _lpc_overflow_stream(bp):
    """An order-8 LPC frame built to overflow an int64 predictor sum."""
    order = 8
    w = bp.BitWriter()
    stream_header(bp, w, 1, BS)
    start = frame_header(bp, w, 0b0000)
    w.write_bits(0, 1)
    w.write_bits(0b100000 | (order - 1), 6)
    w.write_bits(0, 1)
    for _ in range(order):                   # warm-ups at int16 max
        w.write_bits(32767, 16)
    w.write_bits(15 - 1, 4)                  # precision 15
    w.write_bits(0, 5)                       # shift 0
    for _ in range(order):                   # coefficients at +16383
        w.write_bits(16383, 15)
    rice_residual(w, np.zeros(BS - order, np.int64), 0)
    finish_frame(bp, w, start)
    return w.get_bytes()


def test_flac_lpc_overflow_stream_defined_behavior():
    """Defined garbage of the block's length, or FlacDecodeError; the JAX
    package's decoder gives the same outcome on the same bytes."""
    data = _lpc_overflow_stream(bitpack)
    assert data == _lpc_overflow_stream(jax_module("flac.bitpack"))
    got = outcome(decode_flac, data)
    if isinstance(got[0], str):
        assert got[0] == "FlacDecodeError"
    else:
        assert len(got[0]) == BS
    want = outcome(jax_module("flac.decoder").decode_flac, data)
    assert len(got) == len(want)
    if isinstance(got[0], str):
        assert got == want
    else:
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def _frames_stream(bp, total: int, frames: int) -> bytes:
    w = bp.BitWriter()
    stream_header(bp, w, 1, total)
    for f in range(frames):
        constant_frame(bp, w, f)
    return w.get_bytes()


def test_flac_decompression_bomb_capped():
    """A frame past STREAMINFO's declared total: FlacDecodeError, with the
    JAX package's message."""
    data = _frames_stream(bitpack, BS, 2)
    with pytest.raises(FlacDecodeError):
        decode_flac(data)
    assert raised(decode_flac, data) == raised(
        jax_module("flac.decoder").decode_flac, data)


def test_flac_silent_file_with_unknown_total_decodes():
    """total 0 (unknown): eight constant frames decode to 8 x 16 zeros,
    as in the JAX package."""
    data = _frames_stream(bitpack, 0, 8)
    dec, rate, ch, bps = decode_flac(data)
    assert len(dec) == 8 * BS and not dec.any()
    jdec, *jfmt = jax_module("flac.decoder").decode_flac(data)
    assert jfmt == [rate, ch, bps] and np.array_equal(dec, jdec)


@needs_native
def test_native_pack_clamps_hostile_rice_params():
    """Rice parameters of 31 through the port's `_pack`: clamped by the
    library, the stream decodes to the samples, and the bytes equal the
    JAX package's `_pack` of the same arguments."""
    from glc_tpu_torch.flac.encoder import _pack

    total = bs = 4096
    i16 = np.zeros(total, np.int16)
    order = bitpack.predictor_order(bs, 5)
    po = bitpack.partition_order(bs, order, 5)
    md5 = hashlib.md5(i16.astype("<i2").tobytes()).digest()
    args = (i16, 1, 44100, 5, md5, np.asarray([bs], np.int32),
            np.zeros(total, np.int32), np.full(1 << po, 31, np.int8))
    data = _pack(*args)
    dec, _rate, _ch, _bps = decode_flac(data)
    np.testing.assert_array_equal(dec, i16.astype(np.int32))
    assert data == jax_module("flac.encoder")._pack(*args)


def _overflowing_nnz(sc):
    fs = sc.FrameSet(np.array([[(1 << 62) + 10]], np.int64),
                     np.empty(0, sc.PAIR_DTYPE), np.ones((1, 1), np.float32),
                     np.zeros(1, bool), np.empty((0, 2048), np.int16))
    return sc.EncodedAudio(sc.AudioHeader(44100, 1, 0), fs,
                           sc.GaplessInfo(512, 0, 0))


@needs_native
def test_native_serialize_rejects_overflowing_nnz():
    """nnz near 2^62: the port's native writer refuses cleanly (None), as
    the JAX package's does."""
    assert bincode._native_serialize(_overflowing_nnz(schema)) is None
    jbin = jax_module("container.bincode")
    assert jbin._native_serialize(
        _overflowing_nnz(jax_module("container.schema"))) is None


@needs_native
def test_native_fill_self_bounding_against_mutated_buffer():
    """The fill pass through the port's loader: a buffer valid at scan
    time and mutated before fill gets an error code, not an overrun."""
    lib = get_native()
    buf = bytearray()
    buf += struct.pack("<IHQ", 44100, 1, 0)
    buf += struct.pack("<Q", 2)                       # F
    for cnt in (2, 1):
        buf += struct.pack("<Q", 1)                   # outer = C
        buf += struct.pack("<Q", cnt)                 # nnz
        buf += b"\x01\x00\x02\x00" * cnt              # pairs
        buf += struct.pack("<Q", 1) + struct.pack("<f", 1.0) + b"\x00"
    buf += struct.pack("<IIQ", 512, 0, 0)
    arr = np.frombuffer(bytes(buf), np.uint8).copy()
    bp = arr.ctypes.data_as(c.POINTER(c.c_uint8))
    sr, ch, ts = c.c_uint32(), c.c_uint16(), c.c_uint64()
    ed, pad, ol = c.c_uint32(), c.c_uint32(), c.c_uint64()
    F, K, R, L = c.c_int64(), c.c_int64(), c.c_int64(), c.c_int64()
    rc = lib.glc_container_scan(bp, len(arr), c.byref(sr), c.byref(ch),
                                c.byref(ts), c.byref(ed), c.byref(pad),
                                c.byref(ol), c.byref(F), c.byref(K),
                                c.byref(R), c.byref(L))
    assert rc == 0 and K.value == 3
    # the port's parser reads the valid buffer as the JAX package's does
    parsed = bincode._native_deserialize(bytes(buf))
    assert parsed is not None and int(parsed.frame_set.nnz.sum()) == 3
    struct.pack_into("<Q", arr, 22 + 8, 1 << 20)  # frame 0's count, inflated
    nnz = np.zeros((2, 1), np.int64)
    pairs = np.empty(K.value, schema.PAIR_DTYPE)
    scales = np.zeros((2, 1), np.float32)
    raw_mask = np.zeros(2, np.uint8)
    raw_pcm = np.empty((0, 2048), np.int16)
    rc = lib.glc_container_fill(
        bp, len(arr), F.value, 1,
        nnz.ctypes.data_as(c.POINTER(c.c_int64)),
        pairs.view(np.uint8).ctypes.data_as(c.POINTER(c.c_uint8)), K.value,
        scales.ctypes.data_as(c.POINTER(c.c_float)),
        raw_mask.ctypes.data_as(c.POINTER(c.c_uint8)),
        raw_pcm.ctypes.data_as(c.POINTER(c.c_int16)), 0, 2048,
    )
    assert rc != 0
    with pytest.raises(BincodeError):
        bincode.deserialize_encoded(arr.tobytes())


# --- tests/test_cross_writer_fuzz.py ---

def random_encoded(rng: np.random.Generator, sc):
    """tests/test_cross_writer_fuzz.py's random, structurally valid
    container, built with the schema module `sc` (either package's): the
    same draws give the same fields."""
    F = int(rng.integers(1, 40))
    C = int(rng.integers(1, 4))
    frame_size = 2048
    n = frame_size // 2
    raw_mask = rng.random(F) < 0.25
    nnz = rng.integers(0, 60, (F, C)).astype(np.int64)
    nnz[raw_mask] = 0
    K = int(nnz.sum())
    pairs = np.empty(K, sc.PAIR_DTYPE)
    off = 0
    for f in range(F):
        for ch in range(C):
            m = int(nnz[f, ch])
            if m:
                ks = np.sort(rng.choice(n, size=m, replace=False))
                pairs["k"][off: off + m] = ks.astype(np.uint16)
                off += m
    pairs["q"] = rng.integers(-32768, 32768, K).astype(np.int16)
    scales = rng.random((F, C)).astype(np.float32) + np.float32(1e-3)
    scales[raw_mask] = 0.0   # raw frames carry no scales on the wire
    R = int(raw_mask.sum())
    raw_pcm = rng.integers(-32768, 32768, (R, frame_size * C)).astype(np.int16)
    rate = int(rng.choice([8000, 44100, 48000, 96000]))
    total = int(rng.integers(0, 1 << 40))
    return sc.EncodedAudio(
        header=sc.AudioHeader(rate, C, total),
        frame_set=sc.FrameSet(nnz, pairs, scales, raw_mask, raw_pcm,
                              frame_size),
        gapless_info=sc.GaplessInfo(
            encoder_delay=int(rng.integers(0, 1 << 16)),
            padding=int(rng.integers(0, 1 << 16)),
            original_length=total))


def both(seed: int, count: int):
    """`count` (port container, JAX container) pairs of the same draws."""
    jsc = jax_module("container.schema")
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    return [(random_encoded(ra, schema), random_encoded(rb, jsc))
            for _ in range(count)]


def assert_equal_encoded(a, b) -> None:
    assert (a.header.sample_rate, a.header.channels, a.header.total_samples) \
        == (b.header.sample_rate, b.header.channels, b.header.total_samples)
    assert (a.gapless_info.encoder_delay, a.gapless_info.padding,
            a.gapless_info.original_length) == (
        b.gapless_info.encoder_delay, b.gapless_info.padding,
        b.gapless_info.original_length)
    fa, fb = a.frame_set, b.frame_set
    for field in ("nnz", "pairs", "scales", "raw_mask", "raw_pcm"):
        np.testing.assert_array_equal(getattr(fa, field), getattr(fb, field))


@needs_native
def test_cross_writer_byte_identity():
    """native == numpy writer, byte for byte, over 40 random containers,
    and both equal the JAX package's writer on the same fields."""
    jbin = jax_module("container.bincode")
    for ea, jea in both(42, 40):
        nat = bincode._native_serialize(ea)
        assert nat is not None
        assert nat == bincode._serialize_encoded_numpy(ea)
        assert nat == jbin._serialize_encoded_numpy(jea)


@needs_native
def test_cross_parser_field_identity():
    """native-parse(numpy bytes) and numpy-parse(native bytes) give the
    original fields, and so does the JAX package's numpy parser."""
    jbin = jax_module("container.bincode")
    for ea, _jea in both(43, 25):
        nat_bytes = bincode._native_serialize(ea)
        npy_bytes = bincode._serialize_encoded_numpy(ea)
        via_native = bincode._native_deserialize(npy_bytes)
        assert via_native is not None
        assert_equal_encoded(via_native, ea)
        assert_equal_encoded(bincode._deserialize_encoded_numpy(nat_bytes), ea)
        assert_equal_encoded(jbin._deserialize_encoded_numpy(nat_bytes), ea)


def test_roundtrip_default_path():
    """The public serialize/deserialize pair is the identity and
    byte-stable on 15 random containers; the JAX package reads the port's
    bytes and writes them back unchanged."""
    jbin = jax_module("container.bincode")
    for ea, _jea in both(44, 15):
        data = bincode.serialize_encoded(ea)
        back = bincode.deserialize_encoded(data)
        assert_equal_encoded(back, ea)
        assert bincode.serialize_encoded(back) == data
        assert jbin.serialize_encoded(jbin.deserialize_encoded(data)) == data


def _edge_containers(sc, rng):
    F, C = 3, 2
    silent = sc.EncodedAudio(
        header=sc.AudioHeader(44100, C, 0),
        frame_set=sc.FrameSet(
            np.zeros((F, C), np.int64), np.empty(0, sc.PAIR_DTYPE),
            np.ones((F, C), np.float32), np.zeros(F, bool),
            np.empty((0, 2048 * C), np.int16)),
        gapless_info=sc.GaplessInfo(512, 0, 0))
    raw = rng.integers(-32768, 32768, (F, 2048 * C)).astype(np.int16)
    all_raw = sc.EncodedAudio(
        header=sc.AudioHeader(48000, C, 100),
        frame_set=sc.FrameSet(
            np.zeros((F, C), np.int64), np.empty(0, sc.PAIR_DTYPE),
            np.zeros((F, C), np.float32), np.ones(F, bool), raw),
        gapless_info=sc.GaplessInfo(512, 12, 100))
    return [silent, all_raw]


@pytest.mark.parametrize("case", [0, 1], ids=["all_empty", "all_raw"])
def test_empty_and_edge_shapes(case):
    """A silence-like container (zero pairs everywhere) and an all-raw
    one: round trip, the two writers equal, the JAX package's bytes."""
    ea = _edge_containers(schema, np.random.default_rng(45))[case]
    jea = _edge_containers(jax_module("container.schema"),
                           np.random.default_rng(45))[case]
    data = bincode.serialize_encoded(ea)
    assert_equal_encoded(bincode.deserialize_encoded(data), ea)
    if NATIVE:
        assert bincode._serialize_encoded_numpy(ea) == (
            bincode._native_serialize(ea))
    assert data == jax_module("container.bincode").serialize_encoded(jea)
