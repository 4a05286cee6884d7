"""bincode-v1-compatible serialization of the .glc container.

Copied from ``glc_tpu/container/bincode.py``: the native path and its
bit-identical numpy fallback.  The wire format is unchanged, so each
package loads the other's ``.glc``.

Byte-compatible with Rust `bincode::serialize`/`deserialize` (bincode 1.3
legacy options: little-endian, fixed-width integers, u64 Vec lengths, Option as
a 1-byte tag) as used by the reference at src/codec.rs:774-786.  See SURVEY.md
Q9 for the wire layout.

Wire layout of `EncodedAudio` (reference src/codec.rs:31-69):

    AudioHeader   : u32 sample_rate | u16 channels | u64 total_samples
    frames        : u64 F, then per frame:
      compressed  : u64 C | per channel (u64 nnz, nnz×(u16 k, i16 q))
                    | u64 C | C×f32 scales | u8 0   (Option::None)
      raw         : u64 0 | u64 0 | u8 1 | u64 L | L×i16   (Option::Some)
    GaplessInfo   : u32 encoder_delay | u32 padding | u64 original_length

The writer is vectorized with numpy over the columnar `FrameSet` so that
serializing tens of thousands of frames costs a handful of array ops, not a
Python loop per coefficient.  The reader is a light sequential scan (the
format is length-prefixed) followed by one vectorized gather of all pair data.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Union

import numpy as np

from ..profiling import span
from .schema import (
    PAIR_DTYPE,
    AudioHeader,
    EncodedAudio,
    FrameSet,
    GaplessInfo,
)

_HEADER = struct.Struct("<IHQ")    # sample_rate, channels, total_samples
_GAPLESS = struct.Struct("<IIQ")   # encoder_delay, padding, original_length
_U64 = struct.Struct("<Q")

_AR8 = np.arange(8, dtype=np.int64)
_AR4 = np.arange(4, dtype=np.int64)


def _u64le_bytes(values: np.ndarray) -> np.ndarray:
    """[N] ints -> [N, 8] little-endian byte rows."""
    return values.astype("<u8").reshape(-1, 1).view(np.uint8).reshape(-1, 8)


def serialize_encoded(encoded: EncodedAudio) -> bytes:
    """Serialize to the bincode-v1 wire format.

    Uses the native single-pass writer (native/glc_native.cpp) when
    available; falls back to the vectorized numpy writer below (kept as the
    reference implementation — byte-identity is cross-checked in tests).
    While a profiler records, the call is the span
    ``glc.container.serialize``.
    """
    with span("glc.container.serialize"):
        native = _native_serialize(encoded)
        if native is not None:
            return native
        return _serialize_encoded_numpy(encoded)


def _native_serialize(encoded: EncodedAudio):
    import ctypes as c

    from ..native import get_native

    lib = get_native()
    if lib is None:
        return None
    fs = encoded.frame_set
    nnz = np.ascontiguousarray(fs.nnz, np.int64)
    pairs = np.ascontiguousarray(fs.pairs).view(np.uint8)
    scales = np.ascontiguousarray(fs.scales, np.float32)
    raw_mask = np.ascontiguousarray(fs.raw_mask, np.uint8)
    raw_pcm = np.ascontiguousarray(fs.raw_pcm, np.int16)
    out_ptr = c.POINTER(c.c_uint8)()
    out_len = c.c_int64()
    gi = encoded.gapless_info
    h = encoded.header
    rc = lib.glc_container_serialize(
        h.sample_rate, h.channels, h.total_samples,
        gi.encoder_delay, gi.padding, gi.original_length,
        fs.num_frames,
        nnz.ctypes.data_as(c.POINTER(c.c_int64)),
        pairs.ctypes.data_as(c.POINTER(c.c_uint8)),
        len(pairs) // 4,
        scales.ctypes.data_as(c.POINTER(c.c_float)),
        raw_mask.ctypes.data_as(c.POINTER(c.c_uint8)),
        raw_pcm.ctypes.data_as(c.POINTER(c.c_int16)),
        fs.raw_pcm.shape[1] if fs.raw_pcm.size else fs.frame_size * fs.channels,
        c.byref(out_ptr), c.byref(out_len),
    )
    if rc != 0:
        return None
    try:
        return bytes(
            c.cast(out_ptr, c.POINTER(c.c_uint8 * out_len.value)).contents
        )
    finally:
        lib.glc_free(out_ptr)


def _serialize_encoded_numpy(encoded: EncodedAudio) -> bytes:
    fs = encoded.frame_set
    F, C = fs.num_frames, fs.channels
    frame_size = fs.frame_size
    L = frame_size * C  # raw_pcm length per raw frame

    nnz = fs.nnz  # [F, C] int64; zero rows for raw frames
    raw_mask = fs.raw_mask
    comp_mask = ~raw_mask

    # --- per-frame record sizes ---
    nnz_per_frame = nnz.sum(axis=1)  # [F]
    comp_sizes = 8 + 8 * C + 4 * nnz_per_frame + 8 + 4 * C + 1
    raw_size = 8 + 8 + 1 + 8 + 2 * L
    sizes = np.where(raw_mask, raw_size, comp_sizes)

    body = 14 + 8 + int(sizes.sum()) + 16
    out = np.zeros(body, np.uint8)
    mv = memoryview(out)

    _HEADER.pack_into(
        mv, 0, encoded.header.sample_rate, encoded.header.channels,
        encoded.header.total_samples,
    )
    _U64.pack_into(mv, 14, F)

    frame_off = np.empty(F, np.int64)
    if F:
        np.cumsum(sizes[:-1], out=frame_off[1:])
        frame_off[0] = 0
        frame_off += 22

    gi = encoded.gapless_info
    _GAPLESS.pack_into(
        mv, body - 16, gi.encoder_delay, gi.padding, gi.original_length
    )

    # --- compressed frames (vectorized scatter) ---
    cf = np.flatnonzero(comp_mask)
    if cf.size:
        coff = frame_off[cf]
        # outer vec len = C at frame start
        c_row = np.frombuffer(_U64.pack(C), np.uint8)
        out[coff[:, None] + _AR8] = c_row

        # channel record offsets within each compressed frame
        ch_sizes = 8 + 4 * nnz[cf]                         # [Fc, C]
        ch_excl = np.zeros_like(ch_sizes)
        np.cumsum(ch_sizes[:, :-1], axis=1, out=ch_excl[:, 1:])
        ch_off = coff[:, None] + 8 + ch_excl               # [Fc, C]
        ch_off_flat = ch_off.reshape(-1)

        # per-channel nnz u64
        out[ch_off_flat[:, None] + _AR8] = _u64le_bytes(nnz[cf].reshape(-1))

        # pair payloads: fs.pairs is already in stream order (frame-major,
        # channel-major, compressed frames only since raw rows have nnz=0)
        nnz_flat = nnz[cf].reshape(-1)
        K = int(nnz_flat.sum())
        if K:
            seg_dst = ch_off_flat + 8
            seg_excl = np.zeros_like(nnz_flat)
            np.cumsum(nnz_flat[:-1], out=seg_excl[1:])
            within = np.arange(K, dtype=np.int64) - np.repeat(seg_excl, nnz_flat)
            dst = np.repeat(seg_dst, nnz_flat) + 4 * within
            pair_bytes = fs.pairs.view(np.uint8).reshape(-1, 4)
            if len(pair_bytes) != K:
                raise ValueError(
                    f"pair buffer has {len(pair_bytes)} entries, nnz sums to {K}"
                )
            out[dst[:, None] + _AR4] = pair_bytes

        # scales vec: u64 C then C×f32, then Option tag 0
        sc_off = coff + 8 + ch_sizes.sum(axis=1)
        out[sc_off[:, None] + _AR8] = c_row
        sc_bytes = (
            fs.scales[cf].astype("<f4", copy=False).view(np.uint8).reshape(-1, 4 * C)
        )
        out[sc_off[:, None] + (8 + np.arange(4 * C, dtype=np.int64))] = sc_bytes
        # option byte already 0 from np.zeros

    # --- raw frames ---
    rf = np.flatnonzero(raw_mask)
    if rf.size:
        prefix = np.zeros(25, np.uint8)
        prefix[16] = 1  # Option::Some tag after two empty-vec u64 lens
        prefix[17:25] = np.frombuffer(_U64.pack(L), np.uint8)
        pcm_bytes = fs.raw_pcm.astype("<i2", copy=False).view(np.uint8)
        for ri, fi in enumerate(rf):
            off = int(frame_off[fi])
            out[off : off + 25] = prefix
            out[off + 25 : off + 25 + 2 * L] = pcm_bytes[ri]

    return out.tobytes()


class BincodeError(ValueError):
    pass


def deserialize_encoded(data: Union[bytes, bytearray, memoryview]) -> EncodedAudio:
    """Parse the bincode-v1 wire format (native two-pass parser when
    available, numpy fallback otherwise)."""
    native = _native_deserialize(data)
    if native is not None:
        return native
    return _deserialize_encoded_numpy(data)


def _native_deserialize(data):
    import ctypes as c

    from ..native import get_native

    lib = get_native()
    if lib is None:
        return None
    buf = np.frombuffer(bytes(data), np.uint8)
    bp = buf.ctypes.data_as(c.POINTER(c.c_uint8))
    sr = c.c_uint32(); ch = c.c_uint16(); ts = c.c_uint64()
    ed = c.c_uint32(); pad = c.c_uint32(); ol = c.c_uint64()
    F = c.c_int64(); K = c.c_int64(); R = c.c_int64(); L = c.c_int64()
    rc = lib.glc_container_scan(
        bp, len(buf), c.byref(sr), c.byref(ch), c.byref(ts),
        c.byref(ed), c.byref(pad), c.byref(ol),
        c.byref(F), c.byref(K), c.byref(R), c.byref(L),
    )
    if rc != 0:
        raise BincodeError(f"invalid .glc data (native scan code {rc})")
    C = ch.value
    frame_size = (L.value // C) if (R.value and C) else 2048
    nnz = np.zeros((F.value, C), np.int64)
    pairs = np.empty(K.value, PAIR_DTYPE)
    scales = np.zeros((F.value, C), np.float32)
    raw_mask = np.zeros(F.value, np.uint8)
    raw_pcm = np.empty((R.value, L.value if R.value else frame_size * C),
                       np.int16)
    rc = lib.glc_container_fill(
        bp, len(buf), F.value, C,
        nnz.ctypes.data_as(c.POINTER(c.c_int64)),
        pairs.view(np.uint8).ctypes.data_as(c.POINTER(c.c_uint8)),
        K.value,
        scales.ctypes.data_as(c.POINTER(c.c_float)),
        raw_mask.ctypes.data_as(c.POINTER(c.c_uint8)),
        raw_pcm.ctypes.data_as(c.POINTER(c.c_int16)),
        R.value,
        L.value if R.value else frame_size * C,
    )
    if rc != 0:
        raise BincodeError(f"invalid .glc data (native fill code {rc})")
    fs = FrameSet(nnz, pairs, scales, raw_mask.astype(bool), raw_pcm,
                  frame_size)
    return EncodedAudio(
        header=AudioHeader(sr.value, C, ts.value),
        frame_set=fs,
        gapless_info=GaplessInfo(ed.value, pad.value, ol.value),
    )


def _deserialize_encoded_numpy(data) -> EncodedAudio:
    buf = np.frombuffer(bytes(data), np.uint8)
    n = len(buf)
    if n < 14 + 8 + 16:
        raise BincodeError("truncated .glc data")

    sample_rate, channels, total_samples = _HEADER.unpack_from(buf, 0)
    (F,) = _U64.unpack_from(buf, 14)
    if F > n:  # cheap sanity bound: each frame record is ≥ 17 bytes
        raise BincodeError(f"implausible frame count {F}")
    C = channels

    pos = 22
    nnz = np.zeros((F, C), np.int64)
    scales = np.zeros((F, C), np.float32)
    raw_mask = np.zeros(F, bool)
    pair_spans = []  # (src_offset, count) per (frame, channel) in stream order
    raw_spans = []   # (src_offset, length) per raw frame

    try:
        pos, _raw_len = _scan_frames(
            buf, n, F, C, pos, nnz, scales, raw_mask, pair_spans, raw_spans
        )
    except BincodeError:
        raise
    except (struct.error, IndexError, ValueError) as e:
        # truncation inside a frame record — normalize to the parse-error API
        raise BincodeError(f"truncated or malformed .glc data: {e}") from e

    # gapless_info follows the frames; bincode v1's legacy deserialize allows
    # trailing bytes after it (codec.rs:781-786), so we do too
    if pos + 16 > n:
        raise BincodeError("truncated gapless_info")
    encoder_delay, padding, original_length = _GAPLESS.unpack_from(buf, pos)

    # Vectorized gather of all pair data
    K = int(nnz.sum())
    pairs = np.empty(K, PAIR_DTYPE)
    if K:
        starts = np.array([s for s, _ in pair_spans], np.int64)
        counts = np.array([c for _, c in pair_spans], np.int64)
        seg_excl = np.zeros_like(counts)
        np.cumsum(counts[:-1], out=seg_excl[1:])
        within = np.arange(K, dtype=np.int64) - np.repeat(seg_excl, counts)
        src = np.repeat(starts, counts) + 4 * within
        pairs = buf[src[:, None] + _AR4].reshape(-1).view(PAIR_DTYPE)

    if raw_spans:
        L = raw_spans[0][1]
        raw_pcm = np.empty((len(raw_spans), L), np.int16)
        for ri, (off, _) in enumerate(raw_spans):
            raw_pcm[ri] = np.frombuffer(buf, "<i2", L, off)
        frame_size = L // C if C else 2048
    else:
        frame_size = 2048
        raw_pcm = np.empty((0, frame_size * C), np.int16)

    fs = FrameSet(nnz, pairs, scales, raw_mask, raw_pcm, frame_size)
    return EncodedAudio(
        header=AudioHeader(sample_rate, channels, total_samples),
        frame_set=fs,
        gapless_info=GaplessInfo(encoder_delay, padding, original_length),
    )


def _scan_frames(buf, n, F, C, pos, nnz, scales, raw_mask, pair_spans,
                 raw_spans):
    """Sequential scan of the frame records (the format is length-prefixed).

    Fills the columnar output arrays/lists in place; returns (pos after the
    last frame, raw frame length or None)."""
    u64 = _U64.unpack_from
    raw_len = None
    for fi in range(F):
        if pos + 8 > n:
            raise BincodeError("truncated frame table")
        (outer,) = u64(buf, pos)
        pos += 8
        if outer == C and C > 0:
            for c in range(C):
                (cnt,) = u64(buf, pos)
                pos += 8
                if pos + 4 * cnt > n:
                    raise BincodeError("truncated sparse data")
                nnz[fi, c] = cnt
                pair_spans.append((pos, cnt))
                pos += 4 * cnt
            (sl,) = u64(buf, pos)
            pos += 8
            if sl != C:
                raise BincodeError(f"scale vec length {sl} != channels {C}")
            scales[fi] = np.frombuffer(buf, "<f4", C, pos)
            pos += 4 * C
            tag = buf[pos]
            pos += 1
            if tag != 0:
                raise BincodeError("compressed frame with raw_pcm present")
        elif outer == 0:
            (sl,) = u64(buf, pos)
            pos += 8
            if sl != 0:
                raise BincodeError("raw frame with non-empty scale factors")
            tag = buf[pos]
            pos += 1
            if tag != 1:
                raise BincodeError("frame with no coefficients and no raw_pcm")
            (L,) = u64(buf, pos)
            pos += 8
            if pos + 2 * L > n:
                raise BincodeError("truncated raw_pcm data")
            raw_mask[fi] = True
            raw_spans.append((pos, L))
            raw_len = L if raw_len is None else raw_len
            if L != raw_len:
                raise BincodeError("inconsistent raw_pcm lengths")
            pos += 2 * L
        else:
            raise BincodeError(
                f"frame {fi}: channel count {outer} != header channels {C}"
            )
    return pos, raw_len


def save_encoded(encoded: EncodedAudio, path: Union[str, Path]) -> None:
    """reference src/codec.rs:774-779"""
    Path(path).write_bytes(serialize_encoded(encoded))


def load_encoded(path: Union[str, Path]) -> EncodedAudio:
    """reference src/codec.rs:781-786"""
    return deserialize_encoded(Path(path).read_bytes())
