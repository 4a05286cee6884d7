"""Pure-Python FLAC decoder — the no-toolchain fallback for the native
decoder in native/glc_native.cpp.

Copied from ``glc_tpu/flac/pydecoder.py``, so the port never imports the
JAX package.

Role: the reference always has FLAC input available because claxon is a
hard dependency (reference src/audio.rs:66-83).  Here the native .so fills
that role when g++ exists; this module keeps FLAC input and the encoder's
conformance oracle alive when it doesn't (`get_native()` returns None).
Slow (bit-serial Python) but complete: the same RFC 9639 subset as the
native decoder — constant/verbatim/fixed/LPC subframes, both Rice methods
with escape codes, wasted bits, all four stereo modes, CRC-8/CRC-16
verification, and the same hostile-input guards (decompression bomb cap,
bounded reserve).  Error codes match flac_decode_impl so callers see one
behavior regardless of which decoder ran.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_MASK64 = (1 << 64) - 1


class _BitReader:
    """MSB-first bit reader over a bytes-like object (BitReader,
    native/glc_native.cpp:452-510)."""

    __slots__ = ("data", "len", "pos", "bit", "error")

    def __init__(self, data, length: int):
        self.data = data
        self.len = length
        self.pos = 0
        self.bit = 0
        self.error = False

    def eof(self) -> bool:
        return self.pos >= self.len

    def read_bits(self, n: int) -> int:
        v = 0
        data, ln = self.data, self.len
        while n > 0:
            if self.pos >= ln:
                self.error = True
                return 0
            avail = 8 - self.bit
            take = n if n < avail else avail
            cur = data[self.pos]
            shift = avail - take
            v = (v << take) | ((cur >> shift) & ((1 << take) - 1))
            self.bit += take
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
            n -= take
        return v

    def read_signed(self, n: int) -> int:
        v = self.read_bits(n)
        if n < 64 and v & (1 << (n - 1)):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        n = 0
        data, ln = self.data, self.len
        while True:
            if self.pos >= ln:
                self.error = True
                return 0
            cur = (data[self.pos] << self.bit) & 0xFF
            if cur == 0:
                n += 8 - self.bit
                self.bit = 0
                self.pos += 1
                continue
            lz = 7 - cur.bit_length() + 1  # leading zeros in remaining bits
            n += lz
            self.bit += lz + 1
            if self.bit >= 8:
                self.bit -= 8
                self.pos += 1
            return n

    def align(self) -> None:
        if self.bit:
            self.bit = 0
            self.pos += 1


def _crc_tables():
    global _CRC8, _CRC16
    if _CRC8 is None:
        from .bitpack import _CRC8_TABLE, _CRC16_TABLE

        _CRC8 = _CRC8_TABLE.tolist()
        _CRC16 = _CRC16_TABLE.tolist()
    return _CRC8, _CRC16


_CRC8 = _CRC16 = None


def _crc8(data, start: int, end: int) -> int:
    table, _ = _crc_tables()
    crc = 0
    for i in range(start, end):
        crc = table[crc ^ data[i]]
    return crc


def _crc16(data, start: int, end: int) -> int:
    _, table = _crc_tables()
    crc = 0
    for i in range(start, end):
        crc = table[((crc >> 8) ^ data[i]) & 0xFF] ^ ((crc << 8) & 0xFFFF)
    return crc


def _read_utf8(br: _BitReader) -> int:
    b0 = br.read_bits(8)
    if br.error:
        return -1
    if b0 & 0x80 == 0:
        return b0
    if b0 & 0xE0 == 0xC0:
        extra, v = 1, b0 & 0x1F
    elif b0 & 0xF0 == 0xE0:
        extra, v = 2, b0 & 0x0F
    elif b0 & 0xF8 == 0xF0:
        extra, v = 3, b0 & 0x07
    elif b0 & 0xFC == 0xF8:
        extra, v = 4, b0 & 0x03
    elif b0 & 0xFE == 0xFC:
        extra, v = 5, b0 & 0x01
    elif b0 == 0xFE:
        extra, v = 6, 0
    else:
        return -1
    for _ in range(extra):
        b = br.read_bits(8)
        if b & 0xC0 != 0x80:
            return -1
        v = (v << 6) | (b & 0x3F)
    return v


def _decode_residual(br: _BitReader, bs: int, order: int,
                     out: List[int]) -> bool:
    method = br.read_bits(2)
    if method > 1:
        return False
    plen = 4 if method == 0 else 5
    escape = 0xF if method == 0 else 0x1F
    po = br.read_bits(4)
    parts = 1 << po
    if (bs >> po) << po != bs:
        return False
    idx = order
    for p in range(parts):
        ps = (bs >> po) - (order if p == 0 else 0)
        if ps < 0:
            return False
        k = br.read_bits(plen)
        if k == escape:
            raw = br.read_bits(5)
            for _ in range(ps):
                out[idx] = br.read_signed(raw) if raw else 0
                idx += 1
        else:
            read_unary = br.read_unary
            read_bits = br.read_bits
            for _ in range(ps):
                msb = read_unary()
                lsb = read_bits(k) if k else 0
                folded = (msb << k) | lsb
                out[idx] = (folded >> 1) ^ -(folded & 1)
                idx += 1
                if br.error:
                    return False
    return not br.error


def _wrap64(v: int) -> int:
    """Two's-complement wrap to int64 — the native decoder does all
    predictor arithmetic in uint64 so hostile streams wrap instead of
    overflowing (glc_native.cpp:586-640); Python ints never overflow, so
    wrap explicitly for behavioral identity."""
    v &= _MASK64
    return v - (1 << 64) if v >> 63 else v


def _decode_subframe(br: _BitReader, bs: int, bps: int,
                     out: List[int]) -> bool:
    if br.read_bits(1) != 0:
        return False  # padding bit
    stype = br.read_bits(6)
    wasted = 0
    if br.read_bits(1):
        wasted = br.read_unary() + 1
    ebps = bps - wasted
    if ebps <= 0 or br.error:
        return False

    if stype == 0:  # constant
        v = br.read_signed(ebps)
        for i in range(bs):
            out[i] = v
    elif stype == 1:  # verbatim
        for i in range(bs):
            out[i] = br.read_signed(ebps)
    elif stype & 0x38 == 0x08 and stype & 0x07 <= 4:  # fixed
        order = stype & 0x07
        if order > bs:
            return False
        for i in range(order):
            out[i] = br.read_signed(ebps)
        if not _decode_residual(br, bs, order, out):
            return False
        for i in range(order, bs):
            a = out[i - 1]
            if order == 0:
                pred = 0
            elif order == 1:
                pred = a
            elif order == 2:
                pred = 2 * a - out[i - 2]
            elif order == 3:
                pred = 3 * a - 3 * out[i - 2] + out[i - 3]
            else:
                pred = 4 * a - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4]
            out[i] = _wrap64(out[i] + pred)
    elif stype & 0x20:  # LPC
        order = (stype & 0x1F) + 1
        if order > bs:
            return False
        for i in range(order):
            out[i] = br.read_signed(ebps)
        prec = br.read_bits(4) + 1
        if prec == 16:
            return False  # 1111 invalid
        shift = br.read_signed(5)
        if shift < 0:
            return False
        coef = [br.read_signed(prec) for _ in range(order)]
        if not _decode_residual(br, bs, order, out):
            return False
        for i in range(order, bs):
            acc = 0
            for j in range(order):
                acc += coef[j] * out[i - 1 - j]
            # arithmetic >> on the int64-wrapped accumulator
            out[i] = _wrap64(out[i] + (_wrap64(acc) >> shift))
    else:
        return False

    if wasted:
        for i in range(bs):
            out[i] = _wrap64(out[i] << wasted)
    return not br.error


def decode_flac_python(data: bytes) -> Tuple[np.ndarray, int, int, int]:
    """Decode a FLAC stream → (interleaved int32, rate, channels, bps).

    Raises ValueError with the native decoder's error code in the message,
    so `decode_flac` reports identically whichever implementation ran.
    """
    def fail(code: int):
        raise ValueError(f"FLAC decode failed with code {code}")

    n = len(data)
    if n < 8 or data[:4] != b"fLaC":
        fail(-1)
    pos = 4
    si_rate = si_channels = si_bps = 0
    si_total = 0
    have_si = False

    while True:  # metadata blocks
        if pos + 4 > n:
            fail(-2)
        hdr = data[pos]
        btype = hdr & 0x7F
        blen = (data[pos + 1] << 16) | (data[pos + 2] << 8) | data[pos + 3]
        pos += 4
        if pos + blen > n:
            fail(-2)
        if btype == 0 and blen >= 34:
            br = _BitReader(data[pos : pos + blen], blen)
            br.read_bits(16), br.read_bits(16)  # min/max block size
            br.read_bits(24), br.read_bits(24)  # min/max frame size
            si_rate = br.read_bits(20)
            si_channels = br.read_bits(3) + 1
            si_bps = br.read_bits(5) + 1
            si_total = br.read_bits(36)
            have_si = True
        pos += blen
        if hdr & 0x80:
            break
    if not have_si or si_rate == 0:
        fail(-3)

    out: List[int] = []
    br = _BitReader(data[pos:], n - pos)
    while not br.eof():
        if br.bit != 0:
            br.align()
        if br.pos >= br.len:
            break
        frame_start = br.pos
        sync = br.read_bits(14)
        if br.error:
            break
        if sync != 0x3FFE:
            fail(-4)
        br.read_bits(1)  # reserved
        br.read_bits(1)  # blocking strategy
        bsc = br.read_bits(4)
        src = br.read_bits(4)
        ca = br.read_bits(4)
        ssc = br.read_bits(3)
        br.read_bits(1)  # reserved
        if _read_utf8(br) < 0:
            fail(-5)

        if bsc == 0:
            fail(-6)
        elif bsc == 1:
            bs = 192
        elif bsc <= 5:
            bs = 576 << (bsc - 2)
        elif bsc == 6:
            bs = br.read_bits(8) + 1
        elif bsc == 7:
            bs = br.read_bits(16) + 1
        else:
            bs = 256 << (bsc - 8)
        if src == 12:
            br.read_bits(8)
        elif src == 13 or src == 14:
            br.read_bits(16)
        elif src == 15:
            fail(-7)

        if ssc == 0:
            bps = si_bps
        elif ssc in (1, 2):
            bps = 8 if ssc == 1 else 12
        elif ssc in (4, 5, 6, 7):
            bps = {4: 16, 5: 20, 6: 24, 7: 32}[ssc]
        else:
            fail(-8)

        mode = "indep"
        if ca < 8:
            channels = ca + 1
        elif ca == 8:
            channels, mode = 2, "ls"
        elif ca == 9:
            channels, mode = 2, "rs"
        elif ca == 10:
            channels, mode = 2, "ms"
        else:
            fail(-9)
        if channels != si_channels:
            fail(-10)

        # header CRC-8
        if _crc8(br.data, frame_start, br.pos) != br.read_bits(8):
            fail(-11)

        chans = [[0] * bs for _ in range(channels)]
        for c in range(channels):
            sub_bps = bps
            if (mode == "ls" and c == 1) or (mode == "rs" and c == 0) or \
               (mode == "ms" and c == 1):
                sub_bps += 1
            if not _decode_subframe(br, bs, sub_bps, chans[c]):
                fail(-12)
        br.align()
        expect = _crc16(br.data, frame_start, br.pos)
        got = br.read_bits(16)
        if br.error:
            fail(-13)
        if expect != got:
            fail(-14)

        if mode == "ls":
            L, R = chans
            for i in range(bs):
                R[i] = _wrap64(L[i] - R[i])
        elif mode == "rs":
            L, R = chans
            for i in range(bs):
                L[i] = _wrap64(R[i] + L[i])
        elif mode == "ms":
            L, R = chans
            for i in range(bs):
                mid = _wrap64((L[i] << 1) | (R[i] & 1))
                side = R[i]
                L[i] = _wrap64(mid + side) >> 1
                R[i] = _wrap64(mid - side) >> 1

        # decompression-bomb guard (glc_native.cpp:1046-1057)
        new_total = len(out) + bs * channels
        cap = si_total * si_channels if si_total > 0 else (1 << 30)
        if new_total > cap:
            fail(-16)

        if channels == 1:
            out.extend(chans[0])
        else:
            frame = np.empty(bs * channels, np.int64)
            for c in range(channels):
                frame[c::channels] = chans[c]
            out.extend(frame.tolist())

    return (
        np.asarray(out, np.int64).astype(np.int32)
        if out else np.empty(0, np.int32),
        si_rate, si_channels, si_bps,
    )
