"""Pure-Python FLAC bitstream packer — fallback for native/glc_native.cpp.

Copied from ``glc_tpu/flac/bitpack.py``, so the port never imports the JAX
package.

Byte-identical output to the native packer (cross-checked in tests); used
only when the C++ library is unavailable.  Ports the reference's BitWriter
and frame assembly semantics (reference src/flac.rs:320-424, 586-905).
"""

from __future__ import annotations

import numpy as np

FRAME_SYNC_CODE = 0x3FFE

_CRC8_TABLE = np.zeros(256, np.uint8)
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = ((_c << 1) ^ 0x07) & 0xFF if _c & 0x80 else (_c << 1) & 0xFF
    _CRC8_TABLE[_i] = _c

_CRC16_TABLE = np.zeros(256, np.uint16)
for _i in range(256):
    _c = _i << 8
    for _ in range(8):
        _c = ((_c << 1) ^ 0x8005) & 0xFFFF if _c & 0x8000 else (_c << 1) & 0xFFFF
    _CRC16_TABLE[_i] = _c


def crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = int(_CRC8_TABLE[crc ^ b])
    return crc


def crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) ^ int(_CRC16_TABLE[((crc >> 8) ^ b) & 0xFF])) & 0xFFFF
    return crc


class BitWriter:
    """MSB-first bit accumulator (flac.rs:320-424)."""

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write_bits(self, value: int, bits: int) -> None:
        if bits <= 0:
            return
        value &= (1 << bits) - 1
        self.acc = (self.acc << bits) | value
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1 if self.nbits else 0

    def write_byte(self, b: int) -> None:
        self.write_bits(b, 8)

    def write_bytes(self, bs: bytes) -> None:
        for b in bs:
            self.write_bits(b, 8)

    def write_unary(self, v: int) -> None:
        self.write_bits(1, v + 1)  # v zeros then a one

    def byte_align(self) -> None:
        if self.nbits:
            self.write_bits(0, 8 - self.nbits)

    def get_bytes(self) -> bytes:
        return bytes(self.buf)


def write_utf8_number(w: BitWriter, v: int) -> None:
    """flac.rs:426-478"""
    if v < 0x80:
        w.write_byte(v)
        return
    for limit, lead, extra in (
        (0x800, 0xC0, 1), (0x10000, 0xE0, 2), (0x200000, 0xF0, 3),
        (0x4000000, 0xF8, 4), (0x80000000, 0xFC, 5),
    ):
        if v < limit:
            w.write_byte(lead | ((v >> (6 * extra)) & (0x3F >> extra)))
            for i in range(extra - 1, -1, -1):
                w.write_byte(0x80 | ((v >> (6 * i)) & 0x3F))
            return
    w.write_byte(0xFE)
    for i in range(5, -1, -1):
        w.write_byte(0x80 | ((v >> (6 * i)) & 0x3F))


_BLOCK_SIZE_BITS = {
    192: 0b0001, 576: 0b0010, 1152: 0b0011, 2304: 0b0100, 4608: 0b0101,
    256: 0b1000, 512: 0b1001, 1024: 0b1010, 2048: 0b1011, 4096: 0b1100,
    8192: 0b1101, 16384: 0b1110, 32768: 0b1111,
}
_SAMPLE_RATE_BITS = {
    88200: 0b0001, 176400: 0b0010, 192000: 0b0011, 8000: 0b0100,
    16000: 0b0101, 22050: 0b0110, 24000: 0b0111, 32000: 0b1000,
    44100: 0b1001, 48000: 0b1010, 96000: 0b1011,
}


def predictor_order(block_size: int, level: int) -> int:
    """flac.rs:690-700"""
    if level == 0:
        return 0
    if level == 1:
        return 1 if block_size >= 1 else 0
    if level == 2:
        return 2 if block_size >= 2 else 0
    if level <= 4:
        return 3 if block_size >= 3 else 0
    return 4 if block_size >= 4 else 0


def partition_order(block_size: int, pred_order: int, level: int) -> int:
    """flac.rs:589-607"""
    tz = (block_size & -block_size).bit_length() - 1 if block_size else 0
    cap = min(tz, 8)
    if level == 0:
        po = 0
    elif level <= 2:
        po = min(2, cap)
    elif level <= 5:
        po = min(4, cap)
    else:
        po = min(6, cap)
    while po > 0:
        ps = block_size >> po
        if ps > pred_order and ps >= 4:
            break
        po -= 1
    return po


def pack_stream(
    i16_samples: np.ndarray,
    channels: int,
    sample_rate: int,
    level: int,
    md5: bytes,
    block_sizes: np.ndarray,
    residuals: np.ndarray,   # flat int32, frame-major then channel-major
    rice_params: np.ndarray,  # flat int8, frame-major, channel-major, partition
) -> bytes:
    """Python port of glc_flac_pack (native/glc_native.cpp)."""
    bps = 16
    w = BitWriter()
    w.write_bytes(b"fLaC")

    nominal_bs = int(block_sizes[0]) if len(block_sizes) else 0
    total = len(i16_samples) // channels
    w.write_bits(1, 1)
    w.write_bits(0, 7)
    w.write_bits(34, 24)
    w.write_bits(nominal_bs, 16)
    w.write_bits(nominal_bs, 16)
    w.write_bits(0, 24)
    w.write_bits(0, 24)
    w.write_bits(sample_rate, 20)
    w.write_bits(channels - 1, 3)
    w.write_bits(bps - 1, 5)
    w.write_bits(total, 36)
    w.write_bytes(md5)

    sample_off = 0
    res_off = 0
    rp_off = 0
    for f, bs in enumerate(map(int, block_sizes)):
        frame_start = len(w.buf)
        w.write_bits(FRAME_SYNC_CODE, 14)
        w.write_bits(0, 1)
        w.write_bits(0, 1)
        bsb = _BLOCK_SIZE_BITS.get(bs, 0b0110 if bs < 256 else 0b0111)
        w.write_bits(bsb, 4)
        w.write_bits(_SAMPLE_RATE_BITS.get(sample_rate, 0), 4)
        chan_bits = 0 if channels == 1 else (1 if channels == 2 else channels - 1)
        w.write_bits(chan_bits, 4)
        w.write_bits(0b100, 3)
        w.write_bits(0, 1)
        write_utf8_number(w, f)
        if bsb == 0b0110:
            w.write_byte(bs - 1)
        elif bsb == 0b0111:
            w.write_bits(bs - 1, 16)
        w.write_byte(crc8(bytes(w.buf[frame_start:])))

        order = predictor_order(bs, level)
        po = partition_order(bs, order, level)
        num_partitions = 1 << po
        dps = bs >> po

        for c in range(channels):
            w.write_bits(0, 1)
            if order == 0:
                w.write_bits(0b000001, 6)
            else:
                w.write_bits(0b001000 | order, 6)
            w.write_bits(0, 1)

            ch = i16_samples[sample_off + c : sample_off + bs * channels : channels]
            if order == 0:
                for s in ch:
                    w.write_bits(int(s) & 0xFFFF, bps)
            else:
                for i in range(order):
                    w.write_bits(int(ch[i]) & 0xFFFF, bps)
                res = residuals[res_off + c * bs + order : res_off + (c + 1) * bs]
                rp = rice_params[rp_off + c * num_partitions :
                                 rp_off + (c + 1) * num_partitions]
                w.write_bits(0, 2)
                w.write_bits(po, 4)
                idx = 0
                for p in range(num_partitions):
                    ps = dps - order if p == 0 else dps
                    # a Rice parameter is written even for an empty first
                    # partition (RFC 9639; the reference's skip emits
                    # invalid FLAC — QUIRKS.md Q15)
                    k = int(rp[p])
                    w.write_bits(k, 4)
                    if ps == 0:
                        continue
                    for i in range(ps):
                        s = int(res[idx])
                        idx += 1
                        folded = (s << 1) if s >= 0 else (((-(s + 1)) << 1) | 1)
                        w.write_unary(folded >> k)
                        if k > 0:
                            w.write_bits(folded & ((1 << k) - 1), k)

        w.byte_align()
        w.write_bits(crc16(bytes(w.buf[frame_start:])), 16)

        sample_off += bs * channels
        res_off += bs * channels
        rp_off += num_partitions * channels

    return w.get_bytes()
