"""Codec tables as an ``nn.Module`` shared by the encoder and decoder.

Port of ``glc_tpu/codec/tables.py``.  The codec has no trained weights:
its parameters are the MDCT and perceptual tables, held here as buffers so
``.to(device)`` moves them.  `DeviceTables` / `get_device_tables` are the
JAX package's names for the same tables as a tuple, the argument order of
the chunk programs (``ops.encode_chunk_device``,
``ops.decode_chunk_device``).  `len_bucket` and `chunk_size_for` are
copied unchanged; they fix the segment and chunk geometry.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops.mdct import get_mdct_tables
from ..ops.psycho import get_perceptual_tables
from .device import resolve_device


class CodecTables(nn.Module):
    """The tables of one (n, frame_size, sample_rate).

    Buffers: ``cos_table`` [n, frame_size] f32, ``window`` [frame_size]
    f32, ``norm`` 0-dim f32, ``band_mask`` [MAX_BANDS, n] f32,
    ``band_inv_count`` / ``band_pf`` [MAX_BANDS] f32, ``band_of`` [n]
    int64, ``inv_w`` [n] f32.  ``norm_value`` is the same f32 norm as a
    Python float, for kernel launches that take it by value.
    """

    def __init__(self, cos_table, window, norm, band_mask, band_inv_count,
                 band_pf, band_of, inv_w):
        super().__init__()
        f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
        self.register_buffer("cos_table", f32(cos_table))
        self.register_buffer("window", f32(window))
        self.register_buffer("norm", torch.tensor(np.float32(norm)))
        self.register_buffer("band_mask", f32(band_mask))
        self.register_buffer("band_inv_count", f32(band_inv_count))
        self.register_buffer("band_pf", f32(band_pf))
        self.register_buffer(
            "band_of", torch.from_numpy(np.asarray(band_of, np.int64))
        )
        self.register_buffer("inv_w", f32(inv_w))
        self.norm_value = float(np.float32(norm))

    @property
    def n(self) -> int:
        return self.cos_table.shape[0]


def tables_from_numpy(cos_table, window, norm, band_mask, band_inv_count,
                      band_pf, band_of, inv_w, device) -> CodecTables:
    """`CodecTables` on `device` from the numpy arrays that
    ``get_mdct_tables`` / ``get_perceptual_tables`` produce (this package's
    or the JAX package's: they are the same arrays)."""
    return CodecTables(
        cos_table, window, norm, band_mask, band_inv_count, band_pf,
        band_of, inv_w,
    ).to(device)


def get_codec_tables(n: int, frame_size: int, sample_rate: int,
                     device) -> CodecTables:
    """Build the tables from this package's own numpy code."""
    mt = get_mdct_tables(n, frame_size)
    pt = get_perceptual_tables(n, sample_rate)
    return tables_from_numpy(
        mt.cos_table, mt.window, mt.norm, pt.band_mask, pt.band_inv_count,
        pt.band_pf, pt.band_of, pt.inv_w, device,
    )


class DeviceTables(NamedTuple):
    """The tables in the JAX package's field order, which is the order of
    `encode_chunk_device`'s table arguments (`decode_chunk_device` takes
    the first three): ``encode_chunk_device(blocks, *tables)``."""

    cos_table: torch.Tensor       # [n, frame_size] f32
    window: torch.Tensor          # [frame_size] f32
    norm: torch.Tensor            # 0-dim f32
    band_mask: torch.Tensor       # [MAX_BANDS, n] f32
    band_inv_count: torch.Tensor  # [MAX_BANDS] f32
    band_pf: torch.Tensor         # [MAX_BANDS] f32
    band_of: torch.Tensor         # [n] int64 (the JAX package's is int32)
    inv_w: torch.Tensor           # [n] f32


@lru_cache(maxsize=16)
def _device_tables(n: int, frame_size: int, sample_rate: int,
                   device: torch.device) -> DeviceTables:
    tables = get_codec_tables(n, frame_size, sample_rate, device)
    return DeviceTables(*(getattr(tables, f) for f in DeviceTables._fields))


def get_device_tables(n: int, frame_size: int, sample_rate: int,
                      device=None) -> DeviceTables:
    """The buffers of one `CodecTables` on `device` (None resolves as every
    entry point does: `resolve_device`) as a `DeviceTables`, made once per
    (n, frame_size, sample_rate, device) and kept.  ``band_of`` is int64,
    the index type of torch's gathers."""
    return _device_tables(n, frame_size, sample_rate, resolve_device(device))


def pow2_bucket(count: int, cap: int, floor: int = 16) -> int:
    """Smallest power of two ≥ count (starting at `floor`), capped at `cap`.
    Copied unchanged from ``glc_tpu/codec/tables.py``: it sets the frame
    axis of the sharded album (``parallel/album.py``)."""
    b = floor
    while b < count and b < cap:
        b *= 2
    return min(b, cap)


def len_bucket(x: int, bits: int = 4) -> int:
    """Smallest m·2^e ≥ x with 2^(bits−1) ≤ m < 2^bits (a `bits`-bit-mantissa
    ladder): overshoot ≤ 2^(1−bits), ≤ 2^(bits−1) distinct values per octave.
    Copied unchanged from the JAX package: it sets the encode segment
    sizes, so the two packages plan the same segments."""
    floor = 1 << bits
    if x <= floor:
        return floor
    e = x.bit_length() - bits
    m = -(-x >> e)  # ceil(x / 2^e)
    if m >= (1 << bits):
        return (1 << (bits - 1)) << (e + 1)
    return m << e


def chunk_size_for(num_frames: int, max_chunk: int) -> int:
    """Frame-chunk size ≥ num_frames on the 4-bit-mantissa ladder, capped at
    max_chunk.  Copied unchanged: it sets the decode chunk boundaries."""
    return min(max(len_bucket(num_frames, 4), 128), max_chunk)
