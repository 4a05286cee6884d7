"""FLAC decoder wrapper (native/glc_native.cpp).

Copied from ``glc_tpu/flac/decoder.py``, so the port never imports the JAX
package; the C++ decoder is the shared one (``glc_tpu_torch/native.py``).

Fills the role claxon plays in the reference (reference src/audio.rs:66-83):
an independent decoder used both for loading FLAC input files and as the
conformance oracle for our encoder in tests (reference tests/test_flac.rs
round-trips its encoder's output through claxon).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple, Union

import numpy as np

from ..native import get_native


class FlacDecodeError(ValueError):
    pass


def decode_flac(data: bytes) -> Tuple[np.ndarray, int, int, int]:
    """Decode a FLAC stream → (interleaved int32 samples, sample_rate,
    channels, bits_per_sample).

    Native decoder when available; otherwise the pure-Python twin
    (pydecoder.py) — slow but complete, so a toolchain-less install keeps
    FLAC input and the conformance oracle (the role claxon's hard dependency
    plays in the reference, src/audio.rs:66-83)."""
    lib = get_native()
    if lib is None:
        from .pydecoder import decode_flac_python

        try:
            return decode_flac_python(data)
        except ValueError as e:
            raise FlacDecodeError(str(e)) from None
    c = ctypes
    buf = np.frombuffer(data, np.uint8)
    out_ptr = c.POINTER(c.c_int32)()
    out_count = c.c_int64()
    rate = c.c_uint32()
    channels = c.c_uint32()
    bps = c.c_uint32()
    rc = lib.glc_flac_decode(
        buf.ctypes.data_as(c.POINTER(c.c_uint8)), len(buf),
        c.byref(out_ptr), c.byref(out_count),
        c.byref(rate), c.byref(channels), c.byref(bps),
    )
    if rc != 0:
        raise FlacDecodeError(f"FLAC decode failed with code {rc}")
    try:
        n = out_count.value
        samples = np.ctypeslib.as_array(out_ptr, shape=(n,)).copy() if n else \
            np.empty(0, np.int32)
    finally:
        lib.glc_free(c.cast(out_ptr, c.POINTER(c.c_uint8)))
    return samples, rate.value, channels.value, bps.value


def read_flac(path: Union[str, Path]) -> Tuple[np.ndarray, int, int]:
    """Load a FLAC file → (interleaved float32, sample_rate, channels),
    normalizing ints by 2^(bits-1) like the reference loader
    (audio.rs:66-83)."""
    samples, rate, channels, bps = decode_flac(Path(path).read_bytes())
    max_val = np.float32(1 << (bps - 1))
    return samples.astype(np.float32) / max_val, rate, channels
