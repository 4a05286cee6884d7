"""Minimal RIFF/WAVE reader and writer (numpy, no external deps).

Copied from ``glc_tpu/io/wav.py``, so the port never imports the JAX
package.

Covers what the reference gets from the `hound` crate (reference
src/audio.rs:37-64, 98-133): reading integer PCM (8/16/24/32-bit) and IEEE
float32 WAVs, and writing 16-bit integer PCM.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavError(ValueError):
    pass


def convert_f32_to_i16(samples: np.ndarray) -> np.ndarray:
    """×32767, clamp, truncate toward zero (Rust `as i16`; audio.rs:9-16).

    Lives here (rather than audio.py, which re-exports it) so write_wav can
    share the single definition without an import cycle."""
    return np.trunc(
        np.clip(np.asarray(samples, np.float32) * np.float32(32767.0),
                -32768.0, 32767.0)
    ).astype(np.int16)


def _scan_chunks(data: bytes):
    """RIFF chunk walk → (fmt_body, data_body); None for a missing chunk."""
    fmt = None
    raw = None
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    return fmt, raw


def _parse_fmt(fmt: bytes):
    """fmt chunk → (audio_format, channels, sample_rate, bits_per_sample),
    resolving WAVE_FORMAT_EXTENSIBLE to its SubFormat code."""
    (audio_format, channels, sample_rate, _byte_rate, _block_align,
     bits_per_sample) = struct.unpack_from("<HHIIHH", fmt, 0)
    if audio_format == WAVE_FORMAT_EXTENSIBLE:
        if len(fmt) < 26:
            raise WavError("truncated WAVE_FORMAT_EXTENSIBLE fmt chunk")
        (audio_format,) = struct.unpack_from("<H", fmt, 24)  # SubFormat GUID
    return audio_format, channels, sample_rate, bits_per_sample


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int, int]:
    """Read a WAV file → (interleaved float32 samples, sample_rate, channels).

    Matches hound's normalization as used by the reference loader
    (audio.rs:44-61): float data passes through; integer data is divided by
    2^(bits-1).
    """
    data = Path(path).read_bytes()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WavError(f"not a RIFF/WAVE file: {path}")

    fmt, raw = _scan_chunks(data)
    if fmt is None or raw is None:
        raise WavError("missing fmt or data chunk")

    audio_format, channels, sample_rate, bits_per_sample = _parse_fmt(fmt)

    if audio_format == WAVE_FORMAT_IEEE_FLOAT:
        if bits_per_sample == 32:
            samples = np.frombuffer(raw, "<f4").astype(np.float32)
        elif bits_per_sample == 64:
            samples = np.frombuffer(raw, "<f8").astype(np.float32)
        else:
            raise WavError(f"unsupported float bit depth: {bits_per_sample}")
    elif audio_format == WAVE_FORMAT_PCM:
        max_val = np.float32(1 << (bits_per_sample - 1))
        if bits_per_sample == 8:
            # 8-bit WAV is unsigned offset-binary
            ints = np.frombuffer(raw, np.uint8).astype(np.int16) - 128
        elif bits_per_sample == 16:
            ints = np.frombuffer(raw, "<i2")
        elif bits_per_sample == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            ints = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int8).astype(np.int32) << 16)
            )
        elif bits_per_sample == 32:
            ints = np.frombuffer(raw, "<i4")
        else:
            raise WavError(f"unsupported PCM bit depth: {bits_per_sample}")
        samples = ints.astype(np.float32) / max_val
    else:
        raise WavError(f"unsupported WAV format code: {audio_format:#06x}")

    return samples, int(sample_rate), int(channels)


def read_wav_pcm16(path: Union[str, Path]):
    """If `path` is a 16-bit integer PCM WAV, return (int16 interleaved
    samples, sample_rate, channels); otherwise None.

    Used for the encoder's exact i16 fast path: for 16-bit sources,
    i16/2^15 equals the float loader's output bit-for-bit (audio.rs:55),
    so the conversion can happen on device after a half-size upload.
    """
    data = Path(path).read_bytes()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        return None
    fmt, raw = _scan_chunks(data)
    if fmt is None or raw is None:
        return None
    try:
        audio_format, channels, sample_rate, bits = _parse_fmt(fmt)
    except WavError:
        return None
    if audio_format != WAVE_FORMAT_PCM or bits != 16:
        return None
    return np.frombuffer(raw, "<i2"), int(sample_rate), int(channels)


def write_wav(
    path: Union[str, Path],
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
) -> None:
    """Write interleaved float32 samples as a 16-bit integer PCM WAV
    (reference src/audio.rs:98-133): ×32767, clamp, truncate toward zero."""
    write_wav_i16(path, convert_f32_to_i16(samples), sample_rate, channels)


def write_wav_i16(
    path: Union[str, Path],
    i16: np.ndarray,
    sample_rate: int,
    channels: int,
) -> None:
    """Write already-16-bit interleaved samples (decode→export fast path)."""
    payload = np.asarray(i16, "<i2").tobytes()
    byte_rate = sample_rate * channels * 2
    block_align = channels * 2
    header = b"".join([
        b"RIFF",
        struct.pack("<I", 36 + len(payload)),
        b"WAVE",
        b"fmt ",
        struct.pack("<IHHIIHH", 16, WAVE_FORMAT_PCM, channels, sample_rate,
                    byte_rate, block_align, 16),
        b"data",
        struct.pack("<I", len(payload)),
    ])
    Path(path).write_bytes(header + payload)
