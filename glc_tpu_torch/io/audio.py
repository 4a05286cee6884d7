"""Audio file loading/export dispatch (mirrors reference src/audio.rs).

Copied from ``glc_tpu/io/audio.py``, so the port never imports the JAX
package.

* `load_audio_file_lossless` — WAV or FLAC by lowercased extension
  (audio.rs:18-35)
* `export_to_wav` — 16-bit integer PCM (audio.rs:98-133)
* `export_to_flac` — delegates to the pure FLAC encoder at level 5
  (audio.rs:85-96)
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple, Union

import numpy as np

from .wav import convert_f32_to_i16, read_wav, write_wav  # noqa: F401
# convert_f32_to_i16 re-exported: it is the exporters' canonical conversion
# (audio.rs:9-16), defined in wav.py to avoid an import cycle


class AudioFormatError(ValueError):
    pass


def load_audio_file_lossless(
    path: Union[str, Path]
) -> Tuple[np.ndarray, int, int]:
    """Returns (interleaved float32 samples, sample_rate, channels)."""
    path = Path(path)
    ext = path.suffix[1:].lower() if path.suffix else ""
    if not ext:
        raise AudioFormatError("No file extension")
    if ext == "wav":
        return read_wav(path)
    if ext == "flac":
        from ..flac.decoder import read_flac
        return read_flac(path)
    raise AudioFormatError(f"Unsupported file format: {ext}")


def load_audio_pcm16(path: Union[str, Path]):
    """If `path` is a 16-bit lossless source (int16 PCM WAV or 16-bit FLAC),
    return (int16 interleaved samples, sample_rate, channels); else None.

    Enables the encoder's exact half-size-upload fast path (see
    Encoder.encode_pcm16): for these sources i16/2^15 equals what
    `load_audio_file_lossless` returns, bit-for-bit.
    """
    path = Path(path)
    ext = path.suffix[1:].lower() if path.suffix else ""
    if ext == "wav":
        from .wav import read_wav_pcm16
        return read_wav_pcm16(path)
    if ext == "flac":
        from ..flac.decoder import decode_flac
        try:
            samples, rate, channels, bps = decode_flac(path.read_bytes())
        except Exception:
            return None
        if bps != 16:
            return None
        return samples.astype(np.int16), rate, channels
    return None


def load_audio_for_encode(path: Union[str, Path]):
    """Load an input for encoding, decoding the file exactly once.

    Returns (samples, sample_rate, channels, is_pcm16): int16 samples for
    16-bit sources (the encoder's exact half-upload path), float32 otherwise
    (normalized like `load_audio_file_lossless`).
    """
    path = Path(path)
    ext = path.suffix[1:].lower() if path.suffix else ""
    if not ext:
        raise AudioFormatError("No file extension")
    if ext == "wav":
        from .wav import read_wav_pcm16
        pcm16 = read_wav_pcm16(path)
        if pcm16 is not None:
            samples, rate, ch = pcm16
            return samples, rate, ch, True
        samples, rate, ch = read_wav(path)
        return samples, rate, ch, False
    if ext == "flac":
        from ..flac.decoder import decode_flac
        samples, rate, ch, bps = decode_flac(path.read_bytes())
        if bps == 16:
            return samples.astype(np.int16), rate, ch, True
        return (samples.astype(np.float32) / np.float32(1 << (bps - 1)),
                rate, ch, False)
    raise AudioFormatError(f"Unsupported file format: {ext}")


def export_to_wav(
    path: Union[str, Path],
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
) -> None:
    write_wav(path, samples, sample_rate, channels)


def export_to_flac(
    path: Union[str, Path],
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
) -> None:
    from ..flac.encoder import export_to_flac_with_level
    export_to_flac_with_level(path, samples, sample_rate, channels, 5)
