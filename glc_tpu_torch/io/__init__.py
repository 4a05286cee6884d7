"""Host-side audio file I/O (WAV/FLAC loading, WAV/FLAC export)."""

from .audio import (
    convert_f32_to_i16,
    load_audio_file_lossless,
    export_to_wav,
    export_to_flac,
)
from .wav import read_wav, read_wav_pcm16, write_wav, write_wav_i16

__all__ = [
    "convert_f32_to_i16",
    "load_audio_file_lossless",
    "export_to_wav",
    "export_to_flac",
    "read_wav",
    "read_wav_pcm16",
    "write_wav",
    "write_wav_i16",
]
