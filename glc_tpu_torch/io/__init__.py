"""Host-side audio file I/O (WAV only; FLAC input and export are not
ported yet)."""

from .wav import convert_f32_to_i16, read_wav, read_wav_pcm16, write_wav, write_wav_i16

__all__ = [
    "convert_f32_to_i16",
    "read_wav",
    "read_wav_pcm16",
    "write_wav",
    "write_wav_i16",
]
