"""Container layer: .glc schema + bincode-v1-compatible serialization."""

from .schema import AudioHeader, GaplessInfo, EncodedFrame, EncodedAudio, Progress, AudioChunk
from .bincode import save_encoded, load_encoded, serialize_encoded, deserialize_encoded

__all__ = [
    "AudioHeader",
    "GaplessInfo",
    "EncodedFrame",
    "EncodedAudio",
    "Progress",
    "AudioChunk",
    "save_encoded",
    "load_encoded",
    "serialize_encoded",
    "deserialize_encoded",
]
