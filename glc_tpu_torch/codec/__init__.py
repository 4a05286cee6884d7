"""Codec layer: host orchestration of the device encode/decode pipelines."""

from .encoder import Encoder
from .decoder import Decoder

__all__ = ["Encoder", "Decoder"]
