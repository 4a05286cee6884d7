"""Warm-up: pay a fresh process's one-time costs before the first real call.

Port of ``glc_tpu/warmup.py``.  The JAX package compiles a ladder of XLA
programs, one per shape bucket, into a persistent cache.  The port compiles
nothing per shape and has no XLA cache: what a fresh process pays on its
first call on the card is the CUDA context, the build (nvcc, seconds) or
load of the kernel library (``ops/kernels.py``; the build is kept under
``build/`` by a hash of the sources, so only the first process on a machine
builds), the tables' upload and their TF32 splits, the band ranges, the
library handles PyTorch makes at first use, and the caching allocator's
device and pinned pools.  ``warmup()`` runs the shipped entry points once
(``Encoder.encode_pcm16``, ``Decoder.decode_i16`` and the streaming FLAC
export), so a later call finds all of that ready.

The warm signal is program-like material (chord, sweep, noise), as in the
JAX package, so that the encode runs the compressed path as music does.
"""

from __future__ import annotations

import numpy as np

from .codec.decoder import Decoder
from .codec.device import resolve_device
from .codec.encoder import Encoder
from .flac.encoder import encode_flac_i16_streaming
from .ops.kernels import load_library


def _program_material(seconds: float, sample_rate: int,
                      channels: int) -> np.ndarray:
    """Copied from ``glc_tpu/warmup.py``: interleaved int16 chord + sweep +
    noise, from numpy.random.default_rng(99)."""
    t = np.arange(int(sample_rate * seconds), dtype=np.float32) / sample_rate
    left = (
        0.30 * np.sin(2 * np.pi * 261.63 * t)
        + 0.20 * np.sin(2 * np.pi * 329.63 * t)
        + 0.15 * np.sin(2 * np.pi * (440.0 + 100.0 * t) * t)
    )
    rng = np.random.default_rng(99)
    noise = rng.standard_normal(len(t)).astype(np.float32) * 0.01
    chans = [left + noise] + [left * 0.9 + noise] * (channels - 1)
    out = np.empty(channels * len(t), np.float32)
    for c, x in enumerate(chans):
        out[c::channels] = x
    return np.clip(out * 32767.0, -32768, 32767).astype(np.int16)


def warmup(sample_rate: int = 44100, channels: int = 2,
           seconds: float = 60.0, flac: bool = True,
           config=None, *, device=None) -> None:
    """Warm one (sample_rate, channels) deployment on `device`.

    `device` is `resolve_device`'s: None means $GLC_TORCH_DEVICE, else the
    card, else a RuntimeError (the port never warms the CPU unasked).  On
    the card it builds or loads the kernel library first.  One call costs
    one encode + decode (+ FLAC export) of `seconds` of audio.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        load_library()
    enc = Encoder(sample_rate, config=config, device=dev)
    dec = Decoder(channels, sample_rate, config=config, device=dev)
    pcm = _program_material(seconds, sample_rate, channels)
    encoded = enc.encode_pcm16(pcm, channels)
    dec.decode_i16(encoded)
    if flac:
        n_total = dec.decoded_length(encoded)
        encode_flac_i16_streaming(
            dec.decode_i16_stream(
                encoded, chunk_frames=dec.config.stream_chunk_frames),
            sample_rate, channels, 5, n_total // channels,
        )
