"""glc_tpu_torch — the gapless lossy codec in PyTorch, for CUDA GPUs.

A port of ``glc_tpu`` (the JAX package, which stays the reference) with
the same public names:

    from glc_tpu_torch import Encoder, Decoder, save_encoded, load_encoded
    enc = Encoder(44100, device="cuda")
    encoded = enc.encode_pcm16(pcm16, channels=2)
    pcm = Decoder(2, 44100, device="cuda").decode_i16(encoded)

The device math is eager torch ops plus three hand-written CUDA kernels
(``ops/kernels.py``, ``csrc/``): the decode's fused IMDCT+window, and the
encode's MDCT and band energies, which compute each frame alike however
the frames are cut into segments or shards.  ``warmup()`` pays a fresh
process's one-time costs on the card before the first real call.  The
package imports neither JAX nor ``glc_tpu``; the numpy-only host modules
it needs are copies.

Importing the package turns TF32 off for matmuls and cuDNN and asks for
"highest" f32 matmul precision: the counterpart of the JAX package's
``Precision.HIGHEST`` (a lower-precision lowering measured 2e-3 error).
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .config import CodecConfig, DEFAULT_CONFIG, config_from_dict
from .container.schema import (
    AudioHeader,
    GaplessInfo,
    EncodedFrame,
    EncodedAudio,
    Progress,
    AudioChunk,
)
from .container.bincode import save_encoded, load_encoded, serialize_encoded, deserialize_encoded
from .codec.encoder import Encoder
from .codec.decoder import Decoder
from .warmup import warmup

__version__ = "0.5.0"

__all__ = [
    "CodecConfig",
    "DEFAULT_CONFIG",
    "config_from_dict",
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
    "Encoder",
    "Decoder",
    "warmup",
]
