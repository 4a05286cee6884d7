"""Device-side math of the codec in PyTorch: the MDCT and perceptual
tables, the encode and decode math as torch ops, and the three
hand-written CUDA kernels they launch on the card (``kernels.py``:
`imdct_window` for the decode, `mdct_rows` and `band_energy` for the
encode).  The public names are the JAX package's (``glc_tpu/ops``)."""

from .mdct import MdctTables, get_mdct_tables
from .psycho import PerceptualTables, get_perceptual_tables
from .encode import encode_chunk_device
from .decode import decode_chunk_device

__all__ = [
    "MdctTables",
    "get_mdct_tables",
    "PerceptualTables",
    "get_perceptual_tables",
    "encode_chunk_device",
    "decode_chunk_device",
]
