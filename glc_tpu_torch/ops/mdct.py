"""MDCT/IMDCT as batched matmuls against a precomputed cosine table.

Port of ``glc_tpu/ops/mdct.py``.  The tables are the same numpy code, so
they are bit-identical to the JAX package's: cos/sin come from numpy's
float64 evaluation of the f32 angle, never from the device.

Table math matches the reference's f32 evaluation order bit-for-bit:
  angle = (PI/n) * (i + 0.5 + n/2) * (k + 0.5)      (codec.rs:335, f32, left-assoc)
  window = sin(PI * (i + 0.5) / 2N)                  (codec.rs:342-344)
  norm   = sqrt(2/n)                                 (codec.rs:347)

On the CPU, `mdct` / `imdct` are plain f32 ``torch.matmul`` products, the
counterpart of the JAX package's ``Precision.HIGHEST`` einsums: the package
turns TF32 off at import, so the product runs in full f32.  On CUDA the
encode's `mdct` is the hand kernel `mdct_rows` (``ops/kernels.py``), and
`imdct` is the plain version of the decode path's fused kernel
`imdct_window`.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .kernels import _rows_matmul, mdct_rows


@dataclass(frozen=True)
class MdctTables:
    """Precomputed tables (reference src/codec.rs:326-356)."""

    cos_table: np.ndarray  # [n, frame_size] f32
    window: np.ndarray     # [frame_size] f32
    n: int                 # hop size / number of coefficients
    norm: np.float32       # sqrt(2/n)

    def __hash__(self):
        return hash((self.n, self.cos_table.shape))


@lru_cache(maxsize=8)
def get_mdct_tables(n: int = 1024, frame_size: int = 2048) -> MdctTables:
    pi = np.float32(np.pi)
    nf = np.float32(n)
    i = np.arange(frame_size, dtype=np.float32)
    k = np.arange(n, dtype=np.float32)

    # ((PI / n) * (i + 0.5 + n/2)) * (k + 0.5), all f32, matching Rust
    # left-to-right association (codec.rs:335).
    t1 = (pi / nf) * (i + np.float32(0.5) + nf / np.float32(2.0))  # [frame_size]
    angle = t1[None, :] * (k[:, None] + np.float32(0.5))
    cos_table = np.cos(angle.astype(np.float64)).astype(np.float32)

    w_angle = (pi * (i + np.float32(0.5))) / np.float32(frame_size)
    window = np.sin(w_angle.astype(np.float64)).astype(np.float32)

    norm = np.sqrt(np.float32(2.0) / nf).astype(np.float32)
    return MdctTables(cos_table=cos_table, window=window, n=n, norm=norm)


# The CPU's BLAS picks its kernel, and how it splits the work among its
# threads, by the row count of a product, so the same row can round
# differently in products of different sizes.  The encode's products run
# on the CPU in blocks of exactly this many rows instead.
CPU_ROW_BLOCK = 64


def fixed_rows_matmul(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """`_rows_matmul` on the CPU as products of exactly `CPU_ROW_BLOCK` rows
    (the last block zero-padded), so that a row's result does not depend on
    how many rows share the call, at a given thread count.  A frame's
    encode then does not depend on the segment or the shard it rides in:
    the sharded album encode writes the serial encode's bytes, as the JAX
    package's does on XLA:CPU.  The CPU's encode products only: on CUDA
    the encode runs them as the row-invariant kernels `mdct_rows` and
    `band_energy` (``ops/kernels.py``)."""
    if x.device.type != "cpu":
        raise ValueError(f"fixed_rows_matmul runs on the CPU, not {x.device}")
    rows = x.reshape(-1, x.shape[-1])
    M, R = rows.shape[0], CPU_ROW_BLOCK
    full = M - M % R
    parts = [torch.matmul(rows[i : i + R], table) for i in range(0, full, R)]
    if full < M:
        last = rows.new_zeros((R, rows.shape[1]))
        last[: M - full] = rows[full:]
        parts.append(torch.matmul(last, table)[: M - full])
    out = torch.cat(parts) if parts else rows.new_zeros((0, table.shape[-1]))
    return out.view(*x.shape[:-1], table.shape[-1])


def mdct(blocks: torch.Tensor, cos_table: torch.Tensor, norm) -> torch.Tensor:
    """Batched MDCT: [..., frame_size] -> [..., n] (codec.rs:358-374);
    `norm` applied to the product exactly as the reference applies it to
    each dot product.  Row-invariant on both devices: `fixed_rows_matmul`
    on the CPU, the kernel `mdct_rows` on CUDA (any other device raises
    there)."""
    if blocks.device.type == "cpu":
        return fixed_rows_matmul(blocks, cos_table.T) * norm
    rows = blocks.reshape(-1, blocks.shape[-1]).contiguous()
    out = mdct_rows(rows, cos_table, norm)
    return out.view(*blocks.shape[:-1], cos_table.shape[0])


def imdct(coeffs: torch.Tensor, cos_table: torch.Tensor, norm) -> torch.Tensor:
    """Batched IMDCT: [..., n] -> [..., frame_size] (codec.rs:376-391)."""
    return _rows_matmul(coeffs, cos_table) * norm
