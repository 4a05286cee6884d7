"""Device-side decode: dequantize → IMDCT+window → raw select → overlap-add.

Port of ``glc_tpu/ops/decode.py`` (``blocks_from_frames``,
``decode_chunk_device`` and the epilogue of ``_decode_packed_body``).  The
IMDCT+window runs in the hand-written kernel of ``ops/kernels.py``.
Overlap-add with 50% hop is a shifted add,

    hop[f] = first_half(block[f]) + second_half(block[f-1]),

with one [C, n] carry between chunks.
"""

from __future__ import annotations

import torch

from .kernels import imdct_window


def dense_q(pos: torch.Tensor, vals: torch.Tensor, frames: int,
            channels: int, n: int) -> torch.Tensor:
    """Scatter pairs into dense q [frames, C, n] int16.  `pos` holds unique
    flat indices (frame·C + channel)·n + k — the host resolves duplicates
    last-wins and drops out-of-range k first, because a scatter with
    duplicate indices on CUDA has no defined order."""
    q = torch.zeros(frames * channels * n, dtype=torch.int16, device=pos.device)
    q[pos] = vals
    return q.view(frames, channels, n)


def blocks_from_frames(
    q: torch.Tensor,         # [K, C, n] int16
    scales: torch.Tensor,    # [K, C] f32
    raw_idx: torch.Tensor,   # [R] int64 — frames that hold raw PCM
    raw_rows: torch.Tensor,  # [R, C, frame_size] int16
    tables,
    *,
    max_q: float = 32768.0,
    window_raw: bool = False,
) -> torch.Tensor:
    """Dequantize + IMDCT + window + raw-PCM select → blocks [K, C, 2n].

    * coeff = (q / max_q) · max(scale, 1e-12)  (codec.rs:653-663)
    * MDCT frames: IMDCT then synthesis window (codec.rs:669-675), fused
    * raw frames: i16/32767, NOT re-windowed (codec.rs:626-643, quirk Q4;
      window_raw=True is the clean Princen-Bradley path)
    """
    K, C, n = q.shape
    sc = torch.clamp_min(scales, 1e-12)
    coeffs = (q.to(torch.float32) / max_q) * sc[..., None]
    blocks = imdct_window(
        coeffs.reshape(K * C, n), tables.cos_table, tables.window,
        tables.norm_value,
    ).view(K, C, 2 * n)
    if raw_idx.numel():
        # a device divisor keeps this a true division: CUDA turns division
        # by a host scalar into multiplication by its reciprocal
        div = torch.full((), 32767.0, dtype=torch.float32, device=q.device)
        raw_f = raw_rows.to(torch.float32) / div
        if window_raw:
            raw_f = raw_f * tables.window
        blocks[raw_idx] = raw_f
    return blocks


def overlap_add(blocks: torch.Tensor, carry: torch.Tensor):
    """Shifted overlap-add of blocks [K, C, 2n] after `carry` [C, n]
    (codec.rs:688-705).  Returns (hops [K, C, n], new carry [C, n])."""
    n = blocks.shape[-1] // 2
    first = blocks[..., :n]
    second = blocks[..., n:]
    prev = torch.cat([carry[None], second[:-1]], dim=0)
    return first + prev, second[-1].clone()


def to_i16(x: torch.Tensor) -> torch.Tensor:
    """The exporters' conversion ×32767, clamp, truncate toward zero
    (audio.rs:9-16).  Separate eager ops: no FMA, no excess precision."""
    prod = x * 32767.0
    return torch.trunc(torch.clamp(prod, -32768.0, 32767.0)).to(torch.int16)
