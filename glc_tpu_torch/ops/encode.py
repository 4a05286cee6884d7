"""Device-side encode math: window → MDCT → masking → quantize → pairs.

Port of ``glc_tpu/ops/encode.py`` (``round_half_away``, ``encode_math``,
``encode_chunk_device``, ``frames_from_signal``, ``_planarize_device`` and
the segment body ``_encode_signal_body``) as eager torch ops.  One segment
of frames for all channels is one batch: the MDCT is one f32 matmul over
every block, the masking thresholds are a band matmul, and the
keep/quantize gate is elementwise.

The JAX package's six pair-compaction modes, budgets and stats-only program
exist to keep transfers over a TPU host link small and fixed in shape.
Here the compaction is one ``masked_select`` whose row-major order is the
.glc stream order, so the download is exactly the kept pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from .mdct import mdct
from .psycho import masking_thresholds


def _noise_floor_linear(noise_floor_db: float) -> float:
    """10^(NOISE_FLOOR_DB/20) (codec.rs:22,277), rounded to f32."""
    return float(
        np.float32(10.0 ** float(np.float32(noise_floor_db) / np.float32(20.0)))
    )


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Rust f32::round semantics: round half away from zero.

    ``torch.round`` rounds half-to-even, which would disagree with the
    reference on exact .5 ties, and floor(|x|+0.5) is wrong for values one
    ulp below .5 (the f32 addition ties upward) — so compute the fractional
    part exactly instead (x−trunc(x) is exact for |x| < 2^23).
    """
    t = torch.trunc(x)
    frac = x - t
    return t + torch.where(torch.abs(frac) >= 0.5, torch.sign(x), 0.0)


def encode_math(
    blocks: torch.Tensor,      # [..., C, frame_size] f32, un-windowed
    cos_table: torch.Tensor,   # [n, frame_size] f32
    window: torch.Tensor,      # [frame_size] f32
    norm,                      # f32 scalar (0-dim tensor or float)
    band_mask: torch.Tensor,
    band_inv_count: torch.Tensor,
    band_pf: torch.Tensor,
    band_of: torch.Tensor,
    inv_w: torch.Tensor,
    *,
    quality: float = 0.7,
    noise_floor_db: float = -48.0,
    compression_threshold: float = 0.85,
    max_q: float = 32768.0,
):
    """Returns (q int16 [...,C,n], nnz int32 [...,C], scales f32 [...,C],
    raw_pcm int16 [...,C,frame_size], use_raw bool [...]).

    Semantics per reference src/codec.rs:462-541:
      * scale = max |coeff| clamped ≥ 1e-10 (codec.rs:488)
      * keep iff |coeff| > noise_floor·scale AND |coeff| > threshold·scale
        (codec.rs:291)
      * q = round(coeff/scale · 2^15) half-away-from-zero, clamped to i16,
        dropped if 0 (codec.rs:299-306)
      * raw fallback PCM = windowed samples ×32767, clamped, truncated toward
        zero (Rust `as i16`, codec.rs:501)
      * use_raw iff estimated compressed size ≥ 0.85 × raw size
        (codec.rs:506-521)
    """
    C, frame_size = blocks.shape[-2:]

    win = blocks * window
    coeffs = mdct(win, cos_table, norm)                        # [..., C, n]
    absc = torch.abs(coeffs)
    scale = torch.clamp_min(torch.amax(absc, dim=-1), 1e-10)   # [..., C]

    thr = masking_thresholds(
        coeffs, scale[..., None], band_mask, band_inv_count, band_pf,
        band_of, inv_w, quality,
    )

    nf_lin = _noise_floor_linear(noise_floor_db) * scale
    qf = round_half_away((coeffs / scale[..., None]) * max_q)
    qf = torch.clamp(qf, -32768.0, 32767.0)
    keep = (
        (absc > nf_lin[..., None])
        & (absc > thr * scale[..., None])
        & (qf != 0.0)
    )
    q = torch.where(keep, qf, 0.0).to(torch.int16)
    nnz = torch.sum(keep, dim=-1, dtype=torch.int32)

    raw = torch.trunc(
        torch.clamp(win * 32767.0, -32768.0, 32767.0)
    ).to(torch.int16)

    # Per-frame size model (codec.rs:506-521)
    comp_size = (torch.sum(8 + 4 * nnz, dim=-1) + 8 + 4 * C + 64).float()
    raw_limit = float(
        np.float32(frame_size * C * 2) * np.float32(compression_threshold)
    )
    use_raw = comp_size >= raw_limit

    return q, nnz, scale, raw, use_raw


def encode_chunk_device(
    blocks,                    # [K, C, frame_size] f32, un-windowed
    cos_table: torch.Tensor,
    window: torch.Tensor,
    norm,
    band_mask: torch.Tensor,
    band_inv_count: torch.Tensor,
    band_pf: torch.Tensor,
    band_of: torch.Tensor,
    inv_w: torch.Tensor,
    *,
    quality: float = 0.7,
    noise_floor_db: float = -48.0,
    compression_threshold: float = 0.85,
    max_q: float = 32768.0,
):
    """`encode_math` of one chunk of frames on the tables' device
    (``glc_tpu/ops/encode.py::encode_chunk_device``): returns (q, nnz,
    scales, raw_pcm, use_raw).  On the card its MDCT and band sums are the
    kernels `mdct_rows` and `band_energy`, one launch each on K·C rows.
    Like the JAX function it leaves q and nnz unmasked on the raw frames
    (`encode_segment` masks them).  `blocks` may be numpy or a tensor, as
    the JAX function takes either."""
    return encode_math(
        torch.as_tensor(blocks, device=cos_table.device), cos_table,
        window, norm, band_mask, band_inv_count, band_pf, band_of, inv_w,
        quality=quality, noise_floor_db=noise_floor_db,
        compression_threshold=compression_threshold, max_q=max_q,
    )


def frames_from_signal(xpad: torch.Tensor, n: int) -> torch.Tensor:
    """Frame a padded signal [C, P] (P a multiple of n) into 50%-overlap
    blocks [F, C, 2n] with F = P//n − 1, on the signal's device."""
    C, P = xpad.shape
    r = xpad.reshape(C, P // n, n)
    blocks = torch.cat([r[:, :-1], r[:, 1:]], dim=-1)  # [C, F, 2n]
    return blocks.transpose(0, 1)


def planarize(xinter: torch.Tensor, channels: int, lead: int, n: int,
              pad_hops: int) -> torch.Tensor:
    """Interleaved [L] → planar [C, pad_hops·n] with `lead` zeros in front
    and zeros after: frame_signal's deinterleave + pad (reference
    src/codec.rs:427-455) on the signal's device.  The caller guarantees
    L % channels == 0 (ragged inputs are zero-completed on the host, which
    reproduces the reference's modulo deinterleave) and
    lead + L/channels ≤ pad_hops·n."""
    T = xinter.shape[0] // channels
    out = xinter.new_zeros((channels, pad_hops * n))
    out[:, lead : lead + T] = xinter.reshape(T, channels).T
    return out


def compact_pairs(q: torch.Tensor) -> torch.Tensor:
    """Kept (k, q) pairs of q [..., C, n] as int32 words in the .glc byte
    layout: ``q·65536 + k`` has the bits ``k | (q << 16)``, so a word's
    little-endian bytes are bincode's (u16 k, i16 q) and the host views
    the words as `PAIR_DTYPE` with no pass over them (k < 65536, q an
    i16, so no word overflows).  Row-major order — frame, channel,
    ascending k: the .glc stream order (codec.rs:462-541).  Exactly
    sum(nnz) words; there is no budget and no overflow path."""
    n = q.shape[-1]
    k = torch.arange(n, dtype=torch.int32, device=q.device)
    words = q.to(torch.int32) * 65536 + k
    return torch.masked_select(words, q != 0)


def encode_segment(xfull: torch.Tensor, start: int, valid: int, tables, *,
                   quality: float, noise_floor_db: float,
                   compression_threshold: float, max_q: float):
    """Encode frames [start, start+valid) of the planar f32 signal `xfull`
    [C, P] (the segment body of the JAX package's ``_encode_signal_body``).

    Only the `valid` frames are computed: the JAX program computes its
    ladder-bucketed segment and zeroes the q/nnz of frames ≥ valid, which
    no caller reads.  Raw-fallback frames get q = 0 and nnz = 0.

    Returns (stats int32 [valid, 2C+1] — nnz | bitcast f32 scales | use_raw,
    the layout of the JAX segment download —, pair words int32 [sum(nnz)],
    raw rows int16 [R, C, frame_size] of the raw frames in frame order).
    The raw rows are encode_math's windowed, ×32767, clipped and truncated
    samples: the values ``gather_raw_interleaved_device`` computes.
    """
    n = tables.n
    xpad = xfull[:, start * n : (start + valid + 1) * n]
    blocks = frames_from_signal(xpad, n)
    q, nnz, scale, raw, use_raw = encode_math(
        blocks, tables.cos_table, tables.window, tables.norm,
        tables.band_mask, tables.band_inv_count, tables.band_pf,
        tables.band_of, tables.inv_w,
        quality=quality, noise_floor_db=noise_floor_db,
        compression_threshold=compression_threshold, max_q=max_q,
    )
    q = q.masked_fill(use_raw[:, None, None], 0)
    nnz = nnz.masked_fill(use_raw[:, None], 0)
    stats = torch.cat(
        [nnz, scale.view(torch.int32), use_raw.to(torch.int32)[:, None]],
        dim=1,
    )
    return stats, compact_pairs(q), raw[use_raw]
