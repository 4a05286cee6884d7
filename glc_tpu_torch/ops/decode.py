"""Device-side decode: dequantize → IMDCT+window → raw select → overlap-add.

Port of ``glc_tpu/ops/decode.py`` (``blocks_from_frames``,
``decode_chunk_device``, the epilogue of ``_decode_packed_body`` and the
batch program ``decode_chunks_packed_batch_device``).  The IMDCT+window
runs in the hand-written kernel of ``ops/kernels.py``.  Overlap-add with
50% hop is a shifted add,

    hop[f] = first_half(block[f]) + second_half(block[f-1]),

with one [C, n] carry a track between chunks.

Several tracks decode in one pass with their frames stacked back to back
(`decode_stacked`): every step but the overlap-add works row by row, so the
IMDCT+window of the whole batch is one kernel launch on all its rows, and
the overlap-add restarts from each track's own carry at the track's first
frame.  Nothing is padded.  The kernel computes each row alike at any row
count, so on the card a track's hops do not depend on the batch it rode in
(the JAX package gets that guarantee from ``lax.map``).
"""

from __future__ import annotations

import torch

from .kernels import imdct_window


def blocks_from_frames(
    q: torch.Tensor,         # [K, C, n] int16
    scales: torch.Tensor,    # [K, C] f32
    raw_idx: torch.Tensor,   # [R] int64 frame indices, or [K] bool
    raw_rows: torch.Tensor,  # [R, C, frame_size] int16 (or [K, ...])
    cos_table: torch.Tensor,
    window: torch.Tensor,
    norm,                    # f32 scalar: a float or a 0-dim tensor
    *,
    max_q: float = 32768.0,
    window_raw: bool = False,
) -> torch.Tensor:
    """Dequantize + IMDCT + window + raw-PCM select → blocks [K, C, 2n].

    * coeff = (q / max_q) · max(scale, 1e-12)  (codec.rs:653-663)
    * MDCT frames: IMDCT then synthesis window (codec.rs:669-675), fused
    * raw frames: i16/32767, NOT re-windowed (codec.rs:626-643, quirk Q4;
      window_raw=True is the clean Princen-Bradley path)

    The raw frames come as indices with their rows, or as the JAX
    package's dense form: a bool mask over the K frames with rows for all
    K, selected with ``where`` (no host sync).  Both give a raw frame the
    same bits.
    """
    K, C, n = q.shape
    sc = torch.clamp_min(scales, 1e-12)
    coeffs = (q.to(torch.float32) / max_q) * sc[..., None]
    blocks = imdct_window(
        coeffs.reshape(K * C, n), cos_table, window, norm,
    ).view(K, C, 2 * n)
    if raw_idx.numel():
        # a device divisor keeps this a true division: CUDA turns division
        # by a host scalar into multiplication by its reciprocal
        div = torch.full((), 32767.0, dtype=torch.float32, device=q.device)
        raw_f = raw_rows.to(torch.float32) / div
        if window_raw:
            raw_f = raw_f * window
        if raw_idx.dtype == torch.bool:
            return torch.where(raw_idx[:, None, None], raw_f, blocks)
        blocks[raw_idx] = raw_f
    return blocks


def overlap_add(blocks: torch.Tensor, carries: torch.Tensor, counts):
    """Shifted overlap-add (codec.rs:688-705) of the frames of B tracks
    stacked back to back in blocks [Σ counts, C, 2n], `counts[b]` (≥ 1)
    frames of track b, each track after its own carry in carries [B, C, n].
    Returns (hops [Σ counts, C, n], new carries [B, C, n])."""
    n = blocks.shape[-1] // 2
    first = blocks[..., :n]
    second = blocks[..., n:]
    prev, ends, o = [], [], 0
    for b, count in enumerate(counts):
        prev += [carries[b : b + 1], second[o : o + count - 1]]
        o += count
        ends.append(second[o - 1 : o])
    return first + torch.cat(prev), torch.cat(ends)


def decode_chunk_device(
    q,                       # [K, C, n] int16 dense quantized coeffs
    scales,                  # [K, C] f32
    raw_pcm,                 # [K, C, frame_size] int16 (zeros where not raw)
    is_raw,                  # [K] bool
    carry,                   # [C, n] f32: second half of the previous block
    num_valid,               # frames present: an int or a 0-dim tensor
    cos_table: torch.Tensor,
    window: torch.Tensor,
    norm,                    # f32 scalar: a float or a 0-dim tensor
    *,
    max_q: float = 32768.0,
    window_raw: bool = False,
    use_pallas: bool = False,
):
    """One chunk of one track (``glc_tpu/ops/decode.py::
    decode_chunk_device``): returns (hops f32 [K, C, n], new_carry f32
    [C, n]) on the tables' device.

    Dequantize, IMDCT+window (one `imdct_window` launch on K·C rows on the
    card), raw select and the shifted overlap-add after `carry`, as
    `decode_stacked` computes them; ``new_carry`` is the second half of
    frame ``max(num_valid - 1, 0)`` (codec.rs:688-705).  The raw frames are
    selected densely by `is_raw`, and a tensor `num_valid` is read on the
    device, so the call makes no host sync.  Arrays may be numpy or
    tensors, as the JAX function takes either.  `use_pallas` is accepted
    and unread: on CUDA the hand kernel is the one path (as in
    `CodecConfig`).
    """
    dev = cos_table.device
    q, scales, raw_pcm, is_raw, carry = (
        torch.as_tensor(x, device=dev)
        for x in (q, scales, raw_pcm, is_raw, carry))
    n = q.shape[-1]
    blocks = blocks_from_frames(q, scales, is_raw, raw_pcm, cos_table,
                                window, norm, max_q=max_q,
                                window_raw=window_raw)
    hops, _end = overlap_add(blocks, carry[None], [q.shape[0]])
    second = blocks[..., n:]
    if torch.is_tensor(num_valid):
        last = (num_valid.to(dev, torch.int64) - 1).clamp_min(0).reshape(1)
        return hops, second.index_select(0, last)[0]
    return hops, second[max(int(num_valid) - 1, 0)]


def decode_stacked(
    q: torch.Tensor,         # [N, C, n] int16, N = Σ counts
    scales: torch.Tensor,    # [N, C] f32
    raw_idx: torch.Tensor,   # [R] int64 — stacked frames that hold raw PCM
    raw_rows: torch.Tensor,  # [R, C, frame_size] int16
    carries: torch.Tensor,   # [B, C, n] f32
    counts,                  # B frame counts, each ≥ 1
    last: bool,              # this pass ends every track
    tables,
    *,
    max_q: float = 32768.0,
    window_raw: bool = False,
):
    """Decode the frames of B tracks stacked back to back: dequantize,
    IMDCT+window (one `imdct_window` launch on all N·C rows), raw select,
    overlap-add from each track's carry.

    With zero carries and every track ending, this is the counterpart of
    the JAX package's ``decode_chunks_packed_batch_device`` (B single-chunk
    tracks); with B = 1 and the carry chained, of ``decode_chunk_device``
    (one chunk of one track).

    Returns (rows [N (+ B if last), C, n] f32 — each track's hops, each
    followed by its tail, the new carry, if `last`; new carries [B, C, n]).
    """
    blocks = blocks_from_frames(q, scales, raw_idx, raw_rows,
                                tables.cos_table, tables.window,
                                tables.norm_value, max_q=max_q,
                                window_raw=window_raw)
    hops, new = overlap_add(blocks, carries, counts)
    if not last:
        return hops, new
    pieces, o = [], 0
    for b, count in enumerate(counts):
        pieces += [hops[o : o + count], new[b : b + 1]]
        o += count
    return torch.cat(pieces), new


def to_i16(x: torch.Tensor) -> torch.Tensor:
    """The exporters' conversion ×32767, clamp, truncate toward zero
    (audio.rs:9-16).  Separate eager ops: no FMA, no excess precision."""
    prod = x * 32767.0
    return torch.trunc(torch.clamp(prod, -32768.0, 32767.0)).to(torch.int16)
