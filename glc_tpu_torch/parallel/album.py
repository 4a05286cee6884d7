"""Album-scale sharded encode/decode: tracks over the 'data' mesh axis,
frames over the 'frames' axis.

Port of ``glc_tpu/parallel/album.py``.  The reference's album operations
are serial loops (the GUI decodes playlist entries one by one, reference
src/ui.rs:291-402).  Here an album is a batch: each track's frames are one
row of a [B, K, C, 2n] tensor, B laid over 'data' and K over 'frames', and
the per-track results are reassembled into ordinary containers and
streams.  Tracks are independent at encode (no collectives); decode needs
only the 1-hop overlap-add halo along 'frames' (``parallel/sharded.py``).

As everywhere in the package, every rank of the mesh calls with the same
arguments and gets the whole album back.  Each rank frames, scatters and
uploads only its own [B/d, K/f] block; the full arrays exist only as the
gathered results.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..codec.decoder import (
    frame_offsets, gapless_trim, pair_words, row_offsets,
)
from ..codec.device import upload, upload_concat
from ..codec.encoder import frame_plan, frame_signal, zero_extend
from ..codec.tables import get_codec_tables, pow2_bucket
from ..config import CodecConfig, DEFAULT_CONFIG
from ..container.schema import (
    PAIR_DTYPE,
    AudioHeader,
    EncodedAudio,
    FrameSet,
    GaplessInfo,
)
from ..ops.kernels import scatter_pairs
from .sharded import (
    decode_local,
    encode_local,
    gather_axis,
    gather_blocks,
    local_shard,
)


def _album_geometry(num_frames: Sequence[int], mesh: DeviceMesh,
                    floor: int = 16) -> Tuple[int, int]:
    """(B_padded, K_padded): batch padded to the 'data' shard count, frame
    axis to a power-of-two multiple of the 'frames' shard count."""
    shard = local_shard(mesh)
    d, f = shard.data, shard.frames
    B = len(num_frames)
    Bp = ((B + d - 1) // d) * d
    K = pow2_bucket(max(num_frames), 1 << 30, floor=floor)
    K = ((K + f - 1) // f) * f
    return Bp, K


def encode_album_sharded(
    mesh: DeviceMesh,
    signals: Sequence[np.ndarray],
    channels: int,
    sample_rate: int,
    config: Optional[CodecConfig] = None,
) -> List[EncodedAudio]:
    """Encode an album (list of interleaved f32 streams, one per track) in
    one sharded pass.

    Equivalent to ``[Encoder(rate).encode(s, ch) for s in signals]``: the
    same math (``ops.encode.encode_math``), batched [B, K, C, 2n] over the
    mesh instead of file-serial.  Pure data parallelism: encode has no
    cross-frame coupling (SURVEY.md §2.8).
    """
    cfg = config or DEFAULT_CONFIG
    hop, frame_size, n = cfg.hop_size, cfg.frame_size, cfg.n
    C = int(channels)
    shard = local_shard(mesh)
    tb = get_codec_tables(n, frame_size, sample_rate, shard.device)

    signals = [np.asarray(s, np.float32) for s in signals]
    plans = [frame_plan(len(s), C, cfg) for s in signals]  # (T, F, padding)
    num_frames = [F for _T, F, _p in plans]
    Bp, K = _album_geometry(num_frames, mesh)
    Bl, Kl = Bp // shard.data, K // shard.frames
    b0, k0 = shard.d * Bl, shard.f * Kl

    blocks = np.zeros((Bl, Kl, C, frame_size), np.float32)
    for b in range(b0, min(b0 + Bl, len(signals))):
        F = num_frames[b]
        m = min(Kl, F - k0)
        if m <= 0:
            continue
        padded = frame_signal(signals[b], C, cfg)[0]
        # 50%-overlap framing (codec.rs:462-481, un-windowed; the window is
        # applied inside encode_math).  The padded length is hop-aligned
        # plus the trailing hop/2 (codec.rs:434-447), so frame by stride,
        # not reshape.  Very short tracks pad to less than one frame_size:
        # zero-extend so every frame's window is in bounds (the serial
        # encoder's device planarize pads the same way).
        padded = zero_extend(padded, (F - 1) * hop + frame_size)
        win = np.lib.stride_tricks.sliding_window_view(
            padded, frame_size, axis=1
        )[:, ::hop]                                   # [C, F', 2n]
        blocks[b - b0, :m] = win[:, k0 : k0 + m].transpose(1, 0, 2)

    params = dict(
        quality=cfg.quality_factor,
        noise_floor_db=cfg.noise_floor_db,
        compression_threshold=cfg.compression_threshold,
        max_q=cfg.max_q,
    )
    local = encode_local(upload(blocks, shard.device), tb, **params)
    q, nnz, scales, raw, use_raw = (
        t.cpu().numpy() for t in gather_blocks(mesh, local))

    out: List[EncodedAudio] = []
    for b, ((_T, F, padding), sig) in enumerate(zip(plans, signals)):
        total = len(sig)
        m_raw = use_raw[b, :F]
        nnz_b = np.where(m_raw[:, None], 0, nnz[b, :F]).astype(np.int64)
        q_b = np.where(m_raw[:, None, None], np.int16(0), q[b, :F])
        fidx, cidx, kpos = np.nonzero(q_b)
        pairs = np.empty(len(kpos), PAIR_DTYPE)
        pairs["k"] = kpos.astype(np.uint16)
        pairs["q"] = q_b[fidx, cidx, kpos]
        # channel-major raw rows, the container layout (Q13)
        raw_rows = raw[b, :F][m_raw].reshape(-1, C * frame_size)
        fs = FrameSet(nnz_b, pairs, scales[b, :F], m_raw, raw_rows,
                      frame_size)
        out.append(
            EncodedAudio(
                header=AudioHeader(sample_rate, C, total),
                frame_set=fs,
                gapless_info=GaplessInfo(
                    encoder_delay=hop // 2,
                    padding=padding,
                    original_length=total,
                ),
            )
        )
    return out


def decode_album_sharded(
    mesh: DeviceMesh,
    encoded_list: Sequence[EncodedAudio],
    config: Optional[CodecConfig] = None,
) -> List[np.ndarray]:
    """Decode an album in one sharded pass; returns the trimmed interleaved
    f32 stream per track (what `Decoder.decode` yields per file, reference
    src/codec.rs:744-768).

    The frame axis carries the 1-hop overlap-add halo; tracks are
    independent rows of the 'data' axis.  Each rank uploads its block's
    pair words and expands them on the device as the serial decoder does
    (`ops.kernels.scatter_pairs`: out-of-range k dropped, codec.rs:661;
    duplicates last-wins, codec.rs:660-663) and decodes the block with one
    `imdct_window` launch.
    """
    cfg = config or DEFAULT_CONFIG
    n = cfg.n
    if not encoded_list:
        return []
    rate = encoded_list[0].header.sample_rate
    C = encoded_list[0].header.channels
    for ea in encoded_list:
        if (ea.header.sample_rate, ea.header.channels) != (rate, C):
            raise ValueError("album tracks must share sample rate/channels")
    frame_size = 2 * n
    shard = local_shard(mesh)
    dev = shard.device
    tb = get_codec_tables(n, frame_size, rate, dev)

    num_frames = [ea.frame_set.num_frames for ea in encoded_list]
    Bp, K = _album_geometry(num_frames, mesh)
    Bl, Kl = Bp // shard.data, K // shard.frames
    b0, k0 = shard.d * Bl, shard.f * Kl

    # this block's pair words, pair counts, scales and raw rows; frames are
    # numbered bl·Kl + (k − k0) within the block, padded ones without pairs
    word_l = [np.empty(0, np.int32)]
    nnz = np.zeros((Bl, Kl, C), np.int64)
    idx_l = [np.empty(0, np.int64)]
    raw_l = [np.empty((0, C * frame_size), np.int16)]
    scales = np.zeros((Bl, Kl, C), np.float32)
    for b in range(b0, min(b0 + Bl, len(encoded_list))):
        fs = encoded_list[b].frame_set
        m = min(Kl, num_frames[b] - k0)
        if m <= 0:
            continue
        base = (b - b0) * Kl
        pair_off, raw_off = frame_offsets(fs)
        word_l.append(pair_words(fs, k0, m, pair_off))
        nnz[b - b0, :m] = fs.nnz[k0 : k0 + m]
        scales[b - b0, :m] = fs.scales[k0 : k0 + m]
        raw_idx = np.flatnonzero(fs.raw_mask[k0 : k0 + m])
        r0 = int(raw_off[k0])
        idx_l.append(raw_idx + base)
        raw_l.append(fs.raw_pcm[r0 : r0 + len(raw_idx)])

    q = scatter_pairs(upload_concat(word_l, dev),
                      upload(row_offsets(nnz.reshape(-1)), dev),
                      Bl * Kl * C, n).view(Bl, Kl, C, n)
    rows = upload_concat(raw_l, dev)
    if cfg.reference_compat:
        # interleaved read-back of channel-major data (Q13)
        rows = rows.view(-1, frame_size, C).transpose(1, 2)
    else:
        rows = rows.view(-1, C, frame_size)
    carry = torch.zeros((Bl, C, n), dtype=torch.float32, device=dev)
    hops, tail = decode_local(
        mesh, q, upload(scales, dev), upload_concat(idx_l, dev), rows,
        carry, tb, max_q=cfg.max_q, window_raw=not cfg.reference_compat,
    )
    (hops,) = gather_blocks(mesh, [hops])
    hops = hops.cpu().numpy()
    tail = gather_axis(tail, mesh, "data", 0).cpu().numpy()

    out: List[np.ndarray] = []
    for b, ea in enumerate(encoded_list):
        F = ea.frame_set.num_frames
        flat = hops[b, :F].transpose(0, 2, 1).reshape(-1)
        # final chunk appends the stream's own tail: the second half of its
        # LAST frame, not the batch-padded one — recompute locally from the
        # hop after frame F-1, which for padded rows is hops[b, F] when
        # F < K (the padded frame's first half is 0, so hop F == tail).
        if F < K:
            tail_b = hops[b, F].T.reshape(-1)
        else:
            tail_b = tail[b].T.reshape(-1)
        full = np.concatenate([flat, tail_b])
        out.append(
            gapless_trim(full, ea.gapless_info, C, cfg.reference_compat)
        )
    return out
