"""GLC decoder: container → device IMDCT/window/overlap-add per chunk → trim.

Port of ``glc_tpu/codec/decoder.py`` (``decode_i16``, ``decoded_length``,
``decode`` and ``gapless_trim_bounds``).  API mirrors the reference
(reference src/codec.rs:571-768):

    dec = Decoder(channels, sample_rate, device="cuda")
    pcm16 = dec.decode_i16(encoded)   # trimmed, interleaved int16
    samples = dec.decode(encoded)     # trimmed, interleaved float32

The frames are decoded in chunks of ``chunk_size_for(F,
decode_chunk_frames)``; the overlap carry between chunks stays on the
device.  Per chunk the host uploads the pair positions and values, the
scales and the raw rows, and the device scatters, dequantizes, runs the
IMDCT+window kernel, selects the raw rows, overlap-adds and (for
`decode_i16`) converts to int16 before the download.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import CodecConfig, DEFAULT_CONFIG
from ..container.schema import EncodedAudio, FrameSet
from ..ops.decode import blocks_from_frames, dense_q, overlap_add, to_i16
from .device import resolve_device, upload
from .tables import chunk_size_for, get_codec_tables


def gapless_trim_bounds(pre_len: int, gapless_info, channels: int,
                        reference_compat: bool):
    """(skip, limit) of the gapless trim of reference src/codec.rs:756-767:
    drain the encoder delay, truncate to the original length — both guarded,
    both in interleaved-sample units (quirk Q1).  Clean mode scales the
    delay by the channel count so the per-channel lead-in is fully removed
    (fixes Q1).  The trimmed stream is `full[skip : skip + limit]`.
    """
    delay = gapless_info.encoder_delay
    if not reference_compat:
        delay *= channels
    skip = delay if pre_len > delay else 0
    limit = min(gapless_info.original_length, pre_len - skip)
    return skip, limit


def chunk_pairs(fs: FrameSet, start: int, count: int, pair_start: int,
                n: int):
    """Flat positions (frame·C + channel)·n + k (int64, relative to
    `start`) and values (int16) of the pairs of frames [start,
    start+count).

    Out-of-range k is dropped (the reference skips it, codec.rs:661).
    Duplicate positions, which only malformed streams hold, are resolved
    last-wins as the reference's sequential scatter does (codec.rs:660-663):
    the device scatter must see unique positions.
    """
    C = fs.channels
    nnz = fs.nnz[start : start + count].reshape(-1)
    P = int(nnz.sum())
    pairs = fs.pairs[pair_start : pair_start + P]
    k = pairs["k"].astype(np.int64)
    pos = np.repeat(np.arange(count * C, dtype=np.int64), nnz) * n + k
    vals = pairs["q"]
    in_range = k < n
    if not in_range.all():
        pos, vals = pos[in_range], vals[in_range]
    if len(pos) > 1 and not (np.diff(pos) > 0).all():
        # np.unique on the reversed stream keeps each position's LAST pair
        _, last = np.unique(pos[::-1], return_index=True)
        keep = np.sort(len(pos) - 1 - last)
        pos, vals = pos[keep], vals[keep]
    return pos, vals


class Decoder:
    """reference src/codec.rs:571-592 (stateless, Q8).  `device` is where
    the math runs ("cuda", "cpu", a torch.device; None picks CUDA when
    present)."""

    def __init__(self, channels: int, sample_rate: int,
                 config: Optional[CodecConfig] = None, device=None):
        self.channels = int(channels)
        self.sample_rate = int(sample_rate)
        self.config = config or DEFAULT_CONFIG
        self.device = resolve_device(device)
        self.tables = get_codec_tables(
            self.config.n, self.config.frame_size, self.sample_rate,
            self.device,
        )

    def decoded_length(self, encoded: EncodedAudio) -> int:
        """Exact post-trim interleaved sample count of `decode`/`decode_i16`
        output, without decoding: the pre-trim length is (F+1)·n·C (F hops
        plus the overlap tail, quirk Q12)."""
        C = encoded.header.channels
        F = encoded.frame_set.num_frames
        pre_len = (F + 1) * self.config.n * C
        _skip, limit = gapless_trim_bounds(
            pre_len, encoded.gapless_info, C, self.config.reference_compat
        )
        return limit

    def decode_i16(self, encoded: EncodedAudio) -> np.ndarray:
        """Decode to trimmed, interleaved int16: the exporters' conversion
        trunc(clip(x·32767)) (audio.rs:9-16) applied on the device.  Within
        1 LSB of ``convert_f32_to_i16(decode(encoded))``."""
        return self._decode(encoded, out_i16=True)

    def decode(self, encoded: EncodedAudio) -> np.ndarray:
        """Decode to trimmed, interleaved float32 (codec.rs:744-768)."""
        return self._decode(encoded, out_i16=False)

    def _decode(self, encoded: EncodedAudio, *, out_i16: bool) -> np.ndarray:
        cfg = self.config
        n = cfg.n
        dev = self.device
        C = encoded.header.channels
        fs = encoded.frame_set
        F = fs.num_frames
        frame_size = fs.frame_size
        window_raw = not cfg.reference_compat  # fix Q4 in clean mode
        chunk = chunk_size_for(max(F, 1), cfg.decode_chunk_frames)

        pair_off = np.concatenate([[0], np.cumsum(fs.nnz.sum(axis=1))])
        raw_off = np.concatenate([[0], np.cumsum(fs.raw_mask)])
        carry = torch.zeros((C, n), dtype=torch.float32, device=dev)
        outs = []
        for start in range(0, F, chunk):
            valid = min(chunk, F - start)
            pos, vals = chunk_pairs(fs, start, valid, int(pair_off[start]), n)
            q = dense_q(upload(pos, dev), upload(vals, dev), valid, C, n)
            scales = upload(fs.scales[start : start + valid], dev)
            raw_idx = np.flatnonzero(fs.raw_mask[start : start + valid])
            r0 = int(raw_off[start])
            rows = upload(fs.raw_pcm[r0 : r0 + len(raw_idx)], dev)
            if cfg.reference_compat:
                # channel-major data read back interleaved (Q13)
                rows = rows.view(-1, frame_size, C).transpose(1, 2)
            else:
                rows = rows.view(-1, C, frame_size)
            blocks = blocks_from_frames(
                q, scales, upload(raw_idx, dev), rows, self.tables,
                max_q=cfg.max_q, window_raw=window_raw,
            )
            hops, carry = overlap_add(blocks, carry)
            outs.append(self._epilogue(hops, out_i16))
        # the stream's overlap tail (codec.rs:722-732), converted like a hop
        outs.append(self._epilogue(carry[None], out_i16))
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        full = np.concatenate([o.numpy().reshape(-1) for o in outs])
        skip, limit = gapless_trim_bounds(
            len(full), encoded.gapless_info, C, cfg.reference_compat
        )
        return full[skip : skip + limit]

    @staticmethod
    def _epilogue(hops: torch.Tensor, out_i16: bool) -> torch.Tensor:
        """[K, C, n] hops → interleaved [K, n, C] (int16 if asked) on the
        host; on CUDA the copy is queued without blocking, into pinned
        memory."""
        if out_i16:
            hops = to_i16(hops)
        hops = hops.transpose(1, 2).contiguous()
        return hops.to("cpu", non_blocking=hops.is_cuda)
