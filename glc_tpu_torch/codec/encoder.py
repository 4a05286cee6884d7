"""GLC encoder: upload → device MDCT/mask/quantize per segment → container.

Port of ``glc_tpu/codec/encoder.py``.  API mirrors the reference
(reference src/codec.rs:396-566):

    enc = Encoder(sample_rate, device="cuda")
    encoded = enc.encode(samples, channels)     # interleaved float32
    encoded = enc.encode_pcm16(i16, channels)   # exact fast path for 16-bit
                                                # sources (i16/2^15 == f32)
    encodeds = enc.encode_many([(i16, 2), (f32, 1), ...])  # in input order
    st = {}
    encoded = enc.encode_pcm16(i16, channels, stats=st)  # st: the host time
                                # per stage and the transfer counts
    encodeds = enc.encode_many(items, stats=st)  # every track's, summed

The host uploads the interleaved signal once per file, from pinned memory;
the deinterleave, padding and framing happen on the device.  Each segment
of the plan (`upload_geometry`) is one batch of frames: its per-frame
stats are downloaded as it ends, into their rows of one host array; its
kept pairs, already in the container's byte layout, and the raw rows of
the frames that chose the raw-PCM fallback stay on the device until the
track's last segment, and are then copied once each into their slices of
the container's own arrays, with no host pass over a pair.

`encode_many` encodes its tracks one after another.  Each segment waits
for its own downloads (the pair count of ``masked_select`` and the stats),
so grouping tracks on the host overlaps nothing on the device; and a
stacked MDCT could let cuBLAS pick another kernel, move a coefficient by
an ulp and flip a keep-gate decision (the hazard that made the JAX package
map its batch with ``lax.map``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import CodecConfig, DEFAULT_CONFIG
from ..container.schema import (
    AudioHeader,
    EncodedAudio,
    FrameSet,
    GaplessInfo,
)
from ..ops.encode import encode_segment, planarize
from ..profiling import maybe_trace
from .device import StageClock, download_concat, resolve_device, upload
from .tables import get_codec_tables, len_bucket


# The keys of the `stats=` hook (`Encoder.encode`): the JAX package's
# (disp_ms, wait_ms, up_n, down_n) and the port's stages around them.
STATS_KEYS = ("wall_ms", "prep_ms", "disp_ms", "wait_ms", "unpack_ms",
              "assemble_ms", "up_n", "down_n")


def frame_signal(samples: np.ndarray, channels: int, cfg: CodecConfig,
                 dtype=np.float32):
    """Deinterleave + pad on the host, mirroring reference
    src/codec.rs:427-455 (copied from the JAX package; the encoder does
    this on the device with `planarize`, and the tests hold the two equal).

    Returns (padded [C, P], num_frames, padding, per_channel_len).
    Padding: hop/2 leading zeros, pad to hop multiple, hop/2 trailing zeros.
    """
    hop, frame = cfg.hop_size, cfg.frame_size
    samples = np.asarray(samples, dtype)
    if channels <= 0:
        raise ValueError("channels must be >= 1")
    lead = hop // 2

    def padded_len(t: int) -> int:
        rem = (lead + t) % hop
        return lead + t + ((hop - rem) if rem else 0) + lead

    # The reference deinterleaves by i % ch (codec.rs:427-431), so a ragged
    # interleaved count is accepted: early channels get one extra sample.
    # Frame count comes from channel 0's padded length (codec.rs:449-455);
    # if a shorter channel pads to a smaller length the reference's frame
    # slicing would panic — we reject that input explicitly.
    T = (len(samples) + channels - 1) // channels  # channel-0 length
    P = padded_len(T)
    padded = np.zeros((channels, P), dtype)
    if len(samples) % channels == 0:
        padded[:, lead : lead + T] = samples.reshape(T, channels).T
    else:
        for c in range(channels):
            ch_data = samples[c::channels]
            if padded_len(len(ch_data)) < P:
                raise ValueError(
                    "ragged interleaved input where channel lengths pad to "
                    "different sizes (the reference panics on this input)"
                )
            padded[c, lead : lead + len(ch_data)] = ch_data

    num_frames = 1 if P < frame else (P - frame) // hop + 1
    padding = P - T - lead  # codec.rs:546
    return padded, num_frames, padding, T


def zero_extend(padded: np.ndarray, need: int) -> np.ndarray:
    """Zero-extend the signal's sample axis to `need` (no-op when long
    enough).  Copied from ``glc_tpu/codec/encoder.py``, where the serial
    encoder and the sharded album framer share it; here the encoder pads
    on the device (`planarize`) and only the album framer
    (``parallel/album.py``) calls it, so the tests hold the two equal."""
    if padded.shape[1] >= need:
        return padded
    ext = np.zeros((padded.shape[0], need), padded.dtype)
    ext[:, : padded.shape[1]] = padded
    return ext


def frame_plan(total_samples: int, channels: int, cfg: CodecConfig):
    """Pure-arithmetic twin of `frame_signal`: (T, F, padding) without
    building any array.

    T is the channel-0 length (the reference deinterleaves by i % ch,
    codec.rs:427-431, so ragged inputs give early channels one extra
    sample); F and padding come from channel 0 exactly as in
    codec.rs:449-455 and :546.  Raises for the ragged inputs the
    reference's frame slicing panics on.
    """
    hop, frame = cfg.hop_size, cfg.frame_size
    if channels <= 0:
        raise ValueError("channels must be >= 1")
    lead = hop // 2

    def padded_len(t: int) -> int:
        rem = (lead + t) % hop
        return lead + t + ((hop - rem) if rem else 0) + lead

    T = (total_samples + channels - 1) // channels
    P = padded_len(T)
    if total_samples % channels and padded_len(T - 1) < P:
        raise ValueError(
            "ragged interleaved input where channel lengths pad to "
            "different sizes (the reference panics on this input)"
        )
    F = 1 if P < frame else (P - frame) // hop + 1
    padding = P - T - lead
    return T, F, padding


def upload_geometry(total_samples: int, channels: int, cfg: CodecConfig):
    """The segment geometry of one track: (T, F, padding, plan, need_hops).

    * plan — [(start_hop, k_frames)]: full segments of K = ladder(F) capped
      at encode_chunk_frames, plus one ladder-bucketed tail segment for the
      remainder (the JAX package's plan, unchanged).
    * need_hops — the planar signal's length in hops on the device.

    The JAX version also returns an upload length bucketed for its compile
    cache; the port uploads the samples as they are.
    """
    hop = cfg.hop_size
    lead = hop // 2
    T, F, padding = frame_plan(total_samples, channels, cfg)
    K = min(max(len_bucket(F), 16), cfg.encode_chunk_frames)
    plan = [(i * K, K) for i in range(F // K)]  # (start, k_frames)
    rem = F - (F // K) * K  # F >= 1, so rem > 0 whenever plan is empty
    if rem:
        plan.append(((F // K) * K, min(len_bucket(rem), K)))
    last_start, last_k = plan[-1]
    p_hops = (lead + T + hop - 1) // hop + 1   # hops covering lead+T+lead
    need_hops = max(last_start + last_k + 1, p_hops)
    return T, F, padding, plan, need_hops


class Encoder:
    """reference src/codec.rs:396-418.

    Stateless: all state is the immutable tables, so `encode` is a pure
    function of its inputs.  `device` is where the math runs ("cuda",
    "cpu", a torch.device; None is `resolve_device`'s: $GLC_TORCH_DEVICE,
    else the card, else an error).
    """

    def __init__(self, sample_rate: int, config: Optional[CodecConfig] = None,
                 device=None):
        self.sample_rate = int(sample_rate)
        self.config = config or DEFAULT_CONFIG
        self.device = resolve_device(device)
        self.tables = get_codec_tables(
            self.config.n, self.config.frame_size, self.sample_rate,
            self.device,
        )

    def encode(self, samples: np.ndarray, channels: int,
               stats: Optional[dict] = None) -> EncodedAudio:
        """Encode interleaved float32 PCM (codec.rs:421-565).

        `stats`, if given, accumulates the call's stage and transfer
        attribution (the JAX package's keys and the port's stages, each set
        with setdefault and added to, so one dict can sum several calls).
        Each ``*_ms`` key is host milliseconds; while a profiler records,
        each stage is also the span named beside it, with or without
        `stats`:

        * ``wall_ms`` (``glc.encode``) — the track's encode, from its
          dtype conversion to its return;
        * ``prep_ms`` (``glc.encode.prep``) — the input's dtype conversion,
          `upload_geometry`, the ragged zero-completion and the host array
          of the per-frame stats;
        * ``disp_ms`` (``glc.encode.disp``) — issuing the upload and each
          segment's launches.  On CUDA the segment call also blocks on the
          device: ``masked_select`` (`ops.encode.compact_pairs`) needs the
          segment's kept-pair count, and the raw-row select its raw count,
          so this key holds each segment's device math up to those counts;
          it cannot be split from the issuing without adding a sync;
        * ``wait_ms`` (``glc.encode.wait``) — the downloads: each
          segment's stats into their rows of the stats array, and after
          the last segment each segment's pair words and raw rows into
          their slices of the container's pair and raw-PCM arrays;
        * ``unpack_ms`` (``glc.encode.unpack``) — the split of the stats
          array into the per-frame counts, scales and raw flags, once a
          track;
        * ``assemble_ms`` (``glc.encode.assemble``) — the release of the
          segments' device parts and the container object;
        * ``up_n`` — host→device copies: 1, the interleaved signal;
        * ``down_n`` — device→host copies: 2 a segment (stats, words), plus
          1 for a segment with raw-PCM frames.  The JAX package fetches
          the stats and a guessed pair prefix in one download; here the
          pair count is known before the download, so it is exact.

        ``wall_ms`` less the five stages is the call's unstaged time: the
        loop's own steps.  The counts are of calls, whatever the device, so
        a CPU run gives the card's.  Output is identical with or without
        the hook.
        """
        samples = np.asarray(samples)
        if np.issubdtype(samples.dtype, np.integer):
            raise TypeError(
                "encode() expects float PCM in [-1, 1]; for 16-bit integer "
                "sources use encode_pcm16() (exact, half the upload)"
            )
        with maybe_trace("encode"):
            return self._encode(samples, channels, pcm16=False, stats=stats)

    def encode_pcm16(self, samples_i16: np.ndarray, channels: int,
                     stats: Optional[dict] = None) -> EncodedAudio:
        """Exact fast path for 16-bit integer sources: the same container
        as `encode(samples_i16 / 32768.0, ch)`, with the division on the
        device (exact in f32) after a half-size upload.  `stats`: see
        `encode`."""
        with maybe_trace("encode"):
            return self._encode(samples_i16, channels, pcm16=True,
                                stats=stats)

    def encode_many(self, items, stats: Optional[dict] = None) -> list:
        """Encode several tracks (glc_tpu/codec/encoder.py:468-905):
        `items` is a sequence of (samples, channels); int16 arrays take the
        exact `encode_pcm16` path, float arrays the `encode` path.  Other
        integer arrays raise TypeError, and empty or unframeable inputs
        ValueError, before anything is encoded.  Returns the containers in
        input order, each the per-file encode's (the module docstring says
        why the tracks are not batched).  `stats` (see `encode`) sums every
        track's keys, as the per-file calls would add them; a track's
        ``wall_ms`` starts after the checks of all the tracks."""
        prepped = []
        for samples, channels in items:
            samples = np.asarray(samples)
            pcm16 = samples.dtype == np.int16
            if not pcm16 and np.issubdtype(samples.dtype, np.integer):
                raise TypeError("encode_many expects float PCM or int16 arrays")
            prepped.append((samples, int(channels), pcm16))
        for samples, channels, _pcm16 in prepped:
            if len(samples) == 0:
                raise ValueError("cannot encode empty input")
            frame_plan(len(samples), channels, self.config)
        with maybe_trace("encode_many"):
            return [self._encode(s, c, pcm16=p, stats=stats)
                    for s, c, p in prepped]

    def _encode(self, samples, channels: int, *, pcm16: bool,
                stats: Optional[dict] = None) -> EncodedAudio:
        clock = StageClock(stats, STATS_KEYS, "encode")
        with clock.call():
            return self._encode_stages(samples, channels, pcm16, clock)

    def _encode_stages(self, samples, channels: int, pcm16: bool,
                       clock: StageClock) -> EncodedAudio:
        cfg = self.config
        hop, frame_size, n = cfg.hop_size, cfg.frame_size, cfg.n
        C = int(channels)
        lead = hop // 2
        with clock.stage("prep"):
            samples = (np.asarray(samples, np.int16) if pcm16
                       else samples.astype(np.float32, copy=False))
            total_samples = len(samples)
            if total_samples == 0:
                raise ValueError("cannot encode empty input")
            T, F, padding, plan, need_hops = upload_geometry(
                total_samples, C, cfg
            )
            if T * C != total_samples:
                # ragged input: zero-complete the last sample row, which
                # reproduces the reference's modulo deinterleave
                xup = np.zeros(T * C, samples.dtype)
                xup[:total_samples] = samples
            else:
                xup = samples
            seg_stats = np.empty((F, 2 * C + 1), np.int32)
        with clock.stage("disp"):
            xfull = planarize(upload(xup, self.device), C, lead, n, need_hops)
            clock.count("up_n")
            if pcm16:
                xfull = xfull.to(torch.float32) / 32768.0  # exact: 2^15

        word_parts = []
        raw_parts = []
        for start, k in plan:
            valid = min(k, F - start)
            with clock.stage("disp"):
                stats_d, words_d, raw_d = encode_segment(
                    xfull, start, valid, self.tables,
                    quality=cfg.quality_factor,
                    noise_floor_db=cfg.noise_floor_db,
                    compression_threshold=cfg.compression_threshold,
                    max_q=cfg.max_q,
                )
            with clock.stage("wait"):  # waits for the segment
                torch.from_numpy(seg_stats[start : start + valid]).copy_(
                    stats_d)
            clock.count("down_n")
            word_parts.append(words_d)
            if raw_d.shape[0]:
                # channel-major flatten — the reference's actual storage
                # layout (codec.rs:471-503, quirk Q13)
                raw_parts.append(raw_d.reshape(-1, C * frame_size))

        with clock.stage("wait"):
            pairs_all = download_concat(word_parts, np.int32)
            raw_all = download_concat(raw_parts, np.int16, C * frame_size)
        clock.count("down_n", len(word_parts) + len(raw_parts))
        with clock.stage("unpack"):
            nnz_all = seg_stats[:, :C].astype(np.int64)
            scales_all = np.ascontiguousarray(seg_stats[:, C : 2 * C]).view(
                np.float32)
            raw_mask_all = seg_stats[:, 2 * C] != 0

        with clock.stage("assemble"):
            del word_parts, raw_parts, stats_d, words_d, raw_d
            fs = FrameSet(nnz_all, pairs_all, scales_all, raw_mask_all,
                          raw_all, frame_size)
            return EncodedAudio(
                header=AudioHeader(self.sample_rate, C, total_samples),
                frame_set=fs,
                gapless_info=GaplessInfo(
                    encoder_delay=hop // 2,
                    padding=padding,
                    original_length=total_samples,
                ),
            )
