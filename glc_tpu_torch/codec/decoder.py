"""GLC decoder: container → device IMDCT/window/overlap-add per chunk → trim.

Port of ``glc_tpu/codec/decoder.py`` (``decode_streaming``,
``decode_i16_stream`` with ``_pipelined_i16_chunks``, ``decode_i16``,
``decode_many``, ``decode``,
``decoded_length``, ``gapless_trim_bounds`` and ``gapless_trim``).  API
mirrors the reference (reference src/codec.rs:571-768):

    dec = Decoder(channels, sample_rate, device="cuda")
    for part in dec.decode_i16_stream(encoded):  # trimmed int16 chunks
        ...
    pcm16 = dec.decode_i16(encoded)              # trimmed, interleaved int16
    rx = dec.decode_streaming(encoded, progress) # queue of AudioChunk (f32)
    samples = dec.decode(encoded)                # trimmed, interleaved f32
    outs = dec.decode_many([ea1, ea2, ...])      # int16 a track, in order
    pcm16 = dec.decode_i16(encoded, stats=st)    # st: the host time per
                                                 # stage, transfer counts

The frames are decoded in chunks of ``chunk_size_for(F,
decode_chunk_frames)``; the overlap carry between chunks stays on the
device.  Per chunk the host uploads the pairs as the container holds them
(one int32 word a pair) with each frame·channel row's offset into them,
the scales and the raw rows, and the device expands the words into dense q
(`ops.kernels.scatter_pairs`), dequantizes, runs the IMDCT+window kernel,
selects the raw rows, overlap-adds and (for the int16 surfaces) converts to
int16 before the download.

There are two chunk loops, one per output type: `_pipelined_i16_chunks`
(int16: `decode_i16_stream`, `decode_i16`) and the producer thread of
`decode_streaming` (float32: `decode`).  On CUDA each chunk's download is
queued into pinned memory with an event recorded after it; the host waits
on that chunk's event only, with up to `_PIPELINE_DEPTH` chunks in flight.

`decode_many` decodes several tracks at once (`ops.decode.decode_stacked`:
their frames stacked back to back, one kernel launch on all their rows):
each group of single-chunk tracks of one channel count and chunk size in
one pass.  Multi-chunk tracks run through `_pipelined_i16_chunks` one
after another, in one window of chunks.  The JAX package's segment-level
batch of multi-chunk tracks (``segmented_batch``) is not ported: no
measurement on the card has shown it ahead of the serial chunks.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import CodecConfig, DEFAULT_CONFIG
from ..container.schema import AudioChunk, EncodedAudio, FrameSet, Progress
from ..ops.decode import decode_stacked, to_i16
from ..ops.kernels import scatter_pairs
from ..profiling import maybe_trace
from .device import NO_STATS, StageClock, resolve_device, upload_concat
from .tables import chunk_size_for, get_codec_tables

ProgressSender = Callable[[Progress], None]

# Chunks in flight in the int16 stream: dispatched, their downloads queued,
# not yet handed to the consumer (glc_tpu/codec/decoder.py:83).  It bounds
# the pinned host memory and device buffers a long file holds at once.
_PIPELINE_DEPTH = 8

# The name of `decode_streaming`'s producer threads.
PRODUCER_NAME = "glc-decode-producer"

# The keys of the `stats=` hook (`Decoder.decode_i16_stream`), the JAX
# package's.
STATS_KEYS = ("pack_ms", "disp_ms", "wait_ms", "up_n", "down_n")
# The port's own count beside them: the pairs handed to the card as words.
PAIR_KEYS = ("pairs_n",)
# The counts `Decoder.decode_many`'s hook adds: how its single-chunk tracks
# batch.
GROUP_KEYS = ("group_n", "group_tracks_n", "group_rows_n")


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


def gapless_trim(all_samples: np.ndarray, gapless_info, channels: int,
                 reference_compat: bool) -> np.ndarray:
    """The trimmed stream of the pre-trim stream `all_samples` (a view)."""
    skip, limit = gapless_trim_bounds(len(all_samples), gapless_info,
                                      channels, reference_compat)
    return all_samples[skip : skip + limit]


def frame_offsets(fs: FrameSet):
    """(pair_off, raw_off): the index of each frame's first pair and first
    raw row in the FrameSet's arrays, with the totals appended."""
    pair_off = np.concatenate([[0], np.cumsum(fs.nnz.sum(axis=1))])
    raw_off = np.concatenate([[0], np.cumsum(fs.raw_mask)])
    return pair_off, raw_off


def pair_words(fs: FrameSet, start: int, count: int,
               pair_off: np.ndarray) -> np.ndarray:
    """The pairs of frames [start, start+count) as the card takes them
    (`ops.kernels.scatter_pairs`): a view of `fs.pairs` as int32 words,
    q·65536 + k, with no copy.  `pair_off` is `frame_offsets(fs)[0]`."""
    p0, p1 = int(pair_off[start]), int(pair_off[start + count])
    words = fs.pairs[p0:p1].view(np.int32)
    if len(words) != p1 - p0:
        raise ValueError(f"the FrameSet holds {len(fs.pairs)} pairs, its nnz "
                         f"counts {int(pair_off[-1])}")
    return words


def row_offsets(nnz: np.ndarray) -> np.ndarray:
    """[rows + 1] int64: where each frame·channel row's pairs start among
    the rows' words, then their total; `nnz` is each row's pair count."""
    if len(nnz) and nnz.min() < 0:
        raise ValueError("a FrameSet's nnz holds a negative count")
    off = np.zeros(len(nnz) + 1, np.int64)
    np.cumsum(nnz, out=off[1:])
    return off


class _Cancelled(Exception):
    """Raised inside the producer thread when the consumer abandoned the
    stream (rx.cancelled set)."""


class _Download:
    """One chunk's hops on their way to the host: a CPU tensor (pinned and
    still being filled on CUDA) and the event recorded after its copy."""

    __slots__ = ("host", "event")

    def __init__(self, hops: torch.Tensor, out_i16: bool):
        """Queue [K, C, n] hops → interleaved [K, n, C] (int16 if asked);
        on CUDA the copy does not block, into pinned memory."""
        if out_i16:
            hops = to_i16(hops)
        hops = hops.transpose(1, 2).contiguous()
        self.host = hops.to("cpu", non_blocking=hops.is_cuda)
        self.event = None
        if hops.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(hops.device))

    def wait(self) -> np.ndarray:
        """The host array, once this chunk's copy is done.  It keeps the
        tensor, so its pinned block, alive for as long as it lives."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class Decoder:
    """reference src/codec.rs:571-592 (stateless, Q8).  `device` is where
    the math runs ("cuda", "cpu", a torch.device; None is
    `resolve_device`'s: $GLC_TORCH_DEVICE, else the card, else an
    error)."""

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

    def _decode_parts(self, parts, carries: torch.Tensor, last: bool,
                      clock: StageClock = NO_STATS):
        """Decode the frames of `parts` stacked back to back in one pass
        (`decode_stacked`, one kernel launch).  Each part is ``(fs, start,
        valid, offsets)``: frames [start, start+valid) of a FrameSet with
        `frame_offsets(fs)`; all parts have one channel count, and `last`
        says they end their tracks.  `carries` [B, C, n] holds each part's
        overlap carry.  Returns `decode_stacked`'s (rows, new carries).
        `clock` takes the host work that builds the inputs as ``pack_ms``
        (views and slices of the FrameSets, and the row offsets: no pass
        over the pairs), the uploads and launches as ``disp_ms``, and counts
        the uploads and the pairs."""
        cfg = self.config
        n = cfg.n
        dev = self.device

        def up(arrays):
            clock.count("up_n")
            return upload_concat(arrays, dev)

        with clock.stage("pack"):
            C = parts[0][0].channels
            frame_size = parts[0][0].frame_size
            word_l, nnz_l, scale_l, idx_l, raw_l = [], [], [], [], []
            counts = []
            off = 0
            for fs, start, valid, (pair_off, raw_off) in parts:
                word_l.append(pair_words(fs, start, valid, pair_off))
                nnz_l.append(fs.nnz[start : start + valid].reshape(-1))
                scale_l.append(fs.scales[start : start + valid])
                raw_idx = np.flatnonzero(fs.raw_mask[start : start + valid])
                r0 = int(raw_off[start])
                idx_l.append(raw_idx + off)
                raw_l.append(fs.raw_pcm[r0 : r0 + len(raw_idx)])
                counts.append(valid)
                off += valid
            row_off = row_offsets(
                np.concatenate(nnz_l) if len(nnz_l) > 1 else nnz_l[0])
            clock.count("pairs_n", int(row_off[-1]))

        with clock.stage("disp"):
            q = scatter_pairs(up(word_l), up([row_off]), off * C, n)
            rows = up(raw_l)
            if cfg.reference_compat:
                # channel-major data read back interleaved (Q13)
                rows = rows.view(-1, frame_size, C).transpose(1, 2)
            else:
                rows = rows.view(-1, C, frame_size)
            return decode_stacked(
                q.view(off, C, n), up(scale_l), up(idx_l), rows, carries,
                counts, last, self.tables, max_q=cfg.max_q,
                window_raw=not cfg.reference_compat,  # fix Q4 in clean mode
            )

    def _chunks(self, encoded: EncodedAudio, chunk: int,
                clock: StageClock = NO_STATS):
        """Run the frames on the device in chunks of `chunk`, in order;
        yields (valid frames, hops [valid, C, n] f32).  The last chunk's
        hops carry one more row: the stream's overlap tail
        (codec.rs:722-732), so its download brings the tail along.
        `clock` goes to `_decode_parts`."""
        fs = encoded.frame_set
        F = fs.num_frames
        offsets = frame_offsets(fs)
        carry = torch.zeros((1, encoded.header.channels, self.config.n),
                            dtype=torch.float32, device=self.device)
        for start in range(0, F, chunk):
            valid = min(chunk, F - start)
            hops, carry = self._decode_parts(
                [(fs, start, valid, offsets)], carry, start + chunk >= F,
                clock)
            yield valid, hops

    # --- int16: the stream and the whole-file decode (export path) ---

    def decode_i16_stream(self, encoded: EncodedAudio,
                          chunk_frames: Optional[int] = None,
                          stats: Optional[dict] = None):
        """Generator of gapless-trimmed int16 interleaved chunks, in stream
        order, with the exporters' conversion trunc(clip(x·32767))
        (audio.rs:9-16) applied on the device.

        The trim is applied incrementally: the guarded drain/truncate of
        codec.rs:756-767 needs the pre-trim total, which is exact up front,
        (F+1)·n·C interleaved samples (F hops plus the overlap tail).
        `chunk_frames` overrides the decode chunk size (config
        ``decode_chunk_frames``) for this stream; consumers that do host
        work per chunk (the FLAC export) use ``stream_chunk_frames``.  The
        yielded arrays stay valid after the generator moves on.

        `stats`, if given, accumulates the loop's stage and transfer
        attribution (the JAX package's keys, each set with setdefault and
        added to, so one dict can sum several calls).  While a profiler
        records, each stage is also the span named beside it, with or
        without `stats`:

        * ``pack_ms`` (``glc.decode.pack``) — host ms building a chunk's
          inputs: views of its pair words, the scale and raw-row slices,
          the rows' pair offsets (a sum over its frame·channel rows) and
          their lists (the counterpart of the JAX package's
          ``_packed_slices``);
        * ``disp_ms`` (``glc.decode.disp``) — host ms issuing the uploads
          (the pinned staging included), the launches and the non-blocking
          download;
        * ``wait_ms`` (``glc.decode.wait``) — host ms blocked on a chunk's
          download, and its trim;
        * ``up_n`` — host→device copies: 5 a chunk, where the JAX package
          uploads one packed words array a chunk; the port sends the pair
          words, the rows' pair offsets, the raw rows, the scales and the
          raw frames' indices apart, each a pinned copy that does not block;
        * ``down_n`` — device→host copies: 1 a chunk (the JAX package's
          ≤1024-row pieces are not ported);
        * ``pairs_n`` (`PAIR_KEYS`, the port's own) — the pairs handed to
          the card as words, out-of-range and duplicate pairs included.

        The counts are of calls, whatever the device, so a CPU run gives
        the card's.  The consumer's time between two chunks lands in no
        key.  Output is identical with or without the hook.
        """
        clock = StageClock(stats, STATS_KEYS + PAIR_KEYS, "decode")
        for _pos, flat in self._pipelined_i16_chunks(
            [(0, encoded)], clock, chunk_frames=chunk_frames
        ):
            yield flat

    def _pipelined_i16_chunks(self, recs, clock: StageClock,
                              chunk_frames: Optional[int] = None):
        """Core of the int16 decode surfaces: drive the tracks in `recs` (a
        list of ``(pos, EncodedAudio)``) chunk by chunk through the device
        with one `_PIPELINE_DEPTH`-deep window of chunks in flight, yielding
        ``(pos, trimmed_flat)`` in stream order.

        Each chunk's int16 hops are queued to the host as a `_Download`;
        chunk i is handed on only after waiting on chunk i's event, never
        on the whole device, so the host's work on chunk i overlaps the
        device's on the chunks after it.  `clock` times the stages and
        counts the transfers of `decode_i16_stream`'s hook.
        """
        cfg = self.config
        n = cfg.n

        # per-track trim state: pos -> [skip_left, emitted, limit]
        trim_state: dict = {}

        def trim(pos, flat):
            st = trim_state[pos]
            skip, emitted, limit = st
            if skip:
                cut = min(skip, len(flat))
                flat = flat[cut:]
                st[0] = skip - cut
            if emitted + len(flat) > limit:
                flat = flat[: limit - emitted]
            st[1] = emitted + len(flat)
            return flat

        def collect(handle):
            pos, download = handle
            with clock.stage("wait"):
                out = trim(pos, download.wait().reshape(-1))
            return pos, out

        handles: list = []
        for pos, encoded in recs:
            C = encoded.header.channels
            F = encoded.frame_set.num_frames
            chunk = chunk_size_for(max(F, 1),
                                   chunk_frames or cfg.decode_chunk_frames)
            skip, limit = gapless_trim_bounds(
                (F + 1) * n * C, encoded.gapless_info, C,
                cfg.reference_compat,
            )
            trim_state[pos] = [skip, 0, limit]
            if F == 0:  # no chunks to run: the stream is the silent tail
                tail = trim(pos, np.zeros(n * C, np.int16))
                if len(tail):
                    yield pos, tail
                continue
            for _valid, hops in self._chunks(encoded, chunk, clock):
                with clock.stage("disp"):
                    handles.append((pos, _Download(hops, out_i16=True)))
                clock.count("down_n")
                if len(handles) > _PIPELINE_DEPTH:
                    pos_o, out = collect(handles.pop(0))
                    if len(out):
                        yield pos_o, out

        for handle in handles:
            pos_o, out = collect(handle)
            if len(out):
                yield pos_o, out

    def decode_i16(self, encoded: EncodedAudio,
                   stats: Optional[dict] = None) -> np.ndarray:
        """Decode to trimmed, interleaved int16: the concatenation of
        `decode_i16_stream` at the default chunk size.  Within 1 LSB of
        ``convert_f32_to_i16(decode(encoded))``.  `stats` goes to
        `decode_i16_stream`'s stage-attribution hook."""
        with maybe_trace("decode_i16"):
            parts = list(self.decode_i16_stream(encoded, stats=stats))
        if not parts:
            return np.empty(0, np.int16)
        return np.concatenate(parts)

    # --- int16, several tracks: the album decode ---

    def decode_many(self, encoded_list, stats: Optional[dict] = None) -> list:
        """Decode several tracks to trimmed int16, one array a track in
        input order (glc_tpu/codec/decoder.py:630-751; the reference's GUI
        decodes an album one file after another, src/ui.rs:317-359).  Each
        track uses its own header's channel count.

        * Single-chunk tracks (F ≤ the chunk size of F) are grouped by
          (channels, chunk size); each group is one pass of
          `_decode_parts`: one upload of each input, one kernel launch on
          the rows of every track, one download.  Every group is dispatched
          before any is collected.
        * Multi-chunk tracks run through `_pipelined_i16_chunks`, one track
          after another in one window of chunks
          (`_decode_streaming_pipelined`).
        * Tracks with no frames go through `decode_i16`.

        On the card each track equals its own `decode_i16` bit for bit (the
        kernel computes each row alike at any row count).  On the CPU the
        plain product rounds a product of ≤ 128 rows differently from a
        larger one, so a batched track can differ from `decode_i16` by
        1 LSB there.  Each result owns its memory.

        `stats`, if given, accumulates `decode_i16_stream`'s keys over the
        whole call, the single-chunk groups' and the multi-chunk tracks'
        alike, each stage also the span of its name while a profiler
        records: a group's input build is ``pack_ms``, its uploads, its
        launch and its download that does not block ``disp_ms``, and the
        wait on its download with each track's trim and copy ``wait_ms``.
        ``up_n``, ``down_n`` and ``pairs_n`` count a group's as a chunk's.
        Three more counts say how the tracks batch (`GROUP_KEYS`):

        * ``group_n`` — single-chunk groups, one pass and one
          `imdct_window` launch each;
        * ``group_tracks_n`` — the tracks decoded in them;
        * ``group_rows_n`` — the rows those launches take, frames ×
          channels.

        The empty tracks' `decode_i16` is not counted.  Output is identical
        with or without the hook.
        """
        cfg = self.config
        n = cfg.n
        clock = StageClock(stats, STATS_KEYS + PAIR_KEYS + GROUP_KEYS,
                           "decode")
        results: list = [None] * len(encoded_list)
        groups: dict = {}
        multis: list = []
        empties: list = []
        for i, ea in enumerate(encoded_list):
            C = ea.header.channels
            F = ea.frame_set.num_frames
            chunk = chunk_size_for(max(F, 1), cfg.decode_chunk_frames)
            if F == 0:
                empties.append((i, ea))
            elif F > chunk:
                multis.append((i, ea))
            else:
                groups.setdefault((C, chunk), []).append((i, ea))

        handles = []
        for (C, _chunk), recs in groups.items():
            parts = [
                (ea.frame_set, 0, ea.frame_set.num_frames,
                 frame_offsets(ea.frame_set))
                for _i, ea in recs
            ]
            carries = torch.zeros((len(recs), C, n), dtype=torch.float32,
                                  device=self.device)
            rows, _carries = self._decode_parts(parts, carries, True, clock)
            with clock.stage("disp"):
                handles.append((recs, _Download(rows, out_i16=True)))
            clock.count("down_n")
            clock.count("group_n")
            clock.count("group_tracks_n", len(recs))
            clock.count("group_rows_n", C * sum(p[2] for p in parts))

        # the multi-chunk tracks run while the groups' downloads drain
        if multis:
            self._decode_streaming_pipelined(multis, results, clock)

        for i, ea in empties:
            results[i] = self.decode_i16(ea)

        for recs, download in handles:
            with clock.stage("wait"):
                out = download.wait()  # [Σ (F + 1), n, C]: hops, tail a track
                o = 0
                for i, ea in recs:
                    rows = ea.frame_set.num_frames + 1
                    flat = out[o : o + rows].reshape(-1)
                    o += rows
                    # copy: the trim is a view into the group's download
                    results[i] = gapless_trim(
                        flat, ea.gapless_info, ea.header.channels,
                        cfg.reference_compat,
                    ).copy()
        return results

    def _decode_streaming_pipelined(self, recs, results,
                                    clock: StageClock) -> None:
        """Multi-chunk tracks (decoder.py:753-770): the
        tracks of `recs` (``(index, EncodedAudio)``) one after another
        through `_pipelined_i16_chunks`, with one window of chunks in flight
        across track boundaries.  Each track equals its `decode_i16` bit for
        bit (the same chunks).  `clock` goes to `_pipelined_i16_chunks`."""
        parts: dict = {i: [] for i, _ea in recs}
        for i, flat in self._pipelined_i16_chunks(recs, clock):
            parts[i].append(flat)
        for i, _ea in recs:
            results[i] = (np.concatenate(parts[i]) if parts[i]
                          else np.empty(0, np.int16))

    # --- float32: the streaming decode (codec.rs:595-741) ---

    def decode_streaming(
        self,
        encoded: EncodedAudio,
        progress_sender: Optional[ProgressSender] = None,
    ) -> "queue.Queue[AudioChunk]":
        """Start a producer thread; returns a bounded queue of AudioChunk.

        Chunks are frames_per_chunk (=500) frames of interleaved float32
        samples; the final chunk carries the remainder plus the last
        overlap tail and has ``is_last=True``.  The output is UNtrimmed,
        exactly like the reference streaming path (the gapless trim only
        happens in `decode`, codec.rs:744-768).  A consumer that abandons
        the stream sets ``rx.cancelled``, and may join ``rx.producer`` (the
        thread), which ends at its next chunk without leaving a copy in
        flight; a failure arrives as a terminal ``AudioChunk(error=...)``.
        """
        rx: "queue.Queue[AudioChunk]" = queue.Queue(maxsize=5)
        # the crossbeam analog: rx dropped → send errors → thread exits
        rx.cancelled = threading.Event()  # type: ignore[attr-defined]
        rx.producer = threading.Thread(  # type: ignore[attr-defined]
            target=self._produce_safe,
            args=(encoded, rx, progress_sender),
            name=PRODUCER_NAME,
            daemon=True,
        )
        rx.producer.start()
        return rx

    def _produce_safe(self, encoded, rx, progress_sender):
        try:
            if self.device.type == "cuda":
                # this thread's current device is the decoder's
                with torch.cuda.device(self.device):
                    self._produce(encoded, rx, progress_sender)
            else:
                self._produce(encoded, rx, progress_sender)
        except _Cancelled:
            pass
        except Exception as e:  # surface the failure instead of hanging rx
            if progress_sender is not None:
                try:
                    progress_sender(Progress.error(str(e)))
                except Exception:
                    pass
            try:
                # must not be dropped: without a terminal chunk the consumer
                # blocks forever (reference: crossbeam send blocks too)
                self._put(
                    rx,
                    AudioChunk(samples=np.empty(0, np.float32), is_last=True,
                               error=str(e)),
                )
            except _Cancelled:
                pass

    @staticmethod
    def _put(rx, chunk) -> None:
        """Bounded put that gives up when the consumer cancelled."""
        while True:
            if rx.cancelled.is_set():
                raise _Cancelled()
            try:
                rx.put(chunk, timeout=0.25)
                return
            except queue.Full:
                continue

    def _produce(self, encoded, rx, progress_sender):
        cfg = self.config
        n, C = cfg.n, encoded.header.channels
        F = encoded.frame_set.num_frames
        start_time = time.monotonic()

        def send(p: Progress):
            if progress_sender is not None:
                progress_sender(p)

        send(Progress.status(f"Starting streaming decode of {F} frames"))

        flush_frames = cfg.frames_per_chunk
        chunk = chunk_size_for(max(F, 1), cfg.decode_chunk_frames)
        pending = []          # [frames, n, C] f32 host arrays
        pending_frames = 0
        emitted = 0           # frames emitted so far
        tail = np.zeros((n, C), np.float32)  # F == 0: the tail is silence

        def flush_full_chunks():
            # Flush in exact 500-frame chunks, mirroring the per-frame
            # accumulate-and-flush of codec.rs:706-717; progress uses the
            # 0-based index of the frame that filled the chunk
            # (codec.rs:710-714).
            nonlocal pending, pending_frames, emitted
            while pending_frames >= flush_frames:
                buf = np.concatenate(pending) if len(pending) > 1 else pending[0]
                out, rest = buf[:flush_frames], buf[flush_frames:]
                pending = [rest] if len(rest) else []
                pending_frames -= flush_frames
                send(Progress.decoding((emitted + flush_frames - 1) / F * 100.0))
                self._put(rx, AudioChunk(samples=out.reshape(-1),
                                         is_last=False))
                emitted += flush_frames

        # one chunk of lookahead: chunk i+1 is queued on the device before
        # the host waits for chunk i's download
        inflight = None  # (download, valid)
        try:
            for valid, hops in self._chunks(encoded, chunk):
                prev, inflight = inflight, (_Download(hops, out_i16=False),
                                            valid)
                if prev is not None:
                    pending.append(prev[0].wait())
                    pending_frames += prev[1]
                    flush_full_chunks()
            if inflight is not None:
                arr = inflight[0].wait()
                valid = inflight[1]
                pending.append(arr[:valid])
                pending_frames += valid
                tail = arr[valid]
                flush_full_chunks()
        finally:
            # a cancelled or failed stream leaves no copy into a pinned
            # buffer in flight behind it
            if inflight is not None:
                inflight[0].wait()

        # final chunk: remaining frames + last overlap tail (codec.rs:722-732)
        rest = [p.reshape(-1) for p in pending]
        last = np.concatenate(rest + [tail.reshape(-1)])
        self._put(rx, AudioChunk(samples=last, is_last=True))
        send(Progress.complete(
            f"Decoded {F} frames in {time.monotonic() - start_time:.2f}s"
        ))

    def decode(self, encoded: EncodedAudio,
               progress_sender: Optional[ProgressSender] = None) -> np.ndarray:
        """Decode to trimmed, interleaved float32 (codec.rs:744-768): the
        chunks of `decode_streaming`, joined and gapless-trimmed."""
        with maybe_trace("decode"):
            rx = self.decode_streaming(encoded, progress_sender)
            parts = []
            while True:
                chunk = rx.get()
                if chunk.error is not None:
                    raise RuntimeError(f"decode failed: {chunk.error}")
                parts.append(chunk.samples)
                if chunk.is_last:
                    break
        full = np.concatenate(parts)
        skip, limit = gapless_trim_bounds(
            len(full), encoded.gapless_info, encoded.header.channels,
            self.config.reference_compat,
        )
        return full[skip : skip + limit]
