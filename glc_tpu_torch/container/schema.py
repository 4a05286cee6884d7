""".glc container schema.

Copied from ``glc_tpu/container/schema.py`` (numpy only), so the port
never imports the JAX package.

Mirrors the serde structs of the reference (reference src/codec.rs:31-85).
Two representations:

* **Object view** — `EncodedAudio` / `EncodedFrame`, the user-facing API that
  matches the reference's struct-per-frame shape.
* **Columnar view** — `FrameSet`, flat numpy arrays over all frames at once.
  This is the TPU-native representation: the device pipeline produces/consumes
  dense frame-major tensors, and the bincode serializer is vectorized over the
  columnar form.  `EncodedAudio` holds a `FrameSet` internally and materializes
  per-frame objects lazily.

The wire format is bincode v1 "legacy" encoding: little-endian, fixed-width
ints, u64 Vec lengths, Option as a 1-byte tag (SURVEY.md Q9).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence

import numpy as np

# Structured dtype for one sparse (index, value) pair — 4 bytes, matching the
# bincode layout of Rust `(u16, i16)` (reference src/codec.rs:62).
PAIR_DTYPE = np.dtype([("k", "<u2"), ("q", "<i2")])


@dataclass
class AudioHeader:
    """reference src/codec.rs:39-45"""

    sample_rate: int
    channels: int
    total_samples: int  # interleaved sample count


@dataclass
class GaplessInfo:
    """reference src/codec.rs:47-53.

    Note `padding` is write-only in the reference (set at codec.rs:546, never
    read — SURVEY.md Q2); we keep it for wire compatibility.
    """

    encoder_delay: int
    padding: int
    original_length: int  # interleaved sample count


@dataclass
class EncodedFrame:
    """Per-timeframe data (reference src/codec.rs:55-69).

    * ``sparse_coeffs_per_channel[c]`` — structured array of PAIR_DTYPE
      (index, quantized value) pairs; empty list if ``raw_pcm`` is used.
    * ``scale_factors`` — float32 array, one per channel; empty if raw.
    * ``raw_pcm`` — int16 array of length frame_size*channels, or None.
      Stored channel-major by the reference encoder despite the struct
      comment claiming interleaved (codec.rs:471-503; SURVEY.md Q13).
    """

    sparse_coeffs_per_channel: List[np.ndarray] = field(default_factory=list)
    scale_factors: np.ndarray = field(default_factory=lambda: np.empty(0, np.float32))
    raw_pcm: Optional[np.ndarray] = None

    @property
    def is_raw(self) -> bool:
        return self.raw_pcm is not None


class FrameSet:
    """Columnar storage for all frames of one encoded file.

    Layout (F frames, C channels):
      * ``nnz``      — int64 [F, C], sparse pair count per (frame, channel);
                       rows of raw frames are 0.
      * ``pairs``    — PAIR_DTYPE [K], all sparse pairs concatenated
                       frame-major then channel-major (the bincode stream
                       order, reference src/codec.rs:462-541).
      * ``scales``   — float32 [F, C] (undefined for raw frames).
      * ``raw_mask`` — bool [F], True where the frame stores raw PCM.
      * ``raw_pcm``  — int16 [R, frame_size*C] for the R raw frames, in frame
                       order, channel-major layout (Q13).
    """

    def __init__(
        self,
        nnz: np.ndarray,
        pairs: np.ndarray,
        scales: np.ndarray,
        raw_mask: np.ndarray,
        raw_pcm: np.ndarray,
        frame_size: int = 2048,
    ):
        self.nnz = np.ascontiguousarray(nnz, dtype=np.int64)
        self.pairs = np.ascontiguousarray(pairs).view(PAIR_DTYPE).reshape(-1)
        self.scales = np.ascontiguousarray(scales, dtype=np.float32)
        self.raw_mask = np.ascontiguousarray(raw_mask, dtype=bool)
        self.raw_pcm = np.ascontiguousarray(raw_pcm, dtype=np.int16)
        self.frame_size = frame_size
        if self.nnz.ndim != 2:
            raise ValueError("nnz must be [F, C]")
        F, C = self.nnz.shape
        if self.raw_pcm.size and self.raw_pcm.shape[1] != frame_size * C:
            raise ValueError("raw_pcm rows must be frame_size*channels")

    @property
    def num_frames(self) -> int:
        return self.nnz.shape[0]

    @property
    def channels(self) -> int:
        return self.nnz.shape[1]

    @staticmethod
    def empty(channels: int, frame_size: int = 2048) -> "FrameSet":
        return FrameSet(
            nnz=np.zeros((0, channels), np.int64),
            pairs=np.empty(0, PAIR_DTYPE),
            scales=np.zeros((0, channels), np.float32),
            raw_mask=np.zeros(0, bool),
            raw_pcm=np.empty((0, frame_size * channels), np.int16),
            frame_size=frame_size,
        )

    # --- object-view bridge ---

    def frame(self, fi: int) -> EncodedFrame:
        if self.raw_mask[fi]:
            ri = int(np.count_nonzero(self.raw_mask[:fi]))
            return EncodedFrame(raw_pcm=self.raw_pcm[ri].copy())
        # offset of this frame's pairs in the flat buffer
        start = int(self.nnz[:fi].sum())
        per_ch = []
        for c in range(self.channels):
            n = int(self.nnz[fi, c])
            per_ch.append(self.pairs[start : start + n].copy())
            start += n
        return EncodedFrame(
            sparse_coeffs_per_channel=per_ch,
            scale_factors=self.scales[fi].copy(),
        )

    def iter_frames(self) -> Iterator[EncodedFrame]:
        pair_off = 0
        raw_off = 0
        for fi in range(self.num_frames):
            if self.raw_mask[fi]:
                yield EncodedFrame(raw_pcm=self.raw_pcm[raw_off].copy())
                raw_off += 1
            else:
                per_ch = []
                for c in range(self.channels):
                    n = int(self.nnz[fi, c])
                    per_ch.append(self.pairs[pair_off : pair_off + n].copy())
                    pair_off += n
                yield EncodedFrame(
                    sparse_coeffs_per_channel=per_ch,
                    scale_factors=self.scales[fi].copy(),
                )

    @staticmethod
    def from_frames(
        frames: Sequence[EncodedFrame], channels: int, frame_size: int = 2048
    ) -> "FrameSet":
        F = len(frames)
        nnz = np.zeros((F, channels), np.int64)
        scales = np.zeros((F, channels), np.float32)
        raw_mask = np.zeros(F, bool)
        pair_chunks: List[np.ndarray] = []
        raw_rows: List[np.ndarray] = []
        for fi, fr in enumerate(frames):
            if fr.is_raw:
                raw_mask[fi] = True
                raw_rows.append(np.asarray(fr.raw_pcm, np.int16).reshape(-1))
            else:
                for c, sp in enumerate(fr.sparse_coeffs_per_channel):
                    sp = np.asarray(sp).view(PAIR_DTYPE).reshape(-1)
                    nnz[fi, c] = len(sp)
                    pair_chunks.append(sp)
                scales[fi, : len(fr.scale_factors)] = fr.scale_factors
        pairs = (
            np.concatenate(pair_chunks) if pair_chunks else np.empty(0, PAIR_DTYPE)
        )
        raw_pcm = (
            np.stack(raw_rows)
            if raw_rows
            else np.empty((0, frame_size * channels), np.int16)
        )
        return FrameSet(nnz, pairs, scales, raw_mask, raw_pcm, frame_size)


class _FrameListView(Sequence):
    """List-like lazy view over a FrameSet, so ``encoded.frames[i]`` and
    ``len(encoded.frames)`` work like the reference's ``Vec<EncodedFrame>``."""

    def __init__(self, fs: FrameSet):
        self._fs = fs

    def __len__(self) -> int:
        return self._fs.num_frames

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._fs.frame(j) for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError("frame index out of range")
        return self._fs.frame(i)

    def __iter__(self):
        return self._fs.iter_frames()


@dataclass
class EncodedAudio:
    """Top-level container (reference src/codec.rs:31-37)."""

    header: AudioHeader
    frame_set: FrameSet
    gapless_info: GaplessInfo

    @property
    def frames(self) -> _FrameListView:
        return _FrameListView(self.frame_set)

    @classmethod
    def from_frames(
        cls,
        header: AudioHeader,
        frames: Sequence[EncodedFrame],
        gapless_info: GaplessInfo,
        frame_size: int = 2048,
    ) -> "EncodedAudio":
        return cls(
            header,
            FrameSet.from_frames(frames, header.channels, frame_size),
            gapless_info,
        )


class ProgressKind(enum.Enum):
    """reference src/codec.rs:71-79"""

    ENCODING = "Encoding"
    DECODING = "Decoding"
    EXPORTING = "Exporting"
    COMPLETE = "Complete"
    ERROR = "Error"
    STATUS = "Status"


@dataclass
class Progress:
    kind: ProgressKind
    # percentage for Encoding/Decoding/Exporting; message for the others
    value: object

    # Constructors mirroring the Rust enum variants
    @staticmethod
    def encoding(pct: float) -> "Progress":
        return Progress(ProgressKind.ENCODING, pct)

    @staticmethod
    def decoding(pct: float) -> "Progress":
        return Progress(ProgressKind.DECODING, pct)

    @staticmethod
    def exporting(pct: float) -> "Progress":
        return Progress(ProgressKind.EXPORTING, pct)

    @staticmethod
    def complete(msg: str) -> "Progress":
        return Progress(ProgressKind.COMPLETE, msg)

    @staticmethod
    def error(msg: str) -> "Progress":
        return Progress(ProgressKind.ERROR, msg)

    @staticmethod
    def status(msg: str) -> "Progress":
        return Progress(ProgressKind.STATUS, msg)


@dataclass
class AudioChunk:
    """reference src/codec.rs:81-85.

    ``error`` is a rebuild extension: when the producer thread fails, the
    final chunk carries the error message (the crossbeam-channel analog is
    the sender being dropped on panic, which the consumer sees as a closed
    channel)."""

    samples: np.ndarray  # float32, interleaved if multichannel
    is_last: bool
    error: Optional[str] = None
