"""The encode's kept pairs in the .glc byte layout, on the CPU.

- `ops.encode.compact_pairs`: its int32 words, viewed as `PAIR_DTYPE`,
  equal the pairs built field by field from q's nonzeros (row-major:
  frame, channel, ascending k), at q's extremes and k's ends, with an
  all-zero row.
- The encoder's containers: `fs.pairs` equals the pairs decoded field by
  field from each segment's `encode_segment` words, and `fs.raw_pcm` its
  raw rows, segment by segment, through `encode`, `encode_pcm16` and
  `encode_many`; `fs.pairs` is a contiguous 4-byte array; the download
  count is still 2 a segment and 1 more for a segment with raw-PCM frames.

The `cuda` test skips here; on the card's machine, which has no JAX, run
it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pairs.py
"""

import numpy as np
import pytest
import torch

from glc_tpu_torch import CodecConfig, Encoder
from glc_tpu_torch.codec.device import upload
from glc_tpu_torch.codec.encoder import upload_geometry
from glc_tpu_torch.container.schema import PAIR_DTYPE
from glc_tpu_torch.ops.encode import compact_pairs, encode_segment, planarize

from test_torch_api import (
    FRAME, N, RATE, encode_down_n, sweep_with_noise_i16,
)

EXTREMES = (-32768, -1, 1, 32767)
CFG = CodecConfig(encode_chunk_frames=128)


def crafted_q(frames: int, channels: int, n: int, seed: int) -> np.ndarray:
    """int16 q [frames, channels, n] (at least 5 rows): seeded sparse
    values, every extreme at k = 0 and at k = n-1 of the first four rows,
    and the last row all zero."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-32768, 32768, (frames, channels, n)).astype(np.int16)
    q[rng.random(q.shape) < 0.8] = 0
    rows = q.reshape(-1, n)
    for i, v in enumerate(EXTREMES):
        rows[i, 0], rows[i, n - 1] = v, EXTREMES[-1 - i]
    rows[-1] = 0
    return q


def pairs_by_field(q: np.ndarray) -> np.ndarray:
    """q's nonzeros as PAIR_DTYPE pairs, in row-major order, a field at a
    time."""
    rows = q.reshape(-1, q.shape[-1])
    rk, kk = np.nonzero(rows)
    pairs = np.empty(len(kk), PAIR_DTYPE)
    pairs["k"] = kk
    pairs["q"] = rows[rk, kk]
    return pairs


def pairs_of_words(words: np.ndarray) -> np.ndarray:
    """The words' (k, q) by arithmetic (low half k, high half q signed),
    a field at a time."""
    w = words.astype(np.int64)
    pairs = np.empty(len(w), PAIR_DTYPE)
    pairs["k"] = w & 0xFFFF
    pairs["q"] = w >> 16
    return pairs


def check_wire_layout(device) -> None:
    for frames, channels, n in ((2, 3, 8), (5, 2, 1024), (3, 6, 2048),
                                (4, 3, 8192)):
        q = crafted_q(frames, channels, n, seed=frames * n + channels)
        words = compact_pairs(torch.from_numpy(q).to(device)).cpu().numpy()
        assert words.dtype == np.int32
        want = pairs_by_field(q)
        np.testing.assert_array_equal(words.view(PAIR_DTYPE), want)
        np.testing.assert_array_equal(pairs_of_words(words), want)
        assert {int(v) for v in want["q"]} >= set(EXTREMES)
        assert {0, n - 1} <= {int(k) for k in want["k"]}


def test_compact_pairs_words_are_bincode_pairs():
    check_wire_layout(torch.device("cpu"))


@pytest.mark.cuda
def test_cuda_compact_pairs_words_are_bincode_pairs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    check_wire_layout(torch.device("cuda"))


def segment_parts(enc: Encoder, pcm: np.ndarray, channels: int):
    """The pairs (decoded from each segment's words a field at a time) and
    raw rows of every segment, run as the encoder runs them."""
    _T, F, _pad, plan, need = upload_geometry(len(pcm), channels, CFG)
    x = planarize(upload(pcm, enc.device), channels, N // 2, N, need)
    x = x.to(torch.float32) / 32768.0
    pairs, raws = [], []
    for start, k in plan:
        _stats, words, raw = encode_segment(
            x, start, min(k, F - start), enc.tables,
            quality=CFG.quality_factor, noise_floor_db=CFG.noise_floor_db,
            compression_threshold=CFG.compression_threshold,
            max_q=CFG.max_q)
        pairs.append(pairs_of_words(words.numpy()))
        raws.append(raw.numpy().reshape(-1, channels * FRAME))
    return pairs, raws


@pytest.mark.parametrize("entry", ["encode", "encode_pcm16", "encode_many"])
def test_container_pairs_are_the_segments_words(entry):
    enc = Encoder(RATE, config=CFG, device="cpu")
    pcm = sweep_with_noise_i16()
    f32 = pcm.astype(np.float32) / 32768.0  # exact: the pcm16 path's input
    stats: dict = {}
    if entry == "encode":
        eas = [enc.encode(f32, 2, stats=stats)]
    elif entry == "encode_pcm16":
        eas = [enc.encode_pcm16(pcm, 2, stats=stats)]
    else:
        eas = enc.encode_many([(pcm, 2), (f32, 2)], stats=stats)
    pairs, raws = segment_parts(enc, pcm, 2)
    assert len(pairs) > 2 and sum(len(r) > 0 for r in raws) > 0
    for ea in eas:
        fs = ea.frame_set
        assert fs.pairs.dtype == PAIR_DTYPE and fs.pairs.itemsize == 4
        assert fs.pairs.flags.c_contiguous
        np.testing.assert_array_equal(fs.pairs, np.concatenate(pairs))
        np.testing.assert_array_equal(fs.raw_pcm, np.concatenate(raws))
        assert fs.nnz.sum() == len(fs.pairs)
    assert stats["down_n"] == sum(encode_down_n(ea, CFG) for ea in eas)
