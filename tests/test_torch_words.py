"""The decode's pairs expanded on the device from the container's words:
`ops.kernels.scatter_pairs` and `Decoder._decode_parts`, on the CPU, with
`cuda` twins.

The oracle is the host path the words replaced (`pair_oracle`):
`chunk_pairs` (out-of-range k dropped, duplicates resolved last-wins on the
host) and `dense_q` (a scatter of unique positions into zeros).

- The dense q that `_decode_parts` hands `decode_stacked` equals the
  oracle's, bit for bit, on seeded FrameSets: several parts stacked as
  `decode_many` stacks them (whole tracks, and chunks that start inside a
  track), rows with no pairs, k = 0, n-1, n and 65535, duplicate positions
  (the last wins), a row of 70 000 pairs, raw frames among them, mono and
  5.1.
- `scatter_pairs` against a sequential model (a dict per row, written pair
  by pair in stream order), and its input checks.
- `decode_i16`, `decode` and `decode_many` give the bytes of the host path
  (`_decode_parts` as it was, on `chunk_pairs` and `dense_q`) on a short
  5.1 track, a small mono bank and the crafted FrameSets; the hook's
  ``pairs_n`` counts the containers' pairs.
- On the card: the kernel equals the plain version bit for bit at a film
  chunk (1408 x 6 rows), a CD chunk (1408 x 2) and a bank pass (168 and
  6533 rows), at hop 1024 (16-byte stores) and at hops 441 and 8192; the
  decode surfaces equal the host path's bytes there, and
  `scatter_pairs.launches` rises by one a pass.

Every comparison is exact: q is integers, and the words change nothing
downstream of it.  The `cuda` tests skip here; on the card's machine, which
has no JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_words.py
"""

import numpy as np
import pytest
import torch

from glc_tpu_torch import CodecConfig, Decoder, Encoder
from glc_tpu_torch.codec import decoder as decoder_mod
from glc_tpu_torch.codec.decoder import frame_offsets
from glc_tpu_torch.codec.device import upload_concat
from glc_tpu_torch.container.schema import (
    PAIR_DTYPE, AudioHeader, EncodedAudio, FrameSet, GaplessInfo,
)
from glc_tpu_torch.ops import kernels
from glc_tpu_torch.ops.decode import decode_stacked
from glc_tpu_torch.ops.kernels import scatter_pairs, scatter_pairs_reference

from pair_oracle import chunk_pairs, dense_q
from test_torch_api import UPLOADS_PER_CHUNK, sweep, tone

RATE = 44100
N, FRAME = 1024, 2048
EDGE_KS = (0, N - 1, N, 65535)
HUGE_ROW = 70000


# --- inputs, from seeds ---

def crafted_frame_set(seed: int, frames: int, channels: int,
                      huge: bool = False) -> FrameSet:
    """A FrameSet of `frames` frames: about a fifth of the rows without
    pairs, the others 1-1500 pairs (more than n, so duplicates) with
    seeded k over [0, n + 8) and full-range q, each of EDGE_KS in some row,
    an explicit duplicate whose last pair differs from its first, every
    fourth frame raw (no pairs), and with `huge` one row of HUGE_ROW pairs
    over 8 positions."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(1, 1500, (frames, channels))
    nnz[rng.random(nnz.shape) < 0.2] = 0
    raw = np.zeros(frames, bool)
    raw[3::4] = True
    nnz[raw] = 0
    nnz[0, 0] = 6
    if huge:
        nnz[1, channels - 1] = HUGE_ROW
    P = int(nnz.sum())
    pairs = np.empty(P, PAIR_DTYPE)
    pairs["k"] = rng.integers(0, N + 8, P)
    pairs["q"] = rng.integers(-32768, 32768, P)
    # row (0, 0): the edge ks, then k = 7 twice, the last one wins
    pairs["k"][:6] = (*EDGE_KS, 7, 7)
    pairs["q"][:6] = (11, -22, 33, -44, 1000, -32768)
    if huge:
        at = int(nnz.reshape(-1)[: channels + channels - 1].sum())
        pairs["k"][at : at + HUGE_ROW] = rng.integers(0, 8, HUGE_ROW)
    raw_pcm = rng.integers(-32768, 32768, (int(raw.sum()), FRAME * channels)
                           ).astype(np.int16)
    scales = rng.uniform(0.01, 2.0, (frames, channels)).astype(np.float32)
    return FrameSet(nnz, pairs, scales, raw, raw_pcm, FRAME)


def encoded_of(fs: FrameSet) -> EncodedAudio:
    C, F = fs.channels, fs.num_frames
    samples = F * N * C
    return EncodedAudio(AudioHeader(RATE, C, samples), fs,
                        GaplessInfo(N // 2 * C, 0, samples))


def oracle_q(parts, n: int) -> torch.Tensor:
    """The host path's dense q of `parts` stacked back to back."""
    qs = []
    for fs, start, valid, (pair_off, _raw_off) in parts:
        pos, vals = chunk_pairs(fs, start, valid, int(pair_off[start]), n)
        qs.append(dense_q(torch.from_numpy(pos), torch.from_numpy(vals),
                          valid, fs.channels, n))
    return torch.cat(qs)


def host_decode_parts(self, parts, carries, last, clock=decoder_mod.NO_STATS):
    """`Decoder._decode_parts` as it was on the host path: `chunk_pairs`
    per part, the positions and values uploaded, `dense_q` on the
    device."""
    cfg, n, dev = self.config, self.config.n, self.device

    def up(arrays):
        clock.count("up_n")
        return upload_concat(arrays, dev)

    C, frame_size = parts[0][0].channels, parts[0][0].frame_size
    pos_l, val_l, scale_l, idx_l, raw_l, counts = [], [], [], [], [], []
    off = 0
    for fs, start, valid, (pair_off, raw_off) in parts:
        pos, vals = chunk_pairs(fs, start, valid, int(pair_off[start]), n)
        pos_l.append(pos + off * C * n)
        val_l.append(vals)
        scale_l.append(fs.scales[start : start + valid])
        raw_idx = np.flatnonzero(fs.raw_mask[start : start + valid])
        r0 = int(raw_off[start])
        idx_l.append(raw_idx + off)
        raw_l.append(fs.raw_pcm[r0 : r0 + len(raw_idx)])
        counts.append(valid)
        off += valid
    q = dense_q(up(pos_l), up(val_l), off, C, n)
    rows = up(raw_l)
    if cfg.reference_compat:
        rows = rows.view(-1, frame_size, C).transpose(1, 2)
    else:
        rows = rows.view(-1, C, frame_size)
    return decode_stacked(q, up(scale_l), up(idx_l), rows, carries, counts,
                          last, self.tables, max_q=cfg.max_q,
                          window_raw=not cfg.reference_compat)


def model_q(words: np.ndarray, row_off: np.ndarray, n: int) -> np.ndarray:
    """Sequential model: each row's pairs written in stream order into a
    dict (the reference's loop, codec.rs:660-663), out-of-range k skipped."""
    rows = len(row_off) - 1
    out = np.zeros((rows, n), np.int16)
    for r in range(rows):
        last = {}
        for w in words[row_off[r] : row_off[r + 1]]:
            k, q = int(w) & 0xFFFF, int(w) >> 16
            if k < n:
                last[k] = q
        for k, q in last.items():
            out[r, k] = q
    return out


def random_words(seed: int, rows: int, per_row: int, n: int,
                 huge: bool = False):
    """(words int32, row_off int64) for `rows` rows of about `per_row`
    pairs (a fifth of the rows empty), k over [0, n + 8) with EDGE_KS-like
    ends at n, q full range; with `huge` one row of HUGE_ROW pairs over 8
    positions."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(per_row // 2, per_row * 3 // 2 + 2, rows)
    nnz[rng.random(rows) < 0.2] = 0
    if huge:
        nnz[rows // 2] = HUGE_ROW
    row_off = np.zeros(rows + 1, np.int64)
    np.cumsum(nnz, out=row_off[1:])
    P = int(row_off[-1])
    k = rng.integers(0, n + 8, P)
    k[rng.random(P) < 0.01] = 65535
    if huge:
        a = int(row_off[rows // 2])
        k[a : a + HUGE_ROW] = rng.integers(0, 8, HUGE_ROW)
    pairs = np.empty(P, PAIR_DTYPE)
    pairs["k"] = k
    pairs["q"] = rng.integers(-32768, 32768, P)
    return pairs.view(np.int32), row_off


# --- the words against the oracle ---

STACKS = {
    # name: (FrameSets as (seed, frames, channels, huge), parts as
    # (FrameSet index, start, valid))
    "mono_tracks": ([(1, 13, 1, False), (2, 40, 1, True), (3, 5, 1, False)],
                    [(0, 0, 13), (1, 0, 40), (2, 0, 5)]),
    "5.1_tracks": ([(4, 9, 6, True), (5, 17, 6, False)],
                   [(0, 0, 9), (1, 0, 17)]),
    "chunks_inside": ([(6, 50, 2, True)], [(0, 7, 21)]),
    "chunk_after_huge": ([(7, 30, 6, True)], [(0, 2, 28)]),
}


@pytest.mark.parametrize("name", sorted(STACKS))
def test_decode_parts_q_equals_the_host_oracle(name, monkeypatch):
    sets, picks = STACKS[name]
    fss = [crafted_frame_set(seed, F, C, huge) for seed, F, C, huge in sets]
    parts = [(fss[i], start, valid, frame_offsets(fss[i]))
             for i, start, valid in picks]
    seen = []

    def recording(q, *args, **kwargs):
        seen.append(q)
        return decode_stacked(q, *args, **kwargs)

    monkeypatch.setattr(decoder_mod, "decode_stacked", recording)
    C = fss[0].channels
    dec = Decoder(C, RATE, device="cpu")
    carries = torch.zeros((len(parts), C, N))
    stats: dict = {}
    clock = decoder_mod.StageClock(stats, decoder_mod.STATS_KEYS
                                   + decoder_mod.PAIR_KEYS, "decode")
    dec._decode_parts(parts, carries, True, clock)
    (q,) = seen
    want = oracle_q(parts, N)
    assert q.dtype == torch.int16 and q.shape == want.shape
    assert torch.equal(q, want)
    assert stats["up_n"] == UPLOADS_PER_CHUNK
    assert stats["pairs_n"] == sum(
        int(fs.nnz[s : s + v].sum()) for fs, s, v, _o in parts)


def test_the_crafted_rows_hold_every_case():
    """The crafted FrameSets hold what the oracle tests claim: empty rows,
    each edge k, a duplicate whose first and last q differ, raw frames, a
    row of HUGE_ROW pairs, mono and six channels."""
    fs = crafted_frame_set(2, 40, 1, True)
    assert (fs.nnz == 0).any() and fs.raw_mask.any()
    assert fs.nnz.max() == HUGE_ROW
    assert set(EDGE_KS) <= set(fs.pairs["k"][:6].tolist())
    assert fs.pairs["q"][4] != fs.pairs["q"][5]
    assert crafted_frame_set(4, 9, 6, True).channels == 6


@pytest.mark.parametrize("n", [1, 7, 441, 1024])
def test_scatter_pairs_equals_the_sequential_model(n):
    words, row_off = random_words(n, 40, 30 if n > 8 else 5, n)
    got = scatter_pairs(torch.from_numpy(words), torch.from_numpy(row_off),
                        40, n)
    np.testing.assert_array_equal(got.numpy(), model_q(words, row_off, n))


def test_scatter_pairs_a_huge_duplicate_row_and_no_pairs():
    words, row_off = random_words(3, 9, 20, N, huge=True)
    got = scatter_pairs(torch.from_numpy(words), torch.from_numpy(row_off),
                        9, N)
    np.testing.assert_array_equal(got.numpy(), model_q(words, row_off, N))
    empty = scatter_pairs(torch.empty(0, dtype=torch.int32),
                          torch.zeros(6, dtype=torch.int64), 5, N)
    assert empty.shape == (5, N) and not empty.any()
    assert scatter_pairs(torch.empty(0, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int64), 0, N).shape == (0, N)


def test_scatter_pairs_checks_its_inputs():
    words = torch.zeros(4, dtype=torch.int32)
    off = torch.tensor([0, 2, 4])
    with pytest.raises(TypeError):
        scatter_pairs(words.to(torch.int64), off, 2, N)
    with pytest.raises(TypeError):
        scatter_pairs(words.view(2, 2), off, 2, N)
    with pytest.raises(ValueError):
        scatter_pairs(words, off.to(torch.int32), 2, N)
    with pytest.raises(ValueError):
        scatter_pairs(words, off, 3, N)
    with pytest.raises(ValueError):
        scatter_pairs(words.to("meta"), off.to("meta"), 2, N)


def test_a_frame_set_short_of_pairs_or_with_a_negative_count_raises():
    """The words are read by row offsets: a FrameSet whose pairs fall
    short of its nnz, or whose nnz holds a negative count, raises on the
    host before anything reaches the device."""
    fs = crafted_frame_set(8, 6, 2)
    short = FrameSet(fs.nnz, fs.pairs[:-1], fs.scales, fs.raw_mask,
                     fs.raw_pcm, FRAME)
    dec = Decoder(2, RATE, device="cpu")
    with pytest.raises(ValueError, match="pairs"):
        dec.decode_i16(encoded_of(short))
    nnz = fs.nnz.copy()
    nnz[0, 0], nnz[0, 1] = nnz[0, 0] + nnz[0, 1] + 1, -1
    bad = FrameSet(nnz, fs.pairs, fs.scales, fs.raw_mask, fs.raw_pcm, FRAME)
    with pytest.raises(ValueError, match="negative"):
        dec.decode_i16(encoded_of(bad))


# --- the decode surfaces against the host path ---

def short_5p1(device) -> EncodedAudio:
    return Encoder(RATE, device=device).encode(sweep(6, 2.0), 6)


def mono_bank(device) -> list:
    enc = Encoder(RATE, device=device)
    return [enc.encode(tone(s, 220.0 * (i + 1), 1), 1)
            for i, s in enumerate((0.2, 0.5, 0.9, 1.6, 3.5))]


def surfaces(dec: Decoder, eas) -> list:
    """Every decode surface's output bytes on `eas`."""
    out = [dec.decode_many(eas)]
    for ea in eas:
        out += [dec.decode_i16(ea), dec.decode(ea),
                np.concatenate(list(dec.decode_i16_stream(ea,
                                                          chunk_frames=16)))]
    return [a.tobytes() for x in out for a in (x if isinstance(x, list)
                                                else [x])]


def check_surfaces(device, eas, channels, monkeypatch) -> None:
    cfg = CodecConfig(decode_chunk_frames=64)
    dec = Decoder(channels, RATE, config=cfg, device=device)
    words = surfaces(dec, eas)
    stats: dict = {}
    dec.decode_many(eas, stats=stats)
    assert stats["pairs_n"] == sum(len(ea.frame_set.pairs) for ea in eas)
    with monkeypatch.context() as m:
        m.setattr(Decoder, "_decode_parts", host_decode_parts)
        host = surfaces(dec, eas)
    assert words == host


def test_surfaces_equal_the_host_path_5p1(monkeypatch):
    check_surfaces("cpu", [short_5p1("cpu")], 6, monkeypatch)


def test_surfaces_equal_the_host_path_mono_bank(monkeypatch):
    check_surfaces("cpu", mono_bank("cpu"), 1, monkeypatch)


@pytest.mark.parametrize("channels", [1, 6])
def test_surfaces_equal_the_host_path_crafted(channels, monkeypatch):
    eas = [encoded_of(crafted_frame_set(10 + i, F, channels, huge))
           for i, (F, huge) in enumerate(((9, False), (40, True), (90, False)))]
    check_surfaces("cpu", eas, channels, monkeypatch)


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# (rows, pairs a row): a film chunk (1408 frames x 6), a CD chunk (x 2),
# the bank's smallest and largest passes (mono)
CARD_SHAPES = ((1408 * 6, 400), (1408 * 2, 80), (168, 60), (6533, 60))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,per_row", CARD_SHAPES)
@pytest.mark.parametrize("n", [1024, 441, 8192])
def test_cuda_scatter_pairs_is_the_plain_version(cuda_device, rows, per_row,
                                                 n):
    words, row_off = random_words(rows + n, rows, per_row, n,
                                  huge=rows == 168)
    w = torch.from_numpy(words).to(cuda_device)
    off = torch.from_numpy(row_off).to(cuda_device)
    before = kernels.scatter_pairs.launches
    got = scatter_pairs(w, off, rows, n)
    torch.cuda.synchronize()
    assert kernels.scatter_pairs.launches == before + 1
    want = scatter_pairs_reference(w, off, rows, n)
    assert got.dtype == torch.int16 and torch.equal(got, want)
    if rows == 168:
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      model_q(words, row_off, n))


@pytest.mark.cuda
def test_cuda_scatter_pairs_raises_above_max_n(cuda_device):
    words = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    off = torch.tensor([0, 2], device=cuda_device)
    with pytest.raises(ValueError):
        scatter_pairs(words, off, 1, kernels.MAX_N + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["5.1", "mono_bank", "crafted"])
def test_cuda_surfaces_equal_the_host_path(cuda_device, case, monkeypatch):
    if case == "5.1":
        eas, C = [short_5p1(cuda_device)], 6
    elif case == "mono_bank":
        eas, C = mono_bank(cuda_device), 1
    else:
        eas = [encoded_of(crafted_frame_set(20 + i, F, 6, huge))
               for i, (F, huge) in enumerate(((9, False), (40, True)))]
        C = 6
    check_surfaces(cuda_device, eas, C, monkeypatch)
    dec = Decoder(C, RATE, config=CodecConfig(decode_chunk_frames=64),
                  device=cuda_device)
    stats: dict = {}
    before = kernels.scatter_pairs.launches
    dec.decode_many(eas, stats=stats)
    assert (kernels.scatter_pairs.launches - before
            == stats["up_n"] // UPLOADS_PER_CHUNK == stats["down_n"])
