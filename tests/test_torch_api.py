"""The port's public API against the JAX package's, on the CPU: the
`stats=` hooks of `Encoder` and `Decoder`, `glc_tpu_torch.ops` (its names
and the chunk programs `encode_chunk_device` / `decode_chunk_device`) and
`codec.tables.get_device_tables`.

Bounds, each with its reason:
- Hooked against unhooked calls: equal, bytes and bits.  The hook only
  reads the clock and adds.
- The hook's keys: the JAX package's (tests/test_chunking.py:588-608,
  tests/test_decode_many.py:244-330).  Its counts: the port's own, exact,
  from the geometry.  The encode uploads the signal once and downloads 2
  arrays a segment, 3 for a segment with raw-PCM frames.  The decode
  uploads 5 arrays a chunk, where the JAX package uploads one packed
  array, and downloads 1 a chunk.
- `encode_chunk_device` against the JAX package's: q within the pair
  contract (glc_tpu_torch/parity.py), scales within rtol 1e-6, raw_pcm and
  use_raw equal.
- `decode_chunk_device` against the JAX package's: hops and carry within
  atol 1e-5, tests/test_sharding.py's bound.  Against the port's own
  `decode_stacked` on the same chunk: equal (the same product on the same
  rows).
- `get_device_tables`: every field equal to the JAX package's, in its
  order.

The JAX package runs on the CPU here (tests/conftest.py) and is imported
inside the tests.  The `cuda` tests skip here; on the card's machine,
which has no JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_api.py
"""

import inspect
import sys
import time
import types

import numpy as np
import pytest
import torch

import glc_tpu_torch
from glc_tpu_torch import (
    CodecConfig, Decoder, Encoder, serialize_encoded,
)
from glc_tpu_torch import ops as tops
from glc_tpu_torch.codec.encoder import upload_geometry
from glc_tpu_torch.codec.tables import (
    DeviceTables, chunk_size_for, get_codec_tables, get_device_tables,
)
from glc_tpu_torch.container.schema import (
    AudioHeader, EncodedAudio, FrameSet, GaplessInfo,
)
from glc_tpu_torch.ops.decode import decode_stacked
from glc_tpu_torch.ops.encode import encode_math, frames_from_signal, planarize
from glc_tpu_torch.parity import MAX_FLIP_RATE, dense_pair_flips

sys.path.insert(0, "tests")
from utils import generate_frequency_sweep, generate_white_noise  # noqa: E402

RATE = 44100
N, FRAME = 1024, 2048
ENCODE_KEYS = {"disp_ms", "wait_ms", "up_n", "down_n"}
DECODE_KEYS = {"pack_ms", "disp_ms", "wait_ms", "up_n", "down_n"}
# The decode's uploads a chunk: pair positions, pair values, raw rows,
# scales, raw frames' indices (Decoder._decode_parts)
UPLOADS_PER_CHUNK = 5


# --- inputs, from seeds ---

def sweep(channels: int = 2, seconds: float = 6.0) -> np.ndarray:
    """tests/test_chunking.py:595's signal."""
    return generate_frequency_sweep(150.0, 4000.0, RATE, channels, seconds)


def sweep_with_noise_i16() -> np.ndarray:
    """The sweep with 1 s of white noise from 2 s (raw-PCM frames), int16."""
    x = sweep().copy()
    x[2 * RATE * 2 : 3 * RATE * 2] = generate_white_noise(RATE, 2, 1.0, 7)
    return (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)


def tone(seconds: float, freq: float, channels: int) -> np.ndarray:
    t = np.arange(int(seconds * RATE), dtype=np.float32) / RATE
    return np.repeat((0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32),
                     channels)


def encode_blocks(kind: str) -> np.ndarray:
    """[K, C, 2048] f32 blocks.  "sharding": tests/test_sharding.py:44-47's
    (seed 0, B·K = 16, C = 2), flattened.  "tones": 12 frames of seeded
    harmonic tones (kept pairs) and 4 of white noise (raw-PCM frames)."""
    if kind == "sharding":
        rng = np.random.default_rng(0)
        return (rng.standard_normal((2, 8, 2, FRAME), np.float32)
                * 0.1).reshape(-1, 2, FRAME)
    rng = np.random.default_rng(5)
    t = np.arange(FRAME) / RATE
    blocks = np.zeros((16, 2, FRAME))
    for k in range(12):
        for c in range(2):
            f0 = rng.uniform(100.0, 2000.0)
            for h in range(1, 5):
                blocks[k, c] += (0.3 / h) * np.sin(
                    2 * np.pi * h * f0 * t + rng.uniform(0, 2 * np.pi))
    blocks[12:] = rng.uniform(-0.6, 0.6, (4, 2, FRAME))
    return blocks.astype(np.float32)


def decode_inputs():
    """tests/test_sharding.py:68-77: seed 1, B = 2 streams of K = 8 frames,
    a raw frame at k = 3, a random carry."""
    rng = np.random.default_rng(1)
    B, K, C = 2, 8, 2
    q = rng.integers(-2000, 2000, (B, K, C, N)).astype(np.int16)
    scales = rng.random((B, K, C)).astype(np.float32) + 0.1
    raw = np.zeros((B, K, C, FRAME), np.int16)
    is_raw = np.zeros((B, K), bool)
    is_raw[:, 3] = True
    raw[:, 3] = rng.integers(-3000, 3000, (B, C, FRAME)).astype(np.int16)
    carry = rng.standard_normal((B, C, N)).astype(np.float32)
    return q, scales, raw, is_raw, carry


def mixed_playlist(enc: Encoder) -> list:
    """tests/test_decode_many.py:297-318: mono and stereo multi-chunk
    tracks (at 32-frame chunks), a single-chunk track and an empty one."""
    rng = np.random.default_rng(3)
    t = np.arange(2 * RATE, dtype=np.float32) / RATE
    mono = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    stereo = np.repeat(
        (0.3 * np.sin(2 * np.pi * 440 * t)
         + 0.02 * rng.standard_normal(len(t))).astype(np.float32), 2)
    short = (0.4 * np.sin(2 * np.pi * 330 * t[:4096])).astype(np.float32)
    return [
        enc.encode(mono, 1),
        enc.encode(stereo, 2),
        enc.encode(short, 1),
        EncodedAudio(AudioHeader(RATE, 1, 0), FrameSet.empty(1),
                     GaplessInfo(512, 0, 0)),
        enc.encode(stereo * 0.5, 2),
    ]


def chunks_of(ea, max_chunk: int) -> int:
    F = ea.frame_set.num_frames
    return -(-F // chunk_size_for(max(F, 1), max_chunk)) if F else 0


def encode_down_n(ea, cfg) -> int:
    """2 downloads a segment, 3 for a segment with raw-PCM frames."""
    fs = ea.frame_set
    plan = upload_geometry(ea.header.total_samples, ea.header.channels,
                           cfg)[3]
    F = fs.num_frames
    return sum(2 + bool(fs.raw_mask[s : s + min(k, F - s)].any())
               for s, k in plan)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# --- (a) the stats hooks ---

@pytest.mark.parametrize("method,signal", [("encode", "sweep"),
                                           ("encode_pcm16", "noise")])
def test_encode_stats_hook_accumulates_and_is_inert(method, signal):
    """tests/test_chunking.py:588-608 on the port: bytes equal with and
    without the hook, the JAX package's keys, and the port's exact counts:
    one upload, 2 downloads a segment and 1 more for each segment with
    raw-PCM frames.  A second call into the same dict adds to it."""
    samples = sweep() if signal == "sweep" else sweep_with_noise_i16()
    cfg = CodecConfig(encode_chunk_frames=128)
    enc = Encoder(RATE, config=cfg, device="cpu")
    call = getattr(enc, method)
    plain = serialize_encoded(call(samples, 2))
    stats: dict = {}
    ea = call(samples, 2, stats=stats)
    assert serialize_encoded(ea) == plain
    assert set(stats) == ENCODE_KEYS
    plan = upload_geometry(len(samples), 2, cfg)[3]
    assert len(plan) > 1, "geometry must span multiple segments"
    raw_segments = encode_down_n(ea, cfg) - 2 * len(plan)
    assert (raw_segments > 0) == (signal == "noise")
    assert stats["up_n"] == 1
    assert stats["down_n"] == 2 * len(plan) + raw_segments
    assert stats["disp_ms"] > 0 and stats["wait_ms"] >= 0
    first = dict(stats)
    call(samples, 2, stats=stats)
    assert stats["up_n"] == 2 and stats["down_n"] == 2 * first["down_n"]
    assert stats["disp_ms"] > first["disp_ms"]


@pytest.mark.parametrize("max_chunk", [None, 32])
def test_decode_i16_stats_hook_accumulates_and_is_inert(max_chunk):
    """tests/test_decode_many.py:244-269 on the port (and at 32-frame
    chunks, several chunks): bits equal with and without the hook, the JAX
    package's keys, 5 uploads and 1 download a chunk."""
    cfg = CodecConfig() if max_chunk is None else CodecConfig(
        decode_chunk_frames=max_chunk)
    ea = Encoder(RATE, device="cpu").encode(tone(1.0, 330.0, 2), 2)
    dec = Decoder(2, RATE, config=cfg, device="cpu")
    plain = dec.decode_i16(ea)
    stats: dict = {}
    np.testing.assert_array_equal(dec.decode_i16(ea, stats=stats), plain)
    assert set(stats) == DECODE_KEYS
    assert stats["pack_ms"] > 0 and stats["disp_ms"] > 0
    assert stats["wait_ms"] >= 0
    chunks = chunks_of(ea, cfg.decode_chunk_frames)
    assert chunks == (1 if max_chunk is None else 2)
    assert stats["up_n"] == UPLOADS_PER_CHUNK * chunks
    assert stats["down_n"] == chunks


def test_decode_many_stats_hook_counts_the_multi_chunk_tracks():
    """The stats part of tests/test_decode_many.py:272-330 on the port: one
    decode_many over mono and stereo multi-chunk tracks, a single-chunk and
    an empty track, equal with and without the hook; the hook counts the
    multi-chunk tracks' transfers only, as the JAX package's does.  The
    multi-chunk tracks equal their decode_i16 (the same chunks); the
    batched single-chunk track is within 1 LSB of it on the CPU
    (tests/test_torch_album.py says why)."""
    cfg = CodecConfig(decode_chunk_frames=32)
    eas = mixed_playlist(Encoder(RATE, device="cpu"))
    dec = Decoder(2, RATE, config=cfg, device="cpu")
    plain = dec.decode_many(eas)
    stats: dict = {}
    got = dec.decode_many(eas, stats=stats)
    for a, b in zip(got, plain, strict=True):
        np.testing.assert_array_equal(a, b)
    assert set(stats) == DECODE_KEYS
    multi = [ea for ea in eas if ea.frame_set.num_frames > 32]
    multi_chunks = sum(chunks_of(ea, 32) for ea in multi)
    assert len(multi) == 3 and multi_chunks > len(multi)
    assert stats["up_n"] == UPLOADS_PER_CHUNK * multi_chunks
    assert stats["down_n"] == multi_chunks
    for ea, out in zip(eas, got):
        want = dec.decode_i16(ea)
        if ea.frame_set.num_frames > 32:
            np.testing.assert_array_equal(out, want)
        else:
            assert len(out) == len(want)
            assert np.abs(out.astype(np.int32) - want).max(initial=0) <= 1


def test_decode_i16_stream_leaves_consumer_time_out(monkeypatch):
    """A consumer that sleeps between chunks: its time lands in no key.
    11 chunks of 8 frames, more than the 8 in flight, so chunks are
    dispatched between yields too.  The stream is the unhooked one.

    The hook's clock (`codec/device.py`'s `time.perf_counter`) is the real
    clock plus an offset that the consumer's "sleep" moves on by `step_s`
    a chunk, in no real time: one chunk of the consumer's time in any key
    would put it past `step_s`, which no real host work comes near, however
    loaded the host."""
    from glc_tpu_torch.codec import device as device_mod

    step_s, offset = 1000.0, [0.0]
    monkeypatch.setattr(device_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: time.perf_counter() + offset[0]))
    ea = Encoder(RATE, device="cpu").encode(tone(2.0, 440.0, 2), 2)
    dec = Decoder(2, RATE, device="cpu")
    plain = list(dec.decode_i16_stream(ea, chunk_frames=8))
    stats: dict = {}
    parts = []
    for part in dec.decode_i16_stream(ea, chunk_frames=8, stats=stats):
        parts.append(part)
        offset[0] += step_s
    step_ms = step_s * 1e3
    assert len(parts) == len(plain) == 11
    for a, b in zip(parts, plain):
        np.testing.assert_array_equal(a, b)
    assert stats["up_n"] == UPLOADS_PER_CHUNK * 11 and stats["down_n"] == 11
    assert stats["wait_ms"] < step_ms
    assert stats["pack_ms"] + stats["disp_ms"] + stats["wait_ms"] < step_ms


# --- (b) encode_chunk_device ---

@pytest.fixture(scope="module")
def jax_tables():
    from glc_tpu.codec.tables import get_device_tables as jget

    return jget(N, FRAME, RATE)


@pytest.mark.parametrize("kind", ["sharding", "tones"])
def test_encode_chunk_device_matches_jax(jax_tables, kind):
    """Port against the JAX package's chunk program on the same blocks:
    q within the pair contract, scales within rtol 1e-6, raw_pcm and
    use_raw equal, nnz the count of each side's nonzero q.  numpy and
    tensor blocks give the same result."""
    from glc_tpu.ops import encode_chunk_device as jencode

    blocks = encode_blocks(kind)
    want = [np.asarray(t) for t in jencode(blocks, *jax_tables)]
    tabs = get_device_tables(N, FRAME, RATE, "cpu")
    got = [t.numpy() for t in tops.encode_chunk_device(blocks, *tabs)]
    again = tops.encode_chunk_device(torch.from_numpy(blocks), *tabs)
    for a, b in zip(got, again, strict=True):
        assert np.array_equal(a, b.numpy())
    q, nnz, scale, raw, use_raw = got
    jq, jnnz, jscale, jraw, juse_raw = want
    assert q.shape == jq.shape == (16, 2, N) and q.dtype == np.int16
    np.testing.assert_array_equal(use_raw, juse_raw)
    np.testing.assert_allclose(scale, jscale, rtol=1e-6)
    np.testing.assert_array_equal(raw, jraw)
    flips = dense_pair_flips(q, jq)
    assert flips["max_dq"] <= 1 and flips["rate"] <= MAX_FLIP_RATE, flips
    assert np.array_equal(nnz, (q != 0).sum(-1))
    assert np.array_equal(jnnz, (jq != 0).sum(-1))
    if kind == "tones":  # both branches of the raw-PCM decision, and pairs
        assert use_raw[12:].all() and not use_raw[:12].any()
        assert flips["kept"] > 1000


# --- (c) decode_chunk_device ---

@pytest.mark.parametrize("num_valid,window_raw,as_tensor", [
    (8, False, False), (5, False, True), (1, False, False),
    (8, True, True), (3, True, False)])
def test_decode_chunk_device_matches_jax(jax_tables, num_valid, window_raw,
                                         as_tensor):
    """tests/test_sharding.py:67-88's inputs through both packages' chunk
    programs, each stream with its carry: hops and new carry within atol
    1e-5, at num_valid = K and below, with and without window_raw, with
    num_valid an int or a 0-dim tensor."""
    from glc_tpu.ops import decode_chunk_device as jdecode

    tabs = get_device_tables(N, FRAME, RATE, "cpu")
    q, scales, raw, is_raw, carry = decode_inputs()
    for b in range(q.shape[0]):
        jhops, jcarry = jdecode(
            q[b], scales[b], raw[b], is_raw[b], carry[b], np.int32(num_valid),
            jax_tables.cos_table, jax_tables.window, jax_tables.norm,
            window_raw=window_raw)
        nv = torch.tensor(num_valid) if as_tensor else num_valid
        hops, new_carry = tops.decode_chunk_device(
            q[b], scales[b], raw[b], is_raw[b], carry[b], nv, *tabs[:3],
            window_raw=window_raw)
        assert hops.shape == (8, 2, N) and new_carry.shape == (2, N)
        np.testing.assert_allclose(hops.numpy(), np.asarray(jhops), atol=1e-5)
        np.testing.assert_allclose(new_carry.numpy(), np.asarray(jcarry),
                                   atol=1e-5)


def _decode_chunk_against_stacked(device):
    """decode_chunk_device and decode_stacked on the same chunk of
    tests/test_sharding.py's inputs: the same hops and carry bits."""
    tables = get_codec_tables(N, FRAME, RATE, device)
    tabs = get_device_tables(N, FRAME, RATE, device)
    q, scales, raw, is_raw, carry = decode_inputs()
    for b in range(q.shape[0]):
        on = [torch.from_numpy(x[b]).to(device)
              for x in (q, scales, raw, is_raw, carry)]
        hops, new_carry = tops.decode_chunk_device(*on, 8, *tabs[:3])
        idx = torch.nonzero(on[3]).squeeze(1)
        rows, ends = decode_stacked(on[0], on[1], idx, on[2][idx],
                                    on[4][None], [8], True, tables)
        assert torch.equal(hops, rows[:8]) and torch.equal(rows[8], ends[0])
        assert torch.equal(new_carry, ends[0])


def test_decode_chunk_device_is_decode_stacked():
    _decode_chunk_against_stacked(torch.device("cpu"))


# --- (d), (e), (f) the names ---

def test_get_device_tables_matches_jax(jax_tables, monkeypatch):
    """Field by field, in the JAX package's order; band_of is int64 here
    (torch's index type) and int32 there.  Made once, from the buffers of
    a CodecTables; device=None resolves as every entry point does."""
    tabs = get_device_tables(N, FRAME, RATE, "cpu")
    assert type(tabs).__name__ == type(jax_tables).__name__ == "DeviceTables"
    assert DeviceTables._fields == type(jax_tables)._fields
    for name, a, b in zip(DeviceTables._fields, tabs, jax_tables,
                          strict=True):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        assert a.dtype == (torch.int64 if name == "band_of"
                           else torch.float32), name
        assert np.array_equal(a.numpy(), b), name
    assert get_device_tables(N, FRAME, RATE, "cpu") is tabs
    monkeypatch.setenv("GLC_TORCH_DEVICE", "cpu")
    assert get_device_tables(N, FRAME, RATE) is tabs


def test_ops_names_match_jax():
    import glc_tpu
    import glc_tpu.ops as jops

    assert tops.__all__ == jops.__all__
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name
    assert set(glc_tpu.__all__) <= set(glc_tpu_torch.__all__)


@pytest.mark.parametrize("name", ["Encoder", "Decoder"])
def test_public_methods_match_jax(name):
    """Every public method of the JAX package's Encoder and Decoder has a
    counterpart here with the same parameters, in order; __init__ adds
    `device`."""
    import glc_tpu

    jcls, tcls = getattr(glc_tpu, name), getattr(glc_tpu_torch, name)
    methods = [m for m, f in vars(jcls).items()
               if callable(f) and (m == "__init__" or not m.startswith("_"))]
    assert len(methods) >= 4
    for m in methods:
        want = list(inspect.signature(getattr(jcls, m)).parameters)
        if m == "__init__":
            want.append("device")
        got = list(inspect.signature(getattr(tcls, m)).parameters)
        assert got == want, (name, m)


# --- (h) on the card ---

@pytest.mark.cuda
def test_cuda_stats_hooks_are_inert(cuda_device):
    """Hooked against unhooked on the card: the encode's bytes, decode_i16's
    and decode_many's bits, with the counts pinned above."""
    cfg = CodecConfig(encode_chunk_frames=128, decode_chunk_frames=32)
    enc = Encoder(RATE, config=cfg, device=cuda_device)
    dec = Decoder(2, RATE, config=cfg, device=cuda_device)
    pcm = sweep_with_noise_i16()
    plain = serialize_encoded(enc.encode_pcm16(pcm, 2))
    st: dict = {}
    ea = enc.encode_pcm16(pcm, 2, stats=st)
    assert serialize_encoded(ea) == plain and set(st) == ENCODE_KEYS
    assert st["up_n"] == 1 and st["down_n"] == encode_down_n(ea, cfg)
    st = {}
    np.testing.assert_array_equal(dec.decode_i16(ea, stats=st),
                                  dec.decode_i16(ea))
    chunks = chunks_of(ea, 32)
    assert set(st) == DECODE_KEYS
    assert st["up_n"] == UPLOADS_PER_CHUNK * chunks and st["down_n"] == chunks
    eas = mixed_playlist(Encoder(RATE, device=cuda_device))
    st = {}
    for a, b in zip(dec.decode_many(eas, stats=st), dec.decode_many(eas),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    multi_chunks = sum(chunks_of(x, 32) for x in eas
                       if x.frame_set.num_frames > 32)
    assert st["down_n"] == multi_chunks


@pytest.mark.cuda
def test_cuda_encode_chunk_device_is_encode_math(cuda_device):
    """On the card, the chunk program on a segment's frames, built as
    encode_segment builds them (planarize, frames_from_signal), equals
    encode_math bit for bit, with one mdct_rows and one band_energy
    launch."""
    from glc_tpu_torch.ops import kernels

    cfg = CodecConfig(encode_chunk_frames=128)
    pcm = sweep_with_noise_i16()
    _T, _F, _pad, plan, need = upload_geometry(len(pcm), 2, cfg)
    x = planarize(torch.from_numpy(pcm).to(cuda_device), 2, N // 2, N, need)
    x = x.to(torch.float32) / 32768.0
    tables = get_codec_tables(N, FRAME, RATE, cuda_device)
    tabs = get_device_tables(N, FRAME, RATE, cuda_device)
    for start, k in plan[:3]:
        blocks = frames_from_signal(x[:, start * N : (start + k + 1) * N], N)
        m0, b0 = kernels.mdct_rows.launches, kernels.band_energy.launches
        got = tops.encode_chunk_device(blocks, *tabs)
        assert kernels.mdct_rows.launches == m0 + 1
        assert kernels.band_energy.launches == b0 + 1
        want = encode_math(blocks, tables.cos_table, tables.window,
                           tables.norm, tables.band_mask,
                           tables.band_inv_count, tables.band_pf,
                           tables.band_of, tables.inv_w)
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_decode_chunk_device_is_decode_stacked(cuda_device):
    _decode_chunk_against_stacked(cuda_device)

