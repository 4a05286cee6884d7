"""The port's streaming decode surfaces against its own whole-file decode and
against the JAX package's, on the CPU: `Decoder.decode_i16_stream` (the
int16 chunks that the FLAC export consumes) and `Decoder.decode_streaming`
(the float32 AudioChunk queue with its Progress messages).

On the CPU the plain IMDCT product rounds a row differently when the
product has at most 128 rows (a chunk of K frames is K·C rows), so the
int16 output can depend on the chunk size there; from 129 rows on it does
not.  The card's kernel computes each row the same way at any row count.
So the CPU tests of chunk-size invariance use stereo and chunk sizes at
which every chunk has at least 129 rows, and a test that crosses that line
holds the output to 1 LSB instead.

The JAX package is imported inside the tests that use it.  The tests
marked `cuda` need a card and skip here; on the card's machine, which has
no JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_stream.py
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import glc_tpu_torch
from glc_tpu_torch import Decoder, Encoder
from glc_tpu_torch.codec import decoder as tdecoder
from glc_tpu_torch.codec.encoder import frame_plan
from glc_tpu_torch.codec.tables import chunk_size_for
from glc_tpu_torch.container.schema import ProgressKind
from glc_tpu_torch.ops.kernels import imdct_window

RATE = 44100
T_321 = 328256        # samples a channel that frame to F = 321
MIN_EQUAL_ROWS = 129  # from here on a CPU product row does not depend on B


def _pcm(T: int, channels: int, seed: int = 0) -> np.ndarray:
    """Interleaved int16 from numpy.random.default_rng(seed): harmonic tones
    with a decaying envelope per 0.25 s note, and uniform noise over the
    fifth tenth of the signal (it drives the raw-PCM fallback)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / RATE
    note = (t // 0.25).astype(np.int64)
    env = np.exp(-6.0 * (t % 0.25))
    x = np.zeros((T, channels))
    for c in range(channels):
        f0 = rng.uniform(110.0, 880.0, size=note[-1] + 1)[note]
        for h in range(1, 5):
            x[:, c] += (0.3 / h) * np.sin(2 * np.pi * h * f0 * t)
        x[:, c] *= env
    noise = slice(4 * T // 10, 5 * T // 10)
    x[noise] = rng.uniform(-0.6, 0.6, size=x[noise].shape)
    return (x * 32767.0).astype(np.int16).reshape(-1)


@pytest.fixture(scope="module")
def container():
    """channels -> (pcm, the JAX package's container) at F = 321 frames."""
    import glc_tpu

    cache = {}

    def get(channels):
        if channels not in cache:
            pcm = _pcm(T_321, channels, seed=channels)
            ea = glc_tpu.Encoder(RATE).encode_pcm16(pcm, channels)
            assert ea.frame_set.num_frames == 321
            assert ea.frame_set.raw_mask.any()
            cache[channels] = (pcm, ea)
        return cache[channels]

    return get


def _config(**over):
    return dataclasses.replace(glc_tpu_torch.DEFAULT_CONFIG, **over)


def _chunk_rows(F: int, chunk: int, channels: int):
    """Rows of the IMDCT product of each chunk."""
    return [min(chunk, F - s) * channels for s in range(0, F, chunk)]


def test_frame_plan_gives_321_frames():
    _T, F, _pad = frame_plan(T_321 * 2, 2, glc_tpu_torch.DEFAULT_CONFIG)
    assert F == 321


@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
@pytest.mark.parametrize("chunk_frames", [32, 1408])
def test_stream_concatenates_to_decode_i16(container, channels, chunk_frames):
    """decode_i16 is the stream's concatenation, over raw frames and several
    chunks; each yielded array is its own memory and stays valid after the
    generator moves on."""
    pcm, ea = container(channels)
    dec = Decoder(channels, RATE, _config(decode_chunk_frames=chunk_frames),
                  device="cpu")
    before = imdct_window.launches
    parts = list(dec.decode_i16_stream(ea))
    whole = dec.decode_i16(ea)
    assert imdct_window.launches == before  # the CPU takes the plain version
    chunk = chunk_size_for(321, chunk_frames)
    assert len(parts) == -(-321 // chunk)
    assert all(p.dtype == np.int16 and p.ndim == 1 for p in parts)
    for i in range(len(parts) - 1):
        assert not np.shares_memory(parts[i], parts[i + 1])
    assert np.array_equal(np.concatenate(parts), whole)
    assert len(whole) == len(pcm) == dec.decoded_length(ea)


@pytest.mark.parametrize("chunk_frames", [128, 200, 256, 1024])
def test_chunk_size_does_not_change_stereo_output(container, chunk_frames):
    """Stereo, and every chunk of at least 129 rows (see the module
    docstring): the stream equals decode_i16 at its default chunk size bit
    for bit, whatever the chunk size."""
    _pcm16, ea = container(2)
    chunk = chunk_size_for(321, chunk_frames)
    assert min(_chunk_rows(321, chunk, 2)) >= MIN_EQUAL_ROWS
    assert min(_chunk_rows(321, chunk_size_for(321, 1408), 2)) >= MIN_EQUAL_ROWS
    dec = Decoder(2, RATE, device="cpu")
    got = np.concatenate(list(dec.decode_i16_stream(ea, chunk_frames)))
    assert np.array_equal(got, dec.decode_i16(ea))


@pytest.mark.parametrize("chunk_frames", [32, 64, 100])
def test_chunks_below_129_rows_stay_within_one_lsb(container, chunk_frames):
    """Mono chunks of at most 128 rows: the CPU product rounds those rows
    differently, so the stream is held to 1 LSB of decode_i16 here, not to
    equality."""
    _pcm16, ea = container(1)
    assert min(_chunk_rows(321, chunk_frames, 1)) < MIN_EQUAL_ROWS
    dec = Decoder(1, RATE, device="cpu")
    got = np.concatenate(list(dec.decode_i16_stream(ea, chunk_frames)))
    want = dec.decode_i16(ea)
    assert len(got) == len(want)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("channels,chunk_frames", [(1, 128), (2, 256),
                                                   (2, None)])
def test_stream_matches_jax(container, channels, chunk_frames):
    """Same chunk boundaries and trim as the JAX package's stream (equal
    lengths chunk by chunk) and samples within 1 LSB, the bound the JAX
    package holds between its own programs."""
    import glc_tpu

    _pcm16, ea = container(channels)
    jparts = list(glc_tpu.Decoder(channels, RATE).decode_i16_stream(
        ea, chunk_frames=chunk_frames))
    tparts = list(Decoder(channels, RATE, device="cpu").decode_i16_stream(
        ea, chunk_frames=chunk_frames))
    assert [len(p) for p in tparts] == [len(p) for p in jparts]
    d = np.abs(np.concatenate(tparts).astype(np.int32)
               - np.concatenate(jparts).astype(np.int32))
    assert d.max() <= 1


def _drain(rx, timeout=60.0):
    chunks = []
    while True:
        c = rx.get(timeout=timeout)
        chunks.append(c)
        if c.is_last:
            return chunks


@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
def test_decode_streaming_matches_jax(container, channels):
    """Flushes of 100 frames across decode chunks of 128: the same chunk
    count, lengths, is_last flags and Progress messages as the JAX
    package, samples within 1e-5."""
    import glc_tpu

    _pcm16, ea = container(channels)
    over = {"frames_per_chunk": 100, "decode_chunk_frames": 128}
    jcfg = glc_tpu.CodecConfig(**over)
    runs = {}
    for name, dec in (
        ("jax", glc_tpu.Decoder(channels, RATE, jcfg)),
        ("torch", Decoder(channels, RATE, _config(**over), device="cpu")),
    ):
        msgs = []
        runs[name] = (_drain(dec.decode_streaming(ea, msgs.append)), msgs)
    (jc, jm), (tc, tm) = runs["jax"], runs["torch"]
    assert [len(c.samples) for c in tc] == [len(c.samples) for c in jc]
    assert [c.is_last for c in tc] == [c.is_last for c in jc]
    assert len(tc) == 4 and [c.error for c in tc] == [None] * 4
    assert len(tc[-1].samples) == (21 * 1024 + 1024) * channels  # + tail
    assert [m.kind.value for m in tm] == [m.kind.value for m in jm]
    assert [m.value for m in tm[:-1]] == [m.value for m in jm[:-1]]
    assert tm[-1].kind is ProgressKind.COMPLETE
    for a, b in zip(tc, jc):
        assert a.samples.dtype == np.float32
        np.testing.assert_allclose(a.samples, b.samples, atol=1e-5, rtol=0)


def test_decode_is_the_trimmed_stream(container):
    """decode() joins decode_streaming's chunks and trims them."""
    _pcm16, ea = container(2)
    dec = Decoder(2, RATE, _config(frames_per_chunk=64), device="cpu")
    full = np.concatenate([c.samples for c in _drain(dec.decode_streaming(ea))])
    skip, limit = tdecoder.gapless_trim_bounds(
        len(full), ea.gapless_info, 2, True)
    out = dec.decode(ea)
    assert np.array_equal(out, full[skip : skip + limit])
    assert len(out) == dec.decoded_length(ea)


def _producers():
    return {t for t in threading.enumerate() if t.daemon}


def test_cancelled_consumer_does_not_hang_the_producer(container):
    """A consumer that reads one chunk of many and sets rx.cancelled lets
    the producer thread end while the queue is full."""
    _pcm16, ea = container(2)
    dec = Decoder(2, RATE, _config(frames_per_chunk=8), device="cpu")
    before = _producers()
    rx = dec.decode_streaming(ea)
    first = rx.get(timeout=60)
    assert not first.is_last
    new = _producers() - before
    assert len(new) == 1
    (producer,) = new
    time.sleep(0.5)  # the producer fills the queue of 5 and waits
    assert rx.full()
    rx.cancelled.set()
    producer.join(timeout=10)
    assert not producer.is_alive()


def test_producer_failure_is_a_terminal_chunk(container, monkeypatch):
    _pcm16, ea = container(1)

    def broken(self, encoded, chunk):
        yield 5, torch.zeros((5, 1, 1024))
        raise RuntimeError("chunk upload failed")

    monkeypatch.setattr(Decoder, "_chunks", broken)
    dec = Decoder(1, RATE, _config(frames_per_chunk=4), device="cpu")
    msgs = []
    chunks = _drain(dec.decode_streaming(ea, msgs.append), timeout=10)
    assert chunks[-1].error == "chunk upload failed" and chunks[-1].is_last
    assert msgs[-1].kind is ProgressKind.ERROR
    with pytest.raises(RuntimeError, match="chunk upload failed"):
        dec.decode(ea)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_frames", [128, 256, 1024, 1408])
def test_cuda_stream_equals_decode_i16(cuda_device, chunk_frames):
    """On the card the hand kernel computes each row the same way at any
    row count, so the stream equals decode_i16 bit for bit at every chunk
    size, mono and stereo, and launches the kernel once a chunk."""
    for channels in (1, 2):
        pcm = _pcm(40 * RATE, channels, seed=7)
        ea = Encoder(RATE, device=cuda_device).encode_pcm16(pcm, channels)
        F = ea.frame_set.num_frames
        dec = Decoder(channels, RATE, device=cuda_device)
        whole = dec.decode_i16(ea)
        imdct_window.launches = 0
        got = np.concatenate(list(dec.decode_i16_stream(ea, chunk_frames)))
        assert imdct_window.launches == -(-F // chunk_size_for(F, chunk_frames))
        assert len(got) == len(pcm)
        assert np.array_equal(got, whole)
