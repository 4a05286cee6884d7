"""The port's FLAC encoder, block math and decoder (glc_tpu_torch.flac) against
the JAX package's (glc_tpu.flac), on numpy-seeded int16 input on the CPU.

The bytes must be equal: the predictor/Rice math is exact integer
arithmetic and the bit packer is the shared native library (or its
pure-Python twin).  The JAX package is imported inside the tests that use
it.  The test marked `cuda` needs a card and skips here; on the card's
machine, which has no JAX, run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_flac.py
"""

import hashlib
import threading

import numpy as np
import pytest
import torch

from glc_tpu_torch.flac import bitpack
from glc_tpu_torch.flac import decoder as tfdecoder
from glc_tpu_torch.flac import encoder as tfencoder
from glc_tpu_torch.flac.decoder import FlacDecodeError, decode_flac
from glc_tpu_torch.flac.encoder import (
    FlacError,
    encode_flac_i16_streaming,
    encode_flac_i16_with_level,
)
from glc_tpu_torch.flac.ops import (
    flac_block_stats,
    flac_block_stats_host,
    rice_params_from_sums,
)
from glc_tpu_torch.flac.pydecoder import decode_flac_python

RATE = 44100


def _i16(total: int, channels: int, seed: int = 0) -> np.ndarray:
    """Interleaved int16 from numpy.random.default_rng(seed): a tone per
    channel plus noise, with a loud noise burst in the middle."""
    rng = np.random.default_rng(seed)
    t = np.arange(total) / RATE
    x = np.empty((total, channels))
    for c in range(channels):
        x[:, c] = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
    x += rng.normal(0.0, 0.01, x.shape)
    x[total // 3 : total // 3 + total // 10] += rng.uniform(
        -0.6, 0.6, (total // 10, channels))
    return (np.clip(x, -1, 1) * 32767).astype(np.int16).reshape(-1)


# 2 blocks of 4096 (8 of 1152) and a partial last block at every level
TOTAL = 2 * 4096 + 1000


@pytest.mark.parametrize("channels", [1, 2, 4])
@pytest.mark.parametrize("level", range(9))
def test_i16_bytes_match_jax(level, channels):
    from glc_tpu.flac.encoder import encode_flac_i16_with_level as jax_encode

    i16 = _i16(TOTAL, channels, seed=level * 10 + channels)
    want = jax_encode(i16, RATE, channels, level)
    got = encode_flac_i16_with_level(i16, RATE, channels, level)
    assert got == want


@pytest.mark.parametrize("total", [16, 17, 2 * 4096 + 4, 1152 + 2])
@pytest.mark.parametrize("level", [0, 2, 5, 8])
def test_edge_lengths_match_jax(level, total):
    """The 16-sample minimum, and last blocks as short as the predictor
    order (QUIRKS.md Q15)."""
    from glc_tpu.flac.encoder import encode_flac_i16_with_level as jax_encode

    i16 = _i16(total, 2, seed=total)
    got = encode_flac_i16_with_level(i16, RATE, 2, level)
    assert got == jax_encode(i16, RATE, 2, level)
    samples, rate, ch, bps = decode_flac(got)
    assert (rate, ch, bps) == (RATE, 2, 16)
    assert np.array_equal(samples, i16.astype(np.int32))


def test_f32_entry_and_export_match_jax(tmp_path):
    from glc_tpu.flac import encoder as jenc
    from glc_tpu.io import audio as jaudio

    from glc_tpu_torch.io import audio as taudio

    x = (_i16(5000, 2).astype(np.float32) / 40000.0)
    assert (tfencoder.encode_flac_with_level(x, RATE, 2, 7)
            == jenc.encode_flac_with_level(x, RATE, 2, 7))
    assert tfencoder.encode_flac(x, RATE, 2) == jenc.encode_flac(x, RATE, 2)
    taudio.export_to_flac(tmp_path / "t.flac", x, RATE, 2)
    jaudio.export_to_flac(tmp_path / "j.flac", x, RATE, 2)
    tfencoder.export_to_flac_i16_with_level(tmp_path / "ti.flac",
                                            _i16(5000, 2), RATE, 2, 3)
    jenc.export_to_flac_i16_with_level(tmp_path / "ji.flac",
                                       _i16(5000, 2), RATE, 2, 3)
    for a, b in (("t", "j"), ("ti", "ji")):
        assert ((tmp_path / f"{a}.flac").read_bytes()
                == (tmp_path / f"{b}.flac").read_bytes())


@pytest.mark.parametrize("whole_pack", [False, True], ids=["frames", "whole"])
@pytest.mark.parametrize("no_worker", [False, True], ids=["worker", "inline"])
@pytest.mark.parametrize("level", [0, 5, 8])
def test_streaming_bytes_equal_whole_stream(monkeypatch, level, whole_pack,
                                            no_worker):
    """Chunks cut at awkward places (not block-, not channel-aligned): the
    streamed bytes equal the whole-stream bytes, whichever switches are
    set."""
    if whole_pack:
        monkeypatch.setenv("GLC_FLAC_WHOLE_PACK", "1")
    if no_worker:
        monkeypatch.setenv("GLC_FLAC_NO_WORKER", "1")
    i16 = _i16(4096 * 20 + 777, 2, seed=level)
    rng = np.random.default_rng(level)
    cuts = np.sort(rng.choice(len(i16) - 2, 9, replace=False) + 1)
    got = encode_flac_i16_streaming(iter(np.split(i16, cuts)), RATE, 2,
                                    level, len(i16) // 2)
    assert got == encode_flac_i16_with_level(i16, RATE, 2, level)


@pytest.mark.parametrize("level", [1, 5, 8])
def test_device_math_branch_gives_the_same_bytes(monkeypatch, level):
    """GLC_FLAC_DEVICE_MATH=1: the torch block math on the default device
    (the CPU here, through GLC_TORCH_DEVICE), whole-stream and streaming."""
    from glc_tpu.flac.encoder import encode_flac_i16_with_level as jax_encode

    monkeypatch.setenv("GLC_TORCH_DEVICE", "cpu")

    i16 = _i16(TOTAL, 2, seed=3)
    want = jax_encode(i16, RATE, 2, level)
    monkeypatch.setattr(tfencoder, "_USE_DEVICE_MATH", True)
    calls = []
    real = tfencoder.flac_block_stats
    monkeypatch.setattr(tfencoder, "flac_block_stats",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert encode_flac_i16_with_level(i16, RATE, 2, level) == want
    chunks = np.array_split(i16, 5)
    assert encode_flac_i16_streaming(iter(chunks), RATE, 2, level,
                                     TOTAL) == want
    assert calls


def test_python_packer_gives_the_same_bytes(monkeypatch):
    """Without the native library the encoder packs with bitpack.pack_stream
    (also the streaming encoder, which then packs once at the end)."""
    i16 = _i16(3000, 2, seed=5)
    want = encode_flac_i16_with_level(i16, RATE, 2, 5)
    monkeypatch.setattr(tfencoder, "get_native", lambda: None)
    assert encode_flac_i16_with_level(i16, RATE, 2, 5) == want
    assert encode_flac_i16_streaming(iter(np.array_split(i16, 3)), RATE, 2,
                                     5, 3000) == want


def test_order_helpers_match_jax():
    from glc_tpu.flac import bitpack as jbitpack

    for bs in (16, 100, 314, 1000, 1024, 1152, 4096):
        for level in range(9):
            order = bitpack.predictor_order(bs, level)
            assert order == jbitpack.predictor_order(bs, level)
            assert (bitpack.partition_order(bs, order, level)
                    == jbitpack.partition_order(bs, order, level))
    assert bitpack.crc8(b"123456789") == jbitpack.crc8(b"123456789")
    assert bitpack.crc16(b"123456789") == jbitpack.crc16(b"123456789")


def _blocks(B: int, bs: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(-32768, 32768, (B, bs), dtype=np.int32)
    x[0] = np.where(np.arange(bs) % 2, 32767, -32768)  # Δ⁴ at its largest
    return x


@pytest.mark.parametrize("order", range(5))
def test_block_stats_match_jax_and_host(order):
    """The torch block math on CPU tensors equals the JAX package's jitted
    program and the numpy twin, at the partition orders the levels use."""
    import jax

    from glc_tpu.flac.ops import flac_block_stats as jax_stats

    for bs, po in ((1152, 0), (1152, 2), (4096, 4), (4096, 6), (314, 1)):
        x = _blocks(6, bs, seed=order * 100 + po)
        got = flac_block_stats(torch.from_numpy(x), order=order, po=po)
        want = jax_stats(jax.device_put(x), order=order, po=po)
        host = flac_block_stats_host(x, order=order, po=po)
        for g, w, h in zip(got, want, host, strict=True):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), np.asarray(w))
            assert np.array_equal(g.numpy(), h)


def test_block_stats_refuse_other_dtypes():
    with pytest.raises(TypeError):
        flac_block_stats(torch.zeros((2, 16), dtype=torch.int64), order=1,
                         po=0)


def test_rice_params_match_jax():
    from glc_tpu.flac.ops import rice_params_from_sums as jax_rice

    rng = np.random.default_rng(11)
    for bs, order, po in ((4096, 4, 4), (1152, 2, 2), (4096, 0, 6),
                          (20, 4, 0), (314, 3, 1)):
        P = 1 << po
        lo = rng.integers(0, 1 << 28, (7, P), dtype=np.int32)
        hi = rng.integers(0, 1 << 12, (7, P), dtype=np.int32)
        hi[0] = 0
        lo[0, 0] = 0
        got = rice_params_from_sums(lo, hi, bs, order, po)
        assert got.dtype == np.int8
        assert np.array_equal(got, jax_rice(lo, hi, bs, order, po))


@pytest.fixture(scope="module")
def flac_pair():
    """(int16 samples, the port's bytes, the JAX package's bytes) of a
    short stereo stream at level 5."""
    from glc_tpu.flac.encoder import encode_flac_i16_with_level as jax_encode

    i16 = _i16(4096 + 300, 2, seed=21)
    return (i16, encode_flac_i16_with_level(i16, RATE, 2, 5),
            jax_encode(i16, RATE, 2, 5))


def test_decoders_read_each_others_bytes(flac_pair):
    from glc_tpu.flac.decoder import decode_flac as jax_decode
    from glc_tpu.flac.pydecoder import decode_flac_python as jax_py

    i16, ours, theirs = flac_pair
    want = (i16.astype(np.int32), RATE, 2, 16)
    for decode, data in ((decode_flac, theirs), (decode_flac_python, theirs),
                         (jax_decode, ours), (jax_py, ours)):
        samples, *info = decode(data)
        assert samples.dtype == np.int32
        assert np.array_equal(samples, want[0]) and tuple(info) == want[1:]
    md5 = hashlib.md5(i16.astype("<i2").tobytes()).digest()
    assert ours[26:42] == md5


def test_decode_flac_falls_back_to_the_python_twin(monkeypatch, flac_pair):
    i16, ours, _theirs = flac_pair
    monkeypatch.setattr(tfdecoder, "get_native", lambda: None)
    samples, rate, ch, bps = decode_flac(ours)
    assert np.array_equal(samples, i16.astype(np.int32))
    with pytest.raises(FlacDecodeError, match="code -1"):
        decode_flac(b"RIFF0000")


BAD_STREAMS = {
    "empty": b"",
    "not_flac": b"RIFF" + bytes(40),
    "truncated_metadata": b"fLaC\x80\x00\x00\x22" + bytes(10),
}


@pytest.mark.parametrize("name", sorted(BAD_STREAMS))
def test_decode_errors_match_jax(name):
    from glc_tpu.flac.decoder import FlacDecodeError as JaxDecodeError
    from glc_tpu.flac.decoder import decode_flac as jax_decode

    data = BAD_STREAMS[name]
    with pytest.raises(JaxDecodeError) as jerr:
        jax_decode(data)
    with pytest.raises(FlacDecodeError) as terr:
        decode_flac(data)
    assert str(terr.value) == str(jerr.value)


def test_truncated_frames_raise_like_jax(flac_pair):
    from glc_tpu.flac.decoder import decode_flac as jax_decode

    _i16s, ours, _theirs = flac_pair
    cut = ours[: len(ours) // 2]
    outcomes = []
    for decode in (decode_flac, jax_decode):
        try:
            outcomes.append(("ok", len(decode(cut)[0])))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]


ENCODE_ERRORS = {
    "too_short": (np.zeros(15, np.int16), 1, 5, None),
    "too_short_stereo": (np.zeros(30, np.int16), 2, 5, None),
    "bad_level": (np.zeros(100, np.int16), 1, 9, None),
    "negative_level": (np.zeros(100, np.int16), 1, -1, None),
    "length_mismatch": (np.zeros(1000, np.int16), 1, 5, 999),
}


@pytest.mark.parametrize("name", sorted(ENCODE_ERRORS))
def test_encode_errors_match_jax(name):
    """FlacError where the JAX package raises it, whole-stream and
    streaming, with the same message."""
    from glc_tpu.flac import encoder as jenc

    i16, ch, level, declared = ENCODE_ERRORS[name]
    total = len(i16) // ch if declared is None else declared
    for pkg, err in ((jenc, jenc.FlacError), (tfencoder, FlacError)):
        msgs = []
        if declared is None:
            with pytest.raises(err) as e:
                pkg.encode_flac_i16_with_level(i16, RATE, ch, level)
            msgs.append(str(e.value))
        with pytest.raises(err) as e:
            pkg.encode_flac_i16_streaming(iter([i16]), RATE, ch, level, total)
        msgs.append(str(e.value))
        if pkg is jenc:
            want = msgs
    assert msgs == want


def _run_bounded(fn, timeout=30.0):
    """fn() on a thread; its exception, or None; fails if it hangs."""
    out = []

    def target():
        try:
            fn()
            out.append(None)
        except BaseException as e:  # handed to the test
            out.append(e)

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "the streaming encoder hung"
    return out[0]


def test_producer_error_reaches_the_caller():
    i16 = _i16(4096 * 40, 2)

    def chunks():
        for i, c in enumerate(np.array_split(i16, 40)):
            if i == 30:
                raise RuntimeError("decode failed mid-stream")
            yield c

    err = _run_bounded(lambda: encode_flac_i16_streaming(
        chunks(), RATE, 2, 5, len(i16) // 2))
    assert isinstance(err, RuntimeError) and "mid-stream" in str(err)


def test_worker_error_reaches_the_caller(monkeypatch):
    """An error on the worker thread stops the stream and is raised in the
    caller, without a hang, even with the producer still sending."""
    def broken(*args):
        raise MemoryError("worker failed")

    monkeypatch.setattr(tfencoder, "_block_group_stats", broken)
    i16 = _i16(4096 * 40, 2)
    err = _run_bounded(lambda: encode_flac_i16_streaming(
        iter(np.array_split(i16, 200)), RATE, 2, 5, len(i16) // 2))
    assert isinstance(err, MemoryError)


@pytest.mark.cuda
def test_cuda_block_stats_equal_host():
    """On the card: int32 diff, abs, & and >> and the int32 sums are exact,
    so the device math equals the host twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for order in range(5):
        for bs, po in ((1152, 2), (4096, 4), (4096, 6), (314, 1)):
            x = _blocks(64, bs, seed=order + bs)
            got = flac_block_stats(torch.from_numpy(x).cuda(), order=order,
                                   po=po)
            for g, h in zip(got, flac_block_stats_host(x, order=order, po=po),
                            strict=True):
                assert g.is_cuda and g.dtype == torch.int32
                assert np.array_equal(g.cpu().numpy(), h)
