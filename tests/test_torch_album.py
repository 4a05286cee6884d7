"""The port's multi-track paths against its own single-track ones and
against the JAX package's, on the CPU: `Encoder.encode_many`,
`Decoder.decode_many` on the default and the ``segmented_batch`` config
(which the port does not read), and `glc_tpu_torch.album`
(`decode_playlist`, `export_playlist_to_flac`, `export_playlist_to_wav`).

Bounds, each with its reason:
- `encode_many` equals the per-file encodes byte for byte: it runs them.
- Port against the JAX package's `encode_many`: the pair contract
  (glc_tpu_torch/parity.py), as for single files.
- `decode_many` against the port's `decode_i16`: equal where every launch
  of the IMDCT product has at least 129 rows, else within 1 LSB.  On the
  CPU the plain product rounds the rows of a product of at most 128 rows
  differently from those of a larger one (tests/test_torch_stream.py);
  the card's kernel does not, and the `cuda` tests ask for equality.
- Port against the JAX package's `decode_many` and album functions: 1 LSB,
  the bound the JAX package holds between its own programs
  (tests/test_decode_many.py).

Every decode test records the row counts the decode hands the IMDCT, so
it fails if the batched path did not run (tests/test_decode_many.py:12-16
says why that matters).  `launch_rows` predicts those counts from the
frame counts alone; chip_smoke.py imports it for its launch checks.  The JAX package is imported inside the tests
that use it.  The `cuda` tests skip here; on the card's machine, which
has no JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_album.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import glc_tpu_torch
from glc_tpu_torch import Decoder, Encoder, save_encoded, serialize_encoded
from glc_tpu_torch import album
from glc_tpu_torch.codec import encoder as tencoder
from glc_tpu_torch.codec.encoder import upload_geometry
from glc_tpu_torch.codec.tables import chunk_size_for
from glc_tpu_torch.flac.decoder import decode_flac
from glc_tpu_torch.flac.encoder import encode_flac_i16_with_level
from glc_tpu_torch.io.wav import read_wav_pcm16
from glc_tpu_torch.ops import decode as decode_ops
from glc_tpu_torch.parity import check_containers

RATE = 44100
MIN_EQUAL_ROWS = 129  # from here on a CPU product row does not depend on B
# multi-segment encodes and multi-chunk decodes at test sizes
# (tests/test_chunking.py:401 does the same)
SMALL = {"encode_chunk_frames": 128, "decode_chunk_frames": 128}


def _tone(seconds: float, channels: int, seed: int) -> np.ndarray:
    """Interleaved int16 from numpy.random.default_rng(seed): harmonic
    tones with a decaying envelope per 0.25 s note."""
    rng = np.random.default_rng(seed)
    T = int(seconds * RATE)
    t = np.arange(T) / RATE
    note = (t // 0.25).astype(np.int64)
    env = np.exp(-6.0 * (t % 0.25))
    x = np.zeros((T, channels))
    for c in range(channels):
        f0 = rng.uniform(110.0, 880.0, size=note[-1] + 1)[note]
        for h in range(1, 5):
            x[:, c] += (0.3 / h) * np.sin(2 * np.pi * h * f0 * t)
        x[:, c] *= env
    return (x * 32767.0).astype(np.int16).reshape(-1)


def _noise(seconds: float, channels: int, seed: int) -> np.ndarray:
    """Interleaved float32 white noise: every frame takes the raw fallback."""
    rng = np.random.default_rng(seed)
    n = int(seconds * RATE) * channels
    return rng.uniform(-0.5, 0.5, n).astype(np.float32)


# (samples, channels) items of each mix; int16 items take encode_pcm16
MIXES = {
    # one group of identical single-segment tracks
    "identical": lambda: [(_tone(1.0, 2, 1), 2)] * 3,
    # heterogeneous lengths (multi-segment at 128-frame segments), raw
    # fallback, mono, int16 beside float32
    "mixed": lambda: [
        (_tone(3.7, 2, 2), 2),
        (_noise(0.6, 2, 3), 2),
        (_tone(2.4, 1, 4), 1),
        (_tone(3.1, 2, 5).astype(np.float32) / 32768.0, 2),
    ],
}


def _config(segmented: bool, **over):
    return dataclasses.replace(glc_tpu_torch.DEFAULT_CONFIG, **SMALL,
                               segmented_batch=segmented, **over)


def _solo(enc, samples, channels):
    if samples.dtype == np.int16:
        return enc.encode_pcm16(samples, channels)
    return enc.encode(samples, channels)


@pytest.fixture(scope="module")
def jax_album():
    """mix -> (items, the JAX package's encode_many containers) at SMALL."""
    import glc_tpu

    cache = {}

    def get(mix):
        if mix not in cache:
            items = MIXES[mix]()
            jenc = glc_tpu.Encoder(RATE, glc_tpu.CodecConfig(**SMALL))
            cache[mix] = (items, jenc.encode_many(items))
        return cache[mix]

    return get


@pytest.fixture
def rows_seen(monkeypatch):
    """The row counts of the decode's IMDCT calls, in call order."""
    seen = []
    wrapper = decode_ops.imdct_window

    def recorded(coeffs, *args):
        seen.append(coeffs.shape[0])
        return wrapper(coeffs, *args)

    monkeypatch.setattr(decode_ops, "imdct_window", recorded)
    return seen


def launch_rows(tracks, decode_chunk_frames):
    """The row counts `Decoder.decode_many` launches the IMDCT with, in call
    order, from each track's (channels, frames) alone: one call a
    (channels, chunk) group of single-chunk tracks, on Σ F·C rows, in the
    order the groups first appear; then one call a chunk of each
    multi-chunk track, in input order.  Tracks with no frames launch
    nothing."""
    groups = {}
    for C, F in tracks:
        chunk = chunk_size_for(max(F, 1), decode_chunk_frames)
        if 0 < F <= chunk:
            groups.setdefault((C, chunk), []).append(F)
    rows = [sum(Fs) * C for (C, _chunk), Fs in groups.items()]
    for C, F in tracks:
        chunk = chunk_size_for(max(F, 1), decode_chunk_frames)
        if F > chunk:
            rows += [min(chunk, F - s) * C for s in range(0, F, chunk)]
    return rows


def expected_rows(encodeds, cfg):
    """`launch_rows` of containers under `cfg`."""
    return launch_rows(
        [(ea.header.channels, ea.frame_set.num_frames) for ea in encodeds],
        cfg.decode_chunk_frames)


def _max_lsb(a, b):
    assert a.shape == b.shape
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max(initial=0))


# --- encode_many ---

@pytest.mark.parametrize("segmented", [False, True],
                         ids=["default", "segmented"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_encode_many_equals_per_file(mix, segmented):
    items = MIXES[mix]()
    enc = Encoder(RATE, _config(segmented), device="cpu")
    many = enc.encode_many(items)
    assert len(many) == len(items)
    for (samples, channels), ea in zip(items, many):
        assert serialize_encoded(ea) == serialize_encoded(
            _solo(enc, samples, channels))
    if mix == "mixed":
        # two multi-segment tracks (one int16, one float32) around the
        # single-segment noise and mono tracks
        plans = [len(upload_geometry(len(s), c, enc.config)[3])
                 for s, c in items]
        assert plans == [2, 1, 1, 2]


def test_encode_many_checks_every_item_before_encoding(monkeypatch):
    """A bad item anywhere fails the call before any track is encoded, as
    in the JAX package: dtypes first, then lengths and framing."""
    encoded = []
    real = tencoder.Encoder._encode

    def counting(self, *args, **kw):
        encoded.append(1)
        return real(self, *args, **kw)

    monkeypatch.setattr(tencoder.Encoder, "_encode", counting)
    enc = Encoder(RATE, device="cpu")
    good = (_tone(0.5, 2, 1), 2)
    with pytest.raises(TypeError):
        enc.encode_many([good, (np.zeros(0, np.float32), 2),
                         (np.zeros(64, np.int32), 2)])
    with pytest.raises(ValueError, match="channels must be >= 1"):
        enc.encode_many([good, (np.zeros(64, np.float32), 0)])
    assert encoded == []
    assert len(enc.encode_many([good, good])) == 2 and len(encoded) == 2


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_encode_many_matches_jax(jax_album, mix):
    items, jax_many = jax_album(mix)
    many = Encoder(RATE, _config(False), device="cpu").encode_many(items)
    for ea, jea in zip(many, jax_many, strict=True):
        check_containers(ea, jea)


@pytest.mark.parametrize("bad,error", [
    (np.zeros(64, np.int32), TypeError),
    (np.zeros(0, np.float32), ValueError),
    (np.zeros(0, np.int16), ValueError),
])
def test_encode_many_input_errors_match_jax(bad, error):
    import glc_tpu

    items = [(_tone(0.5, 2, 1), 2), (bad, 2)]
    with pytest.raises(error) as jax_err:
        glc_tpu.Encoder(RATE).encode_many(items)
    with pytest.raises(error) as port_err:
        Encoder(RATE, device="cpu").encode_many(items)
    assert str(port_err.value) == str(jax_err.value)


# --- decode_many ---

@pytest.mark.parametrize("segmented", [False, True],
                         ids=["default", "segmented"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_decode_many_against_decode_i16_and_jax(jax_album, rows_seen, mix,
                                                segmented):
    """The JAX package's containers decoded by both packages' decode_many:
    exact lengths, in order, each result its own memory."""
    import glc_tpu

    _items, eas = jax_album(mix)
    cfg = _config(segmented)
    dec = Decoder(2, RATE, cfg, device="cpu")
    outs = dec.decode_many(eas)
    assert rows_seen == expected_rows(eas, cfg)
    jouts = glc_tpu.Decoder(2, RATE, glc_tpu.CodecConfig(
        **SMALL, segmented_batch=segmented)).decode_many(eas)
    for ea, out, jout in zip(eas, outs, jouts, strict=True):
        assert out.dtype == np.int16
        assert len(out) == dec.decoded_length(ea) == ea.header.total_samples
        assert out.base is None or out.base.nbytes <= out.nbytes
        assert _max_lsb(out, dec.decode_i16(ea)) <= 1
        assert _max_lsb(out, jout) <= 1


def test_decode_many_default_multichunk_is_decode_i16(jax_album, rows_seen):
    """Multi-chunk tracks on the default config run decode_i16's own
    chunks: bit for bit equal."""
    _items, eas = jax_album("mixed")
    dec = Decoder(2, RATE, _config(False), device="cpu")
    outs = dec.decode_many(eas)
    multi = [i for i, ea in enumerate(eas) if ea.frame_set.num_frames > 128]
    assert multi == [0, 3]
    for i in multi:
        assert np.array_equal(outs[i], dec.decode_i16(eas[i]))


def test_decode_many_batch_is_exact_from_129_rows(rows_seen):
    """Stereo single-chunk tracks of 66-110 frames: the solo decode of each
    has at least 132 rows, the group one launch of all of them, so on the
    CPU too each track equals its decode_i16 bit for bit."""
    enc = Encoder(RATE, device="cpu")
    eas = [enc.encode_pcm16(_tone(s, 2, i), 2)
           for i, s in enumerate((1.6, 2.5, 1.6, 2.1))]
    Fs = [ea.frame_set.num_frames for ea in eas]
    assert min(Fs) * 2 >= MIN_EQUAL_ROWS
    dec = Decoder(2, RATE, device="cpu")
    outs = dec.decode_many(eas)
    assert rows_seen == [2 * sum(Fs)]
    for ea, out in zip(eas, outs):
        assert np.array_equal(out, dec.decode_i16(ea))


@pytest.mark.parametrize("path", ["encode_many", "decode_many"])
def test_segmented_batch_changes_nothing(rows_seen, path):
    """The port does not read ``segmented_batch``: multi-segment and
    multi-chunk tracks (3, 3 and 2 chunks of 128 frames) give the same
    containers, the same decodes and the same launches either way."""
    items = [(_tone(s, 2, i), 2) for i, s in enumerate((7.9, 7.6, 4.6))]
    plain, segmented = _config(False), _config(True)
    eas = Encoder(RATE, plain, device="cpu").encode_many(items)
    if path == "encode_many":
        again = Encoder(RATE, segmented, device="cpu").encode_many(items)
        assert ([serialize_encoded(ea) for ea in again]
                == [serialize_encoded(ea) for ea in eas])
        return
    assert [-(-ea.frame_set.num_frames // 128) for ea in eas] == [3, 3, 2]
    outs = Decoder(2, RATE, plain, device="cpu").decode_many(eas)
    first = list(rows_seen)
    assert first == expected_rows(eas, plain) and len(first) == 8
    rows_seen.clear()
    again = Decoder(2, RATE, segmented, device="cpu").decode_many(eas)
    assert rows_seen == first
    for out, out2 in zip(outs, again, strict=True):
        assert np.array_equal(out, out2)


def test_decode_many_empty_track_and_mixed_channels(rows_seen):
    """An F == 0 track, mono and stereo tracks in one call: each with its
    own header's channel count, in input order."""
    from glc_tpu_torch.container.schema import (
        AudioHeader, EncodedAudio, FrameSet, GaplessInfo,
    )

    enc = Encoder(RATE, device="cpu")
    eas = [enc.encode_pcm16(_tone(0.8, 1, 1), 1),
           EncodedAudio(AudioHeader(RATE, 1, 0), FrameSet.empty(1),
                        GaplessInfo(512, 0, 0)),
           enc.encode_pcm16(_tone(0.8, 2, 2), 2),
           enc.encode_pcm16(_tone(0.7, 1, 3), 1)]
    dec = Decoder(2, RATE, device="cpu")
    outs = dec.decode_many(eas)
    assert sorted(rows_seen[:2]) == sorted(expected_rows(eas, dec.config))
    for ea, out in zip(eas, outs):
        assert len(out) == dec.decoded_length(ea)
        assert _max_lsb(out, dec.decode_i16(ea)) <= 1
    assert dec.decode_many([]) == []


# --- album ---

@pytest.fixture(scope="module")
def playlist(tmp_path_factory, jax_album):
    """Three stereo .glc files of the JAX package's containers (default
    config: single-chunk tracks of one group)."""
    import glc_tpu

    d = tmp_path_factory.mktemp("album")
    jenc = glc_tpu.Encoder(RATE)
    paths = []
    for i, s in enumerate((1.0, 1.9, 0.7)):
        p = d / f"track{i}.glc"
        save_encoded(jenc.encode_pcm16(_tone(s, 2, 10 + i), 2), p)
        paths.append(p)
    return paths


def _progress_log():
    log = []
    return log, lambda p: log.append((p.kind.value, p.value))


def test_decode_playlist_matches_jax(playlist, rows_seen):
    import glc_tpu.album

    samples, rate, channels = album.decode_playlist(playlist, device="cpu")
    jsamples, jrate, jchannels = glc_tpu.album.decode_playlist(playlist)
    assert (rate, channels) == (jrate, jchannels) == (RATE, 2)
    assert _max_lsb(samples, jsamples) <= 1
    # the batch ran: one launch on all three tracks' rows
    assert len(rows_seen) == 1
    # with progress: serial decode_i16, the JAX package's messages
    log, cb = _progress_log()
    jlog, jcb = _progress_log()
    serial, _r, _c = album.decode_playlist(playlist, cb, device="cpu")
    glc_tpu.album.decode_playlist(playlist, jcb)
    assert log == jlog and len(log) == 6
    assert _max_lsb(serial, samples) <= 1


def test_export_playlist_to_flac_matches_jax(playlist, tmp_path):
    import glc_tpu.album

    log, cb = _progress_log()
    jlog, jcb = _progress_log()
    album.export_playlist_to_flac(playlist, tmp_path / "a.flac", 5, cb,
                                  device="cpu")
    glc_tpu.album.export_playlist_to_flac(playlist, tmp_path / "j.flac", 5,
                                          jcb)
    assert log == jlog
    data = (tmp_path / "a.flac").read_bytes()
    samples, rate, channels, bps = decode_flac(data)
    jsamples, *_fmt = decode_flac((tmp_path / "j.flac").read_bytes())
    assert (rate, channels, bps) == (RATE, 2, 16)
    assert _max_lsb(samples, jsamples) <= 1
    # the bytes are the whole-stream encode of the decoded playlist
    dec = Decoder(2, RATE, device="cpu")
    stream = np.concatenate([
        part for p in playlist
        for part in dec.decode_i16_stream(
            glc_tpu_torch.load_encoded(p),
            chunk_frames=dec.config.stream_chunk_frames)])
    assert data == encode_flac_i16_with_level(stream, RATE, 2, 5)


def test_export_playlist_to_wav_matches_jax(playlist, tmp_path):
    import glc_tpu.album

    album.export_playlist_to_wav(playlist, tmp_path / "a.wav", device="cpu")
    glc_tpu.album.export_playlist_to_wav(playlist, tmp_path / "j.wav")
    out, rate, channels = read_wav_pcm16(tmp_path / "a.wav")
    jout, jrate, jchannels = read_wav_pcm16(tmp_path / "j.wav")
    assert (rate, channels) == (jrate, jchannels) == (RATE, 2)
    assert _max_lsb(out, jout) <= 1
    want, _r, _c = album.decode_playlist(playlist, device="cpu")
    assert np.array_equal(out, want)


@pytest.mark.parametrize("fn", ["decode_playlist", "export_playlist_to_flac",
                                "export_playlist_to_wav"])
@pytest.mark.parametrize("case", ["empty", "rate", "channels"])
def test_playlist_errors_match_jax(playlist, tmp_path, fn, case):
    import glc_tpu.album

    paths = list(playlist)
    if case == "empty":
        paths = []
    else:
        odd = (Encoder(48000, device="cpu").encode_pcm16(_tone(0.3, 2, 1), 2)
               if case == "rate" else
               Encoder(RATE, device="cpu").encode_pcm16(_tone(0.3, 1, 1), 1))
        save_encoded(odd, tmp_path / "odd.glc")
        paths.append(tmp_path / "odd.glc")
    args = [] if fn == "decode_playlist" else [tmp_path / "out"]
    with pytest.raises(ValueError) as jax_err:
        getattr(glc_tpu.album, fn)(paths, *args)
    with pytest.raises(ValueError) as port_err:
        getattr(album, fn)(paths, *args, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    assert not (tmp_path / "out").exists()


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("segmented", [False, True],
                         ids=["default", "segmented"])
def test_cuda_album_paths_are_exact(cuda_device, segmented):
    """On the card: encode_many equals the per-file encodes byte for byte,
    and decode_many equals decode_i16 bit for bit (the kernel computes each
    row alike at any row count), with one launch a group and a chunk as
    `launch_rows` predicts."""
    from glc_tpu_torch.ops.kernels import imdct_window

    cfg = _config(segmented)
    enc = Encoder(RATE, cfg, device=cuda_device)
    dec = Decoder(2, RATE, cfg, device=cuda_device)
    for mix in sorted(MIXES):
        items = MIXES[mix]()
        many = enc.encode_many(items)
        for (s, c), ea in zip(items, many):
            assert serialize_encoded(ea) == serialize_encoded(
                _solo(enc, s, c))
        imdct_window.launches = 0
        outs = dec.decode_many(many)
        assert imdct_window.launches == len(expected_rows(many, cfg))
        for ea, out in zip(many, outs):
            assert np.array_equal(out, dec.decode_i16(ea))


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_upload_concat_is_concatenate(device):
    """The batch paths' upload: the arrays back to back on the device, 1-D
    or 2-D, read-only ones too (a loaded container's arrays are views of
    the file's bytes)."""
    from glc_tpu_torch.codec.device import upload_concat

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    frozen = rng.integers(-9, 9, (3, 8)).astype(np.int16)
    frozen.flags.writeable = False
    for arrays in ([rng.standard_normal(5).astype(np.float32)],
                   [rng.integers(0, 99, n) for n in (4, 0, 7)],
                   [frozen, rng.integers(-9, 9, (2, 8)).astype(np.int16)]):
        got = upload_concat(arrays, torch.device(device))
        assert got.device.type == device
        assert np.array_equal(got.cpu().numpy(), np.concatenate(arrays))
