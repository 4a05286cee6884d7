"""tests/test_streaming_export.py and tests/test_dense_fallback.py on the
port, where tests/test_torch_stream.py and tests/test_torch_flac.py do not
already hold them.

Streaming export (ops/decode.py, codec/decoder.py's `decode_i16_stream`,
flac/encoder.py's streaming encoder, album.py, cli.py): the streamed
samples and FLAC bytes equal the batch path's exactly, on the inputs of
the JAX tests; where both packages encode, the containers are within the
pair contract and the JAX package's container decodes within 1 LSB by
both (`Codecs.run` of tests/test_torch_suites.py); FLAC bytes of the same
int16 equal the JAX package's encoder's.  Already held elsewhere, so left
out here: test_streaming_flac_incremental_matches_whole_pack
(tests/test_torch_flac.py::test_streaming_bytes_equal_whole_stream, with
GLC_FLAC_WHOLE_PACK on and off).

Dense fallback: the port has no density tiers, no dense program and no
stats-only probe (ROADMAP "Not ported"), so the JAX tests' program-count
assertions (the `count_programs` fixture: dense dispatches, probes) are
left out.  What they promise about output is held: mid-range density
(~40% kept) and past-the-crossover density (~65%) give self-consistent
containers within the pair contract of the JAX package's, that decode to
their length and, in clean mode, within 0.5 relative RMS error; the bytes
do not depend on an earlier encode (the JAX package's density hint); a
frame inside a short prefix encodes as it does in the long signal.

The test marked `cuda` runs the stream-versus-batch cases on the card,
held to the CPU port: the stream equals decode_i16 bit for bit, the FLAC
bytes the batch encode of it, the decode within 1 LSB of the CPU's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_rates import (  # noqa: E402,F401  (fixtures of the cuda twin)
    check_kernel_rows, cuda_device, launched_rows, max_lsb,
)
from test_torch_suites import Codecs, assert_lsb  # noqa: E402
from utils import generate_sine_wave, generate_white_noise  # noqa: E402

from glc_tpu_torch import (  # noqa: E402
    CodecConfig, Decoder, Encoder, deserialize_encoded, load_encoded,
    save_encoded, serialize_encoded,
)
from glc_tpu_torch.flac.decoder import decode_flac  # noqa: E402
from glc_tpu_torch.flac.encoder import (  # noqa: E402
    FlacError, encode_flac_i16_streaming, encode_flac_i16_with_level,
)
from glc_tpu_torch.parity import check_containers  # noqa: E402

RATE = 44100


@pytest.fixture(scope="module")
def codecs():
    return Codecs()


# --- tests/test_streaming_export.py ---

def _tone_noise():
    """1.6 s of tone then 1.6 s of white noise, mono: over 128 frames, with
    raw-PCM frames."""
    tone = generate_sine_wave(440.0, RATE, 1, 1.6)
    noise = generate_white_noise(RATE, 1, 1.6, 5)
    return np.concatenate([tone, noise]).astype(np.float32)


STREAM_CASES = {
    # name -> (samples, channels, decode_chunk_frames or None)
    "mono_2s": (lambda: generate_sine_wave(440.0, RATE, 1, 2.0), 1, None),
    "stereo_1s": (lambda: generate_sine_wave(440.0, RATE, 2, 1.0), 2, None),
    "mono_0.05s": (lambda: generate_sine_wave(440.0, RATE, 1, 0.05), 1, None),
    "raw_frames_chunk128": (_tone_noise, 1, 128),
}


@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_decode_stream_equals_batch(codecs, name):
    """decode_i16_stream concatenates to decode_i16 exactly, and
    decoded_length is its length; the chunk-128 case with raw frames is
    really chunked."""
    make, channels, chunk = STREAM_CASES[name]
    s = make()
    ea = codecs.run(s, RATE, channels).et
    cfg = None if chunk is None else CodecConfig(decode_chunk_frames=chunk)
    dec = Decoder(channels, RATE, config=cfg, device="cpu")
    batch = dec.decode_i16(ea)
    parts = list(dec.decode_i16_stream(ea))
    np.testing.assert_array_equal(np.concatenate(parts), batch)
    assert dec.decoded_length(ea) == len(batch) == len(s)
    if chunk is not None:
        assert int(ea.frame_set.raw_mask.sum()) > 0
        assert ea.frame_set.num_frames > chunk
        assert len(parts) > 1


def _awkward_chunks(i16: np.ndarray, rng) -> list:
    cuts = np.sort(rng.choice(len(i16) - 2, 7, replace=False) + 1)
    return np.split(i16, cuts)


@pytest.mark.parametrize("level", [0, 3, 5, 8])
def test_streaming_flac_byte_identity(level):
    """Stereo int16 fed in chunks that align with nothing: the streamed
    bytes equal the whole-stream encode's and the JAX package's."""
    from glc_tpu.flac.encoder import encode_flac_i16_with_level as jax_encode

    rng = np.random.default_rng(0)
    i16 = (rng.standard_normal(RATE * 2) * 8000).astype(np.int16)
    ref = encode_flac_i16_with_level(i16, RATE, 2, level)
    got = encode_flac_i16_streaming(iter(_awkward_chunks(i16, rng)), RATE, 2,
                                    level, len(i16) // 2)
    assert got == ref == jax_encode(i16, RATE, 2, level)


def test_streaming_flac_single_chunk_and_partial_tail():
    """A total off the block size: a partial last block, 48 kHz mono."""
    from glc_tpu.flac.encoder import encode_flac_i16_with_level as jax_encode

    rng = np.random.default_rng(1)
    total = 4096 * 2 + 1234
    i16 = (rng.standard_normal(total) * 5000).astype(np.int16)
    ref = encode_flac_i16_with_level(i16, 48000, 1, 5)
    assert encode_flac_i16_streaming(iter([i16]), 48000, 1, 5, total) == ref
    assert ref == jax_encode(i16, 48000, 1, 5)


def test_streaming_flac_length_mismatch_rejected():
    """A declared length the stream does not have: FlacError, with the JAX
    package's message."""
    from glc_tpu.flac.encoder import FlacError as JaxFlacError
    from glc_tpu.flac.encoder import encode_flac_i16_streaming as jax_stream

    i16 = np.zeros(1000, np.int16)
    with pytest.raises(FlacError) as got:
        encode_flac_i16_streaming(iter([i16]), RATE, 1, 5, 999)
    with pytest.raises(JaxFlacError) as want:
        jax_stream(iter([i16]), RATE, 1, 5, 999)
    assert str(got.value) == str(want.value)


def test_stream_chunk_override_byte_identical(codecs):
    """The stream's chunk_frames (None, 1024, 256, 128) changes nothing:
    the same FLAC bytes, the batch encode's."""
    s = generate_sine_wave(440.0, RATE, 2, 2.2)
    ea = codecs.run(s, RATE, 2).et
    dec = Decoder(2, RATE, device="cpu")
    n_total = dec.decoded_length(ea)
    outs = [encode_flac_i16_streaming(
        dec.decode_i16_stream(ea, chunk_frames=kf), RATE, 2, 5, n_total // 2)
        for kf in (None, 1024, 256, 128)]
    assert all(o == outs[0] for o in outs[1:])
    assert outs[0] == encode_flac_i16_with_level(dec.decode_i16(ea), RATE, 2, 5)


def test_cli_decode_uses_streaming_path(tmp_path, capsys, monkeypatch):
    """cli.main: WAV -> .glc -> FLAC prints the decode and level-5 lines;
    the FLAC is the batch encode of decode_i16 of the .glc, within 1 LSB
    of the JAX package's decode of it; the .glc within the pair contract
    of the JAX package's encode of the WAV."""
    import glc_tpu

    from glc_tpu_torch.cli import main
    from glc_tpu_torch.io.wav import read_wav, write_wav

    monkeypatch.setenv("GLC_TORCH_DEVICE", "cpu")
    s = generate_sine_wave(440.0, RATE, 2, 0.5)
    wav = tmp_path / "t.wav"
    write_wav(wav, s, RATE, 2)
    assert main([str(wav)]) == 0
    glc = wav.with_suffix(".glc")
    assert main(["-d", str(glc)]) == 0
    out = capsys.readouterr().out
    assert "Decoded " in out and "(FLAC, level 5)" in out
    ea = load_encoded(glc)
    i16 = Decoder(2, RATE, device="cpu").decode_i16(ea)
    data = wav.with_suffix(".flac").read_bytes()
    assert data == encode_flac_i16_with_level(i16, RATE, 2, 5)
    assert max_lsb(decode_flac(data)[0],
                   glc_tpu.Decoder(2, RATE).decode_i16(ea)) <= 1
    samples, _rate, _ch = read_wav(wav)
    check_containers(glc_tpu.Encoder(RATE).encode(samples, 2), ea)


def test_album_export_streaming_byte_identity(tmp_path, codecs):
    """export_playlist_to_flac of two mono tracks equals the whole-stream
    encode of their decode_i16s; the JAX package's export of the same
    files decodes within 1 LSB of it."""
    import glc_tpu.album

    from glc_tpu_torch.album import export_playlist_to_flac

    paths = []
    for i, f in enumerate((440.0, 660.0)):
        p = tmp_path / f"t{i}.glc"
        save_encoded(codecs.run(generate_sine_wave(f, RATE, 1, 0.4),
                                RATE, 1).et, p)
        paths.append(p)
    out = tmp_path / "album.flac"
    export_playlist_to_flac(paths, out, 5, device="cpu")
    dec = Decoder(1, RATE, device="cpu")
    full = np.concatenate([dec.decode_i16(load_encoded(p)) for p in paths])
    assert out.read_bytes() == encode_flac_i16_with_level(full, RATE, 1, 5)
    glc_tpu.album.export_playlist_to_flac(paths, tmp_path / "j.flac", 5)
    assert max_lsb(decode_flac(out.read_bytes())[0],
                   decode_flac((tmp_path / "j.flac").read_bytes())[0]) <= 1


# --- tests/test_dense_fallback.py ---

def bandlimited_noise(duration_s: float, channels: int, frac: float = 0.4,
                      sample_rate: int = RATE, seed: int = 7) -> np.ndarray:
    """tests/test_dense_fallback.py's white noise lowpassed to `frac` of
    the spectrum (about `frac` of the coefficients kept), copied."""
    rng = np.random.default_rng(seed)
    T = int(sample_rate * duration_s)
    chans = []
    for _ in range(channels):
        x = rng.standard_normal(T)
        X = np.fft.rfft(x)
        X[int(len(X) * frac):] = 0
        y = np.fft.irfft(X, T)
        chans.append(y / np.abs(y).max() * 0.5)
    out = np.empty(T * channels, np.float32)
    for c, y in enumerate(chans):
        out[c::channels] = y
    return out


def check_container(codecs, run, channels: int) -> None:
    """tests/test_dense_fallback.py's check on the port's container:
    self-consistent, a byte-stable round trip, the decode's length, and
    in clean mode a relative RMS error under 0.5."""
    ea, samples = run.et, run.samples
    fs = ea.frame_set
    assert len(fs.pairs) == int(fs.nnz.sum())
    assert len(fs.raw_pcm) == int(fs.raw_mask.sum())
    assert (fs.nnz[fs.raw_mask] == 0).all()
    assert (fs.scales > 0).all()
    data = serialize_encoded(ea)
    assert serialize_encoded(deserialize_encoded(data)) == data
    assert len(run.out) == len(samples)
    clean = codecs.run(samples, RATE, channels, compat=False).out
    assert len(clean) == len(samples)
    a, b = samples[1000:-1000], clean[1000:-1000]
    assert np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(a ** 2)) < 0.5


@pytest.mark.parametrize("channels,duration,frac,lo,hi", [
    (1, 2.0, 0.4, 0.15, 0.50),   # mid-range, past the standard tier
    (2, 1.0, 0.4, 0.15, 0.50),
    (1, 2.0, 0.65, 0.50, 0.80),  # past the 50% byte crossover
], ids=["midrange_mono", "midrange_stereo", "past_crossover"])
def test_density_container(codecs, channels, duration, frac, lo, hi):
    """The kept density in the JAX test's range, not all raw, the
    container checked and within the pair contract of the JAX package's."""
    run = codecs.run(bandlimited_noise(duration, channels, frac=frac),
                     RATE, channels)
    fs = run.et.frame_set
    density = fs.nnz[~fs.raw_mask].mean() / 1024
    assert lo < density < hi
    assert not fs.raw_mask.all()
    check_container(codecs, run, channels)


@pytest.mark.parametrize("frac", [0.4, 0.65], ids=["midrange", "dense"])
def test_density_hint_cannot_change_bytes(codecs, frac):
    """The same content encoded cold and warm by one Encoder, and by a
    fresh one: the same bytes, the container within the pair contract of
    the JAX package's."""
    samples = bandlimited_noise(2.0, 1, frac=frac)
    enc = Encoder(RATE, device="cpu")
    d1 = serialize_encoded(enc.encode(samples, 1))
    d2 = serialize_encoded(enc.encode(samples, 1))
    d3 = serialize_encoded(Encoder(RATE, device="cpu").encode(samples, 1))
    assert d1 == d2 == d3 == serialize_encoded(codecs.run(samples, RATE, 1).et)


def test_prefix_frame_matches_the_long_signal(codecs):
    """Frame 4 of a 0.25 s prefix and of the 2 s signal it is cut from
    sees the same samples: kept counts within 2, equal scales, 99% of the
    shared pairs equal (tests/test_dense_fallback.py:154-187)."""
    long = bandlimited_noise(2.0, 1)
    short = long[: int(RATE * 0.25)].copy()
    fs_s = codecs.run(short, RATE, 1).et.frame_set
    fs_l = codecs.run(long, RATE, 1).et.frame_set
    f = 4
    n_s, n_l = int(fs_s.nnz[f, 0]), int(fs_l.nnz[f, 0])
    assert n_s > 100
    assert abs(n_s - n_l) <= 2
    assert fs_s.scales[f, 0] == fs_l.scales[f, 0]
    off_s, off_l = int(fs_s.nnz[:f].sum()), int(fs_l.nnz[:f].sum())
    m = min(n_s, n_l)
    ps, pl = fs_s.pairs[off_s: off_s + m], fs_l.pairs[off_l: off_l + m]
    assert ((ps["k"] == pl["k"]) & (ps["q"] == pl["q"])).mean() > 0.99


# --- on the card ---

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_cuda_stream_equals_batch(cuda_device, launched_rows, name):
    """The stream cases on the card: the stream equals decode_i16 bit for
    bit, its FLAC the batch encode's, the container within the pair
    contract of the CPU port's and the decode within 1 LSB of the CPU's;
    each kernel held to plain at every row count the case launched it
    with (tests/test_torch_rates.py's `check_kernel_rows`)."""
    make, channels, chunk = STREAM_CASES[name]
    s = make()
    cfg = CodecConfig() if chunk is None else CodecConfig(
        decode_chunk_frames=chunk)
    ea = Encoder(RATE, device="cuda").encode(s, channels)
    check_containers(ea, Encoder(RATE, device="cpu").encode(s, channels))
    dec = Decoder(channels, RATE, config=cfg, device="cuda")
    batch = dec.decode_i16(ea)
    parts = list(dec.decode_i16_stream(ea))
    np.testing.assert_array_equal(np.concatenate(parts), batch)
    n_total = dec.decoded_length(ea)
    assert n_total == len(batch) == len(s)
    data = encode_flac_i16_streaming(iter(parts), RATE, channels, 5,
                                     n_total // channels)
    assert data == encode_flac_i16_with_level(batch, RATE, channels, 5)
    want = Decoder(channels, RATE, config=cfg, device="cpu").decode_i16(ea)
    assert max_lsb(batch, want) <= 1
    assert_lsb(dec.decode(ea), Decoder(channels, RATE, config=cfg,
                                       device="cpu").decode(ea))
    check_kernel_rows(RATE, launched_rows)
