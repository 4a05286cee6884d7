"""The port's playback layer (glc_tpu_torch.playback) and `glc -p`, against
the JAX package's (glc_tpu.playback, glc_tpu.cli), on the CPU.

The cases of tests/test_playback.py run on the port: the SamplesSource
chunk stream, gapless continuity across file boundaries, the stop event,
one sink for a same-format playlist and a restart on a format change, and
the audio-device sink against a fake `sounddevice`.  Parity: the same .glc
files through both packages' `stream_playlist_sources` give the same chunk
lengths and samples within 1e-5 (the bound tests/test_torch_stream.py
holds `decode_streaming` to), and each track's part of the stream, trimmed,
is the port's `Decoder.decode`.  `-p` and `-p --ffplay` run against a stub
`ffplay` first on PATH that appends its stdin to a file, with the audio
device probe forced off, so no sound card is needed.

The JAX package is imported inside the tests.  The tests marked `cuda`
need a card and skip here; on the card's machine, which has no JAX, run
them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_playback.py
"""

import dataclasses
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import glc_tpu_torch
import glc_tpu_torch.cli as torch_cli
from glc_tpu_torch import Decoder, Encoder, load_encoded, save_encoded
from glc_tpu_torch import playback
from glc_tpu_torch.codec import decoder as tdecoder
from glc_tpu_torch.codec.decoder import PRODUCER_NAME, gapless_trim_bounds
from glc_tpu_torch.playback import (
    AudioDeviceSink,
    SamplesSource,
    audio_device_available,
    play_files_gapless,
    stream_playlist_sources,
)

RATE = 44100
# Decode chunks of 128 frames flushed every 64 frames: a track of a few
# hundred frames crosses both kinds of chunk boundary.
SMALL_CHUNKS = {"frames_per_chunk": 64, "decode_chunk_frames": 128}
STREAM_TOL = 1e-5


class MockSink:
    """Collects everything appended; records close order."""

    def __init__(self, sample_rate, channels, log=None):
        self.sample_rate = sample_rate
        self.channels = channels
        self.parts = []
        self.closed = False
        self.log = log if log is not None else []
        self.log.append(self)

    def write(self, samples):
        self.parts.append(np.asarray(samples, np.float32))
        return True

    def append(self, source):
        return self.write(source.remaining())

    def close(self):
        self.closed = True
        return 0

    def samples(self):
        return np.concatenate(self.parts) if self.parts else np.empty(0)


def _tone(seconds, channels, seed, rate=RATE):
    """Interleaved int16 from numpy.random.default_rng(seed): a tone of a
    random pitch a channel with a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    x = np.stack([0.4 * np.sin(2 * np.pi * rng.uniform(200, 900) * t)
                  + 0.01 * rng.standard_normal(len(t))
                  for _c in range(channels)], axis=1)
    return (x * 32767).astype(np.int16).reshape(-1)


def _glc(path, seconds, channels, seed, rate=RATE):
    ea = Encoder(rate, device="cpu").encode_pcm16(
        _tone(seconds, channels, seed, rate), channels)
    save_encoded(ea, path)
    return path


@pytest.fixture(scope="module")
def two_glc_files(tmp_path_factory):
    """Two short mono .glc files with different tones."""
    d = tmp_path_factory.mktemp("playback")
    return [_glc(d / f"tone{i}.glc", 0.5, 1, seed=i) for i in range(2)]


def _producers():
    return [t for t in threading.enumerate()
            if t.name == PRODUCER_NAME and t.is_alive()]


def _untrimmed(path, device="cpu"):
    """The track's untrimmed decode_streaming chunks, in order."""
    ea = load_encoded(path)
    rx = Decoder(ea.header.channels, ea.header.sample_rate,
                 device=device).decode_streaming(ea)
    parts = []
    while True:
        chunk = rx.get(timeout=60)
        assert chunk.error is None
        parts.append(chunk.samples)
        if chunk.is_last:
            return parts


def test_samples_source_iter_and_remaining():
    src = SamplesSource(np.arange(6, dtype=np.float32), 44100, 2)
    assert next(src) == 0.0 and next(src) == 1.0
    rest = src.remaining()
    assert rest.tolist() == [2.0, 3.0, 4.0, 5.0]
    with pytest.raises(StopIteration):
        next(src)
    # rodio::Source metadata parity (playback.rs:44-66)
    assert src.current_frame_len() is None
    assert src.total_duration() is None


def test_stream_sources_gapless_continuity(two_glc_files):
    """Chunks from the shared source, appended back-to-back, equal the
    per-file untrimmed streaming outputs concatenated — sample-exact gapless
    joins at the file boundary (main.rs:152-161)."""
    meta = []
    streamed = np.concatenate([
        src.remaining() for src in stream_playlist_sources(
            two_glc_files, on_file=lambda p, r, c: meta.append((p.name, r, c)),
            device="cpu")
    ])
    expected = np.concatenate([p for path in two_glc_files
                               for p in _untrimmed(path)])
    np.testing.assert_array_equal(streamed, expected)
    assert meta == [("tone0.glc", 44100, 1), ("tone1.glc", 44100, 1)]


def test_stream_sources_stop_event(two_glc_files):
    """A stop after the first chunk ends the stream, and no producer thread
    outlives it."""
    stop = threading.Event()
    got = 0
    for _src in stream_playlist_sources(two_glc_files, stop=stop,
                                        device="cpu"):
        got += 1
        stop.set()
    assert got == 1  # aborted after the first chunk
    assert _producers() == []


def test_play_files_gapless_mock_sink(two_glc_files, capsys):
    """The gapless player feeds one sink across file boundaries and closes
    it once (same rate/channels → no sink restart)."""
    log = []
    play_files_gapless(
        two_glc_files, sink_factory=lambda r, c: MockSink(r, c, log),
        device="cpu",
    )
    assert len(log) == 1  # one sink for the whole same-format playlist
    sink = log[0]
    assert sink.closed
    assert (sink.sample_rate, sink.channels) == (44100, 1)
    assert len(sink.parts) >= 2  # both files' untrimmed streams arrived
    out = capsys.readouterr().out
    assert "Playing 2 files gaplessly" in out
    assert "Playback finished" in out


def test_play_files_gapless_restarts_sink_on_format_change(
    two_glc_files, tmp_path
):
    p48 = _glc(tmp_path / "tone48k.glc", 0.25, 1, seed=5, rate=48000)
    log = []
    play_files_gapless(
        [two_glc_files[0], p48],
        sink_factory=lambda r, c: MockSink(r, c, log),
        device="cpu",
    )
    assert [s.sample_rate for s in log] == [44100, 48000]
    assert all(s.closed for s in log)
    np.testing.assert_array_equal(log[1].samples(),
                                  np.concatenate(_untrimmed(p48)))


def test_play_files_gapless_empty_raises():
    with pytest.raises(ValueError):
        play_files_gapless([])


def _fake_sounddevice():
    """A minimal fake of the sounddevice API used by AudioDeviceSink."""
    mod = types.ModuleType("sounddevice")
    written = []

    class OutputStream:
        def __init__(self, samplerate, channels, dtype):
            self.samplerate = samplerate
            self.channels = channels
            self.dtype = dtype
            self.started = False
            self.closed = False

        def start(self):
            self.started = True

        def write(self, data):
            written.append(np.asarray(data))

        def stop(self):
            self.started = False

        def close(self):
            self.closed = True

    mod.OutputStream = OutputStream
    mod._written = written
    return mod


def test_audio_device_sink_sounddevice(monkeypatch):
    fake = _fake_sounddevice()
    monkeypatch.setitem(sys.modules, "sounddevice", fake)
    assert audio_device_available()

    sink = AudioDeviceSink(44100, 2)
    assert sink.backend_name == "sounddevice"
    src = SamplesSource(np.arange(8, dtype=np.float32), 44100, 2)
    assert sink.append(src)
    assert sink.close() == 0
    (chunk,) = fake._written
    assert chunk.shape == (4, 2)  # interleaved → frames × channels


def test_audio_device_sink_unavailable(monkeypatch):
    for name in ("sounddevice", "simpleaudio"):
        monkeypatch.setitem(sys.modules, name, None)  # import → ImportError
    assert not audio_device_available()
    with pytest.raises(RuntimeError):
        AudioDeviceSink(44100, 2)


# --- parity with glc_tpu.playback ---


@pytest.fixture
def small_chunks(monkeypatch):
    """Both packages' decoders at SMALL_CHUNKS (their default config)."""
    import glc_tpu
    import glc_tpu.codec.decoder as jdecoder

    monkeypatch.setattr(tdecoder, "DEFAULT_CONFIG", dataclasses.replace(
        glc_tpu_torch.DEFAULT_CONFIG, **SMALL_CHUNKS))
    monkeypatch.setattr(jdecoder, "DEFAULT_CONFIG", dataclasses.replace(
        glc_tpu.DEFAULT_CONFIG, **SMALL_CHUNKS))


@pytest.fixture(scope="module")
def playlist(tmp_path_factory):
    """A mono track of 224 frames (decode chunks of 128 and 96 frames,
    three flushes of 64 and a last chunk) and a short stereo one."""
    d = tmp_path_factory.mktemp("parity")
    return [_glc(d / "long.glc", 5.2, 1, seed=11),
            _glc(d / "short.glc", 0.4, 2, seed=12)]


def test_stream_matches_jax(playlist, small_chunks):
    """The same chunk count and lengths as glc_tpu's stream, samples within
    STREAM_TOL; each track's part, trimmed, is the port's Decoder.decode."""
    import glc_tpu.playback

    assert load_encoded(playlist[0]).frame_set.num_frames == 224
    runs = {}
    for name, stream in (
        ("jax", glc_tpu.playback.stream_playlist_sources(playlist)),
        ("torch", stream_playlist_sources(playlist, device="cpu")),
    ):
        runs[name] = [(s.sample_rate, s.channels, s.remaining())
                      for s in stream]
    jax, port = runs["jax"], runs["torch"]
    assert [(r, c, len(x)) for r, c, x in port] == [
        (r, c, len(x)) for r, c, x in jax]
    assert len(port) == 4 + 1  # 224 frames: 3 flushes + the last; 1
    for (_r, _c, a), (_r2, _c2, b) in zip(port, jax):
        np.testing.assert_allclose(a, b, atol=STREAM_TOL, rtol=0)

    # split the port's stream into tracks by channel count and trim each
    for path, channels in zip(playlist, (1, 2)):
        ea = load_encoded(path)
        full = np.concatenate([x for _r, c, x in port if c == channels])
        skip, limit = gapless_trim_bounds(len(full), ea.gapless_info,
                                          channels, True)
        want = Decoder(channels, RATE, device="cpu").decode(ea)
        np.testing.assert_array_equal(full[skip : skip + limit], want)


def test_cancelled_stream_waits_for_its_downloads(playlist, monkeypatch):
    """Flushes of 8 frames: the producer fills the queue from the first
    decode chunk while the second one's download is in flight.  A consumer
    that stops after one chunk cancels it there; the producer waits on that
    download too before it ends, and has ended when the generator
    returns."""
    monkeypatch.setattr(tdecoder, "DEFAULT_CONFIG", dataclasses.replace(
        glc_tpu_torch.DEFAULT_CONFIG, frames_per_chunk=8,
        decode_chunk_frames=128))
    made, waited = [], []

    class Download(tdecoder._Download):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def wait(self):
            waited.append(self)
            return super().wait()

    monkeypatch.setattr(tdecoder, "_Download", Download)
    stop = threading.Event()
    for _src in stream_playlist_sources(playlist, stop=stop, device="cpu"):
        stop.set()
    assert _producers() == []
    assert len(made) == 2 and all(d in waited for d in made)


# --- glc -p against a stub ffplay ---


@pytest.fixture
def stub_ffplay(tmp_path, monkeypatch):
    """An `ffplay` first on PATH that records its arguments and appends its
    stdin to a file; returns (bytes-so-far reader, argument lines reader).
    The audio device probe is off in both packages, so playback takes the
    ffplay pipe."""
    import glc_tpu.playback

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    out, args = tmp_path / "ffplay.f32", tmp_path / "ffplay.args"
    stub = bin_dir / "ffplay"
    stub.write_text('#!/bin/sh\necho "$@" >> "$STUB_ARGS"\n'
                    'cat >> "$STUB_OUT"\n')
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("STUB_OUT", str(out))
    monkeypatch.setenv("STUB_ARGS", str(args))
    monkeypatch.setenv("GLC_TORCH_DEVICE", "cpu")
    for mod in (playback, glc_tpu.playback):
        monkeypatch.setattr(mod, "_probe_device_backend", lambda: None)

    def take():
        """(f32 samples, argument lines) since the last call."""
        got = (np.frombuffer(out.read_bytes(), "<f4"),
               args.read_text().splitlines())
        out.unlink()
        args.unlink()
        return got

    return take


@pytest.fixture(scope="module")
def cli_playlist(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    return [_glc(d / "a.glc", 0.4, 2, seed=21), _glc(d / "b.glc", 0.3, 2,
                                                     seed=22)]


@pytest.mark.parametrize("flags", [[], ["--ffplay"]], ids=["gapless",
                                                          "ffplay"])
def test_play_matches_the_jax_cli(cli_playlist, stub_ffplay, capsys, flags):
    """`-p a.glc b.glc` (one ffplay for the playlist) and `-p --ffplay`
    (one a file): exit 0, the JAX CLI's stdout line for line, the stub's
    f32le bytes equal the port's stream and within STREAM_TOL of the JAX
    CLI's."""
    import glc_tpu.cli as jax_cli

    argv = ["-p", *flags, *map(str, cli_playlist)]
    runs = {}
    for name, cli in (("jax", jax_cli), ("torch", torch_cli)):
        assert cli.main(list(argv)) == 0
        runs[name] = (capsys.readouterr().out.splitlines(), *stub_ffplay())
    (jout, jbytes, jargs), (tout, tbytes, targs) = runs["jax"], runs["torch"]
    assert tout == jout
    assert tout[-1] == "Playback finished"
    assert targs == jargs == ["-f f32le -ar 44100 -ac 2 -nodisp -autoexit -"
                              ] * (2 if flags else 1)
    want = np.concatenate([s.remaining() for s in stream_playlist_sources(
        cli_playlist, device="cpu")])
    np.testing.assert_array_equal(tbytes, want)
    assert len(tbytes) == len(jbytes)
    np.testing.assert_allclose(tbytes, jbytes, atol=STREAM_TOL, rtol=0)


@pytest.mark.parametrize("args", [
    ["-p"], ["-p", "--ffplay"], ["-p", "missing.glc"],
    ["-p", "--ffplay", "missing.glc"], ["-p", "NOT_GLC"],
], ids=["no-files", "ffplay-no-files", "missing", "ffplay-missing",
        "not-glc"])
def test_play_errors_match_the_jax_cli(cli_playlist, tmp_path, capsys, args,
                                       stub_ffplay):
    import glc_tpu.cli as jax_cli

    (tmp_path / "x.wav").write_bytes(b"RIFF")
    args = [str(tmp_path / "x.wav") if a == "NOT_GLC" else a for a in args]
    got = []
    for cli in (jax_cli, torch_cli):
        code = cli.main(list(args))
        captured = capsys.readouterr()
        got.append((code, captured.out, captured.err))
    assert got[0] == got[1]
    assert got[1][0] == 1


def test_play_without_any_backend_fails_like_the_jax_cli(cli_playlist,
                                                        monkeypatch, capsys):
    """No audio device library and no ffplay: exit 1 with the JAX CLI's
    lines, and nothing decoded."""
    import glc_tpu.cli as jax_cli
    import glc_tpu.playback

    monkeypatch.setenv("PATH", "")
    for mod in (playback, glc_tpu.playback):
        monkeypatch.setattr(mod, "_probe_device_backend", lambda: None)
    got = []
    for cli in (jax_cli, torch_cli):
        code = cli.main(["-p", *map(str, cli_playlist)])
        got.append((code, capsys.readouterr().err))
    assert got[0] == got[1]
    assert got[1][0] == 1 and "Playback not available" in got[1][1]


# --- on the card ---


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_playback_equals_the_cpu_stream(cuda_device, two_glc_files):
    """The playlist streamed from the card (imdct_window a chunk) equals the
    CPU's stream within STREAM_TOL, chunk for chunk."""
    from glc_tpu_torch.ops.kernels import imdct_window

    streams = {}
    for dev in ("cpu", cuda_device):
        imdct_window.launches = 0
        streams[str(dev)] = [s.remaining() for s in stream_playlist_sources(
            two_glc_files, device=dev)]
    assert imdct_window.launches == len(two_glc_files)
    assert [len(x) for x in streams["cuda"]] == [len(x)
                                                 for x in streams["cpu"]]
    for a, b in zip(streams["cuda"], streams["cpu"]):
        np.testing.assert_allclose(a, b, atol=STREAM_TOL, rtol=0)


@pytest.mark.cuda
def test_cuda_stop_leaves_no_producer(cuda_device, tmp_path):
    """A sink that stops playback after its first chunk of a 30 s stereo
    track: one chunk written, no producer thread left, and the card has no
    error to report."""
    path = _glc(tmp_path / "long.glc", 30.0, 2, seed=31)
    stop = threading.Event()
    log = []

    class StoppingSink(MockSink):
        def append(self, source):
            ok = super().append(source)
            stop.set()
            return ok

    t0 = time.monotonic()
    play_files_gapless([path, path], lambda r, c: StoppingSink(r, c, log),
                       stop=stop, device=cuda_device)
    assert sum(len(s.parts) for s in log) == 1
    assert _producers() == []
    assert time.monotonic() - t0 < 30
    torch.cuda.synchronize()
