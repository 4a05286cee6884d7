"""The port's `glc` CLI (python -m glc_tpu_torch): WAV and FLAC inputs to
.glc, several inputs batched through `Encoder.encode_many`, .glc to FLAC
(the default, at any --flac-level) and to WAV, the lines it prints beside
the JAX package's CLI, and the usage with no arguments and no display.
Playback (`-p`) is tested in tests/test_torch_playback.py.

The CLI takes no device argument; these tests ask for the CPU through
GLC_TORCH_DEVICE=cpu, in this process and in the subprocesses."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import glc_tpu.cli as jax_cli
import glc_tpu_torch.cli as torch_cli
import pytest

from glc_tpu_torch import Decoder, Encoder, load_encoded, serialize_encoded
from glc_tpu_torch.flac.decoder import decode_flac
from glc_tpu_torch.flac.encoder import encode_flac_i16_with_level
from glc_tpu_torch.io.wav import read_wav_pcm16, write_wav_i16
from glc_tpu_torch.parity import check_containers

REPO = Path(__file__).resolve().parent.parent
RATE = 44100


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GLC_TORCH_DEVICE", "cpu")


def _pcm(seconds=0.5, channels=2):
    t = np.arange(int(RATE * seconds)) / RATE
    x = 0.4 * np.sin(2 * np.pi * 523.25 * t)
    return (np.repeat(x, channels) * 32767).astype(np.int16)


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), GLC_TORCH_DEVICE="cpu")
    return subprocess.run(
        [sys.executable, "-m", "glc_tpu_torch", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_wav_round_trip(tmp_path):
    pcm = _pcm()
    write_wav_i16(tmp_path / "tone.wav", pcm, RATE, 2)

    enc = _run(["tone.wav"], tmp_path)
    assert enc.returncode == 0, enc.stderr
    assert "Saved: 'tone.glc'" in enc.stdout
    (tmp_path / "tone.wav").rename(tmp_path / "orig.wav")

    dec = _run(["-d", "tone.glc", "--wav"], tmp_path)
    assert dec.returncode == 0, dec.stderr
    assert f"Decoded {len(pcm)} samples" in dec.stdout
    out, rate, channels = read_wav_pcm16(tmp_path / "tone.wav")
    assert (rate, channels, len(out)) == (RATE, 2, len(pcm))
    want = Decoder(2, RATE, device="cpu").decode_i16(
        load_encoded(tmp_path / "tone.glc"))
    assert np.array_equal(out, want)


def _decoded(glc):
    return Decoder(load_encoded(glc).header.channels, RATE,
                   device="cpu").decode_i16(load_encoded(glc))


def test_decode_writes_flac_by_default(tmp_path):
    write_wav_i16(tmp_path / "a.wav", _pcm(0.4, 1), RATE, 1)
    assert torch_cli.main([str(tmp_path / "a.wav")]) == 0
    proc = _run(["-d", "a.glc"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "Saved: 'a.flac' (FLAC, level 5)" in proc.stdout
    want = _decoded(tmp_path / "a.glc")
    data = (tmp_path / "a.flac").read_bytes()
    samples, rate, channels, bps = decode_flac(data)
    assert (rate, channels, bps) == (RATE, 1, 16)
    assert np.array_equal(samples, want.astype(np.int32))
    assert data == encode_flac_i16_with_level(want, RATE, 1, 5)


def test_flac_level_is_honoured(tmp_path):
    write_wav_i16(tmp_path / "b.wav", _pcm(0.4), RATE, 2)
    assert torch_cli.main([str(tmp_path / "b.wav")]) == 0
    assert torch_cli.main(["-d", str(tmp_path / "b.glc"),
                           "--flac-level", "8"]) == 0
    want = _decoded(tmp_path / "b.glc")
    data = (tmp_path / "b.flac").read_bytes()
    assert data == encode_flac_i16_with_level(want, RATE, 2, 8)
    assert data != encode_flac_i16_with_level(want, RATE, 2, 5)


def test_flac_input_is_encoded(tmp_path):
    """`glc x.flac`: a 16-bit FLAC takes the exact int16 encode."""
    pcm = _pcm(0.5)
    (tmp_path / "c.flac").write_bytes(
        encode_flac_i16_with_level(pcm, RATE, 2, 5))
    proc = _run(["c.flac"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[:2] == [
        "Loading: 'c.flac'", f"Encoding: {RATE} Hz, 2 channels, {len(pcm)} "
        "samples"]
    want = Encoder(RATE, device="cpu").encode_pcm16(pcm, 2)
    assert (serialize_encoded(load_encoded(tmp_path / "c.glc"))
            == serialize_encoded(want))


@pytest.mark.parametrize("source", ["wav", "flac"])
def test_flac_paths_print_the_same_lines_as_the_jax_cli(tmp_path, capsys,
                                                        source):
    """WAV or FLAC → .glc → FLAC with each package's CLI in this process:
    the same stdout, line for line."""
    pcm = _pcm(0.3)
    lines = {}
    for name, cli in (("jax", jax_cli), ("torch", torch_cli)):
        d = tmp_path / name
        d.mkdir()
        src = d / f"song.{source}"
        if source == "wav":
            write_wav_i16(src, pcm, RATE, 2)
        else:
            src.write_bytes(encode_flac_i16_with_level(pcm, RATE, 2, 5))
        assert cli.main([str(src)]) == 0
        src.unlink()
        assert cli.main(["-d", str(d / "song.glc"), "--flac-level", "3"]) == 0
        lines[name] = capsys.readouterr().out.splitlines()
    assert lines["torch"] == lines["jax"]
    assert len(lines["torch"]) == 7
    assert lines["torch"][-1] == "Saved: 'song.flac' (FLAC, level 3)"


def test_no_arguments_without_a_display_prints_usage(monkeypatch, capsys):
    """With no arguments both CLIs try the GUI; with no display they print
    the usage and exit 1."""
    monkeypatch.delenv("DISPLAY", raising=False)
    errs = []
    for cli in (jax_cli, torch_cli):
        assert cli.main([]) == 1
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1]
    assert "glc -p <file.glc> ... [--ffplay]" in errs[1]


def test_prints_the_same_lines_as_the_jax_cli(tmp_path, capsys):
    """Encode, then decode to WAV, with each package's CLI in this process
    (the port on the CPU, as there is no card here): the same stdout line
    for line."""
    pcm = _pcm(0.3)
    lines = {}
    for name, cli in (("jax", jax_cli), ("torch", torch_cli)):
        d = tmp_path / name
        d.mkdir()
        write_wav_i16(d / "song.wav", pcm, RATE, 2)
        assert cli.main([str(d / "song.wav")]) == 0
        (d / "song.wav").unlink()
        assert cli.main(["-d", str(d / "song.glc"), "--wav"]) == 0
        lines[name] = capsys.readouterr().out.splitlines()
    assert lines["torch"] == lines["jax"]
    assert len(lines["torch"]) == 7


def _album(d, specs):
    """Write one source file a spec (name, seconds, channels, rate) into
    `d`: WAV, or 16-bit FLAC for a .flac name; returns the paths and the
    int16 samples."""
    d.mkdir()
    paths, pcms = [], []
    for name, seconds, channels, rate in specs:
        pcm = _pcm(seconds, channels)
        if name.endswith(".flac"):
            (d / name).write_bytes(
                encode_flac_i16_with_level(pcm, rate, channels, 5))
        else:
            write_wav_i16(d / name, pcm, rate, channels)
        paths.append(d / name)
        pcms.append(pcm)
    return paths, pcms


ALBUM = [("one.wav", 0.4, 2, RATE), ("two.flac", 0.7, 2, RATE),
         ("three.wav", 0.3, 1, RATE), ("four.wav", 0.5, 2, 48000)]


@pytest.fixture
def encode_many_calls(monkeypatch):
    """The track counts of each `Encoder.encode_many` call."""
    from glc_tpu_torch.codec.encoder import Encoder as TorchEncoder

    calls = []
    real = TorchEncoder.encode_many

    def spy(self, items):
        calls.append(len(items))
        return real(self, items)

    monkeypatch.setattr(TorchEncoder, "encode_many", spy)
    return calls


def test_multi_file_encode_is_batched(tmp_path, capsys, encode_many_calls):
    """Four files in one call (WAV and FLAC, stereo and mono, two rates):
    one `encode_many` a rate, .glc files equal to the per-file encodes byte
    for byte and to the JAX CLI's within the pair contract (a ±1 flip moves
    a byte, not the size), the same stdout as the JAX CLI with the "Saved"
    lines in input order."""
    out = {}
    for name, cli in (("jax", jax_cli), ("torch", torch_cli)):
        paths, pcms = _album(tmp_path / name, ALBUM)
        assert cli.main([str(p) for p in paths]) == 0
        out[name] = capsys.readouterr().out.splitlines()
    assert encode_many_calls == [3, 1]
    assert out["torch"] == out["jax"]
    saved = [line for line in out["torch"] if line.startswith("Saved: ")]
    assert [line.split("'")[1] for line in saved] == [
        "one.glc", "two.glc", "three.glc", "four.glc"]
    for (name, _s, channels, rate), pcm in zip(ALBUM, pcms):
        glc = Path(name).with_suffix(".glc")
        got = serialize_encoded(load_encoded(tmp_path / "torch" / glc))
        want = Encoder(rate, device="cpu").encode_pcm16(pcm, channels)
        assert got == serialize_encoded(want), name
        check_containers(load_encoded(tmp_path / "torch" / glc),
                         load_encoded(tmp_path / "jax" / glc))


def test_encode_batches_flush_at_the_byte_bound(tmp_path, capsys,
                                                monkeypatch,
                                                encode_many_calls):
    """With the resident-PCM bound below one file, every file is its own
    batch, and its "Saved" line comes before the next file loads."""
    monkeypatch.setattr(torch_cli, "_ENCODE_BATCH_BYTES", 1)
    paths, _pcms = _album(tmp_path / "d", ALBUM[:3])
    assert torch_cli.main([str(p) for p in paths]) == 0
    assert encode_many_calls == [1, 1, 1]
    kinds = [line.split(":")[0]
             for line in capsys.readouterr().out.splitlines()]
    assert kinds == ["Loading", "Encoding", "Saved"] * 3


def test_failed_batch_retries_each_file(tmp_path, capsys, monkeypatch):
    """A batch that raises prints the JAX CLI's warning and encodes each
    file on its own, on the same device: the same .glc bytes."""
    from glc_tpu_torch.codec.encoder import Encoder as TorchEncoder

    def broken(self, items):
        raise RuntimeError("device lost")

    paths, pcms = _album(tmp_path / "d", ALBUM[:3])
    monkeypatch.setattr(TorchEncoder, "encode_many", broken)
    assert torch_cli.main([str(p) for p in paths]) == 0
    captured = capsys.readouterr()
    assert captured.err.splitlines() == [
        "Warning: batched encode failed (device lost); retrying files "
        "serially"]
    assert sum(line.startswith("Saved: ")
               for line in captured.out.splitlines()) == 3
    for (name, _s, channels, rate), pcm in zip(ALBUM, pcms):
        want = Encoder(rate, device="cpu").encode_pcm16(pcm, channels)
        assert (serialize_encoded(load_encoded(tmp_path / "d" / Path(
            name).with_suffix(".glc"))) == serialize_encoded(want)), name


def test_usage_errors_match(tmp_path, capsys):
    for args in (["-d"], ["-d", "missing.glc", "--wav"],
                 ["-d", "x.glc", "--wav", "--flac-level", "9"],
                 [str(tmp_path / "nope.mp3")]):
        codes = [cli.main(list(args)) for cli in (jax_cli, torch_cli)]
        assert codes[0] == codes[1] == 1, args
    capsys.readouterr()
