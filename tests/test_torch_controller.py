"""The port's headless GUI controller (glc_tpu_torch.controller) and its
tkinter view (glc_tpu_torch.ui), on the CPU.

The cases of tests/test_controller.py run on the port with
`device="cpu"`, and each action is held to the port's own entry point:
`encode_selected` writes `Encoder.encode_pcm16`'s containers byte for byte
(and agrees with glc_tpu's within the pair contract, glc_tpu_torch/parity.py),
`play_gapless` feeds its sink `stream_playlist_sources`' stream, and
`export_playlist` writes `album.export_playlist_to_flac`'s bytes.  The view
tests of tests/test_ui_view.py drive real poll() cycles where a display
exists ($DISPLAY, or an Xvfb started here) and skip where none does.
"""

import inspect
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest

from glc_tpu_torch import Encoder, load_encoded, save_encoded
from glc_tpu_torch import album
from glc_tpu_torch.container.bincode import serialize_encoded
from glc_tpu_torch.controller import CodecController
from glc_tpu_torch.flac.decoder import read_flac
from glc_tpu_torch.flac.encoder import encode_flac_i16_with_level
from glc_tpu_torch.io.wav import write_wav_i16
from glc_tpu_torch.parity import check_containers
from glc_tpu_torch.playback import stream_playlist_sources

RATE = 44100


class MockSink:
    def __init__(self, sample_rate, channels, log):
        self.sample_rate = sample_rate
        self.channels = channels
        self.parts = []
        self.closed = False
        log.append(self)

    def write(self, samples):
        self.parts.append(np.asarray(samples, np.float32))
        return True

    def append(self, source):
        return self.write(source.remaining())

    def close(self):
        self.closed = True
        return 0


def _tone(seconds, channels, seed):
    """Interleaved int16 from numpy.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(RATE * seconds)) / RATE
    x = np.stack([0.4 * np.sin(2 * np.pi * rng.uniform(200, 900) * t)
                  for _c in range(channels)], axis=1)
    return (x * 32767).astype(np.int16).reshape(-1)


@pytest.fixture()
def wav_files(tmp_path):
    """A mono and a stereo 16-bit WAV, with their samples."""
    out = []
    for name, seconds, channels, seed in (("tone.wav", 0.5, 1, 1),
                                          ("duo.wav", 0.3, 2, 2)):
        pcm = _tone(seconds, channels, seed)
        write_wav_i16(tmp_path / name, pcm, RATE, channels)
        out.append((tmp_path / name, pcm, channels))
    return out


@pytest.fixture()
def glc_files(tmp_path):
    paths = []
    for i in range(2):
        ea = Encoder(RATE, device="cpu").encode_pcm16(_tone(0.3, 1, 10 + i), 1)
        p = tmp_path / f"t{i}.glc"
        save_encoded(ea, p)
        paths.append(p)
    return paths


def test_file_and_playlist_management(glc_files):
    ctl = CodecController(device="cpu")
    ctl.add_files(["a.wav", "a.wav", "b.wav"])  # dedup (ui.rs file picker)
    assert [p.name for p in ctl.selected_files] == ["a.wav", "b.wav"]

    ctl.encoded_files = list(glc_files)
    ctl.add_to_playlist([1, 0, 7])  # out-of-range index ignored
    assert [p.name for p in ctl.playlist] == ["t1.glc", "t0.glc"]
    ctl.clear_playlist()
    assert ctl.playlist == []

    snap = ctl.snapshot()
    assert snap.status == "Ready"
    assert snap.playing is False
    assert snap.encode_progress is None


def test_encode_selected_produces_glc(wav_files):
    """Each .glc is `Encoder.encode_pcm16`'s container byte for byte and
    agrees with glc_tpu's within the pair contract."""
    import glc_tpu

    ctl = CodecController(device="cpu")
    ctl.add_files([p for p, _pcm, _c in wav_files])
    ctl.encode_selected(wait=True)
    snap = ctl.snapshot()
    assert snap.status == "Encoded 2/2"
    assert snap.encoded_files == [p.with_suffix(".glc") for p, _x, _c in
                                  wav_files]
    assert snap.encode_progress is None  # progress bar cleared
    for path, pcm, channels in wav_files:
        got = load_encoded(path.with_suffix(".glc"))
        want = Encoder(RATE, device="cpu").encode_pcm16(pcm, channels)
        assert serialize_encoded(got) == serialize_encoded(want)
        check_containers(got, glc_tpu.Encoder(RATE).encode_pcm16(pcm,
                                                                 channels))


def test_encode_selected_continue_on_error(tmp_path, wav_files):
    bad = tmp_path / "missing.wav"
    good = wav_files[0][0]
    ctl = CodecController(device="cpu")
    ctl.add_files([bad, good])
    ctl.encode_selected(wait=True)
    snap = ctl.snapshot()
    # the bad file errored, the good one still encoded (ui.rs:90-156 /
    # CLI continue-on-error semantics)
    assert snap.status == "Encoded 2/2"
    assert good.with_suffix(".glc").exists()
    assert snap.encoded_files == [good.with_suffix(".glc")]


def test_encode_nothing_selected():
    ctl = CodecController(device="cpu")
    assert ctl.encode_selected() is None
    assert ctl.snapshot().status == "No files selected"


def test_play_gapless_mock_sink(glc_files):
    """One sink across the boundary, fed `stream_playlist_sources`' stream
    sample for sample."""
    log = []
    ctl = CodecController(sink_factory=lambda r, c: MockSink(r, c, log),
                          device="cpu")
    ctl.encoded_files = list(glc_files)
    ctl.add_to_playlist([0, 1])
    ctl.play_gapless(wait=True)
    snap = ctl.snapshot()
    assert snap.status == "Playback finished"
    assert snap.playing is False
    assert len(log) == 1  # same format → one sink across the boundary
    assert log[0].closed
    want = np.concatenate([s.remaining() for s in stream_playlist_sources(
        glc_files, device="cpu")])
    np.testing.assert_array_equal(np.concatenate(log[0].parts), want)


def test_play_gapless_empty_playlist():
    ctl = CodecController(device="cpu")
    assert ctl.play_gapless() is None


def test_play_gapless_stop_flag(glc_files):
    """The stop flag is honored between chunks (ui.rs stop-flag-per-chunk,
    ui.rs:224-271): a stop raised after the first chunk ends playback before
    the second file streams."""
    log = []
    ctl = CodecController(device="cpu")

    class StoppingSink(MockSink):
        def append(self, source):
            ok = super().append(source)
            ctl.stop_playing()  # raise stop from the consumer side
            return ok

    ctl._sink_factory = lambda r, c: StoppingSink(r, c, log)
    ctl.encoded_files = list(glc_files)
    ctl.add_to_playlist([0, 1])
    ctl.play_gapless(wait=True)
    # exactly one chunk was written before the stop took effect
    assert sum(len(s.parts) for s in log) == 1
    assert ctl.snapshot().status == "Playback stopped"
    assert ctl.snapshot().playing is False
    assert all(s.closed for s in log)


def test_export_playlist_flac(glc_files, tmp_path):
    """The album FLAC is `album.export_playlist_to_flac`'s, byte for byte:
    the gapless concatenation of both decodes."""
    ctl = CodecController(device="cpu")
    ctl.encoded_files = list(glc_files)
    ctl.add_to_playlist([0, 1])
    out = tmp_path / "album.flac"
    ctl.export_playlist(out, compression_level=3, wait=True)
    snap = ctl.snapshot()
    assert snap.status == "Export complete"
    assert snap.export_progress is None

    album.export_playlist_to_flac(glc_files, tmp_path / "want.flac", 3,
                                  device="cpu")
    assert out.read_bytes() == (tmp_path / "want.flac").read_bytes()
    samples, rate, ch = read_flac(out)
    assert rate == RATE and ch == 1
    assert len(samples) == int(RATE * 0.3) * 2


def test_export_empty_playlist(tmp_path):
    ctl = CodecController(device="cpu")
    assert ctl.export_playlist(tmp_path / "x.flac") is None
    assert ctl.snapshot().status == "Playlist is empty"


def test_test_audio_device_plays_the_flac(tmp_path):
    """The device test writes the FLAC's samples to one sink and closes it."""
    pcm = _tone(0.2, 2, 3)
    flac = tmp_path / "probe.flac"
    flac.write_bytes(encode_flac_i16_with_level(pcm, RATE, 2, 5))
    log = []
    ctl = CodecController(sink_factory=lambda r, c: MockSink(r, c, log),
                          device="cpu")
    ctl.test_audio_device(flac, wait=True)
    assert ctl.snapshot().status == "Device test finished"
    (sink,) = log
    assert (sink.sample_rate, sink.channels, sink.closed) == (RATE, 2, True)
    want, _rate, _ch = read_flac(flac)
    np.testing.assert_array_equal(np.concatenate(sink.parts), want)


def test_ui_imports_and_uses_controller():
    """ui.py imports without a display and is a view over the port's
    CodecController."""
    import glc_tpu_torch.ui

    assert hasattr(glc_tpu_torch.ui, "run_gui")
    assert glc_tpu_torch.ui.CodecController is CodecController
    assert "import tkinter" not in inspect.getsource(glc_tpu_torch.ui).split(
        "def build_gui")[0]


# --- the tkinter view, under a display ---


def _display():
    """Return (display, proc-or-None) for a usable X display, else None."""
    if os.environ.get("DISPLAY"):
        return os.environ["DISPLAY"], None
    xvfb = shutil.which("Xvfb")
    if not xvfb:
        return None
    disp = ":94"
    proc = subprocess.Popen(
        [xvfb, disp, "-screen", "0", "640x480x24"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    time.sleep(0.5)
    if proc.poll() is not None:
        return None
    return disp, proc


@pytest.fixture(scope="module")
def gui():
    probe = _display()
    if probe is None:
        pytest.skip(
            "no X display: $DISPLAY unset and Xvfb not present on PATH "
            "(probed at test time; install Xvfb to exercise the view)"
        )
    disp, proc = probe
    old = os.environ.get("DISPLAY")
    os.environ["DISPLAY"] = disp
    try:
        from glc_tpu_torch.ui import build_gui

        ctl = CodecController(device="cpu")
        try:
            root, poll = build_gui(ctl)
        except Exception as e:  # display exists but Tk can't open it
            pytest.skip(f"Tk could not open display {disp}: {e}")
        yield ctl, root, poll
        root.destroy()
    finally:
        if old is None:
            os.environ.pop("DISPLAY", None)
        else:
            os.environ["DISPLAY"] = old
        if proc is not None:
            proc.terminate()
            proc.wait(timeout=5)


def test_poll_syncs_status_and_listbox(gui):
    ctl, root, poll = gui
    ctl.set_status("Hello", "detail text")
    ctl.encoded_files.append(Path("/tmp/x.glc"))
    poll()
    root.update()
    boxes = [w for w in root.winfo_children()[0].winfo_children()
             if w.winfo_class() == "Listbox"]
    assert any(b.get(0, "end") == ("x.glc",) for b in boxes)


def test_poll_packs_and_forgets_progress(gui):
    ctl, root, poll = gui
    bars = [w for w in root.winfo_children()[0].winfo_children()
            if w.winfo_class() == "TProgressbar"]
    assert bars
    with ctl._lock:
        ctl._encode_progress = 42.0
    poll()
    root.update()
    assert any(b.winfo_ismapped() for b in bars)
    with ctl._lock:
        ctl._encode_progress = None
    poll()
    root.update()
    assert not any(b.winfo_ismapped() for b in bars)
