"""The JAX package's edge-case tests, run on both packages with the same
input: the reference's quirks and the hostile-container cases of
tests/test_quirks.py, the regressions of tests/test_review_regressions.py
and the NaN/Inf input of tests/test_fuzz.py.

Each case asserts the JAX test's property on each package and then holds
the port to the JAX package: containers within the pair contract
(glc_tpu_torch/parity.py) or equal byte for byte where the case is all
raw-PCM frames, decoded int16 within 1 LSB, FLAC bytes equal.  The port
runs on the CPU (`device="cpu"`, `GLC_TORCH_DEVICE=cpu` for the CLI and
the controller); the JAX package is imported inside the tests, so the
module collects without JAX.
"""

import importlib
import re
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from utils import (  # noqa: E402
    calculate_snr,
    generate_sine_wave,
    generate_white_noise,
)

from glc_tpu_torch.parity import check_containers  # noqa: E402

RATE = 44100
PACKAGES = ("glc_tpu", "glc_tpu_torch")


class Pkg:
    """One package's codec, built alike for both: the port on the CPU."""

    def __init__(self, name: str):
        self.name = name
        self.mod = importlib.import_module(name)
        self.kw = {"device": "cpu"} if name == "glc_tpu_torch" else {}

    def sub(self, path: str):
        return importlib.import_module(f"{self.name}.{path}")

    def config(self, compat: bool = True):
        return self.mod.CodecConfig(reference_compat=compat)

    def encode(self, samples, channels, compat: bool = True):
        return self.mod.Encoder(RATE, config=self.config(compat),
                                **self.kw).encode(samples, channels)

    def decoder(self, channels, compat: bool = True):
        return self.mod.Decoder(channels, RATE, config=self.config(compat),
                                **self.kw)

    def decode(self, encoded, compat: bool = True, **kwargs):
        return self.decoder(encoded.header.channels, compat).decode(
            encoded, **kwargs)

    def to_i16(self, samples):
        return self.sub("io.wav").convert_f32_to_i16(np.asarray(samples))

    def container(self, frames, channels=1, length=1024):
        """A container of `frames` ((pairs per channel, scales)), built
        with the package's own schema."""
        schema = self.sub("container.schema")
        return schema.EncodedAudio.from_frames(
            schema.AudioHeader(RATE, channels, length),
            [schema.EncodedFrame(sparse_coeffs_per_channel=pairs,
                                 scale_factors=np.asarray(scales, np.float32))
             for pairs, scales in frames],
            schema.GaplessInfo(512, 0, length))


@pytest.fixture(scope="module")
def pkgs():
    return [Pkg(name) for name in PACKAGES]


def assert_lsb(a, b, jax_pkg, port):
    """Decoded streams of the two packages within 1 LSB as int16."""
    assert len(a) == len(b)
    d = np.abs(jax_pkg.to_i16(a).astype(np.int32)
               - port.to_i16(b).astype(np.int32))
    assert d.max(initial=0) <= 1


def pairs(*kq):
    from glc_tpu_torch.container.schema import PAIR_DTYPE

    return np.array(list(kq), PAIR_DTYPE)


# --- tests/test_quirks.py ---

def q1_stereo(jax_pkg, port):
    """Q1 (codec.rs:755-767): the compat trim drains 512 interleaved
    samples, shifting stereo by 256 a channel; clean mode aligns."""
    s = generate_sine_wave(440.0, RATE, 2, 1.0)
    outs = []
    for p in (jax_pkg, port):
        ea = p.encode(s, 2)
        out = p.decode(ea)
        clean = p.decode(p.encode(s, 2, compat=False), compat=False)
        assert len(out) == len(clean) == len(s)
        assert calculate_snr(s[: len(s) - 512], out[512:]) > 20.0
        assert calculate_snr(s, clean) > 20.0
        assert calculate_snr(s, out) < 10.0
        outs.append((ea, out, clean))
    (jea, jout, jclean), (tea, tout, tclean) = outs
    check_containers(tea, jea)
    assert_lsb(jout, tout, jax_pkg, port)
    assert_lsb(jclean, tclean, jax_pkg, port)


def q1_mono(jax_pkg, port):
    """For mono, interleaved units are per-channel units: both modes
    align."""
    s = generate_sine_wave(440.0, RATE, 1, 1.0)
    outs = []
    for p in (jax_pkg, port):
        compat = p.decode(p.encode(s, 1))
        clean = p.decode(p.encode(s, 1, compat=False), compat=False)
        assert calculate_snr(s, compat) > 20.0
        np.testing.assert_allclose(compat, clean, atol=1e-6)
        outs.append(compat)
    assert_lsb(*outs, jax_pkg, port)


def q2_padding(jax_pkg, port):
    """Q2: GaplessInfo.padding is written (codec.rs:546), though never
    read."""
    s = generate_sine_wave(440.0, RATE, 1, 1.0)
    T, lead = 44100, 512
    P = lead + T
    P = P + (1024 - P % 1024) % 1024 + lead
    infos = []
    for p in (jax_pkg, port):
        g = p.encode(s, 1).gapless_info
        assert (g.padding, g.encoder_delay, g.original_length) == (
            P - T - lead, 512, len(s))
        infos.append((g.padding, g.encoder_delay, g.original_length))
    assert infos[0] == infos[1]


def q4_raw_single_windowed(jax_pkg, port):
    """Q4 (codec.rs:496-502 vs 626-643): raw frames are windowed at encode
    only, so mono noise comes back ~1.27× louder in compat mode; clean
    mode re-windows.  All frames are raw: the containers are equal."""
    s = generate_white_noise(RATE, 1, 1.0, 7)
    rms_in = float(np.sqrt(np.mean(s[2048:-2048] ** 2)))
    blobs, outs = [], []
    for p in (jax_pkg, port):
        ea, clean_ea = p.encode(s, 1), p.encode(s, 1, compat=False)
        compat = p.decode(ea)
        clean = p.decode(clean_ea, compat=False)
        rms = [float(np.sqrt(np.mean(x[2048:-2048] ** 2)))
               for x in (compat, clean)]
        assert rms[0] / rms_in > 1.15
        assert abs(rms[1] / rms_in - 1.0) < 0.02
        assert calculate_snr(s, clean) > 40.0
        blobs.append([p.mod.serialize_encoded(e) for e in (ea, clean_ea)])
        outs.append((compat, clean))
    assert blobs[0] == blobs[1]
    for a, b in zip(*outs):
        assert_lsb(a, b, jax_pkg, port)


def q13_channel_scramble(jax_pkg, port):
    """Q13 (codec.rs:471-503 vs 636): raw PCM is stored channel-major and
    read back interleaved, scrambling stereo raw frames in compat mode;
    clean mode reconstructs.  All frames are raw: the containers are
    equal."""
    left = generate_white_noise(RATE, 1, 0.5, 1)
    right = generate_white_noise(RATE, 1, 0.5, 2)
    s = np.empty(2 * len(left), np.float32)
    s[0::2], s[1::2] = left, right
    blobs, outs = [], []
    for p in (jax_pkg, port):
        ea, clean_ea = p.encode(s, 2), p.encode(s, 2, compat=False)
        assert bool(ea.frame_set.raw_mask.all())
        compat = p.decode(ea)
        clean = p.decode(clean_ea, compat=False)
        assert calculate_snr(s, compat) < 0.0
        assert calculate_snr(s, clean) > 40.0
        blobs.append([p.mod.serialize_encoded(e) for e in (ea, clean_ea)])
        outs.append((compat, clean))
    assert blobs[0] == blobs[1]
    for a, b in zip(*outs):
        assert_lsb(a, b, jax_pkg, port)


def out_of_range_k(jax_pkg, port):
    """A foreign .glc with k = 2000 ≥ n decodes, the pair skipped
    (codec.rs:661)."""
    outs = []
    for p in (jax_pkg, port):
        out = p.decode(p.container([([pairs((5, 1000), (2000, 5000))],
                                     [0.5])]))
        assert len(out) == 1024 and np.isfinite(out).all()
        # the same as the container without the out-of-range pair
        np.testing.assert_array_equal(out, p.decode(p.container(
            [([pairs((5, 1000))], [0.5])])))
        outs.append(out)
    assert_lsb(*outs, jax_pkg, port)


def progress_sequence(jax_pkg, port):
    """Status → Decoding(pct) a 500-frame flush → Complete, the same
    messages from both packages but the time."""
    s = generate_sine_wave(440.0, RATE, 1, 12.0)  # 517 frames
    seqs = []
    for p in (jax_pkg, port):
        ea = p.encode(s, 1)
        F = len(ea.frames)
        assert F > 500
        msgs = []
        p.decode(ea, progress_sender=msgs.append)
        kinds = [m.kind.name for m in msgs]
        assert kinds == ["STATUS"] + ["DECODING"] * (F // 500) + ["COMPLETE"]
        assert msgs[0].value == f"Starting streaming decode of {F} frames"
        assert abs(msgs[1].value - 499 / F * 100.0) < 1e-6
        assert re.fullmatch(rf"Decoded {F} frames in \d+\.\d\ds",
                            msgs[-1].value)
        seqs.append((kinds, [m.value for m in msgs[:-1]]))
    assert seqs[0] == seqs[1]


def duplicate_last_wins(jax_pkg, port):
    """Duplicate indices scatter last-wins (codec.rs:660-663)."""
    outs = []
    for p in (jax_pkg, port):
        out = p.decode(p.container(
            [([pairs((5, 1000), (5, -2000), (9, 300))], [0.5])]))
        np.testing.assert_array_equal(out, p.decode(p.container(
            [([pairs((5, -2000), (9, 300))], [0.5])])))
        outs.append(out)
    assert_lsb(*outs, jax_pkg, port)


QUIRKS = [q1_stereo, q1_mono, q2_padding, q4_raw_single_windowed,
          q13_channel_scramble, out_of_range_k, progress_sequence,
          duplicate_last_wins]


@pytest.mark.parametrize("case", QUIRKS, ids=lambda f: f.__name__)
def test_quirk(pkgs, case):
    case(*pkgs)


# --- tests/test_review_regressions.py ---

def ragged_streaming_flac(jax_pkg, port, tmp_path, monkeypatch):
    """A stream whose length is not a multiple of the channels exports
    like the whole-array path, which drops the fractional sample."""
    rng = np.random.default_rng(3)
    i16 = (rng.standard_normal(44100 + 1) * 6000).astype(np.int16)
    blobs = []
    for p in (jax_pkg, port):
        flac = p.sub("flac.encoder")
        ref = flac.encode_flac_i16_with_level(i16, RATE, 2, 5)
        got = flac.encode_flac_i16_streaming(
            iter([i16[:30000], i16[30000:]]), RATE, 2, 5, len(i16) // 2)
        assert got == ref
        blobs.append(got)
    assert blobs[0] == blobs[1]


def ragged_glc_to_flac_cli(jax_pkg, port, tmp_path, monkeypatch):
    """Ragged stereo → .glc → each CLI's FLAC export (the streaming path):
    the JAX package's container, decoded by both CLIs, within 1 LSB."""
    monkeypatch.setenv("GLC_TORCH_DEVICE", "cpu")
    s = generate_sine_wave(440.0, RATE, 2, 0.5)[:-1]
    ea = jax_pkg.encode(s, 2)
    outs = []
    for p in (jax_pkg, port):
        path = tmp_path / p.name / "ragged.glc"
        path.parent.mkdir()
        jax_pkg.mod.save_encoded(ea, path)
        assert p.sub("cli").main(["-d", str(path)]) == 0
        out = path.with_suffix(".flac")
        assert out.exists() and out.stat().st_size > 0
        pcm, rate, channels, _bits = p.sub("flac").decode_flac(
            out.read_bytes())
        assert (rate, channels) == (RATE, 2)
        outs.append(np.asarray(pcm).reshape(-1).astype(np.int32))
    assert len(outs[0]) == len(outs[1])
    assert np.abs(outs[0] - outs[1]).max(initial=0) <= 1


def huge_duplicate_row(jax_pkg, port, tmp_path, monkeypatch):
    """70 000 pairs in one frame-channel, full of duplicates: last-wins,
    not a wrapped count."""
    F, big = 3, 70000
    rng = np.random.default_rng(0)
    nnz = np.zeros((F, 1), np.int64)
    nnz[1, 0], nnz[2, 0] = big, 4
    ks = rng.integers(0, 8, big).astype(np.uint16)
    qs = rng.integers(-3000, 3000, big).astype(np.int16)
    ks[-1], qs[-1] = 5, 1234
    last = {}
    for k, q in zip(ks, qs):
        last[int(k)] = int(q)
    assert last[5] == 1234
    dk = np.array(sorted(last), np.uint16)
    rows = {"dup": (ks, qs, big),
            "dedup": (dk, np.array([last[int(k)] for k in dk], np.int16),
                      len(dk))}
    outs = []
    for p in (jax_pkg, port):
        schema = p.sub("container.schema")
        decoded = {}
        for name, (k, q, count) in rows.items():
            pr = np.zeros(count + 4, schema.PAIR_DTYPE)
            pr["k"][:count], pr["q"][:count] = k, q
            pr["k"][count:] = [1, 2, 3, 4]
            pr["q"][count:] = [100, -100, 50, -50]
            nz = nnz.copy()
            nz[1, 0] = count
            fs = schema.FrameSet(nz, pr, np.ones((F, 1), np.float32),
                                 np.zeros(F, bool),
                                 np.empty((0, 2048), np.int16))
            decoded[name] = p.decode(schema.EncodedAudio(
                schema.AudioHeader(RATE, 1, 4096), fs,
                schema.GaplessInfo(512, 0, 4096)))
        assert len(decoded["dup"]) == 3584
        assert np.isfinite(decoded["dup"]).all()
        np.testing.assert_array_equal(decoded["dup"], decoded["dedup"])
        outs.append(decoded["dup"])
    assert_lsb(*outs, jax_pkg, port)


def controller_error_status(jax_pkg, port, tmp_path, monkeypatch):
    """A decode error during GUI playback stays visible, not overwritten by
    'Playback finished'."""

    class NullSink:
        def append(self, source):
            return True

        def close(self):
            return 0

    # the port's stream_playlist_sources also takes the device
    def failing(paths, stop=None, on_file=None, on_error=None, device=None):
        for path in paths:
            if on_file is not None:
                on_file(path, RATE, 1)
            if on_error is not None:
                on_error(path, "synthetic decode failure")
        return iter(())

    snaps = []
    for p in (jax_pkg, port):
        good = tmp_path / f"{p.name}.glc"
        p.mod.save_encoded(
            p.encode(generate_sine_wave(440.0, RATE, 1, 0.2), 1), good)
        ctl = p.sub("controller").CodecController(
            sink_factory=lambda r, c: NullSink(), **p.kw)
        ctl.encoded_files = [good]
        ctl.add_to_playlist([0])
        monkeypatch.setattr(p.sub("playback"), "stream_playlist_sources",
                            failing)
        ctl.play_gapless(wait=True)
        snap = ctl.snapshot()
        assert (snap.status, snap.detail, snap.playing) == (
            "Decode error", "synthetic decode failure", False)
        snaps.append((snap.status, snap.detail, snap.playing))
    assert snaps[0] == snaps[1]


REGRESSIONS = [ragged_streaming_flac, ragged_glc_to_flac_cli,
               huge_duplicate_row, controller_error_status]


@pytest.mark.parametrize("case", REGRESSIONS, ids=lambda f: f.__name__)
def test_review_regression(pkgs, case, tmp_path, monkeypatch):
    case(*pkgs, tmp_path, monkeypatch)


# --- tests/test_fuzz.py ---

@pytest.mark.parametrize("channels", [1, 2])
def test_encode_nan_inf_input(pkgs, channels):
    """NaN/Inf samples: no crash, a valid container that round-trips to
    the input's length, and the two packages' containers within the pair
    contract."""
    s = generate_sine_wave(440.0, RATE, channels, 0.2)
    s[100], s[200], s[300] = np.nan, np.inf, -np.inf
    encoded = []
    for p in pkgs:
        ea = p.encode(s, channels)
        fs = ea.frame_set
        assert len(fs.pairs) == int(fs.nnz.sum())
        back = p.mod.deserialize_encoded(p.mod.serialize_encoded(ea))
        assert len(p.decode(back)) == len(s)
        encoded.append(ea)
    jea, tea = encoded
    check_containers(tea, jea)
