"""The stages of the port's encode and decode loops (`StageClock`): the
``stats=`` keys and the profiler's ``glc.*`` spans from the same
boundaries, on the CPU.

- Output: equal, bytes and bits, with and without `stats`, under a
  profiler or not.  A stage only reads the clock and opens a span.
- The encode's keys: every stage non-negative, the five stages within
  ``wall_ms`` (they are disjoint parts of it, on one clock).
  `encode_many`'s counts: the sum of its tracks' per-file counts, exact.
- The spans: ``glc.encode`` once a track, its stages nested in it
  (``prep``, ``unpack`` and ``assemble`` once, ``disp`` once a segment
  and once for the upload, ``wait`` once a segment and once for the
  pairs' and raw rows' downloads after the last),
  ``glc.container.serialize`` once a `serialize_encoded`, and the
  decode's ``glc.decode.{pack,disp,wait}`` where its hook has stages.
- Off (no `stats`, no profiler): a stage reads no clock and opens no span.

The `cuda` test skips here; on the card's machine, which has no JAX, run
it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_stages.py
"""

import types
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import profile

from glc_tpu_torch import (
    CodecConfig, Decoder, Encoder, profiling, serialize_encoded,
)
from glc_tpu_torch.codec import device as device_mod
from glc_tpu_torch.codec.device import StageClock
from glc_tpu_torch.codec.encoder import STATS_KEYS, upload_geometry
from glc_tpu_torch.codec.tables import chunk_size_for

RATE = 44100
STAGES = ("prep_ms", "disp_ms", "wait_ms", "unpack_ms", "assemble_ms")
COUNTS = ("up_n", "down_n")
CFG = CodecConfig(encode_chunk_frames=64, decode_chunk_frames=32)
ENTRIES = ("encode", "encode_pcm16", "encode_many")


def signals():
    """Seeded stereo int16 with a burst of noise (raw-PCM frames), the same
    as float with a ragged sample count, and a float mono tone."""
    rng = np.random.default_rng(11)
    t = np.arange(int(2.5 * RATE)) / RATE
    x = np.repeat(0.4 * np.sin(2 * np.pi * 330.0 * t), 2)
    x[RATE : RATE + RATE // 2] = rng.uniform(-0.7, 0.7, RATE // 2)
    i16 = (x * 32767.0).astype(np.int16)
    f32 = (i16[:-1] / 32768.0).astype(np.float32)  # ragged: zero-completed
    mono = (0.3 * np.sin(2 * np.pi * 440.0 * t[: RATE])).astype(np.float32)
    return i16, f32, mono


def tracks(entry):
    """The (samples, channels) an entry encodes."""
    i16, f32, mono = signals()
    return {"encode": [(f32, 2)], "encode_pcm16": [(i16, 2)],
            "encode_many": [(i16, 2), (f32, 2), (mono, 1)]}[entry]


def run(enc, entry, stats=None):
    """The containers of one call of `entry`, serialized."""
    items = tracks(entry)
    if entry == "encode_many":
        eas = enc.encode_many(items, stats=stats)
    else:
        eas = [getattr(enc, entry)(*items[0], stats=stats)]
    return [serialize_encoded(ea) for ea in eas]


def segments(samples, channels):
    return len(upload_geometry(len(samples), channels, CFG)[3])


def glc_spans(prof):
    """(name, start µs, end µs) of every ``glc.*`` span of the trace."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("glc.")]


@pytest.fixture(scope="module")
def enc():
    return Encoder(RATE, config=CFG, device="cpu")


@pytest.mark.parametrize("entry", ENTRIES)
def test_stage_keys_fit_in_the_wall(enc, entry):
    plain = run(enc, entry)
    stats: dict = {}
    assert run(enc, entry, stats) == plain
    assert set(stats) == set(STATS_KEYS)
    assert all(stats[k] >= 0 for k in STATS_KEYS)
    assert stats["wall_ms"] > 0 and stats["disp_ms"] > 0
    assert sum(stats[k] for k in STAGES) <= stats["wall_ms"]
    assert stats["up_n"] == len(tracks(entry))


def test_encode_many_sums_its_tracks(enc):
    items = tracks("encode_many")
    per_file = []
    for samples, channels in items:
        st: dict = {}
        entry = enc.encode_pcm16 if samples.dtype == np.int16 else enc.encode
        entry(samples, channels, stats=st)
        per_file.append(st)
    many: dict = {}
    enc.encode_many(items, stats=many)
    assert set(many) == set(STATS_KEYS)
    for key in COUNTS:
        assert many[key] == sum(st[key] for st in per_file), key
    assert many["down_n"] > 2 * len(items)  # several segments a track
    # a second call into the same dict adds to it
    enc.encode_many(items, stats=many)
    assert many["up_n"] == 2 * len(items)


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("entry", ENTRIES)
def test_stages_are_nested_spans_under_a_profiler(enc, entry, with_stats):
    plain = run(enc, entry)
    stats = {} if with_stats else None
    with profile() as prof:
        got = run(enc, entry, stats)
    assert got == plain
    spans = glc_spans(prof)
    names = Counter(name for name, _a, _b in spans)
    items = tracks(entry)
    segs = sum(segments(s, c) for s, c in items)
    assert names["glc.encode"] == len(items)
    assert names["glc.encode.prep"] == names["glc.encode.assemble"] == len(
        items)
    assert names["glc.encode.unpack"] == len(items)
    assert names["glc.encode.disp"] == names["glc.encode.wait"] == len(
        items) + segs
    assert names["glc.container.serialize"] == len(items)
    calls = [(a, b) for name, a, b in spans if name == "glc.encode"]
    for name, a, b in spans:
        if name.startswith("glc.encode."):
            assert any(a0 <= a and b <= b1 for a0, b1 in calls), name
        if name == "glc.container.serialize":
            assert not any(a0 <= a < b1 for a0, b1 in calls)
    if with_stats:
        assert set(stats) == set(STATS_KEYS)


def test_decoder_stages_are_spans(enc):
    """The decode's pack, disp and wait are spans where its hook has
    stages: a chunk of decode_i16 packs once, dispatches twice (the
    uploads and launches; the download) and waits once."""
    eas = [enc.encode(s, c) for s, c in tracks("encode_many")[1:]]
    dec = Decoder(2, RATE, config=CFG, device="cpu")
    plain = [dec.decode_i16(ea) for ea in eas]
    chunks = sum(-(-F // chunk_size_for(F, 32))
                 for F in (ea.frame_set.num_frames for ea in eas))
    for stats in (None, {}):
        with profile() as prof:
            got = [dec.decode_i16(ea, stats=stats) for ea in eas]
        for a, b in zip(got, plain, strict=True):
            np.testing.assert_array_equal(a, b)
        names = Counter(name for name, _a, _b in glc_spans(prof))
        assert names == {"glc.decode.pack": chunks,
                         "glc.decode.disp": 2 * chunks,
                         "glc.decode.wait": chunks}


def test_a_stage_reads_no_clock_and_opens_no_span_when_off(enc,
                                                           monkeypatch):
    monkeypatch.delenv("GLC_PROFILE", raising=False)
    plain = run(enc, "encode_many")
    off = StageClock(None, STATS_KEYS, "encode")
    assert off.stage("prep") is profiling.OFF and off.call() is profiling.OFF

    def boom(*_a, **_k):
        raise AssertionError("read or opened while off")

    # `stats` alone reads the clock but opens no span
    monkeypatch.setattr(profiling, "stage", boom)
    stats: dict = {}
    assert run(enc, "encode_many", stats) == plain and stats["wall_ms"] > 0
    monkeypatch.setattr(device_mod, "time",
                        types.SimpleNamespace(perf_counter=boom))
    assert run(enc, "encode_many") == plain


def test_stage_clock_keys():
    stats: dict = {"a_ms": 1.0}
    clock = StageClock(stats, ("a_ms", "wall_ms", "b_n"), "t")
    assert stats == {"a_ms": 1.0, "wall_ms": 0.0, "b_n": 0}
    with profile() as prof:
        with clock.call():
            with clock.stage("a"):
                pass
            clock.count("b_n", 3)
    assert stats["b_n"] == 3 and stats["a_ms"] >= 1.0
    assert stats["wall_ms"] >= stats["a_ms"] - 1.0
    # the clock decides on spans when it is made: this one was made
    # before the profiler
    assert glc_spans(prof) == []
    with profile() as prof:
        clock = StageClock(None, (), "t")
        with clock.call(), clock.stage("a"):
            pass
    assert [n for n, _a, _b in glc_spans(prof)] == ["glc.t", "glc.t.a"]


def test_a_raising_call_closes_its_stages(enc):
    stats: dict = {}
    with profile() as prof:
        with pytest.raises(ValueError, match="empty"):
            enc.encode_pcm16(np.zeros(0, np.int16), 2, stats=stats)
    names = Counter(n for n, _a, _b in glc_spans(prof))
    assert names == {"glc.encode": 1, "glc.encode.prep": 1}
    assert stats["prep_ms"] <= stats["wall_ms"] and stats["up_n"] == 0


@pytest.mark.cuda
def test_cuda_stages_are_inert_and_spanned():
    """On the card: the bytes with and without `stats` and under a
    profiler, the keys and the spans, as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    enc = Encoder(RATE, config=CFG, device="cuda")
    plain = run(enc, "encode_many")
    stats: dict = {}
    with profile() as prof:
        assert run(enc, "encode_many", stats) == plain
    assert sum(stats[k] for k in STAGES) <= stats["wall_ms"]
    names = Counter(n for n, _a, _b in glc_spans(prof))
    items = tracks("encode_many")
    segs = sum(segments(s, c) for s, c in items)
    assert names["glc.encode"] == len(items)
    assert names["glc.encode.unpack"] == len(items)
    assert names["glc.encode.wait"] == len(items) + segs
    assert names["glc.container.serialize"] == len(items)
