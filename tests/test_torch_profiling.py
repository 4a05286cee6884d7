"""The port's profiling hooks (glc_tpu_torch.profiling), on the CPU.

Without GLC_PROFILE `maybe_trace` does nothing and writes nothing.  With it
set, each traced entry point (`Encoder.encode`, `encode_pcm16`,
`encode_many`, `Decoder.decode_i16`, `decode`) writes a torch.profiler
Chrome trace under ``$GLC_PROFILE/<name>`` that holds a span of its name,
and returns what it returns untraced, bit for bit, and holds the program's
stage spans (``glc.encode.*``, ``glc.decode.*``).
"""

import contextlib
import json

import numpy as np
import pytest

from glc_tpu_torch import Decoder, Encoder, serialize_encoded
from glc_tpu_torch import profiling

RATE = 44100


def _pcm(seconds=0.4, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(RATE * seconds)) / RATE
    x = 0.4 * np.sin(2 * np.pi * rng.uniform(200, 900) * t)
    x = np.repeat(x, channels) + 0.01 * rng.standard_normal(len(t) * channels)
    return (x * 32767).astype(np.int16)


def _events(log_dir):
    """The names of every event of the traces under `log_dir`."""
    files = sorted(log_dir.glob("*.pt.trace.json"))
    assert files, f"no trace written under {log_dir}"
    return {e.get("name") for f in files
            for e in json.loads(f.read_text())["traceEvents"]}


def test_maybe_trace_is_a_no_op_without_the_variable(monkeypatch, tmp_path):
    monkeypatch.delenv("GLC_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    assert isinstance(profiling.maybe_trace("decode_i16"),
                      contextlib.nullcontext)
    Decoder(2, RATE, device="cpu").decode_i16(
        Encoder(RATE, device="cpu").encode_pcm16(_pcm(), 2))
    assert list(tmp_path.iterdir()) == []


def _calls():
    """name -> (the call, how its result is compared)."""
    pcm = _pcm()
    enc = Encoder(RATE, device="cpu")
    dec = Decoder(2, RATE, device="cpu")
    ea = enc.encode_pcm16(pcm, 2)
    return {
        "encode": lambda: serialize_encoded(
            enc.encode(pcm.astype(np.float32) / 32768.0, 2)),
        "encode_pcm16": lambda: serialize_encoded(enc.encode_pcm16(pcm, 2)),
        "encode_many": lambda: [serialize_encoded(e) for e in
                                enc.encode_many([(pcm, 2), (pcm[:4000], 1)])],
        "decode_i16": lambda: dec.decode_i16(ea).tobytes(),
        "decode": lambda: dec.decode(ea).tobytes(),
    }


# encode and encode_pcm16 share the span "encode" (glc_tpu's name)
SPANS = {"encode": "encode", "encode_pcm16": "encode",
         "encode_many": "encode_many", "decode_i16": "decode_i16",
         "decode": "decode"}


@pytest.mark.parametrize("entry", sorted(SPANS))
def test_entry_point_writes_its_span(monkeypatch, tmp_path, entry):
    call = _calls()[entry]
    monkeypatch.delenv("GLC_PROFILE", raising=False)
    plain = call()
    monkeypatch.setenv("GLC_PROFILE", str(tmp_path))
    traced = call()
    assert traced == plain
    span = SPANS[entry]
    assert [p.name for p in tmp_path.iterdir()] == [span]
    assert span in _events(tmp_path / span)


def test_trace_and_annotate(tmp_path):
    """`trace` around a call labelled with `annotate`: one trace file in the
    directory, holding the label."""
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("phase"):
            Decoder(1, RATE, device="cpu").decode_i16(
                Encoder(RATE, device="cpu").encode_pcm16(_pcm(0.2, 1), 1))
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1
    assert "phase" in _events(tmp_path)


STAGE_SPANS = {
    "encode": {"glc.encode", "glc.encode.prep", "glc.encode.disp",
               "glc.encode.wait", "glc.encode.unpack", "glc.encode.assemble"},
    "decode_i16": {"glc.decode.pack", "glc.decode.disp", "glc.decode.wait"},
}


@pytest.mark.parametrize("entry", ["encode", "encode_pcm16", "encode_many",
                                   "decode_i16"])
def test_entry_point_traces_hold_its_stages(monkeypatch, tmp_path, entry):
    """Under GLC_PROFILE the trace of an entry holds the program's stage
    spans (`codec.device.StageClock`), with no `stats=` given."""
    call = _calls()[entry]
    monkeypatch.setenv("GLC_PROFILE", str(tmp_path))
    call()
    span = SPANS[entry]
    want = STAGE_SPANS["decode_i16" if entry == "decode_i16" else "encode"]
    assert want <= _events(tmp_path / span)
