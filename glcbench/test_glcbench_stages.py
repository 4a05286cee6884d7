"""The readers of the encode's stage keys (the program's ``stats=`` hook):
each key's milliseconds per minute of audio, the wall's unstaged rest, and
nothing where the program has no such key, as a program without the
stages has none."""

import pytest

from glcbench import manifest

# the hook of two tracks' encodes, 120 s of audio: 2 minutes
STATS = {"wall_ms": 100.0, "prep_ms": 1.0, "disp_ms": 20.0, "wait_ms": 4.0,
         "unpack_ms": 30.0, "assemble_ms": 40.0, "up_n": 2, "down_n": 9}


def ctx(stats, direction="encode", audio_s=120.0):
    return {"trace": None, "direction": direction, "audio_s": audio_s,
            "host_ms": {"encode": 110.0}, "stats": stats}


@pytest.mark.parametrize("name,value", [
    ("encode.unpack_ms_per_min", 15.0),
    ("encode.assemble_ms_per_min", 20.0),
    ("encode.unstaged_ms_per_min", 2.5),  # (100 - 95) ms over 2 min
])
def test_stage_readers(name, value):
    mod = manifest.metric_module(name)
    assert mod.read(ctx(STATS)) == pytest.approx(value)
    assert mod.read(ctx(STATS, direction="decode")) is None
    assert mod.read(ctx(STATS, audio_s=0.0)) is None


@pytest.mark.parametrize("name,key", [
    ("encode.unpack_ms_per_min", "unpack_ms"),
    ("encode.assemble_ms_per_min", "assemble_ms"),
    ("encode.unstaged_ms_per_min", "wall_ms"),
    ("encode.unstaged_ms_per_min", "prep_ms"),
])
def test_stage_readers_read_nothing_without_their_keys(name, key):
    mod = manifest.metric_module(name)
    stats = {k: v for k, v in STATS.items() if k != key}
    assert mod.read(ctx(stats)) is None
    # the parent's hook: disp_ms, wait_ms and the counts only
    parent = {k: STATS[k] for k in ("disp_ms", "wait_ms", "up_n", "down_n")}
    assert mod.read(ctx(parent)) is None
