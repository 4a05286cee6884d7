"""The sound-bank cell, ``sfx_bank_decode``, and the film decode cell,
``film_5p1_decode``: on the CPU, at sizes a test can hold, the bank kind's
pool is the seed's log-spaced clips, every clip is one decode chunk, a run
is correct, the TF32 control and a short or cut answer make it false, and
a traced run reads the decode's stacked groups.  The harness's look for a
card is skipped by calling `harness.run_cell` with the CPU."""

import time

import numpy as np
import pytest
import torch

from glcbench import (calibrate, compare, compare_decode, harness, manifest,
                      reference)

CELL = "sfx_bank_decode"
SEED = 2**31 + 97531


def small(seconds=(0.3, 6.0)) -> dict:
    """The bank at a size the CPU holds: 6 clips of 0.3-6 s, banks of 3."""
    spec = manifest.cell(CELL)
    spec["traffic"].update(item_seconds=list(seconds), pool_items=6,
                           items_per_call=3)
    spec["traffic"]["check"]["items"] = 2
    return spec


def _cell(seed, spec=None):
    from glcbench.kinds import bank_decode

    spec = spec or manifest.cell(CELL)
    return bank_decode.make(spec["config"], spec["traffic"], seed, "cpu")


def run(trace: bool = False) -> dict:
    before = torch.get_num_threads()
    try:
        return harness.run_cell(small(), SEED, 0.0, trace, "cpu",
                                time.perf_counter())
    finally:
        torch.set_num_threads(before)


def test_the_pool_is_log_spaced_and_the_same_for_every_seed():
    spec = manifest.cell(CELL)
    lo, hi = spec["traffic"]["item_seconds"]
    assert (lo, hi) == (0.3, 30) and spec["traffic"]["pool_items"] == 256
    a, b, other = _cell(SEED), _cell(SEED), _cell(SEED + 1)
    want = np.geomspace(0.3, 30, 256)
    assert np.allclose(sorted(a.seconds), want, rtol=0, atol=0)
    assert sorted(other.seconds) == sorted(a.seconds)
    assert a.seconds == b.seconds and a.seconds != other.seconds
    ratios = np.diff(np.log(sorted(a.seconds)))
    assert np.allclose(ratios, ratios[0])
    assert 6.4 < np.mean(a.seconds) < 6.5
    calls = [next(it) for it in [a.calls()] for _ in range(3)]
    assert [len(c) for c in calls] == [128, 128, 128]
    assert calls[0] == calls[2] and set(calls[0]) | set(calls[1]) == set(
        range(256))
    torch.set_num_threads(4)


def test_every_clip_is_one_decode_chunk():
    """So the whole call runs through the stacked single-chunk groups: on
    about 28 rungs of `chunk_size_for`, half the clips on the 128 rung."""
    from glc_tpu_torch.codec.tables import chunk_size_for

    spec = manifest.cell(CELL)
    cfg = spec["config"]
    assert cfg["sample_rate"] == 44100 and cfg["channel_layout"] == ["C"]
    codec = reference.Codec.from_config(cfg)
    cell = _cell(SEED)
    chunk = cfg["codec"]["decode_chunk_frames"]
    F = [reference.geometry(cell.samples(i), 1, codec)[1]
         for i in range(len(cell.seconds))]
    rungs = [chunk_size_for(f, chunk) for f in F]
    assert all(f <= r for f, r in zip(F, rungs))
    assert max(F) == 1292 and min(F) == 13
    assert len(set(rungs)) == 28 and rungs.count(128) == 128
    torch.set_num_threads(4)


def test_a_sound_run_is_correct():
    result = run()
    assert result["correct"], result["checked"]
    assert list(result)[-1] == "checked"
    assert set(result["metrics"]) == {"decode_rate", "setup_s"}
    assert result["attempted"] == 3 and result["failed"] == 0


def test_a_traced_run_reads_the_stacked_groups():
    result = run(trace=True)
    assert result["correct"]
    host = {"container.deserialize_ms_per_min", "decode.pack_ms_per_min",
            "decode.disp_ms_per_min", "decode.wait_ms_per_min",
            "decode.unkeyed_ms_per_min", "decode.group_launches_per_min"}
    # no device here: the device's metrics find nothing and stay out
    assert set(result["metrics"]) == host
    assert all(result["metrics"][k]["value"] > 0 for k in host
               if k != "decode.unkeyed_ms_per_min")


def test_the_program_passes_and_the_control_fails_every_limit():
    spec = small()
    limits = spec["traffic"]["check"]["limits"]
    assert set(limits) == set(compare_decode.DECODE_NUMBERS)
    try:
        program = calibrate.readings(spec, SEED, "cpu", control=False)
        control = calibrate.readings(spec, SEED, "cpu", control=True)
    finally:
        torch.set_num_threads(4)
    assert compare.verdict(program, limits), program
    assert all(control[k] > limits[k] for k in limits), control


def _decoded(change):
    def fault(fn):
        def call(self, encs, *a, **k):
            return change(fn(self, encs, *a, **k))
        return call
    fault.__name__ = change.__name__
    return fault


@_decoded
def one_sample_short(outs):
    return [o[:-1] for o in outs]


@_decoded
def cut_to_half(outs):
    return [o[: len(o) // 2] for o in outs]


@pytest.mark.parametrize("fault", [one_sample_short, cut_to_half],
                         ids=lambda f: f.__name__)
def test_a_short_or_cut_answer_reads_the_worst(monkeypatch, fault):
    import glc_tpu_torch

    dec = glc_tpu_torch.Decoder
    monkeypatch.setattr(dec, "decode_many", fault(dec.decode_many))
    result = run()
    assert result["correct"] is False
    assert {k: v["value"] for k, v in result["checked"].items()} == {
        "lsb_mismatch_share": 1.0, "max_lsb": 65535.0}


@pytest.mark.parametrize("cell,traffic", [
    (CELL, {"kind": "bank_decode", "item_seconds": [0.3, 30],
            "pool_items": 256, "items_per_call": 128, "plan": "albums",
            "host_threads": 1}),
    ("film_5p1_decode", {"kind": "album_decode", "item_seconds": [667, 1333],
                         "pool_items": 6, "items_per_call": 6,
                         "plan": "draw", "host_threads": 1}),
])
def test_the_traffic_files(cell, traffic):
    spec = manifest.cell(cell)
    got = dict(spec["traffic"])
    check = got.pop("check")
    assert got == traffic
    assert set(check["limits"]) == set(compare_decode.DECODE_NUMBERS)
    assert check["items"] == (8 if cell == CELL else 1)


DECODE_PER_LAYER = [
    "container.deserialize_ms_per_min", "decode.pack_ms_per_min",
    "decode.disp_ms_per_min", "decode.wait_ms_per_min",
    "decode.unkeyed_ms_per_min", "torch_ops.decode_ms_per_min",
    "imdct_window_roofline", "device_idle.decode"]


@pytest.mark.parametrize("cell,per_layer", [
    (CELL, DECODE_PER_LAYER + ["decode.group_launches_per_min"]),
    ("film_5p1_decode", DECODE_PER_LAYER),
])
def test_each_new_cell_resolves_to_its_metrics(cell, per_layer):
    spec = manifest.cell(cell)
    assert [m["name"] for m in spec["end_to_end"]] == ["setup_s",
                                                        "decode_rate"]
    assert [m["name"] for m in spec["per_layer"]] == per_layer
    assert spec["chips"] == 1


def test_the_group_reader():
    mod = manifest.metric_module("decode.group_launches_per_min")
    ctx = {"trace": None, "direction": "decode", "audio_s": 120.0,
           "host_ms": {}, "stats": {"group_n": 50, "down_n": 50}}
    assert mod.read(ctx) == pytest.approx(25.0)
    # the parent's hook has no such count: nothing to read
    assert mod.read({**ctx, "stats": {"down_n": 4}}) is None
    assert mod.read({**ctx, "direction": "encode"}) is None
    assert mod.read({**ctx, "audio_s": 0.0}) is None
