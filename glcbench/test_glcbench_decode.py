"""The decode cell, ``cd_album_decode``: on the CPU, at sizes a test can
hold, the program's ``decode_many`` agrees with the plain reference decoder
within the cell's limits, the TF32 control and each fault the cell can have
make `correct` false, the traffic is the seed's, and the decode's readers
and manifest entries are what the cell reports.  The harness's look for a
card is skipped by calling `harness.run_cell` with the CPU."""

import ast
import time

import numpy as np
import pytest
import torch

from glcbench import (calibrate, compare, compare_decode, harness, manifest,
                      material, reference, reference_decode)

CELL = "cd_album_decode"
SEED = 2**31 + 4242


def small(seconds=(34, 40)) -> dict:
    """The cell at a size the CPU holds: 2 tracks a call, each longer than
    one decode chunk (1408 frames, 32.7 s) as every track of the cell is."""
    spec = manifest.cell(CELL)
    spec["traffic"].update(item_seconds=list(seconds), pool_items=2,
                           items_per_call=2)
    spec["traffic"]["check"]["items"] = 1
    return spec


def run(trace: bool = False) -> dict:
    torch.set_num_threads(4)
    return harness.run_cell(small(), SEED, 0.0, trace, "cpu",
                            time.perf_counter())


def test_the_program_passes_and_the_control_fails_every_limit():
    torch.set_num_threads(4)
    spec = small()
    limits = spec["traffic"]["check"]["limits"]
    assert set(limits) == set(compare_decode.DECODE_NUMBERS)
    program = calibrate.readings(spec, SEED, "cpu", control=False)
    control = calibrate.readings(spec, SEED, "cpu", control=True)
    assert compare_decode.DECODE_NUMBERS == tuple(program)
    assert compare.verdict(program, limits), program
    assert all(control[k] > limits[k] for k in limits), control


def test_a_sound_run_is_correct():
    result = run()
    assert result["correct"], result["checked"]
    assert list(result)[-1] == "checked"
    assert set(result["metrics"]) == {"decode_rate", "setup_s"}
    assert result["attempted"] == 2 and result["failed"] == 0


def test_a_traced_run_reads_the_host_layers():
    result = run(trace=True)
    assert result["correct"]
    host = {"container.deserialize_ms_per_min", "decode.pack_ms_per_min",
            "decode.disp_ms_per_min", "decode.wait_ms_per_min",
            "decode.unkeyed_ms_per_min"}
    # no device here: the device's metrics find nothing and stay out
    assert set(result["metrics"]) == host
    assert all(result["metrics"][k]["value"] >= 0 for k in host)
    assert result["device"]["busy_s"] == 0.0


def _decoded(change):
    """A fault in the outputs of ``decode_many``."""
    def fault(fn):
        def call(self, encs, *a, **k):
            return change(fn(self, encs, *a, **k))
        return call
    fault.__name__ = change.__name__
    return fault


@_decoded
def dropped_track(outs):
    """The first track's answer lost, the others handed on in its place."""
    return outs[1:]


@_decoded
def half_the_batch_left_out(outs):
    return outs[: len(outs) // 2]


@_decoded
def one_sample_short(outs):
    return [o[:-1] for o in outs]


@_decoded
def one_sample_long(outs):
    return [np.concatenate([o, o[-1:]]) for o in outs]


@_decoded
def four_lsb_off(outs):
    """A few samples 4 LSB off: only ``max_lsb`` sees it."""
    for o in outs:
        o[::100_000] += 4
    return outs


@_decoded
def swapped_channels(outs):
    return [o.reshape(-1, 2)[:, ::-1].reshape(-1).copy() for o in outs]


@_decoded
def left_as_made(outs):
    """A step that hands back its buffers as it made them: zeros."""
    return [np.zeros_like(o) for o in outs]


def misread_container(fn):
    """The container reader gets one pair's value wrong."""
    def deserialize(data):
        e = fn(data)
        e.frame_set.pairs["q"][len(e.frame_set.pairs) // 2] += 300
        return e
    return deserialize


FAULTS = [("Decoder", "decode_many", f) for f in (
    dropped_track, half_the_batch_left_out, one_sample_short,
    one_sample_long, four_lsb_off, swapped_channels, left_as_made)] + [
    (None, "deserialize_encoded", misread_container)]


@pytest.mark.parametrize("cls,method,fault", FAULTS,
                         ids=lambda x: getattr(x, "__name__", x))
def test_each_fault_makes_correct_false(monkeypatch, cls, method, fault):
    import glc_tpu_torch

    owner = glc_tpu_torch if cls is None else getattr(glc_tpu_torch, cls)
    monkeypatch.setattr(owner, method, fault(getattr(owner, method)))
    result = run()
    assert result["correct"] is False, result["checked"]


def test_a_malformed_container_leaves_no_result(monkeypatch):
    """A container the reader refuses raises in the set-up's warm call, so
    the runner prints no result (in the window it would count as failed)."""
    import glc_tpu_torch
    from glc_tpu_torch.container.bincode import BincodeError

    read = glc_tpu_torch.deserialize_encoded
    monkeypatch.setattr(glc_tpu_torch, "deserialize_encoded",
                        lambda data: read(data[: len(data) // 2]))
    with pytest.raises(BincodeError):
        run()


def test_four_lsb_off_is_caught_by_max_lsb_alone(monkeypatch):
    import glc_tpu_torch

    dec = glc_tpu_torch.Decoder
    monkeypatch.setattr(dec, "decode_many", four_lsb_off(dec.decode_many))
    checked = run()["checked"]
    assert checked["max_lsb"]["value"] == 4.0
    share = checked["lsb_mismatch_share"]
    assert share["value"] <= share["limit"]


def _cell(seed, seconds=(3, 4)):
    from glcbench.kinds import album_decode

    spec = small(seconds)
    return album_decode.make(spec["config"], spec["traffic"], seed, "cpu")


def test_a_seed_gives_the_same_pool_and_calls():
    a, b, other = _cell(SEED), _cell(SEED), _cell(SEED + 1)
    calls = lambda c: [next(it) for it in [c.calls()] for _ in range(4)]
    assert a.seconds == b.seconds and calls(a) == calls(b)
    assert a.make_item(0) == b.make_item(0)
    assert a.make_item(0) != other.make_item(0)
    assert sorted(a.seconds) == sorted(other.seconds)


def test_every_track_of_the_cell_is_a_multi_chunk_track():
    """``decode_many``'s ``stats=`` hook counts only multi-chunk tracks, so
    the pool's shortest track has to be one."""
    from glc_tpu_torch.codec.tables import chunk_size_for

    spec = manifest.cell(CELL)
    codec = reference.Codec.from_config(spec["config"])
    C = len(spec["config"]["channel_layout"])
    lo = spec["traffic"]["item_seconds"][0]
    F = reference.geometry(lo * spec["config"]["sample_rate"] * C, C,
                           codec)[1]
    chunk = spec["config"]["codec"]["decode_chunk_frames"]
    assert F > chunk_size_for(F, chunk)
    # and so is each of `small`'s tracks, with the same count of chunks
    stats: dict = {}
    cell = _cell(SEED, (34, 40))
    cell.make_pool()
    cell.start_program()
    cell.traced_call([0, 1], {"stats": stats, "host_ms": {}})
    frames = [reference.geometry(cell.samples(i), C, codec)[1] for i in (0, 1)]
    assert stats["down_n"] == sum(-(-f // chunk) for f in frames)


def test_raw_frames_and_both_trims_match_the_program():
    """White noise falls back to raw PCM frames: the reference reads them
    as the program does, with quirks Q1, Q4 and Q13 and without."""
    import dataclasses

    import glc_tpu_torch as glc

    cfg = manifest.load(manifest.HERE / "configs" / "cd_stereo_44k1.json")
    g = torch.Generator().manual_seed(7)
    pcm = (torch.randn(44100 * 3 * 2, generator=g) * 8000).clamp(
        -32768, 32767).to(torch.int16)
    for compat in (True, False):
        codec = dataclasses.replace(reference.Codec.from_config(cfg),
                                    reference_compat=compat)
        enc = reference.encode(pcm, 2, 44100, codec)
        assert enc.raw_mask.mean() > 0.5
        data = reference.write_container(enc)
        config = glc.CodecConfig(reference_compat=compat)
        got = glc.Decoder(2, 44100, config=config, device="cpu").decode_many(
            [glc.deserialize_encoded(data)])[0]
        ref = reference_decode.decode_i16(data, codec)
        nums = compare_decode.decoded_numbers(got, ref)
        assert nums["max_lsb"] <= 1.0 and nums["lsb_mismatch_share"] < 1e-3


def test_decoded_numbers():
    ref = np.arange(-50, 50, dtype=np.int16)
    got = ref.copy()
    assert compare_decode.decoded_numbers(got, ref) == {
        "lsb_mismatch_share": 0.0, "max_lsb": 0.0}
    got[[3, 7]] += np.array([2, -3], np.int16)
    detail = {}
    assert compare_decode.decoded_numbers(got, ref, detail) == {
        "lsb_mismatch_share": 0.02, "max_lsb": 3.0}
    assert detail == {"samples": 100, "differ": 2}
    for bad in (None, ref[:-1], np.concatenate([ref, ref[:1]])):
        assert compare_decode.decoded_numbers(bad, ref) == compare_decode.WORST
    assert compare_decode.worst_of([]) == compare_decode.WORST


def test_the_reference_decoder_imports_nothing_of_the_program():
    for name in ("reference_decode.py", "compare_decode.py"):
        tree = ast.parse((manifest.HERE / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert {a.name.split(".")[0] for a in node.names} <= {
                    "numpy", "torch"}
            elif isinstance(node, ast.ImportFrom):
                assert node.level or node.module in ("__future__",)
                if node.level:
                    assert {a.name for a in node.names} <= {"reference"}


class FakeTrace:
    def __init__(self, kernel, busy=0.0, window=1.0):
        self.kernel, self.busy_s, self.window_s = kernel, busy, window

    def kernel_s(self, names):
        return self.kernel


@pytest.mark.parametrize("rows,bound", [
    # operations bound the product at a chunk's rows
    (2816, 2.0 * 2816 * 1024 * 2048 / 495e12),
    # one row: its bytes, the table's and the window's
    (1, 4.0 * (1024 + 2048 + 1024 * 2048 + 2048) / 3.35e12),
])
def test_imdct_window_roofline(rows, bound):
    mod = manifest.metric_module("imdct_window_roofline")
    assert mod.bound_s(rows, 1024) == pytest.approx(bound)
    ctx = {"trace": FakeTrace(4 * bound), "direction": "decode",
           "rows": rows, "n": 1024, "bands": 49}
    assert mod.read(ctx) == pytest.approx(25.0)
    assert mod.read({**ctx, "trace": FakeTrace(0.0)}) is None
    assert mod.read({**ctx, "direction": "encode"}) is None


# the hook and the benchmark's clock of two calls, 120 s of audio: 2 minutes
STATS = {"pack_ms": 10.0, "disp_ms": 20.0, "wait_ms": 5.0, "up_n": 10,
         "down_n": 4}
HOST = {"deserialize": 6.0, "decode": 110.0}


def ctx(stats=STATS, host=HOST, direction="decode", trace=None):
    return {"trace": trace, "direction": direction, "audio_s": 120.0,
            "host_ms": host, "stats": stats, "rows": 0, "n": 1024}


@pytest.mark.parametrize("name,value", [
    ("container.deserialize_ms_per_min", 3.0),
    ("decode.pack_ms_per_min", 5.0),
    ("decode.disp_ms_per_min", 10.0),
    ("decode.wait_ms_per_min", 2.5),
    ("decode.unkeyed_ms_per_min", 37.5),   # (110 - 35) ms over 2 min
    ("torch_ops.decode_ms_per_min", 15.0),  # (0.04 - 0.01) s over 2 min
    ("device_idle.decode", 96.0),
])
def test_decode_readers(name, value):
    mod = manifest.metric_module(name)
    trace = FakeTrace(0.01, busy=0.04, window=1.0)
    assert mod.read(ctx(trace=trace)) == pytest.approx(value)
    assert mod.read(ctx(trace=trace, direction="encode")) is None


@pytest.mark.parametrize("key", ["pack_ms", "disp_ms", "wait_ms"])
def test_unkeyed_reads_nothing_without_a_key(key):
    mod = manifest.metric_module("decode.unkeyed_ms_per_min")
    assert mod.read(ctx({k: v for k, v in STATS.items() if k != key})) is None
    assert mod.read(ctx(host={})) is None


ENCODE_PER_LAYER = [
    "container.serialize_ms_per_min", "encode.disp_ms_per_min",
    "encode.unkeyed_ms_per_min", "torch_ops.encode_ms_per_min",
    "mdct_rows_roofline", "band_energy_roofline", "device_idle.encode",
    "encode.unpack_ms_per_min", "encode.assemble_ms_per_min",
    "encode.unstaged_ms_per_min"]
DECODE_PER_LAYER = [
    "container.deserialize_ms_per_min", "decode.pack_ms_per_min",
    "decode.disp_ms_per_min", "decode.wait_ms_per_min",
    "decode.unkeyed_ms_per_min", "torch_ops.decode_ms_per_min",
    "imdct_window_roofline", "device_idle.decode"]


@pytest.mark.parametrize("cell,e2e,per_layer", [
    ("film_5p1_encode", ["encode_rate", "setup_s"], ENCODE_PER_LAYER),
    ("cd_album_encode", ["encode_rate", "setup_s"], ENCODE_PER_LAYER),
    (CELL, ["setup_s", "decode_rate"], DECODE_PER_LAYER),
])
def test_each_cell_resolves_to_its_metrics(cell, e2e, per_layer):
    spec = manifest.cell(cell)
    assert [m["name"] for m in spec["end_to_end"]] == e2e
    assert [m["name"] for m in spec["per_layer"]] == per_layer
    assert all(m["moves"] in e2e for m in spec["per_layer"])


def test_the_pool_is_the_encode_cells_tracks():
    """The decode cell's containers are the reference's of the very PCM
    that ``cd_album_encode`` encodes at the same seed."""
    from glcbench.kinds import album

    spec = small((3, 4))
    enc = album.make(spec["config"], spec["traffic"], SEED, "cpu")
    dec = _cell(SEED)
    assert enc.seconds == dec.seconds
    codec = reference.Codec.from_config(spec["config"])
    pcm = torch.from_numpy(enc.make_item(1))
    want = reference.write_container(reference.encode(pcm, 2, 44100, codec))
    assert dec.make_item(1) == want
    assert material.item_seed(SEED, 1) != material.item_seed(SEED, 0)



def test_the_cell_runs_the_program_on_its_traffics_host_threads():
    """The traffic's ``host_threads`` sets torch's host pool for the whole
    run, set-up and window alike; a traffic without it leaves the pool."""
    from glcbench.kinds import album_decode

    spec = manifest.cell(CELL)
    assert spec["traffic"]["host_threads"] == 1
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(3)
        _cell(SEED)
        assert torch.get_num_threads() == 1
        torch.set_num_threads(3)
        traffic = dict(small()["traffic"])
        del traffic["host_threads"]
        album_decode.make(spec["config"], traffic, SEED, "cpu")
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(before)
