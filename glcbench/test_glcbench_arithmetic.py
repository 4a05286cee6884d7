"""The yardstick's arithmetic: the whole-window rate, the sample of answers,
the roofline shares, the trace's busy time and idle gaps, and the numbers
of `compare`."""

import numpy as np
import pytest

from glcbench import compare, devtrace, harness, manifest


def test_rate_counts_completed_calls_from_first_start_to_last_end():
    # (start, end, audio seconds): a gap between calls counts as time
    records = [(10.0, 11.0, 3000.0), (11.5, 12.0, 1500.0), (12.0, 14.0, 500.0)]
    assert harness.whole_call_rate(records) == pytest.approx(5000.0 / 4.0)
    # not a median of the calls' own rates (3000, 3000, 250)
    assert harness.whole_call_rate(records) != pytest.approx(3000.0)
    assert harness.whole_call_rate([]) == 0.0


class Cell:
    """A stand-in for a kind's cell: calls of two tracks, 1 s of audio each."""

    def calls(self):
        i = 0
        while True:
            yield [i, i + 1]
            i += 2

    def audio_s(self, idxs):
        return float(len(idxs))

    def call(self, idxs):
        return [f"out{i}" for i in idxs]


def test_window_runs_whole_calls_until_its_time_has_passed():
    sampler = harness.Sampler(3, seed=5, longest=-1)
    win = harness.run_window(Cell(), 0.0, sampler)
    assert len(win["records"]) == 1 and win["attempted"] == 2
    assert win["failed"] == 0 and win["error"] is None


def test_window_counts_missing_answers_and_raised_calls():
    class Half(Cell):
        def call(self, idxs):
            return super().call(idxs)[:1]

    class Raises(Cell):
        def call(self, idxs):
            raise RuntimeError("boom")

    sampler = harness.Sampler(4, seed=5, longest=-1)
    win = harness.run_window(Half(), 0.0, sampler)
    assert win["failed"] == 1 and (1, None) in sampler.answers()
    win = harness.run_window(Raises(), 0.0, harness.Sampler(1, 5, -1))
    assert win["failed"] == 2 and win["records"] == []
    assert win["error"] == "RuntimeError: boom"


def test_sampler_is_uniform_and_drawn_from_the_seed():
    def draw(seed):
        s = harness.Sampler(3, seed, longest=7)
        for i in range(1000):
            s.offer(i % 20, i)
        return s.answers()

    assert draw(11) == draw(11) and draw(11) != draw(12)
    assert (7, 7) in draw(11)  # the longest track's first answer
    counts = np.zeros(1000)
    for seed in range(300):
        for _i, out in draw(seed)[:-1]:
            counts[out] += 1
    assert counts[:500].sum() == pytest.approx(counts[500:].sum(), rel=0.2)


class FakeTrace:
    def __init__(self, seconds):
        self.seconds = seconds

    def kernel_s(self, names):
        return self.seconds


@pytest.mark.parametrize("name,direction,flops,peak", [
    ("mdct_rows_roofline", "encode", 2.0 * 2816 * 2048 * 1024, 495e12),
])
def test_product_rooflines_count_rows_from_shapes_at_the_fixed_peak(
        name, direction, flops, peak):
    mod = manifest.metric_module(name)
    assert mod.PEAK_FLOPS == peak
    bound = flops / peak  # operations bound the products at these rows
    ctx = {"trace": FakeTrace(4 * bound), "direction": direction,
           "rows": 2816, "n": 1024, "bands": 49}
    assert mod.read(ctx) == pytest.approx(25.0)
    assert mod.read({**ctx, "trace": FakeTrace(0.0)}) is None
    other = "encode" if direction == "decode" else "decode"
    assert mod.read({**ctx, "direction": other}) is None


def test_band_energy_roofline_is_bound_by_bytes():
    mod = manifest.metric_module("band_energy_roofline")
    rows, n, bands = 8192, 1024, 49
    nbytes = 4.0 * (rows * n + rows * bands + bands * n)
    ctx = {"trace": FakeTrace(2 * nbytes / 3.35e12), "direction": "encode",
           "rows": rows, "n": n, "bands": bands}
    assert mod.read(ctx) == pytest.approx(50.0)


def ev(name, cat, ts, dur, tid=1):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1,
            "tid": tid}


def test_trace_busy_time_and_idle_gaps():
    events = [
        ev(devtrace.WINDOW, "user_annotation", 0, 1000),
        ev("glcbench.encode", "user_annotation", 0, 1000),
        ev("aten::copy_", "cpu_op", 100, 300),
        ev("mdct_rows_kernel(CUtensorMap_st)", "kernel", 500, 100, 7),
        ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 550, 150, 8),
        ev("late kernel", "kernel", 1900, 50, 7),  # outside the window
    ]
    tr = devtrace.Trace(events)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(200e-6)
    assert tr.kernel_s(("mdct_rows_kernel",)) == pytest.approx(100e-6)
    gaps = dict(tr.idle_gaps)
    # [0, 500): its middle falls in the copy; [700, 1000): in the span only
    assert gaps["glcbench.encode/aten::copy_"] == pytest.approx(500e-6)
    assert gaps["glcbench.encode"] == pytest.approx(300e-6)
    assert dict(tr.device_ops)["Memcpy_HtoD"] == pytest.approx(150e-6)


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::mdct_rows_kernel(CUtensorMap_st, int)",
     "mdct_rows_kernel"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy_DtoH"),
    ("void at::native::vectorized_elementwise_kernel<4>(int, float)",
     "at::native::vectorized_elementwise_kernel<4>"),
    ("(odd)", "(odd)"),
])
def test_device_op_names(name, short):
    assert devtrace.op_name(name) == short


def test_encoded_numbers():
    import dataclasses

    import torch

    from glcbench import material, reference

    cfg = manifest.load(manifest.HERE / "configs" / "cd_stereo_44k1.json")
    codec = reference.Codec.from_config(cfg)
    x = material.track(3.0, 44100, ["L", "R"], seed=3, item=0, device="cpu")
    ref = reference.encode(torch.from_numpy(material.to_pcm(x, 16)), 2,
                           44100, codec)
    n, fsz = codec.hop_size, codec.frame_size
    assert compare.encoded_numbers(ref, ref, n, fsz) == {
        "flip_share": 0.0, "max_q_gap": 0.0, "scale_gap": 0.0}
    q = ref.q.copy()
    q[len(q) // 2] += 2
    got = dataclasses.replace(ref, q=q)
    detail = {}
    nums = compare.encoded_numbers(got, ref, n, fsz, detail)
    assert nums["max_q_gap"] == 2.0 and detail["value"] == 1
    assert nums["flip_share"] == pytest.approx(1 / detail["values"])
    assert compare.encoded_numbers(None, ref, n, fsz) == compare.worst(
        compare.ENCODE_NUMBERS)


@pytest.mark.parametrize("pa,expect", [
    ([1, 4, 6, 9, 12], (4, 1, 5)),    # 6 coded by one side only
    ([9, 1, 4, 30, 12], (5, 1, 5)),   # another order counts the same
    ([1, 4, 4, 9], None),             # a position coded twice
    ([], (0, 0, 0)),
])
def test_pairs_match_positions_and_values(pa, expect):
    from types import SimpleNamespace as NS

    pb = np.array([1, 3, 4, 9, 12, 30], np.int64)

    def enc(pos):
        pos = np.array(pos, np.int64)
        q = np.where(pos == 9, pos + 5, pos)  # position 9 differs by 5
        return NS(nnz=np.array([len(pos)]), k=pos, q=q)

    ref = NS(nnz=np.array([len(pb)]), k=pb, q=pb.copy())
    assert compare._pairs(enc(pa), ref, 64, "cpu") == expect
