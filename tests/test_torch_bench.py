"""The port's benchmark (glc_tpu_torch/bench.py) on the CPU: its artifact
contract (tests/test_bench_contract.py's cases on the port's copy), its
signals against bench.py's bit for bit, each section at a toy size with
its record's keys and its correctness gate, the whole run's final lines,
its quality numbers against the JAX package's by bench.py's own formula,
and its refusal to run without a CUDA card.

Bounds, each with its reason:
- The signals: equal to bench.py's (copies).
- Quality: the port's compat and clean SNR within 0.2 dB of the JAX
  package's on the same 5 s signal (the bench's own card-vs-CPU bound,
  QUALITY_TOL_DB); the port's formula gives bench.py's printed numbers
  from the JAX package's output, to the digits bench.py prints.
- The kernels' bounds: the peaks of NVIDIA's H100 SXM data sheet, TF32
  for the 3xTF32 products, the FP64 tensor cores for their f64 path.

On the CPU every device measurement is None: the sections are checked for
their keys, counts and gates, never for a time.  The JAX package runs on
the CPU here (tests/conftest.py) and is imported inside the tests.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from glc_tpu_torch import bench as tb

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
# The sections at toy sizes: seconds of the trio, albums of 2 tracks of 1
# and 2 s, a 3 s long file, 2 rounds
TOY = {"trio_s": 2.0, "albums_s": (1.0, 2.0), "tracks": 2, "long_s": 3.0,
       "playlist_s": 1.0, "quality_s": 2.0, "rounds": 2}
# The contract's keys of a kernel's entry
KERNEL_ENTRY_KEYS = {"name", "route", "source", "replaces", "launches",
                     "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms"}


def root_bench():
    """The JAX package's bench.py (it imports only numpy at module level)."""
    sys.path.insert(0, str(REPO))
    import bench

    return bench


# --- (a) the artifact contract (tests/test_bench_contract.py:63-141) ---

def representative_summary() -> dict:
    """Every summary key a full run emits, with the widest values the card
    gives (realtime factors to 5 digits, walls to 3)."""
    x = {"x": 88888.8, "med": 88888.8, "ms": [888.8, 888.8]}
    return {
        "decode": {**x, "cf": 88.888, "st": [88.8, 888.8, 88.8]},
        "flac": {**x, "cf": 88.888, "st": [88.8, 888.8, 88.8]},
        "stages": [888.8, 888.8, 88.8, 888.8, 88.8],
        "dev": {"x": [88888.0, 88888.0, 88888.0],
                "idle": [0.8888, 0.8888, 0.8888],
                "k_ms": [0.8888, 0.8888, 0.8888], "bp": [88.8, 88.8, 88.8]},
        "quality": {"compat_snr": -88.88, "clean_snr": 88.88,
                    "compat_maxerr_pct": 888.8, "clean_maxerr_pct": 88.8},
        "album_enc": {**x, "vs_serial": 8.88},
        "album_dec": {**x, "vs_serial": 8.88},
        "album120_enc": {**x, "vs_serial": 8.88},
        "album120_dec": {**x, "vs_serial": 8.88},
        "long600": {**x, "cf": 888.888, "st": [None, 88.8, 88.8],
                    "first_ms": 8888.8},
        "album_flac": dict(x),
        "play": {"first_ms": 888.88, "feed_x": 88888.8},
        "hooked": [[8.888, 8.888, 8.888]] * 3,
    }


def representative_flagship() -> dict:
    return {
        "metric": tb.FLAGSHIP, "value": 88888.8, "unit": "x_realtime",
        "median_value": 88888.8, "runs": 11,
        "spread_ms": [888.88, 888.88, 888.88, 888.88, 888.88],
        "copy_floor_ms": 88.888, "pct_of_copy_ceiling": 888.8,
        "stages": {"disp_ms": 888.88, "wait_ms": 88.88, "up_n": 8.0,
                   "down_n": 88.0},
        "schema_version": tb.SCHEMA_VERSION,
        "device": {"kind": "NVIDIA H100 80GB HBM3", "count": 1,
                   "smi": "NVIDIA H100 80GB HBM3, 700.00 W"},
        "correct": True,
    }


def pathological(summary: dict) -> dict:
    for i in range(60):  # many future metrics, each with wide payloads
        summary[f"future_metric_{i}"] = {"x": 8888.8, "med": 8888.8,
                                         "note": "y" * 40}
    return summary


def runs_bloat(summary: dict) -> dict:
    summary["long600"]["runs"] = [8888.8] * 200
    return summary


@pytest.mark.parametrize("case", ["budget", "flagship", "single_line",
                                  "sheds_runs", "pathological"])
def test_final_line_contract(case):
    """The final line: under LINE_BUDGET with every section's entry at its
    widest, the flagship metric with every summary key, one line; a
    bloated `runs` list is shed before any entry, and any summary size
    leaves the flagship's keys intact."""
    summary = representative_summary()
    if case == "sheds_runs":
        summary = runs_bloat(summary)
    elif case == "pathological":
        summary = pathological(summary)
    s = tb._build_final_line(representative_flagship(), summary)
    d = json.loads(s)
    assert len(s) < tb.LINE_BUDGET == 1500
    if case == "budget":
        assert d["summary"] == representative_summary()
    elif case == "flagship":
        for k, v in representative_flagship().items():
            assert d[k] == v
        assert set(d["summary"]) == set(representative_summary())
    elif case == "single_line":
        assert "\n" not in s
    elif case == "sheds_runs":
        assert "runs" not in d["summary"]["long600"]
        assert set(d["summary"]) == set(summary)
    else:
        assert d["metric"] == tb.FLAGSHIP and d["correct"] is True
        assert d["pct_of_copy_ceiling"] == 888.8


def test_pct_of_median_share():
    """_pct_of pairs each run with its own ceiling and takes the median of
    the shares."""
    assert tb._pct_of([0.5, 0.5, 0.5], [120.0, 240.0, 120.0], 60.0) == 100.0
    assert tb._pct_of([0.6], [50.0], 60.0) == 200.0


def test_emit_records_summary_keys(capsys):
    summary: dict = {}
    line = tb.emit("decode_realtime_factor_44k_stereo", 60.0, 0.3, 0.32,
                   key="decode", summary=summary, copy_floor_ms=1.23456,
                   spread_ms=[300.0, 301.04, 320.0, 330.06, 340.0],
                   vs_serial=1.5,
                   stages={"pack_ms": 1.04, "disp_ms": 2.0, "wait_ms": 0.3})
    assert line["value"] == 200.0 and line["median_value"] == 187.5
    assert "vs_baseline" not in line
    assert summary["decode"] == {"x": 200.0, "med": 187.5,
                                 "ms": [301.0, 330.1], "cf": 1.23,
                                 "vs_serial": 1.5, "st": [1.0, 2.0, 0.3]}
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == line


def test_report_gate_and_final_line(capsys):
    """A record's gate is taken under its section's name; one false entry
    makes the final line's "correct" false."""
    report = tb.Report({"kind": "k", "count": 1, "smi": "k, 1.00 W"})
    report.flagship = {"metric": tb.FLAGSHIP, "value": 1.0}
    report.record({"section": "trio", "gate": {"flac": True}})
    d = json.loads(report.final_line())
    assert d["correct"] is True and d["schema_version"] == tb.SCHEMA_VERSION
    assert d["device"] == {"kind": "k", "count": 1, "smi": "k, 1.00 W"}
    report.record({"section": "album", "gate": {"decode_many": False}})
    assert report.gate == {"trio.flac": True, "album.decode_many": False}
    assert json.loads(report.final_line())["correct"] is False
    assert json.loads(capsys.readouterr().out.splitlines()[0])["section"] \
        == "trio"


# --- (b) the signals ---

@pytest.mark.parametrize("fn", ["make_signal", "make_signal_i16"])
@pytest.mark.parametrize("seconds", [0.25, 5.0, 61.0])
def test_signals_match_bench_py(fn, seconds):
    """bit for bit bench.py's, across the sweep's 60 s wrap too."""
    want = getattr(root_bench(), fn)(seconds, 44100)
    got = getattr(tb, fn)(seconds, 44100)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


# --- (c) each section at a toy size on the CPU ---

SECTIONS = {
    "trio": lambda: tb.trio(CPU, 2.0, 2),
    "encode_stages": lambda: tb.encode_stages(CPU, 2.0),
    "device": lambda: tb.device_diagnostics(CPU, 2.0),
    "quality": lambda: tb.quality(CPU, 2.0),
    "album": lambda: tb.album(CPU, 1.0, 2, 2),
    "long_file": lambda: tb.long_file(CPU, 3.0, 2),
    "album_export": lambda: tb.album_export(CPU, 1.0, 2, 2),
    "playback": lambda: tb.playback(CPU, 1.0, 2, 2),
    "hooked": lambda: tb.hooked(CPU, 2.0, 2),
}


def pipelines_of(rec: dict) -> list:
    """The pipeline records (`tb.pipeline_record`) in a section's record."""
    name = rec["section"]
    if name == "trio":
        return [rec[p] for p in tb.PIPELINES]
    if name == "album":
        return [rec[s][k] for s in ("encode", "decode")
                for k in ("batched", "serial")]
    return {"long_file": [rec.get("encode")],
            "album_export": [rec.get("export")]}.get(name, [])


@pytest.mark.parametrize("name", list(SECTIONS))
def test_section_record_on_cpu(name):
    """Each section at a toy size on the CPU: the record's keys are its
    schema's, its gate is true, every pipeline record has its keys and a
    wall a round, and every device measurement is None."""
    rec = SECTIONS[name]()
    json.dumps(rec)  # JSON-able
    assert rec["section"] == name
    assert set(rec) == tb.SECTION_KEYS[name]
    assert all(rec.get("gate", {}).values())
    for p in pipelines_of(rec):
        assert set(p) == tb.PIPELINE_KEYS
        assert len(p["walls_ms"]) == rec["rounds"]
        assert p["copy_floor"] is None and p["pct_of_copy_ceiling"] is None
        assert p["median_x"] <= p["best_x"]
    if name == "trio":
        assert rec["max_lsb"] == 0 and rec["flip_rate"] == 0.0
        stats = rec["encode"]["stages"]
        assert stats["up_n"] == 1 and set(stats) == {"disp_ms", "wait_ms",
                                                      "up_n", "down_n"}
        assert rec["decode"]["launches"] == {k.__name__: 0
                                             for k in tb.HAND_KERNELS}
    elif name == "device":
        assert set(rec["profiles"].values()) == {None}
        assert [k["name"] for k in rec["kernels"]] == list(tb.KERNEL_SOURCES)
        for k in rec["kernels"]:
            assert KERNEL_ENTRY_KEYS <= set(k)
            assert k["ms"] is k["plain_ms"] is k["library_ms"] is None
            assert k["max_abs_err"] == 0.0  # the wrappers' plain versions
            assert k["bound_ms"] > 0 and k["route"] == "cuda"
    elif name == "album":
        assert rec["encode"]["vs_serial"] > 0 and rec["decode"]["vs_serial"] > 0
    elif name == "playback":
        assert rec["first_append_ms"]["min"] <= rec["first_append_ms"]["max"]
        assert rec["samples"] > 2 * 44100 * 2
    elif name == "hooked":
        for p in tb.PIPELINES:
            assert rec[p]["ratio"]["p10"] <= rec[p]["ratio"]["p90"]


def test_run_sections_final_lines_on_cpu(capsys):
    """The whole run at toy shapes on the CPU: after each section the final
    line is one JSON line under the budget, the flagship first, correct,
    and its summary grows by that section's entries, to every section's
    in the end."""
    report = tb.Report({"kind": "cpu", "count": 0, "smi": "none"})
    keys = []
    for _ in tb.run_sections(report, CPU, TOY):
        line = report.final_line()
        d = json.loads(line)
        assert len(line) < tb.LINE_BUDGET
        assert d["metric"] == tb.FLAGSHIP and d["correct"] is True
        assert list(d["summary"])[: len(keys)] == keys
        keys = list(d["summary"])
    assert set(keys) == set(representative_summary())
    out = capsys.readouterr().out.splitlines()
    sections = [json.loads(s)["section"] for s in out
                if s.startswith('{"section"')]
    assert sections == ["trio", "encode_stages", "device", "quality",
                        "album", "album", "long_file", "album_export",
                        "playback", "hooked"]


# --- (d) quality against the JAX package ---

@pytest.fixture(scope="module")
def quality_pair():
    """The port's quality section on the 5 s signal, the JAX package's
    outputs on it, and bench.py's own printed record of them."""
    import contextlib
    import io

    from glc_tpu import CodecConfig, Decoder, Encoder

    sig = tb.make_signal(5.0)
    jax_out = {
        mode: Decoder(2, 44100, config=cfg).decode(
            Encoder(44100, config=cfg).encode(sig, 2))
        for mode, cfg in (("compat", CodecConfig()),
                          ("clean", CodecConfig(reference_compat=False)))}
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        root_bench()._quality_bench(44100)
    record = json.loads(printed.getvalue().splitlines()[0])
    return tb.quality(CPU, 5.0), sig, jax_out, record


@pytest.mark.parametrize("mode", ["compat", "clean"])
def test_quality_matches_jax(quality_pair, mode):
    """The port's SNR within QUALITY_TOL_DB of the JAX package's on the
    same signal, both by the port's formula; that formula on the JAX
    package's output gives bench.py's printed numbers."""
    port, sig, jax_out, record = quality_pair
    jax = tb.quality_metrics(sig, jax_out[mode])
    assert abs(port[mode]["snr_db"] - jax["snr_db"]) <= tb.QUALITY_TOL_DB
    assert round(jax["snr_db"], 1) == record[mode]["snr_db"]
    assert round(jax["rms_dev_pct"], 2) == record[mode]["rms_dev_pct"]
    assert round(jax["max_amp_err_pct"], 1) == record[mode]["max_amp_err_pct"]
    assert port["gate"]["quality"]


# --- (e) no CUDA device: no run ---

def test_main_without_cuda_prints_the_error_record(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tb.main([]) == 1
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["metric"] == tb.FLAGSHIP and last["value"] == 0.0
    assert last["error"].startswith("no_cuda_device")


def test_module_without_cuda_exits_nonzero():
    """`python3 -m glc_tpu_torch.bench` as a user runs it; the CPU test
    environment has no card (skipped where one is)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the bench would run")
    proc = subprocess.run([sys.executable, "-m", "glc_tpu_torch.bench",
                           "--quick"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1
    last = json.loads(proc.stdout.splitlines()[-1])
    assert last["value"] == 0.0 and "error" in last


# --- helpers the bench shares with chip_smoke ---

def test_device_busy_ms_is_the_union_of_device_events():
    events = [
        {"cat": "kernel", "ts": 0.0, "dur": 1000.0},
        {"cat": "gpu_memcpy", "ts": 500.0, "dur": 1000.0},    # overlaps
        {"cat": "gpu_memset", "ts": 3000.0, "dur": 500.0},
        {"cat": "cpu_op", "ts": 0.0, "dur": 9000.0},          # the host's
        {"cat": "kernel", "ts": 9500.0, "dur": 1000.0},       # cut at t1
        {"cat": "kernel", "ts": 11000.0, "dur": 1000.0},      # after t1
    ]
    assert tb.device_busy_ms(events, 0.0, 10000.0) == 1.5 + 0.5 + 0.5


@pytest.mark.parametrize("n, path, mdct_ms, imdct_ms", [
    (1024, "tiles", 0.0694136, 0.0238609),
    (441, "f64", 0.0951157, 0.0326960),
])
def test_product_bounds_follow_the_path(n, path, mdct_ms, imdct_ms):
    """mdct_rows at 8192 rows and imdct_window at 2816: operations-bound,
    at the TF32 tensor-core peak on the tile product, at the FP64
    tensor-core peak on the f64 path (hop <= 456)."""
    from glc_tpu_torch.ops import kernels

    assert kernels.product_path(n) == path
    for got, want in ((tb.mdct_bound(8192, n), mdct_ms),
                      (tb.kernel_bound(2816, n), imdct_ms)):
        assert got[1] == "operations"
        assert got[0] == pytest.approx(want, rel=1e-5)


def test_copy_floor_needs_the_card():
    assert tb.copy_floor(1 << 20, 1 << 20, CPU) is None
