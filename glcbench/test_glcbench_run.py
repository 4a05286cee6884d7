"""Whole runs: without a card the runner prints no result; on the CPU, at a
size a test can hold, a sound run is correct, and the control and each
fault the cells can have make `correct` false.  The harness's look for a
card is skipped by calling `harness.run_cell` with the CPU."""

import json
import subprocess
import sys
import time

import pytest
import torch

from glcbench import calibrate, compare, harness, manifest

SEED = 2**31 + 12345


def small(cell: str) -> dict:
    """The cell at a size the CPU holds: 2 tracks a call of 34-40 s."""
    spec = manifest.cell(cell)
    spec["traffic"].update(item_seconds=[34, 40], pool_items=2,
                           items_per_call=2)
    spec["traffic"]["check"]["items"] = 1
    return spec


def run(cell: str, trace: bool = False) -> dict:
    torch.set_num_threads(4)
    return harness.run_cell(small(cell), SEED, 0.0, trace, "cpu",
                            time.perf_counter())


def test_without_a_card_no_result_is_printed():
    proc = subprocess.run(
        [sys.executable, str(manifest.HERE / "run.py"), "--workload",
         "cd_album_encode", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=manifest.ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert "metrics" not in proc.stdout
    assert "no CUDA card" in proc.stderr


CELLS = [w["name"] for w in manifest.load(manifest.ROOT / "BENCHMARK.json")
         ["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checked"]
    assert list(result)[-1] == "checked"
    assert set(result["metrics"]) == {"encode_rate", "setup_s"}
    assert result["device"]["platform"] == "cpu"


def test_a_traced_run_reads_the_host_layers():
    result = run("cd_album_encode", trace=True)
    assert result["correct"]
    assert {"container.serialize_ms_per_min", "encode.disp_ms_per_min",
            "encode.unkeyed_ms_per_min"} <= set(result["metrics"])
    # no device here: the device's metrics find nothing and stay out
    assert "mdct_rows_roofline" not in result["metrics"]
    assert result["device"]["busy_s"] == 0.0


def _half(fn):
    def call(self, items, *a, **k):
        out = fn(self, items, *a, **k)
        return out[:len(out) // 2]
    return call


def _no_pairs(fn):
    def call(self, items, *a, **k):
        out = fn(self, items, *a, **k)
        for e in out:
            e.frame_set.nnz[:] = 0
            e.frame_set.pairs = e.frame_set.pairs[:0]
        return out
    return call


def _altered_pair(fn):
    def call(self, items, *a, **k):
        out = fn(self, items, *a, **k)
        for e in out:
            e.frame_set.pairs["q"][len(e.frame_set.pairs) // 2] += 5
        return out
    return call


# each fault a cell can have: half of the batch left out, a step that
# leaves its output as it was made (no pairs), an answer altered where it
# is produced.  One card: no exchange between chips to leave out.
FAULTS = [(cell, "Encoder", "encode_many", fault) for cell in CELLS
          for fault in (_half, _no_pairs, _altered_pair)]


@pytest.mark.parametrize("cell,cls,method,fault", FAULTS,
                         ids=lambda x: getattr(x, "__name__", x))
def test_each_fault_makes_correct_false(monkeypatch, cell, cls, method,
                                        fault):
    import glc_tpu_torch

    klass = getattr(glc_tpu_torch, cls)
    monkeypatch.setattr(klass, method, fault(getattr(klass, method)))
    result = run(cell)
    assert result["correct"] is False, result["checked"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference at TF32 in the program's place fails a limit, where
    the program passes every one."""
    torch.set_num_threads(4)
    spec = small(cell)
    limits = spec["traffic"]["check"]["limits"]
    program = calibrate.readings(spec, SEED, "cpu", control=False)
    control = calibrate.readings(spec, SEED, "cpu", control=True)
    assert compare.verdict(program, limits), program
    assert not compare.verdict(control, limits), control
    json.dumps(control)
