"""One run of one cell: set-up, the measured window, the check, the result.

Set-up makes the pool from the seed, starts the program (its kernel
library from ``build/glc_tpu_torch/`` in the checkout, built there on a
checkout's first run) and runs every track of the pool once through the
window's own call.  The window then runs whole calls until ``--seconds``
have passed; the end-to-end rate is the audio of its completed calls over
the time from the first call's start to the last call's end
(`whole_call_rate`).  A traced run (``--trace 1``) runs the window's calls
with the program's ``stats=`` hook and a host clock around each step under
``torch.profiler``, and reports the per-layer metrics.  After the window
the program is freed and the plain reference judges a sample of its
answers drawn from the seed (`Sampler`), with the pool's longest track.
"""

from __future__ import annotations

import gc
import importlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import compare, devtrace, manifest, reference

FORBIDDEN = ("jax", "jaxlib", "flax", "glc_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def whole_call_rate(records) -> float:
    """Audio seconds of the completed calls over first start to last end.
    `records` are (start, end, audio_s) of each completed call."""
    if not records:
        return 0.0
    span = records[-1][1] - records[0][0]
    return sum(r[2] for r in records) / span


class Sampler:
    """A uniform sample of `k` answers of the window (reservoir sampling,
    drawn from the seed), and the first answer of the `longest` track."""

    def __init__(self, k: int, seed: int, longest: int):
        self.k, self.longest = k, longest
        self.rng = np.random.default_rng([int(seed), 1])
        self.seen = 0
        self.kept: list = []
        self.long = None

    def offer(self, idx: int, out) -> None:
        if idx == self.longest and self.long is None:
            self.long = (idx, out)
            return
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((idx, out))
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.kept[j] = (idx, out)

    def answers(self) -> list:
        return self.kept + ([self.long] if self.long is not None else [])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(cell, seconds: float, sampler: Sampler, acc=None) -> dict:
    """Whole calls until `seconds` have passed since the first began.  A
    call that raises ends the window; its tracks count as failed, and so
    does every track a call leaves without an answer."""
    records, attempted, failed, error = [], 0, 0, None
    calls = cell.calls()
    while True:
        idxs = next(calls)
        attempted += len(idxs)
        t0 = time.perf_counter()
        try:
            outs = cell.call(idxs) if acc is None else cell.traced_call(idxs, acc)
        except Exception as err:  # the run reports it; the check fails
            failed += len(idxs)
            error = f"{type(err).__name__}: {err}"
            break
        t1 = time.perf_counter()
        outs = list(outs)[:len(idxs)]
        failed += len(idxs) - len(outs)
        outs += [None] * (len(idxs) - len(outs))
        records.append((t0, t1, cell.audio_s(idxs), idxs))
        for i, out in zip(idxs, outs):
            sampler.offer(i, out)
        del outs
        if t1 - records[0][0] >= seconds:
            break
    return {"records": records, "attempted": attempted, "failed": failed,
            "error": error}


def smi() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err}"


def per_layer(spec: dict, ctx: dict) -> dict:
    out = {}
    for m in spec["per_layer"]:
        value = manifest.metric_module(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """The result of one run (the dict `report` prints), on `device`."""
    device = torch.device(device)
    traffic = spec["traffic"]
    kind = importlib.import_module(f"glcbench.kinds.{traffic['kind']}")
    cell = kind.make(spec["config"], traffic, seed, device)
    marks = [("start", time.perf_counter())]
    cell.make_pool()
    sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("pool", time.perf_counter()))
    cell.start_program()
    marks.append(("program", time.perf_counter()))
    for idxs in cell.warm_calls():
        cell.call(idxs)
    sync(device)
    gc.collect()
    marks.append(("warm", time.perf_counter()))
    setup_s = time.perf_counter() - t_start

    sampler = Sampler(traffic["check"]["items"], seed, cell.longest())
    acc = tr = None
    if trace:
        acc = {"stats": {}, "host_ms": {}}
        with devtrace.profiler(device) as prof:
            with torch.profiler.record_function(devtrace.WINDOW):
                win = run_window(cell, seconds, sampler, acc)
            sync(device)
    else:
        win = run_window(cell, seconds, sampler)
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" \
        else 0
    cell.stop_program()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    records = win["records"]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": spec["chips"], "memory_peak_bytes": peak}
    result = {"correct": None, "attempted": win["attempted"],
              "failed": win["failed"]}
    if trace:
        tr = devtrace.read(prof)
        del prof
        ctx = {"direction": cell.direction,
               "audio_s": sum(r[2] for r in records),
               "rows": cell.rows([i for r in records for i in r[3]]),
               "n": cell.codec.hop_size,
               "bands": len(reference.band_tables(cell.codec.hop_size,
                                                  cell.rate)[0]),
               "host_ms": acc["host_ms"], "stats": acc["stats"], "trace": tr}
        result["metrics"] = per_layer(spec, ctx)
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
    else:
        values = {f"{cell.direction}_rate": whole_call_rate(records),
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in spec["end_to_end"]}
    if device.type == "cuda":
        dev["smi"] = smi()
    result["device"] = dev
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    result["window"] = {
        "calls": len(records), "audio_s": sum(r[2] for r in records),
        "error": win["error"],
        "call_s": [r[1] - r[0] for r in records],
        "setup_s": {"imports": marks[0][1] - t_start,
                    **{b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}}}

    t0 = time.perf_counter()
    numbers = cell.numbers(sampler.answers())
    result["window"]["check_s"] = time.perf_counter() - t0
    limits = traffic["check"]["limits"]
    result["correct"] = (win["failed"] == 0 and win["error"] is None
                         and win["attempted"] > 0
                         and compare.verdict(numbers, limits))
    result["checked"] = {k: {"value": numbers[k], "limit": limits[k]}
                         for k in numbers}
    return result


def report(result: dict) -> None:
    """Each number compared beside its limit as the last lines on standard
    error, then the result as the last line on standard output."""
    for k, v in result["checked"].items():
        print(f"checked {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"checked correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
