"""The traced window: a ``torch.profiler`` trace of the window's calls,
read into the device's busy time, each kernel's time and the breakdown.

The window is the span ``glcbench.window``; every number is taken inside
it.  Device time is the union of the intervals of the kernels, copies and
memsets (as ``glc_tpu_torch/bench.py::device_busy_ms`` takes it); an idle
gap is named by what the host's thread was doing at its middle: the
innermost ``glcbench.*`` span and the innermost operator inside it.
"""

from __future__ import annotations

import json
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

WINDOW = "glcbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def union_s(spans) -> float:
    """Seconds covered by intervals (µs pairs)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return busy / 1e6


def _merged(spans) -> list:
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def op_name(name: str) -> str:
    """A device op's name without its return type, anonymous namespace and
    argument list, 64 characters at most."""
    short = name.replace("(anonymous namespace)::", "")
    short = short.removeprefix("void ").split("(")[0].strip() or name.strip()
    return short.replace(" ", "_")[:64] or "_unnamed_"


class Trace:
    """The window of one trace: ``window_s``, ``busy_s``, the device events
    as (name, start µs, end µs) clipped to it, and the breakdown."""

    def __init__(self, events: list):
        (win,) = [e for e in events if e.get("name") == WINDOW
                  and e.get("cat") == "user_annotation"]
        t0, t1 = win["ts"], win["ts"] + win["dur"]
        self.window_s = win["dur"] / 1e6
        self.device = [(e.get("name", ""), max(e["ts"], t0),
                        min(e["ts"] + e["dur"], t1))
                       for e in events if e.get("cat") in DEVICE_CATS
                       and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
        self.busy_s = union_s((a, b) for _n, a, b in self.device)
        host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"], e["cat"])
                       for e in events
                       if e.get("cat") in ("cpu_op", "user_annotation")
                       and e.get("tid") == win.get("tid")
                       and e.get("pid") == win.get("pid")),
                      key=lambda h: (h[0], -h[1]))
        self.idle_gaps = self._gaps(t0, t1, host)
        ops: dict = defaultdict(float)
        for name, a, b in self.device:
            ops[op_name(name)] += (b - a) / 1e6
        self.device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]

    def kernel_s(self, names) -> float:
        """Seconds in which a kernel whose name holds one of `names` ran."""
        return union_s((a, b) for n, a, b in self.device
                       if any(k in n for k in names))

    def _gaps(self, t0, t1, host) -> list:
        busy = _merged((a, b) for _n, a, b in self.device)
        edges = [t0] + [x for ab in busy for x in ab] + [t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        sums: dict = defaultdict(float)
        stack: list = []
        i = 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while i < len(host) and host[i][0] <= mid:
                while stack and stack[-1][1] <= host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            sums[_label(stack)] += (b - a) / 1e6
        return sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]


def _label(stack) -> str:
    spans = [h for h in stack if h[3] == "user_annotation"
             and h[2].startswith("glcbench.") and h[2] != WINDOW]
    if not spans:
        return "no_span"
    label = spans[-1][2]
    if stack[-1][3] == "cpu_op":
        label += "/" + stack[-1][2]
    return label


def read(prof) -> Trace:
    """The Trace of a finished profiler; its file lives in a temporary
    directory under TMPDIR and is gone when this returns."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return Trace(events)
