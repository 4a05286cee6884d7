"""Find a cell's files by the names in ``BENCHMARK.json`` (json only: the
runner reads its configuration before torch loads).

* a configuration: the ``file`` of its entry in ``configs``;
* a traffic mix: ``glcbench/traffic/<traffic>.json``, whose ``kind`` names
  its generator, ``glcbench/kinds/<kind>.py``;
* a per-layer metric: ``glcbench/metrics/<name>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def applies(metric: dict, cell: str) -> bool:
    """A metric is reported in the cells its ``workloads`` lists, or in
    every cell where it lists none."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(workload: str, root: Path = ROOT) -> dict:
    """Everything one cell needs: its entry, configuration, traffic, and
    the manifest's metrics that it reports."""
    man = load(root / "BENCHMARK.json")
    (w,) = [w for w in man["workloads"] if w["name"] == workload] or [None]
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    (c,) = [c for c in man["configs"] if c["name"] == w["config"]]
    return {
        "name": workload,
        "chips": w["chips"],
        "config": load(root / c["file"]),
        "traffic": load(root / "glcbench" / "traffic" / f"{w['traffic']}.json"),
        "end_to_end": [m for m in man["end_to_end"] if applies(m, workload)],
        "per_layer": [m for m in man["per_layer"] if applies(m, workload)],
    }


def metric_module(name: str, root: Path = ROOT):
    """The reader of a per-layer metric, loaded from its own file."""
    path = root / "glcbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "glcbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
