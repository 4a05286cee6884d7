"""BENCHMARK.json and the files it names: every cell's files are found, and
every name, unit and line keeps to the benchmark's contract."""

import re

import pytest

from glcbench import manifest

MAN = manifest.load(manifest.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in MAN["workloads"]]


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["command"]) <= 32
    assert all(line(w) for w in MAN["command"])
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (manifest.ROOT / p).is_dir()
    assert len(manifest.ROOT.joinpath("BENCHMARK.json").read_bytes()) <= 65536


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert line(entry["source"]) and line(entry["why"])
    assert entry["file"].startswith("glcbench/")
    cfg = manifest.load(manifest.ROOT / entry["file"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert len(entry["reduced"]) <= 16
    assert all(NAME.match(k) and k in cfg for k in entry["reduced"])
    assert entry["name"] in {w["config"] for w in MAN["workloads"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found(cell):
    spec = manifest.cell(cell)
    (w,) = [w for w in MAN["workloads"] if w["name"] == cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and line(w["why"])
    assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    kind = spec["traffic"]["kind"]
    assert (manifest.HERE / "kinds" / f"{kind}.py").is_file()
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    # every per-layer metric of the cell moves an end-to-end one it reports
    assert {m["moves"] for m in spec["per_layer"]} <= e2e
    assert set(spec["traffic"]["check"]["limits"])


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", MAN["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metrics(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_files(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES and line(m["layer"])
    mod = manifest.metric_module(m["name"])
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"],
                                                m["moves"])
    assert callable(mod.read)
    (moved,) = [e for e in MAN["end_to_end"] if e["name"] == m["moves"]]
    assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


METRIC_FILES = sorted(p.name[:-3] for p in (manifest.HERE / "metrics")
                      .glob("*.py"))
TRAFFIC_FILES = sorted(p.stem for p in (manifest.HERE / "traffic")
                       .glob("*.json"))


@pytest.mark.parametrize("name", METRIC_FILES)
def test_every_metric_file_reads_and_declares_itself(name):
    mod = manifest.metric_module(name)
    assert NAME.match(name) and UNIT.match(mod.UNIT) and line(mod.LAYER)
    assert mod.MOVES in {m["name"] for m in MAN["end_to_end"]}
    assert mod.read({"trace": None, "direction": "none", "audio_s": 60.0,
                     "host_ms": {}, "stats": {}}) is None
    assert {m["name"] for m in MAN["per_layer"]} == set(METRIC_FILES)


@pytest.mark.parametrize("name", TRAFFIC_FILES)
def test_every_traffic_file_names_its_kind_and_numbers(name):
    from glcbench import compare

    traffic = manifest.load(manifest.HERE / "traffic" / f"{name}.json")
    assert (manifest.HERE / "kinds" / f"{traffic['kind']}.py").is_file()
    assert set(traffic["check"]["limits"]) == set(compare.ENCODE_NUMBERS)
    assert name in {w["traffic"] for w in MAN["workloads"]}


def test_cells_on_four_chips_are_few():
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)
