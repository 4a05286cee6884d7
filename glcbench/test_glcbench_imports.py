"""What the benchmark's modules import, by top-level module name compared
whole (``glc_tpu_torch`` begins with ``glc_tpu``)."""

import ast

import pytest

from glcbench import harness, manifest

SOURCES = sorted(manifest.HERE.rglob("*.py"))
# the plain reference and the yardstick it serves: nothing of the program
PLAIN = ("reference.py", "material.py", "compare.py")


def imported(path) -> set:
    """Top-level names of every module `path` imports, at any depth of the
    file; a relative import counts as ``glcbench``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("glcbench" if node.level else node.module.split(".")[0])
    return names


def dotted(path) -> set:
    """Every imported module's full dotted name."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add(node.module)
            out |= {f"{node.module}.{a.name}" for a in node.names}
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_old_benchmark(path):
    names = dotted(path)
    assert "bench" not in names
    assert "glc_tpu_torch.bench" not in names


@pytest.mark.parametrize("name", PLAIN)
def test_reference_imports_nothing_of_the_program(name):
    assert imported(manifest.HERE / name) <= {
        "__future__", "dataclasses", "functools", "math", "struct", "numpy",
        "torch", "glcbench"}
    for node in ast.walk(ast.parse((manifest.HERE / name).read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert {a.name for a in node.names} <= {"reference", "material"}


def test_top_level_names_are_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "glc_tpu_torch_fake",
                        types.ModuleType("glc_tpu_torch_fake"))
    assert "glc_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "glc_tpu.sub",
                        types.ModuleType("glc_tpu.sub"))
    assert "glc_tpu" in harness.forbidden_modules()
