"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package, no source file of it imports them, and its CUDA kernels are built
for Hopper (sm_90a) from the sources under glc_tpu_torch/csrc/."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from glc_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "glc_tpu_torch"

_CHILD = """
import importlib, pkgutil, sys
import glc_tpu_torch
for m in pkgutil.walk_packages(glc_tpu_torch.__path__, "glc_tpu_torch."):
    if not m.name.endswith(".__main__"):  # that one runs the CLI
        importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "glc_tpu" or m.startswith("glc_tpu."))
print(" ".join(bad))
"""


def test_import_loads_no_jax():
    """Every module of the port imports in a fresh interpreter without
    pulling `jax` or `glc_tpu` into sys.modules (the card's machine has no
    JAX at all)."""
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"loaded: {proc.stdout.strip()}"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+glc_tpu\b(?!_torch)"
    r"|from\s+glc_tpu\b(?!_torch))",
    re.MULTILINE,
)


def test_no_source_imports_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_kernel_build_command_targets_sm90a():
    """The loader compiles every source under csrc/ with nvcc for sm_90a,
    one command a source, and links the objects into one plain shared
    library, without fast math (the commands are checked, not run: there
    is no nvcc here)."""
    srcs = kernels.sources()
    assert [s.name for s in srcs] == sorted(f"{k}.cu" for k in kernels.KERNELS)
    out = kernels.library_path()
    assert out.parent == REPO / "build" / "glc_tpu_torch"
    objs = []
    for src in srcs:
        obj = out.parent / f"{src.stem}.o"
        cmd = kernels.compile_command(src, obj, nvcc="nvcc")
        assert cmd[0] == "nvcc" and cmd[-1] == str(src)
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-c" in cmd and "-O3" in cmd and "-std=c++17" in cmd
        assert "-shared" not in cmd
        assert cmd[cmd.index("-o") + 1] == str(obj)
        objs.append(obj)
        text = src.read_text()
        assert f'extern "C" int glc_{src.stem}(' in text
        assert f'extern "C" int glc_{src.stem}_info(' in text
    link = kernels.link_command(objs, out, nvcc="nvcc")
    assert "-shared" in link and "arch=compute_90a,code=sm_90a" in link
    assert link[link.index("-o") + 1] == str(out)
    assert link[-len(objs):] == [str(o) for o in objs]
    for cmd in (link, *(kernels.compile_command(s, s, "nvcc") for s in srcs)):
        assert not any("fast_math" in a or "fast-math" in a for a in cmd)
    # each names what it replaces: the TPU kernel, or the XLA einsum
    assert "pallas_kernels.py" in (PKG / "csrc" / "imdct_window.cu").read_text()
    assert "glc_tpu/ops/mdct.py:67" in (PKG / "csrc" / "mdct_rows.cu").read_text()
    assert "glc_tpu/ops/psycho.py:155" in (
        PKG / "csrc" / "band_energy.cu").read_text()


def test_library_name_tracks_source_hash(tmp_path, monkeypatch):
    """An edit of any source renames the library, so it is rebuilt."""
    before = kernels.library_path()
    for f in kernels.CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC_DIR", tmp_path)
    assert kernels.library_path() == before
    for f in sorted(tmp_path.iterdir()):
        f.write_text(f.read_text() + "\n// edit\n")
        after = kernels.library_path()
        assert after.parent == before.parent and after.name != before.name
        before = after


def test_package_sets_full_f32_matmul():
    """The counterpart of the JAX package's Precision.HIGHEST."""
    import glc_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_wrapper_refuses_other_devices():
    """Only a CPU tensor takes the plain version; any other device that is
    not CUDA raises instead of falling back."""
    n = 1024
    meta = torch.empty((4, n), device="meta")
    with pytest.raises(ValueError):
        kernels.imdct_window(meta, torch.empty((n, 2 * n), device="meta"),
                             torch.empty(2 * n, device="meta"), 1.0)
