"""The hand-written CUDA kernel of the decode path, its plain version and
its build.

`imdct_window` replaces the TPU kernel
``glc_tpu/ops/pallas_kernels.py::imdct_fused``: the IMDCT product fused with
the synthesis window, ``((coeffs @ cos_table) * norm) * window``.  The
source is ``csrc/imdct_window.cu`` (CUDA C++ for sm_90a); it is compiled
with nvcc on first use into ``build/glc_tpu_torch/`` under the repository
root, as a shared library with a plain C entry loaded through ctypes.  The
library's file name carries a hash of the source, so an edit rebuilds it.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
always launches the kernel or raises.  `imdct_window.launches` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import torch

from .mdct import imdct

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "imdct_window.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "glc_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the built library lives; the name carries the source hash."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libimdct_window-{digest}.so"


def find_nvcc() -> str:
    """nvcc from CUDA_HOME (as torch.utils.cpp_extension finds it), else
    from PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the imdct_window kernel")
    return nvcc


def build_command(out: Path, nvcc: str = "nvcc") -> List[str]:
    """The nvcc command that builds the kernel library at `out`."""
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(SOURCE)]


def load_library() -> ctypes.CDLL:
    """The kernel library, built from the source on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    build_command(Path(tmp), find_nvcc()),
                    capture_output=True, text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed to build {SOURCE.name} "
                        f"(rc={proc.returncode}):\n{proc.stderr}"
                    )
                os.replace(tmp, path)  # atomic: concurrent builds agree
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(path))
        c = ctypes
        lib.glc_imdct_window.restype = c.c_int
        lib.glc_imdct_window.argtypes = [
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # coeffs, table, window, out
            c.c_int, c.c_int, c.c_float,                      # B, n, norm
            c.c_void_p,                                       # stream
        ]
        _lib = lib
        return lib


def imdct_window_reference(coeffs: torch.Tensor, cos_table: torch.Tensor,
                           window: torch.Tensor, norm) -> torch.Tensor:
    """Plain version: ((coeffs @ cos_table) * norm) * window, f32."""
    return imdct(coeffs, cos_table, norm) * window


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, coeffs on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def imdct_window(coeffs: torch.Tensor, cos_table: torch.Tensor,
                 window: torch.Tensor, norm) -> torch.Tensor:
    """Windowed IMDCT blocks [B, 2n] f32 of coeffs [B, n] f32.

    `norm` is the f32 IMDCT scale (a float, or a 0-dim tensor).  A CPU
    `coeffs` takes `imdct_window_reference`; a CUDA one launches the kernel
    on the current stream or raises.
    """
    if coeffs.device.type == "cpu":
        return imdct_window_reference(coeffs, cos_table, window, norm)
    if coeffs.device.type != "cuda":
        raise ValueError(f"imdct_window runs on cpu or cuda, not {coeffs.device}")
    if coeffs.dim() != 2:
        raise ValueError(f"coeffs must be [B, n], got {tuple(coeffs.shape)}")
    B, n = coeffs.shape
    if n % 64:
        raise ValueError(f"n={n} must be a multiple of 64")
    dev = coeffs.device
    _check("coeffs", coeffs, (B, n), dev)
    _check("cos_table", cos_table, (n, 2 * n), dev)
    _check("window", window, (2 * n,), dev)
    out = torch.empty((B, 2 * n), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.glc_imdct_window(
        coeffs.data_ptr(), cos_table.data_ptr(), window.data_ptr(),
        out.data_ptr(), B, n, float(norm), stream,
    )
    if rc != 0:
        raise RuntimeError(f"imdct_window launch failed: CUDA error {rc}")
    imdct_window.launches += 1
    return out


imdct_window.launches = 0
