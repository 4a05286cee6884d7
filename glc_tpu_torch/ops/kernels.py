"""The hand-written CUDA kernel of the decode path, its plain version and
its build.

`imdct_window` replaces the TPU kernel
``glc_tpu/ops/pallas_kernels.py::imdct_fused``: the IMDCT product fused with
the synthesis window, ``((coeffs @ cos_table) * norm) * window``.  The
source is ``csrc/imdct_window.cu`` (CUDA C++ for sm_90a: 3xTF32 `wgmma`
fed by TMA); it is compiled with nvcc on first use into
``build/glc_tpu_torch/`` under the repository root, as a shared library with
a plain C entry loaded through ctypes.  The library's file name carries a
hash of every file under ``csrc/`` and of the nvcc flags, so an edit of
either rebuilds it.

The kernel reads the cos table as its TF32 split (`split_tf32`), transposed
to [2n, n]; `table_split` makes it once per table tensor and caches it.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
always launches the kernel or raises.  `imdct_window.launches` counts the
kernel launches, `table_split.splits` the table splits.
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
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from .mdct import imdct

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
SOURCE = CSRC_DIR / "imdct_window.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "glc_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the built library lives; the name carries a hash of every file
    under ``csrc/`` (names and contents) and of `NVCC_FLAGS`."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in CSRC_DIR.rglob("*") if p.is_file()):
        h.update(b"\0" + f.relative_to(CSRC_DIR).as_posix().encode() + b"\0")
        h.update(f.read_bytes())
    return BUILD_DIR / f"libimdct_window-{h.hexdigest()[:16]}.so"


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
            c.c_void_p, c.c_void_p, c.c_void_p,  # coeffs, table_hi, table_lo
            c.c_void_p, c.c_void_p,              # window, out
            c.c_int, c.c_int, c.c_float,         # B, n, norm
            c.c_void_p,                          # stream
        ]
        lib.glc_imdct_window_info.restype = c.c_int
        lib.glc_imdct_window_info.argtypes = [c.POINTER(c.c_int)]
        _lib = lib
        return lib


def kernel_info() -> Dict[str, int]:
    """What the build made of the kernel (needs a CUDA device): registers
    and local (spill) bytes a thread, static and dynamic shared memory a
    block, pipeline stages."""
    lib = load_library()
    info = (ctypes.c_int * 5)()
    rc = lib.glc_imdct_window_info(info)
    if rc != 0:
        raise RuntimeError(f"imdct_window info failed: CUDA error {rc}")
    return {
        "registers": info[0], "local_bytes": info[1],
        "static_smem": info[2], "dynamic_smem": info[3], "stages": info[4],
    }


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10-bit mantissa), ties away from zero,
    as PTX ``cvt.rna.tf32.f32`` rounds: on the bit pattern,
    ``(u + 0x1000) & 0xFFFFE000``."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split of an f32 tensor: ``hi = tf32(x)``,
    ``lo = tf32(x - hi)``, so that ``|x - hi - lo| <= 2**-22 * |x|``."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {x.dtype}")
    hi = _round_tf32(x)
    return hi, _round_tf32(x - hi)


_SPLITS = WeakTensorKeyDictionary()


def table_split(cos_table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``split_tf32(cos_table.T)``, each half [2n, n] contiguous, made once
    per table tensor (and again only if it is changed in place) and held as
    long as the table lives."""
    hit = _SPLITS.get(cos_table)
    if hit is not None and hit[0] == cos_table._version:
        return hit[1], hit[2]
    hi, lo = split_tf32(cos_table.t().contiguous())
    _SPLITS[cos_table] = (cos_table._version, hi, lo)
    table_split.splits += 1
    return hi, lo


table_split.splits = 0


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
    table_hi, table_lo = table_split(cos_table)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.glc_imdct_window(
        coeffs.data_ptr(), table_hi.data_ptr(), table_lo.data_ptr(),
        window.data_ptr(), out.data_ptr(), B, n, float(norm), stream,
    )
    if rc != 0:
        raise RuntimeError(f"imdct_window launch failed: CUDA error {rc}")
    imdct_window.launches += 1
    return out


imdct_window.launches = 0
