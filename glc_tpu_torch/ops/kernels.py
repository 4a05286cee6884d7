"""The hand-written CUDA kernels of the port, their plain versions and their
build.

* `imdct_window` replaces the TPU kernel
  ``glc_tpu/ops/pallas_kernels.py::imdct_fused``: the decode's IMDCT product
  fused with the synthesis window, ``((coeffs @ cos_table) * norm) *
  window`` (``csrc/imdct_window.cu``).
* `mdct_rows` is the encode's MDCT product, ``(win @ cos_table.T) * norm``
  (``csrc/mdct_rows.cu``), and `band_energy` the masking model's band sums
  of squares, ``(coeffs * coeffs) @ band_mask.T`` (``csrc/band_energy.cu``).
  They replace no Pallas kernel but two XLA einsums
  (``glc_tpu/ops/mdct.py:67``, ``glc_tpu/ops/psycho.py:155``): cuBLAS picks
  its kernel by the product's shape, so a frame's bits moved with the row
  count of its segment or shard; these kernels compute each row alike at
  any row count, so the encode's bytes do not depend on how the frames are
  cut, as the JAX package's do not.

Every kernel takes any n (the hop size) from 1 to `MAX_N`: the codec's
default 1024, a 48 kHz library's 20 ms hop 960, 44.1 kHz's 10 ms 441 and
the rest; the wrappers raise ValueError above it.  The two products are
3xTF32 `wgmma` fed by TMA (``csrc/tf32x3.cuh``); they read their table as
its TF32 split (`split_tf32`), made once per table tensor and cached:
`table_split` the transposed table's for `imdct_window`, `cos_split` the
table's own for `mdct_rows`.  A TMA map's rows lie a multiple of 16 bytes
apart, so each operand they read by TMA has rows of `row_pitch` floats:
the splits are made at that pitch (zero padded), and a row input whose
width is no multiple of 4 is copied once a launch (`padded_rows`).  At
the n where the tile product's error passes twice the plain version's on
some rows (`product_path`), the two take their f64 path instead
(``csrc/f64_rows.cuh``): each f32 product exact in f64 and summed in f64
on the f64 tensor cores (``mma.sync`` m16n8k16 f64), one rounding to f32.
Its kernels keep both operands f32 in memory and widen them as a warp
loads its fragments; they copy the row input in aligned 16-byte blocks at
any pitch and offset (no padded copy), and the table at a 16-byte pitch,
made once per table tensor (`f64_table` the table itself for
`imdct_window`, `f64_table_t` the transposed one for `mdct_rows`).  They
launch the build `f64_plan` picks by the row count (`F64Plan`: a block
tile of `F64_TILES`, 16 or 32 rows by 64 columns, a block a tile); every
build gives the same bits.  `mdct_rows`' tile product launches
the tile plan `mdct_rows_plan` picks for its row count (`MdctPlan`: a tile
shape of `MDCT_TILES` and a persistent grid); every plan gives the same
bits.  `band_energy` reads its work plan, `band_plan` (each band's bins cut
into items of `BAND_CHUNK` bins, the items given to a warp's lanes), made
once per band-mask tensor.

Every ``.cu`` file under ``csrc/`` is compiled with nvcc on first use, one
nvcc a source, all at once, and linked into one shared library with plain C
entries, loaded through ctypes, under ``build/glc_tpu_torch/`` at the
repository root.  The library's file name carries a hash of every file
under ``csrc/`` and of the nvcc flags, so an edit of either rebuilds it.

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor
it always launches its kernel or raises.  ``<wrapper>.launches`` counts
each wrapper's launches, ``<wrapper>.f64_launches`` those of them that
took the f64 kernel, ``<split>.splits`` the table splits and
``f64_table.copies`` / ``f64_table_t.copies`` the f64 path's table
copies.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakTensorKeyDictionary


_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "glc_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]
KERNELS = ("imdct_window", "mdct_rows", "band_energy")
MAX_N = 8192  # the largest n (hop size) each kernel takes (csrc/*.cu)
# The largest n at which imdct_window and mdct_rows take their f64 path
# (csrc/f64_rows.cuh) instead of the 3xTF32 tile product: the largest n at
# which the tile product's error against float64 passed twice the plain
# version's, on some seed's rows at some row count, in
# `python3 chip_smoke.py --path-sweep` (every n to 1024; H100)
_F64_MAX_N = 456
PRODUCT_PATHS = ("tiles", "f64")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    """The kernel sources: every ``.cu`` file under ``csrc/``."""
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the built library lives; the name carries a hash of every file
    under ``csrc/`` (names and contents) and of `NVCC_FLAGS`."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in CSRC_DIR.rglob("*") if p.is_file()):
        h.update(b"\0" + f.relative_to(CSRC_DIR).as_posix().encode() + b"\0")
        h.update(f.read_bytes())
    return BUILD_DIR / f"libglc_kernels-{h.hexdigest()[:16]}.so"


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
                           "build the port's kernels")
    return nvcc


def compile_command(src: Path, obj: Path, nvcc: str = "nvcc") -> List[str]:
    """The nvcc command that compiles one kernel source to an object."""
    return [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objs: Sequence[Path], out: Path,
                 nvcc: str = "nvcc") -> List[str]:
    """The nvcc command that links the objects into the library at `out`."""
    return [nvcc, *NVCC_FLAGS, "-shared", "-o", str(out), *map(str, objs)]


def _build(path: Path) -> None:
    """Compile every source (one nvcc each, all at once) and link them into
    the library at `path`, atomically."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sources()
        objs = [Path(tmp) / f"{s.stem}.o" for s in srcs]
        procs = [subprocess.Popen(compile_command(s, o, nvcc),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for s, o in zip(srcs, objs)]
        stderr = [p.communicate()[1] for p in procs]  # waits for each
        errors = [(s.name, p.returncode, err)
                  for s, p, err in zip(srcs, procs, stderr) if p.returncode]
        if not errors:
            lib = Path(tmp) / "lib.so"
            proc = subprocess.run(link_command(objs, lib, nvcc),
                                  capture_output=True, text=True)
            if proc.returncode:
                errors.append(("the library", proc.returncode, proc.stderr))
        if errors:
            name, rc, err = errors[0]
            raise RuntimeError(f"nvcc failed to build {name} (rc={rc}):\n{err}")
        os.replace(lib, path)  # atomic: concurrent builds agree


def load_library() -> ctypes.CDLL:
    """The kernel library, built from the sources on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        c = ctypes
        ptr, i32 = c.c_void_p, c.c_int
        lib.glc_imdct_window.argtypes = [
            ptr, ptr, ptr,          # coeffs, table_hi, table_lo
            ptr, ptr,               # window, out
            i32, i32, c.c_float,    # B, n, norm
            ptr,                    # stream
        ]
        lib.glc_mdct_rows.argtypes = [
            ptr, ptr, ptr, ptr, ptr,  # win, table_hi, table_lo, norm, out
            i32, i32,                 # M, n
            i32, i32, i32, ptr,       # the plan's rows, cols, grid; stream
        ]
        lib.glc_imdct_window_f64.argtypes = [
            ptr, ptr, ptr, ptr,     # coeffs, f64_table, window, out
            i32, i32, c.c_float,    # B, n, norm
            i32, i32, ptr,          # the plan's rows, cols; stream
        ]
        lib.glc_mdct_rows_f64.argtypes = [
            ptr, ptr, ptr, ptr,     # win, f64_table_t, norm, out
            i32, i32,               # M, n
            i32, i32, ptr,          # the plan's rows, cols; stream
        ]
        for name in ("glc_imdct_window_f64", "glc_mdct_rows_f64"):
            getattr(lib, name).restype = i32
            info = getattr(lib, f"{name}_info")
            info.restype = i32
            info.argtypes = [i32, i32, c.POINTER(i32)]
        lib.glc_mdct_rows_plan_info.restype = i32
        lib.glc_mdct_rows_plan_info.argtypes = [i32, i32, c.POINTER(i32)]
        lib.glc_band_energy.argtypes = [
            ptr, ptr, ptr,          # coeffs, plan, out
            i32, i32, i32,          # M, n, bands
            i32, i32, ptr,          # items, plan length, stream
        ]
        for name in KERNELS:
            getattr(lib, f"glc_{name}").restype = i32
            info = getattr(lib, f"glc_{name}_info")
            info.restype = i32
            info.argtypes = [c.POINTER(i32)]
        _lib = lib
        return lib


def kernel_info() -> Dict[str, Dict[str, int]]:
    """What the build made of each kernel (needs a CUDA device): registers
    and local (spill) bytes a thread, static and dynamic shared memory a
    block, pipeline stages; for `mdct_rows` the default plan's, and each
    tile shape's under ``"mdct_rows(rows, cols)"``; for each build of the
    f64 path's kernels (``"mdct_rows_f64(rows, cols)"``,
    ``"imdct_window_f64(rows, cols)"``) also the blocks an SM holds and the
    block tile's rows and columns."""
    lib = load_library()
    out = {name: _info(getattr(lib, f"glc_{name}_info"), name)
           for name in KERNELS}
    for rows, cols in MDCT_TILES:
        out[f"mdct_rows{(rows, cols)}"] = _info(
            lambda info: lib.glc_mdct_rows_plan_info(rows, cols, info),
            f"mdct_rows plan {(rows, cols)}")
    for name in ("mdct_rows", "imdct_window"):
        for rows, cols in F64_TILES:
            out[f"{name}_f64{(rows, cols)}"] = _info(
                lambda info: getattr(lib, f"glc_{name}_f64_info")(
                    rows, cols, info), f"{name} f64 {(rows, cols)}", f64=True)
    return out


def _info(fn, name: str, f64: bool = False) -> Dict[str, int]:
    info = (ctypes.c_int * 8)()
    rc = fn(info)
    if rc != 0:
        raise RuntimeError(f"{name} info failed: CUDA error {rc}")
    out = {"registers": info[0], "local_bytes": info[1],
           "static_smem": info[2], "dynamic_smem": info[3],
           "stages": info[4]}
    if f64:
        out.update(resident_blocks=info[5], tile=(info[6], info[7]))
    return out


def _rows_matmul(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x [..., k] @ table [k, m] as ONE 2-D product over all leading rows:
    the plain versions' product (and the CPU decode's IMDCT).

    ``torch.matmul`` does not fold a non-contiguous [F, C, k] operand into
    rows; it runs a batched product of F tiny [C, k] matrices instead,
    which on an H100 took 29 ms for the 180 s stereo encode's MDCT where
    the 2-D product takes about a millisecond (PERF.md)."""
    out = torch.matmul(x.reshape(-1, x.shape[-1]), table)
    return out.view(*x.shape[:-1], table.shape[-1])


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


def _cached(cache: WeakTensorKeyDictionary, key: torch.Tensor, make):
    """(make(key), True), kept in `cache` as long as `key` lives, or the
    kept value and False; made again if `key` was changed in place."""
    hit = cache.get(key)
    if hit is not None and hit[0] == key._version:
        return hit[1], False
    value = make(key)
    cache[key] = (key._version, value)
    return value, True


_SPLITS = WeakTensorKeyDictionary()
_COS_SPLITS = WeakTensorKeyDictionary()
_F64_TABLES = WeakTensorKeyDictionary()
_F64_TABLES_T = WeakTensorKeyDictionary()
_PLANS = WeakTensorKeyDictionary()
_SCALARS = WeakTensorKeyDictionary()


def host_scalar(x) -> float:
    """`x`, a float or a one-element tensor, as a Python float.  A tensor
    on the card is read to the host once and kept as long as it lives (read
    again if it is changed in place), so a resident table scalar costs one
    sync, not one a launch."""
    if not torch.is_tensor(x):
        return float(x)
    return _cached(_SCALARS, x, lambda t: float(t))[0]


def row_pitch(width: int) -> int:
    """The floats between the rows of an operand a kernel reads by TMA:
    `width` rounded up to a multiple of 4 (a map's row stride is a
    multiple of 16 bytes; ``tf32x3.cuh::pitch_of``)."""
    return -(-width // 4) * 4


def padded_rows(x: torch.Tensor) -> torch.Tensor:
    """x [R, w] laid out as a TMA-read kernel reads it: contiguous rows of
    row_pitch(w) floats, zeros right of w (x itself where it is contiguous
    and w a multiple of 4)."""
    w = x.shape[1]
    if w == row_pitch(w):
        return x.contiguous()
    out = x.new_zeros((x.shape[0], row_pitch(w)))
    out[:, :w] = x
    return out


def table_split(cos_table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``split_tf32(cos_table.T)``, each half [2n, row_pitch(n)]
    contiguous, zeros right of n: the B operand of `imdct_window`, made
    once per table tensor (and again only if it is changed in place) and
    held as long as the table lives."""
    split, made = _cached(_SPLITS, cos_table,
                          lambda t: split_tf32(padded_rows(t.t())))
    table_split.splits += made
    return split


table_split.splits = 0


def cos_split(cos_table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``split_tf32(cos_table)``, each half [n, row_pitch(2n)] contiguous,
    zeros right of 2n: the B operand of `mdct_rows` (the table is K-major
    as it is), cached like `table_split` but apart from it."""
    split, made = _cached(_COS_SPLITS, cos_table,
                          lambda t: split_tf32(padded_rows(t)))
    cos_split.splits += made
    return split


cos_split.splits = 0


def f64_table(cos_table: torch.Tensor) -> torch.Tensor:
    """``cos_table`` [n, row_pitch(2n)] contiguous, zeros right of 2n: the
    table `imdct_window`'s f64 path copies by 16-byte cp.async; the table
    itself at an even n, else a copy made once per table tensor (and again
    only if it is changed in place) and held as long as the table lives;
    ``f64_table.copies`` counts the copies made.  It stays f32: the kernel
    widens it exactly as it loads its fragments."""
    if cos_table.shape[1] % 4 == 0 and cos_table.is_contiguous():
        return cos_table
    t, made = _cached(_F64_TABLES, cos_table, padded_rows)
    f64_table.copies += made
    return t


f64_table.copies = 0


def f64_table_t(cos_table: torch.Tensor) -> torch.Tensor:
    """``cos_table.T`` [2n, row_pitch(n)] contiguous, zeros right of n: the
    table of `mdct_rows`' f64 path, cached like `f64_table` but apart from
    it; ``f64_table_t.copies`` counts the copies made."""
    t, made = _cached(_F64_TABLES_T, cos_table, lambda t: padded_rows(t.t()))
    f64_table_t.copies += made
    return t


f64_table_t.copies = 0


def _ranges_of(band_mask: torch.Tensor) -> np.ndarray:
    """Each band's bins [lo, hi) as int32 [bands, 2] (0, 0 for an empty
    band), for a band mask [bands, n] whose rows are runs of ones."""
    m = band_mask.detach().cpu().numpy()
    ranges = np.zeros((m.shape[0], 2), np.int32)
    for b, row in enumerate(m):
        nz = np.flatnonzero(row)
        if len(nz) == 0:
            continue
        lo, hi = nz[0], nz[-1] + 1
        if not (row[lo:hi] == 1.0).all():
            raise ValueError(f"band_mask row {b} is not one run of ones")
        ranges[b] = lo, hi
    return ranges


BAND_CHUNK = 33   # bins a work item of band_energy (csrc/band_energy.cu)
BAND_LANES = 32   # the lanes of the warp that takes a row
# csrc/band_energy.cu's two builds, (work items, plan ints) each holds: the
# kernel launches the first that holds the plan
BAND_BUILDS = ((192, 1024), (320, 1280))
BAND_MAX_ITEMS, BAND_PLAN_CAP = BAND_BUILDS[-1]


class BandPlan(NamedTuple):
    """band_energy's work for one band mask [bands, n] (`band_plan`).

    Each band's bins are cut into items of `BAND_CHUNK` consecutive bins
    counted from its lo, the last one shorter; runs of bins that no band
    holds get items too, after the bands' (summed only to find non-finite
    squares).  The items go to the lanes longest first, each to the lane
    with the fewest bins so far (the lowest such lane)."""

    ranges: np.ndarray      # [bands, 2]: each band's bins [lo, hi)
    items: np.ndarray       # [I, 2]: each item's bins [lo, hi)
    band_first: np.ndarray  # [bands + 1]: band b's items, in bin order
    order: np.ndarray       # [I]: the items lane by lane, in summing order
    lane_first: np.ndarray  # [33]: where each lane's items start in order
    lane_bins: np.ndarray   # [32]: the bins each lane sums
    table: torch.Tensor     # the kernel's int32 copy, on the mask's device


def _chunks(lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(k, min(k + BAND_CHUNK, hi)) for k in range(lo, hi, BAND_CHUNK)]


def _plan_of(band_mask: torch.Tensor) -> BandPlan:
    ranges = _ranges_of(band_mask)
    items, band_first = [], [0]
    covered = np.zeros(band_mask.shape[1], bool)
    for lo, hi in ranges:
        items += _chunks(int(lo), int(hi))
        band_first.append(len(items))
        covered[lo:hi] = True
    edges = np.flatnonzero(np.diff(np.r_[0, ~covered, 0]))
    for lo, hi in zip(edges[::2], edges[1::2]):  # the runs no band holds
        items += _chunks(int(lo), int(hi))
    if len(items) > BAND_MAX_ITEMS:
        raise ValueError(f"band_mask needs {len(items)} work items, the "
                         f"kernel holds {BAND_MAX_ITEMS}")
    lengths = [hi - lo for lo, hi in items]
    lanes: List[List[int]] = [[] for _ in range(BAND_LANES)]
    lane_bins = np.zeros(BAND_LANES, np.int32)
    for i in sorted(range(len(items)), key=lambda i: (-lengths[i], i)):
        lane = int(np.argmin(lane_bins))
        lanes[lane].append(i)
        lane_bins[lane] += lengths[i]
    items_np = np.asarray(items, np.int32).reshape(-1, 2)
    order = np.asarray([i for lane in lanes for i in lane], np.int32)
    lane_first = np.cumsum([0] + [len(lane) for lane in lanes]).astype(np.int32)
    band_first_np = np.asarray(band_first, np.int32)
    table = np.concatenate([items_np[:, 0], items_np[:, 1], order, lane_first,
                            lane_bins, band_first_np, ranges[:, 0],
                            ranges[:, 1]]).astype(np.int32)
    if len(table) > BAND_PLAN_CAP:
        raise ValueError(f"band_mask's plan needs {len(table)} ints, the "
                         f"kernel holds {BAND_PLAN_CAP}")
    return BandPlan(ranges, items_np, band_first_np, order, lane_first,
                    lane_bins, torch.from_numpy(table).to(band_mask.device))


def band_plan(band_mask: torch.Tensor) -> BandPlan:
    """`BandPlan` of a band mask [bands, n] whose rows are runs of ones:
    made once per mask tensor from one host copy of it (and again only if
    it is changed in place), held as long as the mask lives;
    ``band_plan.plans`` counts the plans made."""
    plan, made = _cached(_PLANS, band_mask, _plan_of)
    band_plan.plans += made
    return plan


band_plan.plans = 0


class MdctPlan(NamedTuple):
    """How `mdct_rows` cuts its output [M, n] (csrc/mdct_rows.cu).

    A tile is `rows` x `cols`, `cols` the wgmma width.  rows 128: a block
    takes one tile, its two consumer warpgroups the tile's two 64-row
    halves (they share the table's tiles); rows 64: a block takes two tiles
    side by side, a warpgroup each (they share the rows of win).  A block's
    tiles are a unit; `grid` blocks (at most one an SM) walk the units,
    block b taking units b, b + grid, ..., columns fastest.  Every plan
    gives each element the same bits."""

    rows: int
    cols: int
    grid: int


# The tile shapes the kernel is built for, (rows, cols), and the device time
# (µs) of one unit of each, its 64 k-tiles (n = 1024) with one block an SM,
# back to back: `python3 chip_smoke.py --mdct-plans` on an NVIDIA H100 80GB
# HBM3 at 700 W.  A unit takes about that long at any row count: its
# k-loop is one chain (each k-tile's sum carries into the next), which no
# other SM shortens.
MDCT_UNIT_US = {(128, 128): 84.0, (64, 64): 58.0, (64, 32): 46.0,
                (64, 16): 42.0, (64, 8): 40.0}
MDCT_TILES = tuple(MDCT_UNIT_US)
MDCT_K_TILE = 32          # the k-tile of csrc/mdct_rows.cu


def mdct_ktiles(n: int) -> int:
    """The k-tiles every plan of mdct_rows walks on rows of width 2n:
    ceil(2n / 32) rounded up to even (``mdct_rows.cu::ktiles_of``; 64 at
    n = 1024)."""
    return (-(-(2 * n) // MDCT_K_TILE) + 1) // 2 * 2


def mdct_unit(rows: int, cols: int) -> Tuple[int, int]:
    """The (rows, cols) of a unit of the tile shape: one tile of 128 rows,
    or two of 64 side by side."""
    return (rows, cols) if rows == 128 else (rows, 2 * cols)


def mdct_units(M: int, n: int, rows: int, cols: int) -> Tuple[int, int]:
    """(units across n, units in all) of the tile shape on [M, n]; the
    last unit across n may reach past n (its columns there are computed on
    zeros and not stored)."""
    unit_rows, unit_cols = mdct_unit(rows, cols)
    units_n = -(-n // unit_cols)
    return units_n, -(-M // unit_rows) * units_n


def mdct_stage_bytes(rows: int, cols: int) -> int:
    """A ring stage's bytes: the unit's [rows, 32] of win, its [cols, 32] of
    table_hi and of table_lo."""
    unit_rows, unit_cols = mdct_unit(rows, cols)
    return 4 * MDCT_K_TILE * (unit_rows + 2 * unit_cols)


def mdct_smem_bytes(rows: int, cols: int) -> int:
    """The dynamic shared memory a block of the tile shape asks for: four
    stages and 1024 bytes of slack."""
    return 4 * mdct_stage_bytes(rows, cols) + 1024


def mdct_plan_us(M: int, n: int, rows: int, cols: int, sms: int) -> float:
    """The model's time (µs) for the tile shape on [M, n] with `sms` SMs:
    its rounds of units (`grid` = min(units, sms) blocks) times the unit's
    time, scaled by the k-loop's depth (`mdct_ktiles`, 64 at n = 1024)."""
    units = mdct_units(M, n, rows, cols)[1]
    rounds = -(-units // min(units, sms))
    return rounds * MDCT_UNIT_US[rows, cols] * mdct_ktiles(n) / 64


def mdct_rows_plan(M: int, n: int, sms: int) -> MdctPlan:
    """The plan `mdct_rows` launches on M rows of width 2n on a card of
    `sms` SMs: the tile shape that the model (`mdct_plan_us`) finds
    fastest, the earlier one in MDCT_TILES on a tie, and a grid of
    min(units, sms) blocks.  Any n from 1 to `MAX_N`."""
    if M < 1 or not 1 <= n <= MAX_N or sms < 1:
        raise ValueError(f"no plan for M={M}, n={n}, sms={sms} (n within "
                         f"[1, {MAX_N}])")
    rows, cols = min(MDCT_TILES, key=lambda t: mdct_plan_us(M, n, *t, sms))
    return MdctPlan(rows, cols, min(mdct_units(M, n, rows, cols)[1], sms))


def check_mdct_plan(plan: MdctPlan, M: int, n: int) -> None:
    """Raises ValueError unless `plan` is a built tile shape with a grid of
    1 to its unit count on [M, n]."""
    rows, cols, grid = plan
    if (rows, cols) not in MDCT_TILES:
        raise ValueError(f"mdct_rows has no tile shape {(rows, cols)}; "
                         f"built: {MDCT_TILES}")
    units = mdct_units(M, n, rows, cols)[1]
    if not 1 <= grid <= units:
        raise ValueError(f"grid {grid} outside [1, {units}] for {plan} on "
                         f"M={M}")


def mdct_rows_tiles(M: int, n: int, plan: MdctPlan) -> np.ndarray:
    """The warpgroup tiles of `plan` on [M, n] as the kernel walks them:
    int64 [T, 6] rows of (block, warpgroup, row0, col0, rows, cols), each
    tile 64 rows (a 128-row tile's halves) by plan.cols columns from
    (row0, col0); `rows` of them lie below M and `cols` below n (0 for a
    tile past M or n, which the kernel computes on zeros and does not
    store)."""
    rows, cols, grid = plan
    units_n, units = mdct_units(M, n, rows, cols)
    unit_rows, unit_cols = mdct_unit(rows, cols)
    u = np.arange(units, dtype=np.int64)
    block = u % grid
    row0 = (u // units_n) * unit_rows
    col0 = (u % units_n) * unit_cols
    out = []
    for wg in (0, 1):
        r0 = row0 + (64 * wg if rows == 128 else 0)
        c0 = col0 + (0 if rows == 128 else cols * wg)
        out.append(np.stack([block, np.full_like(u, wg), r0, c0,
                             np.clip(M - r0, 0, 64),
                             np.clip(n - c0, 0, cols)], axis=1))
    return np.concatenate(out)


class F64Plan(NamedTuple):
    """How an f64 path kernel cuts its output [M, N] (csrc/f64_rows.cuh):
    tiles of `rows` x `cols` (one of `F64_TILES`, the builds' block tiles),
    a block a tile, block b taking tile b, columns fastest.  Every plan
    gives each element the same bits."""

    rows: int
    cols: int


# The f64 path's builds (csrc/f64_rows.cuh Tile16, Tile32), each block
# tile (rows, cols) with the blocks an SM holds (chip_smoke fails where the
# build's info says otherwise) and the device time (µs) of one k16 step of
# a round of tiles, all SMs holding their blocks, back to back: `python3
# chip_smoke.py --f64-plans` on an NVIDIA H100 80GB HBM3 at 700 W, fitted
# over both kernels at hop 441 and 256 (at every row count it timed, the
# model picked the faster build)
F64_RESIDENT = {(16, 64): 3, (32, 64): 4}
F64_UNIT_US = {(16, 64): 0.396, (32, 64): 0.691}
F64_TILES = tuple(F64_UNIT_US)


def f64_tiles(M: int, N: int, rows: int, cols: int) -> int:
    """The tiles of rows x cols that cover [M, N] (the last row and column
    tiles may reach past M and N: nothing is stored there)."""
    return -(-M // rows) * -(-N // cols)


def f64_plan_us(M: int, N: int, K: int, rows: int, cols: int,
                sms: int) -> float:
    """The model's time (µs) for the build of block tile rows x cols on
    [M, N] over K: its rounds of tiles (all SMs holding F64_RESIDENT blocks
    each) times the unit's time, scaled by the k16 steps."""
    tiles = f64_tiles(M, N, rows, cols)
    rounds = -(-tiles // (sms * F64_RESIDENT[rows, cols]))
    return rounds * F64_UNIT_US[rows, cols] * -(-K // 16)


@functools.lru_cache(maxsize=4096)
def f64_plan(M: int, N: int, K: int, sms: int) -> F64Plan:
    """The plan an f64 path kernel launches on an output [M, N] over K on a
    card of `sms` SMs: the build the model (`f64_plan_us`) finds fastest,
    the smaller tile on a tie.  Kept per shape: a launch's host time is
    part of a single call's."""
    if M < 1 or N < 1 or K < 1 or sms < 1:
        raise ValueError(f"no f64 plan for M={M}, N={N}, K={K}, sms={sms}")
    return F64Plan(*min(F64_TILES,
                        key=lambda t: f64_plan_us(M, N, K, *t, sms)))


_SMS: Dict[int, int] = {}


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def imdct_window_reference(coeffs: torch.Tensor, cos_table: torch.Tensor,
                           window: torch.Tensor, norm) -> torch.Tensor:
    """Plain version: ((coeffs @ cos_table) * norm) * window, f32 (the
    IMDCT of ops/mdct.py, then the window)."""
    return (_rows_matmul(coeffs, cos_table) * norm) * window


def mdct_rows_reference(win: torch.Tensor, cos_table: torch.Tensor,
                        norm) -> torch.Tensor:
    """Plain version: (win @ cos_table.T) * norm, f32."""
    return _rows_matmul(win, cos_table.T) * norm


def band_energy_reference(coeffs: torch.Tensor,
                          band_mask: torch.Tensor) -> torch.Tensor:
    """Plain version: (coeffs * coeffs) @ band_mask.T, f32."""
    return _rows_matmul(coeffs * coeffs, band_mask.T)


def _check(name: str, t: torch.Tensor, shape, device,
           align: int = 16) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the input on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte "
                         f"aligned")


# The alignment (bytes) each product path needs of its row input: TMA reads
# the tile product's from 16-byte aligned rows; the f64 path copies the
# aligned 16-byte blocks that hold its rows, at any f32 offset
# (csrc/f64_rows.cuh)
_ROW_ALIGN = {"tiles": 16, "f64": 4}


def _rows_of(name: str, x: torch.Tensor) -> Tuple[int, int]:
    """The [M, width] of a wrapper's row input, which must be on the CPU
    or a CUDA device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{name} takes rows [M, width], got {tuple(x.shape)}")
    return x.shape[0], x.shape[1]


def _check_n(name: str, n: int) -> None:
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{name} takes n (the hop size) from 1 to {MAX_N}, "
                         f"got n={n}")


def product_path(n: int) -> str:
    """The product `imdct_window` and `mdct_rows` launch at n by default:
    "f64" at the n where the 3xTF32 tile product's error can pass twice
    the plain version's, else "tiles"."""
    return "f64" if n <= _F64_MAX_N else "tiles"


def _path_of(path: Optional[str], n: int) -> str:
    if path is None:
        return product_path(n)
    if path not in PRODUCT_PATHS:
        raise ValueError(f"path must be one of {PRODUCT_PATHS} or None, got "
                         f"{path!r}")
    return path


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def imdct_window(coeffs: torch.Tensor, cos_table: torch.Tensor,
                 window: torch.Tensor, norm,
                 path: Optional[str] = None) -> torch.Tensor:
    """Windowed IMDCT blocks [B, 2n] f32 of coeffs [B, n] f32.

    `norm` is the f32 IMDCT scale (a float, or a 0-dim tensor, read once
    by `host_scalar`).  A CPU
    `coeffs` takes `imdct_window_reference`; a CUDA one launches the kernel
    on the current stream or raises: the product `path` names (one of
    `PRODUCT_PATHS`; default `product_path(n)`), the f64 path with the
    build `f64_plan` picks.  Contiguous coeffs, 16-byte aligned for the
    tile product, any f32 alignment for the f64 path.
    """
    path = _path_of(path, coeffs.shape[-1] if coeffs.dim() else 0)
    if coeffs.device.type == "cpu":
        return imdct_window_reference(coeffs, cos_table, window, norm)
    if coeffs.device.type != "cuda":
        raise ValueError(f"imdct_window runs on cpu or cuda, not {coeffs.device}")
    if coeffs.dim() != 2:
        raise ValueError(f"coeffs must be [B, n], got {tuple(coeffs.shape)}")
    B, n = coeffs.shape
    _check_n("imdct_window", n)
    dev = coeffs.device
    _check("coeffs", coeffs, (B, n), dev, _ROW_ALIGN[path])
    _check("cos_table", cos_table, (n, 2 * n), dev)
    _check("window", window, (2 * n,), dev)
    out = torch.empty((B, 2 * n), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = load_library()
    if path == "f64":
        rc = lib.glc_imdct_window_f64(
            coeffs.data_ptr(), f64_table(cos_table).data_ptr(),
            window.data_ptr(), out.data_ptr(), B, n, host_scalar(norm),
            *f64_plan(B, 2 * n, n, _sms(dev)), _stream(dev))
    else:
        table_hi, table_lo = table_split(cos_table)
        coeffs = padded_rows(coeffs)
        rc = lib.glc_imdct_window(
            coeffs.data_ptr(), table_hi.data_ptr(), table_lo.data_ptr(),
            window.data_ptr(), out.data_ptr(), B, n, host_scalar(norm),
            _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"imdct_window launch failed: CUDA error {rc}")
    imdct_window.launches += 1
    imdct_window.f64_launches += path == "f64"
    return out


imdct_window.launches = 0
imdct_window.f64_launches = 0


def mdct_rows(win: torch.Tensor, cos_table: torch.Tensor, norm,
              plan: Optional[MdctPlan] = None,
              path: Optional[str] = None) -> torch.Tensor:
    """MDCT coefficients [M, n] f32 of windowed blocks win [M, 2n] f32 (rows
    contiguous) against cos_table [n, 2n] f32.

    `norm` is the f32 MDCT scale: a float, or a one-element f32 tensor on
    win's device (read by the kernel, with no host copy).  The inputs are
    checked on either device; then a CPU `win` takes
    `mdct_rows_reference`, and a CUDA one launches the kernel on the
    current stream or raises: the product `path` names (one of
    `PRODUCT_PATHS`; default `product_path(n)`), the tile product with
    `plan` (default: `mdct_rows_plan` for the card; the f64 path takes
    `f64_plan`'s build and checks `plan` only).  win 16-byte aligned for
    the tile product, any f32 alignment for the f64 path.  Each row's
    result is the same bits at any M and plan.
    """
    M, width = _rows_of("mdct_rows", win)
    n = width // 2
    dev = win.device
    path = _path_of(path, n)
    _check("win", win, (M, 2 * n), dev, _ROW_ALIGN[path])
    _check("cos_table", cos_table, (n, 2 * n), dev)
    if torch.is_tensor(norm) and (norm.device != dev or norm.numel() != 1
                                  or norm.dtype != torch.float32):
        raise ValueError(f"norm must be one float32 on {dev}, got "
                         f"{norm.dtype}{tuple(norm.shape)} on {norm.device}")
    if plan is not None and M:
        check_mdct_plan(plan, M, n)
    if dev.type == "cpu":
        return mdct_rows_reference(win, cos_table, norm)
    _check_n("mdct_rows", n)
    out = torch.empty((M, n), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    if not torch.is_tensor(norm):
        norm = torch.full((1,), norm, dtype=torch.float32, device=dev)
    lib = load_library()
    if path == "f64":
        rc = lib.glc_mdct_rows_f64(
            win.data_ptr(), f64_table_t(cos_table).data_ptr(),
            norm.data_ptr(), out.data_ptr(), M, n,
            *f64_plan(M, n, 2 * n, _sms(dev)), _stream(dev))
    else:
        if plan is None:
            plan = mdct_rows_plan(M, n, _sms(dev))
        table_hi, table_lo = cos_split(cos_table)
        win = padded_rows(win)
        rc = lib.glc_mdct_rows(
            win.data_ptr(), table_hi.data_ptr(), table_lo.data_ptr(),
            norm.data_ptr(), out.data_ptr(), M, n, *plan, _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"mdct_rows launch failed with plan {plan}: "
                           f"CUDA error {rc}")
    mdct_rows.launches += 1
    mdct_rows.f64_launches += path == "f64"
    return out


mdct_rows.launches = 0
mdct_rows.f64_launches = 0


def band_energy(coeffs: torch.Tensor, band_mask: torch.Tensor) -> torch.Tensor:
    """Band sums of squares [M, bands] f32 of coeffs [M, n] f32 (rows
    contiguous) over band_mask [bands, n] f32, a 0/1 matrix whose rows are
    runs of ones.

    The inputs are checked on either device; then a CPU `coeffs` takes
    `band_energy_reference`, and a CUDA one launches the kernel on the
    current stream or raises.  Each row's sums are the same bits at any M;
    a row with a NaN or Inf square gets the plain version's NaN and +Inf
    bands.
    """
    M, n = _rows_of("band_energy", coeffs)
    dev = coeffs.device
    _check("coeffs", coeffs, (M, n), dev)
    if band_mask.dim() != 2:
        raise ValueError(f"band_mask must be [bands, n], got "
                         f"{tuple(band_mask.shape)}")
    bands = band_mask.shape[0]
    _check("band_mask", band_mask, (bands, n), dev)
    if dev.type == "cpu":
        return band_energy_reference(coeffs, band_mask)
    _check_n("band_energy", n)
    out = torch.empty((M, bands), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    lib = load_library()
    plan = band_plan(band_mask)
    rc = lib.glc_band_energy(coeffs.data_ptr(), plan.table.data_ptr(),
                             out.data_ptr(), M, n, bands, len(plan.items),
                             plan.table.numel(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"band_energy launch failed: CUDA error {rc}")
    band_energy.launches += 1
    return out


band_energy.launches = 0
