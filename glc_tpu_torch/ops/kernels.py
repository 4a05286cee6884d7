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

The two products are 3xTF32 `wgmma` fed by TMA (``csrc/tf32x3.cuh``); they
read their table as its TF32 split (`split_tf32`), made once per table
tensor and cached: `table_split` the transposed table's for `imdct_window`,
`cos_split` the table's own for `mdct_rows`.  `mdct_rows` launches the
tile plan `mdct_rows_plan` picks for its row count (`MdctPlan`: a tile
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
each kernel's launches, ``<split>.splits`` the table splits.
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
    tile shape's under ``"mdct_rows(rows, cols)"``."""
    lib = load_library()
    out = {name: _info(getattr(lib, f"glc_{name}_info"), name)
           for name in KERNELS}
    for rows, cols in MDCT_TILES:
        out[f"mdct_rows{(rows, cols)}"] = _info(
            lambda info: lib.glc_mdct_rows_plan_info(rows, cols, info),
            f"mdct_rows plan {(rows, cols)}")
    return out


def _info(fn, name: str) -> Dict[str, int]:
    info = (ctypes.c_int * 5)()
    rc = fn(info)
    if rc != 0:
        raise RuntimeError(f"{name} info failed: CUDA error {rc}")
    return {"registers": info[0], "local_bytes": info[1],
            "static_smem": info[2], "dynamic_smem": info[3],
            "stages": info[4]}


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
_PLANS = WeakTensorKeyDictionary()


def table_split(cos_table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``split_tf32(cos_table.T)``, each half [2n, n] contiguous: the B
    operand of `imdct_window`, made once per table tensor (and again only
    if it is changed in place) and held as long as the table lives."""
    split, made = _cached(_SPLITS, cos_table,
                          lambda t: split_tf32(t.t().contiguous()))
    table_split.splits += made
    return split


table_split.splits = 0


def cos_split(cos_table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``split_tf32(cos_table)``, each half [n, 2n] contiguous: the B
    operand of `mdct_rows` (the table is K-major as it is), cached like
    `table_split` but apart from it."""
    split, made = _cached(_COS_SPLITS, cos_table,
                          lambda t: split_tf32(t.contiguous()))
    cos_split.splits += made
    return split


cos_split.splits = 0


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
BAND_MAX_ITEMS = 192  # csrc/band_energy.cu's MAX_ITEMS


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


def mdct_unit(rows: int, cols: int) -> Tuple[int, int]:
    """The (rows, cols) of a unit of the tile shape: one tile of 128 rows,
    or two of 64 side by side."""
    return (rows, cols) if rows == 128 else (rows, 2 * cols)


def mdct_units(M: int, n: int, rows: int, cols: int) -> Tuple[int, int]:
    """(units across n, units in all) of the tile shape on [M, n]."""
    unit_rows, unit_cols = mdct_unit(rows, cols)
    units_n = n // unit_cols
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
    time, scaled by the k-loop's depth."""
    units = mdct_units(M, n, rows, cols)[1]
    rounds = -(-units // min(units, sms))
    return rounds * MDCT_UNIT_US[rows, cols] * n / 1024


def mdct_rows_plan(M: int, n: int, sms: int) -> MdctPlan:
    """The plan `mdct_rows` launches on M rows of width 2n on a card of
    `sms` SMs: the tile shape that the model (`mdct_plan_us`) finds
    fastest, the earlier one in MDCT_TILES on a tie, and a grid of
    min(units, sms) blocks."""
    if M < 1 or n < 1 or n % 128 or sms < 1:
        raise ValueError(f"no plan for M={M}, n={n}, sms={sms}")
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
    int64 [T, 5] rows of (block, warpgroup, row0, col0, rows), each tile
    64 rows (a 128-row tile's halves) by plan.cols columns from (row0,
    col0); `rows` of them hold rows below M (0 for a half past M, which
    the kernel computes on zeros and does not store)."""
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
                             np.clip(M - r0, 0, 64)], axis=1))
    return np.concatenate(out)


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


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the input on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _rows_of(name: str, x: torch.Tensor) -> Tuple[int, int]:
    """The [M, width] of a wrapper's row input, which must be on the CPU
    or a CUDA device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{name} takes rows [M, width], got {tuple(x.shape)}")
    return x.shape[0], x.shape[1]


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


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
    rc = lib.glc_imdct_window(
        coeffs.data_ptr(), table_hi.data_ptr(), table_lo.data_ptr(),
        window.data_ptr(), out.data_ptr(), B, n, float(norm), _stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"imdct_window launch failed: CUDA error {rc}")
    imdct_window.launches += 1
    return out


imdct_window.launches = 0


def mdct_rows(win: torch.Tensor, cos_table: torch.Tensor, norm,
              plan: Optional[MdctPlan] = None) -> torch.Tensor:
    """MDCT coefficients [M, n] f32 of windowed blocks win [M, 2n] f32 (rows
    contiguous) against cos_table [n, 2n] f32.

    `norm` is the f32 MDCT scale: a float, or a one-element f32 tensor on
    win's device (read by the kernel, with no host copy).  The inputs are
    checked on either device; then a CPU `win` takes
    `mdct_rows_reference`, and a CUDA one launches the kernel on the
    current stream, with `plan` (default: `mdct_rows_plan` for the card),
    or raises.  Each row's result is the same bits at any M and plan.
    """
    M, width = _rows_of("mdct_rows", win)
    n = width // 2
    dev = win.device
    _check("win", win, (M, 2 * n), dev)
    _check("cos_table", cos_table, (n, 2 * n), dev)
    if torch.is_tensor(norm) and (norm.device != dev or norm.numel() != 1
                                  or norm.dtype != torch.float32):
        raise ValueError(f"norm must be one float32 on {dev}, got "
                         f"{norm.dtype}{tuple(norm.shape)} on {norm.device}")
    if plan is not None and M:
        check_mdct_plan(plan, M, n)
    if dev.type == "cpu":
        return mdct_rows_reference(win, cos_table, norm)
    if n % 128:
        raise ValueError(f"n={n} must be a multiple of 128")
    out = torch.empty((M, n), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    if plan is None:
        plan = mdct_rows_plan(M, n, _sms(dev))
    if not torch.is_tensor(norm):
        norm = torch.full((1,), norm, dtype=torch.float32, device=dev)
    lib = load_library()
    table_hi, table_lo = cos_split(cos_table)
    rc = lib.glc_mdct_rows(
        win.data_ptr(), table_hi.data_ptr(), table_lo.data_ptr(),
        norm.data_ptr(), out.data_ptr(), M, n, *plan, _stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"mdct_rows launch failed with plan {plan}: "
                           f"CUDA error {rc}")
    mdct_rows.launches += 1
    return out


mdct_rows.launches = 0


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
    if n % 4:
        raise ValueError(f"n={n} must be a multiple of 4")
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
