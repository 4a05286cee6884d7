"""ctypes loader for the native runtime (native/glc_native.cpp).

Copied from ``glc_tpu/native.py``.  The C++ source is shared, not copied:
this loader uses the library that ``make -C native`` builds from the
repository's ``native/`` directory, the same one the JAX package loads.

Builds the shared library on first use if it is missing.  All consumers
degrade gracefully to pure-Python fallbacks when the native library is
unavailable (`get_native()` returns None).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_ROOT = Path(__file__).resolve().parent.parent
_NATIVE_DIR = _ROOT / "native"
# GLC_NATIVE_LIB overrides the library path — used to run the test suite
# against the sanitized build (`make -C native sanitize`, see the Makefile)
_SO_PATH = Path(
    os.environ.get("GLC_NATIVE_LIB", _NATIVE_DIR / "libglc_native.so")
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return _SO_PATH.exists()
    except Exception:
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.glc_flac_predictor_order.restype = c.c_int32
    lib.glc_flac_predictor_order.argtypes = [c.c_int32, c.c_int32]
    lib.glc_flac_partition_order.restype = c.c_int32
    lib.glc_flac_partition_order.argtypes = [c.c_int32, c.c_int32, c.c_int32]
    lib.glc_flac_pack.restype = c.c_int64
    lib.glc_flac_pack.argtypes = [
        c.POINTER(c.c_int16), c.c_int64, c.c_int32, c.c_uint32, c.c_int32,
        c.POINTER(c.c_uint8),                       # md5
        c.POINTER(c.c_int32), c.c_int32,            # block_sizes, num_frames
        c.POINTER(c.c_int32), c.POINTER(c.c_int8),  # residuals, rice_params
        c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_int64),
    ]
    if hasattr(lib, "glc_flac_pack_frames"):  # absent in pre-r4 builds
        lib.glc_flac_pack_frames.restype = c.c_int64
        lib.glc_flac_pack_frames.argtypes = [
            c.POINTER(c.c_int16), c.c_int64, c.c_int32, c.c_uint32,
            c.c_int32,
            c.POINTER(c.c_int32), c.c_int32,        # block_sizes, num_frames
            c.c_int64,                              # first_frame
            c.POINTER(c.c_int32), c.POINTER(c.c_int8),
            c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_int64),
        ]
    lib.glc_free.restype = None
    lib.glc_free.argtypes = [c.c_void_p]
    if hasattr(lib, "glc_flac_block_stats"):  # absent in pre-r4 builds
        lib.glc_flac_block_stats.restype = c.c_int32
        lib.glc_flac_block_stats.argtypes = [
            c.POINTER(c.c_int32), c.c_int64, c.c_int32, c.c_int32, c.c_int32,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        ]
    lib.glc_flac_decode.restype = c.c_int32
    lib.glc_flac_decode.argtypes = [
        c.POINTER(c.c_uint8), c.c_int64,
        c.POINTER(c.POINTER(c.c_int32)), c.POINTER(c.c_int64),
        c.POINTER(c.c_uint32), c.POINTER(c.c_uint32), c.POINTER(c.c_uint32),
    ]
    lib.glc_container_serialize.restype = c.c_int64
    lib.glc_container_serialize.argtypes = [
        c.c_uint32, c.c_uint16, c.c_uint64,           # header
        c.c_uint32, c.c_uint32, c.c_uint64,           # gapless
        c.c_int64,                                     # num_frames
        c.POINTER(c.c_int64),                          # nnz
        c.POINTER(c.c_uint8), c.c_int64,               # pairs, pairs_len
        c.POINTER(c.c_float), c.POINTER(c.c_uint8),    # scales, raw_mask
        c.POINTER(c.c_int16), c.c_int64,               # raw_pcm, raw_len
        c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_int64),
    ]
    lib.glc_container_scan.restype = c.c_int32
    lib.glc_container_scan.argtypes = [
        c.POINTER(c.c_uint8), c.c_int64,
        c.POINTER(c.c_uint32), c.POINTER(c.c_uint16), c.POINTER(c.c_uint64),
        c.POINTER(c.c_uint32), c.POINTER(c.c_uint32), c.POINTER(c.c_uint64),
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.POINTER(c.c_int64),
        c.POINTER(c.c_int64),
    ]
    lib.glc_container_fill.restype = c.c_int32
    lib.glc_container_fill.argtypes = [
        c.POINTER(c.c_uint8), c.c_int64, c.c_int64, c.c_int32,
        c.POINTER(c.c_int64),
        c.POINTER(c.c_uint8), c.c_int64,   # pairs, pair_capacity
        c.POINTER(c.c_float), c.POINTER(c.c_uint8),
        c.POINTER(c.c_int16), c.c_int64,   # raw_pcm, raw_capacity
        c.c_int64,                          # raw_len
    ]
    return lib


def get_native() -> Optional[ctypes.CDLL]:
    """Return the bound native library, building it if needed; None if
    unavailable."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if not _SO_PATH.exists() and not _build():
            _load_failed = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(_SO_PATH)))
        except OSError:
            _load_failed = True
            return None
        return _lib
