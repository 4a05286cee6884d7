"""Host↔device helpers shared by the encoder and decoder."""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

# The device of every entry point that is given none (the CLI, the FLAC
# device math): "cpu" runs the port on the CPU, as the tests do.  The
# counterpart of the JAX package's JAX_PLATFORMS.
DEVICE_ENV = "GLC_TORCH_DEVICE"


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device.  None means $GLC_TORCH_DEVICE if set,
    else the CUDA card; with neither, it raises rather than run on the CPU
    unasked."""
    if device is None:
        device = os.environ.get(DEVICE_ENV) or None
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device found; to run on the CPU pass device='cpu' or "
            f"set {DEVICE_ENV}=cpu")
    return torch.device("cuda")


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a host array to `device`: through pinned memory and without
    blocking on CUDA, as a zero-copy view on the CPU."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # e.g. np.frombuffer over file bytes
        a = a.copy()
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def upload_concat(arrays, device: torch.device) -> torch.Tensor:
    """``np.concatenate(arrays)`` on `device`.  On CUDA the arrays are
    copied straight into one pinned buffer, one host copy where
    concatenate-then-`upload` makes two, and sent with one copy that does
    not block."""
    if len(arrays) == 1:
        return upload(arrays[0], device)
    if device.type != "cuda":
        return torch.from_numpy(np.concatenate(arrays)).to(device)
    first = arrays[0]
    dtype = torch.from_numpy(np.empty(0, first.dtype)).dtype
    buf = torch.empty((sum(len(a) for a in arrays), *first.shape[1:]),
                      dtype=dtype, pin_memory=True)
    np.concatenate(arrays, out=buf.numpy())
    return buf.to(device, non_blocking=True)


class StageClock:
    """The `stats=` hook of the encode and decode loops: it adds host
    milliseconds per stage (keys ending in ``_ms``) and transfer counts
    (keys ending in ``_n``) into the caller's dict.  Each key is set with
    ``setdefault`` and then added to, so one dict can sum several calls.

    With ``stats=None`` every method returns at once without reading the
    clock; with a dict it reads only ``time.perf_counter()`` and adds, so
    the loop it instruments issues the same work and waits at the same
    points either way."""

    __slots__ = ("stats",)

    def __init__(self, stats: Optional[dict], keys):
        self.stats = stats
        if stats is not None:
            for key in keys:
                stats.setdefault(key, 0.0 if key.endswith("_ms") else 0)

    def tick(self) -> float:
        """The start of a stage."""
        return time.perf_counter() if self.stats is not None else 0.0

    def add(self, key: str, t0: float) -> float:
        """Add the milliseconds since `t0` to `key`; return now, the next
        stage's start."""
        if self.stats is None:
            return 0.0
        t1 = time.perf_counter()
        self.stats[key] += (t1 - t0) * 1e3
        return t1

    def count(self, key: str, k: int = 1) -> None:
        if self.stats is not None:
            self.stats[key] += k


# The clock of a loop called without `stats`: it records nothing.
NO_STATS = StageClock(None, ())
