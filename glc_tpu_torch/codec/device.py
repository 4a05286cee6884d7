"""Host↔device helpers shared by the encoder and decoder."""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from .. import profiling

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


def download_concat(parts, dtype, *row_shape) -> np.ndarray:
    """``torch.cat(parts)`` as a host array, with no concatenate on the
    device (which would hold every part twice there): one host array of the
    parts' total length, each part copied from its device straight into
    its slice, once.  `dtype` and `row_shape` give the array for an empty
    `parts`."""
    out = np.empty((sum(p.shape[0] for p in parts), *row_shape), dtype)
    at = 0
    for p in parts:
        torch.from_numpy(out[at : at + p.shape[0]]).copy_(p)
        at += p.shape[0]
    return out


class StageClock:
    """The stages of the encode and decode loops, for the `stats=` hook and
    the profiler from the same boundaries.  ``with clock.stage("unpack"):``
    adds the block's host milliseconds to ``stats["unpack_ms"]`` and, while
    a profiler records, spans it as ``glc.<area>.unpack`` (`profiling.stage`:
    a profiler range and, on CUDA, an NVTX range); ``call()`` is
    the whole call, ``wall_ms`` and ``glc.<area>``.  `count` adds transfer
    counts (keys ending in ``_n``).  Each key is set with ``setdefault``
    and then added to, so one dict can sum several calls.

    With ``stats=None`` and no profiler recording when the clock is made, a
    stage is one attribute check and returns `profiling.OFF`: no clock read
    and no profiler object.  Otherwise it reads only
    ``time.perf_counter()`` and adds, so the loop it instruments issues the
    same work and waits at the same points either way."""

    __slots__ = ("stats", "area", "spans", "live")

    def __init__(self, stats: Optional[dict], keys, area: str = ""):
        self.stats = stats
        self.area = area
        self.spans = bool(area) and profiling.recording()
        self.live = stats is not None or self.spans
        if stats is not None:
            for key in keys:
                stats.setdefault(key, 0.0 if key.endswith("_ms") else 0)

    def stage(self, name: str):
        """A stage of the loop: ``<name>_ms``, span ``glc.<area>.<name>``."""
        if not self.live:
            return profiling.OFF
        return _Stage(self, f"{name}_ms", f"glc.{self.area}.{name}")

    def call(self):
        """The whole call: ``wall_ms``, span ``glc.<area>``."""
        if not self.live:
            return profiling.OFF
        return _Stage(self, "wall_ms", f"glc.{self.area}")

    def count(self, key: str, k: int = 1) -> None:
        if self.stats is not None:
            self.stats[key] += k


class _Stage:
    """One stage of a live `StageClock`: the clock is read inside the
    span, so the span holds the milliseconds the key adds."""

    __slots__ = ("stats", "key", "span", "t0")

    def __init__(self, clock: StageClock, key: str, name: str):
        self.stats = clock.stats
        self.key = key
        self.span = profiling.stage(name) if clock.spans else None

    def __enter__(self):
        if self.span is not None:
            self.span.__enter__()
        if self.stats is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.stats is not None:
            self.stats[self.key] += (time.perf_counter() - self.t0) * 1e3
        if self.span is not None:
            return self.span.__exit__(*exc)
        return False


# The clock of a loop called without `stats`: it records nothing.
NO_STATS = StageClock(None, ())
