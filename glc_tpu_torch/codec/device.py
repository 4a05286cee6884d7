"""Host↔device helpers shared by the encoder and decoder."""

from __future__ import annotations

import os

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
