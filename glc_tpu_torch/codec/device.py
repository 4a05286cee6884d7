"""Host↔device helpers shared by the encoder and decoder."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None picks CUDA when a card is present,
    else the CPU."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


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
