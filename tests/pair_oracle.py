"""The host path that the decode's pair words replaced, kept as the
oracle of `ops.kernels.scatter_pairs`: `chunk_pairs` builds a chunk's flat
positions and values with a numpy pass over every pair (out-of-range k
dropped, duplicate positions resolved last-wins), and `dense_q` scatters
them into a zero-filled q on the device.
"""

import numpy as np
import torch

from glc_tpu_torch.container.schema import FrameSet


def chunk_pairs(fs: FrameSet, start: int, count: int, pair_start: int,
                n: int):
    """Flat positions (frame·C + channel)·n + k (int64, relative to
    `start`) and values (int16) of the pairs of frames [start,
    start+count).

    Out-of-range k is dropped (the reference skips it, codec.rs:661).
    Duplicate positions, which only malformed streams hold, are resolved
    last-wins as the reference's sequential scatter does (codec.rs:660-663):
    the device scatter (`dense_q`) must see unique positions.
    """
    C = fs.channels
    nnz = fs.nnz[start : start + count].reshape(-1)
    P = int(nnz.sum())
    pairs = fs.pairs[pair_start : pair_start + P]
    k = pairs["k"].astype(np.int64)
    pos = np.repeat(np.arange(count * C, dtype=np.int64), nnz) * n + k
    vals = pairs["q"]
    in_range = k < n
    if not in_range.all():
        pos, vals = pos[in_range], vals[in_range]
    if len(pos) > 1 and not (np.diff(pos) > 0).all():
        # np.unique on the reversed stream keeps each position's LAST pair
        _, last = np.unique(pos[::-1], return_index=True)
        keep = np.sort(len(pos) - 1 - last)
        pos, vals = pos[keep], vals[keep]
    return pos, vals


def dense_q(pos: torch.Tensor, vals: torch.Tensor, frames: int,
            channels: int, n: int) -> torch.Tensor:
    """Scatter pairs into dense q [frames, C, n] int16.  `pos` holds unique
    flat indices (frame·C + channel)·n + k: a scatter with duplicate
    indices on CUDA has no defined order."""
    q = torch.zeros(frames * channels * n, dtype=torch.int16, device=pos.device)
    q[pos] = vals
    return q.view(frames, channels, n)
