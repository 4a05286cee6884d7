"""Sharded codec steps over a DeviceMesh (SPMD over a torch.distributed world).

Port of ``glc_tpu/parallel/sharded.py``.  The JAX functions are
single-controller: one process holds the full arrays and ``shard_map``
runs the body per device.  Here every rank of the mesh calls the same
function with the same full host inputs.  Each rank takes its block by its
mesh coordinate (B over 'data', K over 'frames', the ``PartitionSpec``s of
the JAX module), computes it on its device, and returns the full result,
gathered to every rank.  A B or K that the mesh does not divide raises
ValueError, as ``shard_map`` refuses it.

Layouts (B = independent streams, K = frames per stream):

* encode: blocks [B, K, C, 2n].  Embarrassingly parallel: no collective
  until the final gather (SURVEY.md §2.8: the rayon frame loop becomes
  pure data parallelism).
* decode: overlap-add couples frame f to f−1 only, so each 'frames' shard
  needs its left neighbour's last second half: one point-to-point
  [Bl, C, n] halo a step, the counterpart of the reference's sequential
  overlap buffer (codec.rs:688-705).  One `imdct_window` launch a rank.
* roundtrip_step: encode → decode → reconstruction MSE, the error sums
  all-reduced over 'frames', then 'data' (the two ``psum``s).

Collectives run on the mesh's groups.  A group with NCCL takes CUDA
tensors as they are; any other backend (gloo) takes host copies, so that
several gloo ranks can share one card.  A failed collective raises, and
nothing falls back to the serial codec or to the CPU.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..codec.device import upload
from ..ops.decode import blocks_from_frames
from ..ops.encode import encode_math


class Shard(NamedTuple):
    """This rank's place in the mesh: its coordinate and the axis sizes
    of 'data' and 'frames', and the device its shard computes on."""

    d: int
    data: int
    f: int
    frames: int
    device: torch.device


def shard_device(mesh: DeviceMesh) -> torch.device:
    """The device a rank's shard computes on: the mesh's device type, and
    for "cuda" the process's current CUDA device.  Raises RuntimeError for
    a CUDA mesh in a process without one (it never computes on the CPU
    instead)."""
    if mesh.device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the mesh computes on cuda, but this process "
                               "has no CUDA device")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis_ranks(mesh: DeviceMesh, name: str) -> List[int]:
    """The global ranks along axis `name` through this rank, in
    coordinate order."""
    dim = mesh.mesh_dim_names.index(name)
    index = list(mesh.get_coordinate())
    index[dim] = slice(None)
    return mesh.mesh[tuple(index)].tolist()


def local_shard(mesh: DeviceMesh) -> Shard:
    """This rank's `Shard`.  Raises ValueError for a mesh without 'data'
    and 'frames' axes or one this rank is not in."""
    names = mesh.mesh_dim_names or ()
    if "data" not in names or "frames" not in names:
        raise ValueError(f"the sharded steps need a mesh with 'data' and "
                         f"'frames' axes, not {names}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    i, j = names.index("data"), names.index("frames")
    return Shard(coord[i], mesh.shape[i], coord[j], mesh.shape[j],
                 shard_device(mesh))


def _block_slices(shape: Sequence[int], shard: Shard, frames_axis: bool):
    """The index of this shard's block of an array of `shape`: B over
    'data', and K over 'frames' if `frames_axis`."""
    axes = [("data", shard.d, shard.data)]
    if frames_axis:
        axes.append(("frames", shard.f, shard.frames))
    index = []
    for size, (name, i, count) in zip(shape, axes):
        if size % count:
            raise ValueError(f"axis of size {size} is not divisible by the "
                             f"'{name}' axis of the mesh ({count} shards)")
        step = size // count
        index.append(slice(i * step, (i + 1) * step))
    return tuple(index)


def _take(x, shard: Shard, frames_axis: bool = True) -> torch.Tensor:
    """This shard's block of a full host input (numpy or tensor), on the
    shard's device."""
    index = _block_slices(x.shape, shard, frames_axis)
    if isinstance(x, torch.Tensor):
        return x[index].to(shard.device).contiguous()
    return upload(np.asarray(x)[index], shard.device)


def check_tables(tables, shard: Shard) -> None:
    """The tables must live where the shard computes: a CUDA mesh never
    computes a shard with CPU tables."""
    if tables.cos_table.device != shard.device:
        raise ValueError(f"the tables are on {tables.cos_table.device}, the "
                         f"mesh computes on {shard.device}")


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """A new contiguous copy of `t` where a collective on `group` takes
    it: on the device for NCCL, in host memory for any other backend."""
    if t.is_cuda and "nccl" in dist.get_backend(group):
        return t.clone(memory_format=torch.contiguous_format)
    return t.to("cpu", copy=True).contiguous()


def gather_axis(t: torch.Tensor, mesh: DeviceMesh, name: str,
                dim: int) -> torch.Tensor:
    """Every shard's `t` along axis `name`, concatenated in coordinate
    order along `dim` (on the wire's device)."""
    group = mesh.get_group(name)
    wire = _wire(t, group)
    parts = [torch.empty_like(wire) for _ in range(group.size())]
    dist.all_gather(parts, wire, group=group)
    return torch.cat([parts[dist.get_group_rank(group, r)]
                      for r in _axis_ranks(mesh, name)], dim=dim)


def gather_blocks(mesh: DeviceMesh,
                  blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The full [B, K, ...] arrays of per-shard [Bl, Kl, ...] blocks (the
    out_specs ``P('data', 'frames', ...)``), on every rank.  The blocks
    travel as the bytes of each (b, k) position, packed into one buffer:
    one all_gather over 'frames', then one over 'data'."""
    Bl, Kl = blocks[0].shape[:2]
    packed = torch.cat([t.contiguous().view(torch.uint8).reshape(Bl, Kl, -1)
                        for t in blocks], dim=2)
    full = gather_axis(gather_axis(packed, mesh, "frames", 1),
                       mesh, "data", 0)
    B, K = full.shape[:2]
    out, o = [], 0
    for t in blocks:
        width = t[0, 0].numel() * t.element_size()
        piece = full[..., o : o + width].contiguous().view(t.dtype)
        out.append(piece.reshape(B, K, *t.shape[2:]))
        o += width
    return out


def encode_local(blocks: torch.Tensor, tables, **params):
    """`encode_math` of one shard's blocks [Bl, Kl, C, 2n] on their
    device."""
    return encode_math(
        blocks, tables.cos_table, tables.window, tables.norm,
        tables.band_mask, tables.band_inv_count, tables.band_pf,
        tables.band_of, tables.inv_w, **params,
    )


def encode_chunk_sharded(mesh: DeviceMesh, blocks, tables, **params):
    """Encode blocks [B, K, C, 2n] with B over 'data', K over 'frames'.

    Each rank runs `encode_math` on its [B/d, K/f, C, 2n] block; no
    collective but the final gather.  `tables` is a `CodecTables` on the
    mesh's device, `params` encode_math's keywords.  Returns (q, nnz,
    scale, raw, use_raw) at [B, K, ...], on the rank's device.
    """
    shard = local_shard(mesh)
    check_tables(tables, shard)
    outs = encode_local(_take(blocks, shard), tables, **params)
    return tuple(t.to(shard.device) for t in gather_blocks(mesh, outs))


def _ola_with_halo(blocks: torch.Tensor, carry: torch.Tensor, n: int,
                   mesh: DeviceMesh):
    """Local overlap-add with a 1-hop left halo over the 'frames' axis.

    blocks: [Bl, Kl, C, 2n] local shard.  carry: [Bl, C, n], the global
    stream's incoming overlap (used by the first 'frames' shard only).
    Each shard sends its last second half to its right neighbour, with no
    wraparound.  Returns (hops [Bl, Kl, C, n], tail [Bl, C, n]: the last
    shard's last second half, on every shard of the axis).
    """
    second = blocks[..., n:]
    last = second[:, -1]  # [Bl, C, n]
    group = mesh.get_group("frames")
    ranks = _axis_ranks(mesh, "frames")
    f = ranks.index(dist.get_rank())
    prev = carry
    ops = []
    if f + 1 < len(ranks):
        ops.append(dist.P2POp(dist.isend, _wire(last, group), ranks[f + 1],
                              group))
    if f > 0:
        halo = _wire(last, group)
        ops.append(dist.P2POp(dist.irecv, halo, ranks[f - 1], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if f > 0:
        prev = halo.to(blocks.device)
    hops = blocks[..., :n] + torch.cat([prev[:, None], second[:, :-1]], dim=1)
    tail = _wire(last, group)
    dist.broadcast(tail, ranks[-1], group=group)
    return hops, tail.to(blocks.device)


def decode_local(mesh: DeviceMesh, q, scales, raw_idx, raw_rows, carry,
                 tables, *, max_q: float, window_raw: bool):
    """Decode one shard: q [Bl, Kl, C, n] int16 and scales [Bl, Kl, C] f32
    on the shard's device, with the raw frames as `blocks_from_frames`
    takes them (their flat indices into the Bl·Kl frames and their rows
    [R, C, 2n] int16), then the halo.  One `imdct_window` launch on
    Bl·Kl·C rows.  Returns (hops [Bl, Kl, C, n], tail [Bl, C, n])."""
    Bl, Kl, C, n = q.shape
    blocks = blocks_from_frames(
        q.reshape(Bl * Kl, C, n), scales.reshape(Bl * Kl, C), raw_idx,
        raw_rows, tables.cos_table, tables.window, tables.norm_value,
        max_q=max_q, window_raw=window_raw,
    ).view(Bl, Kl, C, 2 * n)
    return _ola_with_halo(blocks, carry, n, mesh)


def decode_chunk_sharded(
    mesh: DeviceMesh, q, scales, raw_pcm, is_raw, carry, tables,
    *, max_q: float = 32768.0, window_raw: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode frames [B, K, C, n] sharded (B over 'data', K over 'frames').

    q [B, K, C, n] int16, scales [B, K, C] f32, raw_pcm [B, K, C, 2n]
    int16 with is_raw [B, K] bool, carry [B, C, n] f32.  Returns (hops
    [B, K, C, n], tail [B, C, n]) on the rank's device.  The only
    collective before the gathers is the 1-hop halo of `_ola_with_halo`.
    """
    shard = local_shard(mesh)
    check_tables(tables, shard)
    C, n = q.shape[2:]
    # the dense raw frames as blocks_from_frames takes them
    raw_idx = torch.nonzero(_take(is_raw, shard).reshape(-1)).squeeze(1)
    raw_rows = _take(raw_pcm, shard).reshape(-1, C, 2 * n)[raw_idx]
    hops, tail = decode_local(
        mesh, _take(q, shard), _take(scales, shard), raw_idx, raw_rows,
        _take(carry, shard, frames_axis=False), tables,
        max_q=max_q, window_raw=window_raw,
    )
    (hops,) = gather_blocks(mesh, [hops])
    tail = gather_axis(tail, mesh, "data", 0)
    return hops.to(shard.device), tail.to(shard.device)


def roundtrip_step_sharded(
    mesh: DeviceMesh, blocks, carry, tables, **params
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full pipeline step for the multi-chip dry run: encode → decode →
    reconstruction error, sharded over the ('data', 'frames') mesh.

    blocks: [B, K, C, 2n] input frames, carry [B, C, n]; returns (mse, a
    0-dim f32 tensor, and hops [B, K, C, n]), on the rank's device.
    Collectives: the OLA halo, then the error sums over 'frames' and over
    'data' (the complete communication footprint of the codec), then the
    gather of the hops.  The sums accumulate in float64, so the mse does
    not depend on how the frames are sharded beyond the last bits.
    """
    shard = local_shard(mesh)
    check_tables(tables, shard)
    x = _take(blocks, shard)
    Bl, Kl, C, frame_size = x.shape
    n = frame_size // 2
    q, _nnz, scale, raw, use_raw = encode_local(x, tables, **params)
    raw_idx = torch.nonzero(use_raw.reshape(-1)).squeeze(1)
    rec = blocks_from_frames(
        q.reshape(-1, C, n), scale.reshape(-1, C), raw_idx,
        raw.reshape(-1, C, frame_size)[raw_idx], tables.cos_table,
        tables.window, tables.norm_value,
    ).view(Bl, Kl, C, frame_size)
    hops, _tail = _ola_with_halo(
        rec, _take(carry, shard, frames_axis=False), n, mesh)
    # Princen-Bradley: analysis+synthesis windowing with 50% OLA
    # reconstructs the UNwindowed signal (sin window: w[t]² + w[t+n]² = 1),
    # so the reconstruction target is the raw first half of each block.
    err = hops - x[..., :n]
    sums = torch.stack([torch.sum(err * err, dtype=torch.float64),
                        torch.tensor(float(err.numel()), dtype=torch.float64,
                                     device=err.device)])
    for name in ("frames", "data"):
        group = mesh.get_group(name)
        sums = _wire(sums, group)
        dist.all_reduce(sums, group=group)
    mse = (sums[0] / sums[1]).to(torch.float32).to(shard.device)
    (hops,) = gather_blocks(mesh, [hops])
    return mse, hops.to(shard.device)
