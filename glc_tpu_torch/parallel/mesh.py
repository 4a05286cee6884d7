"""Mesh construction: a ``torch.distributed`` DeviceMesh over the world.

Port of ``glc_tpu/parallel/mesh.py``.  The JAX mesh lays devices out on a
grid; here each device is one rank of a ``torch.distributed`` world, and
the mesh is a `DeviceMesh` whose 'data' and 'frames' groups are the axes
the sharded steps communicate along.  The caller starts the world
(``torch.distributed.init_process_group``): `make_mesh` never starts one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..codec.device import resolve_device


def mesh_shape(n: int, axis_names: Sequence[str] = ("data", "frames"),
               shape: Optional[Tuple[int, ...]] = None) -> Tuple[int, ...]:
    """The mesh shape `make_mesh` lays `n` devices out on (the rule of
    glc_tpu/parallel/mesh.py:33-44): `shape` if given; else ``(n,)`` for one
    axis name; else ``(2, n/2)`` for even n ≥ 4 and ``(1, n)`` otherwise,
    so the halo path always has ≥ 2 'frames' shards.  Raises ValueError
    if the shape does not cover n."""
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            # favor the frames axis; 'data' absorbs the remainder factor
            frames = n
            data = 1
            if n % 2 == 0 and n >= 4:
                data, frames = 2, n // 2
            shape = (data, frames)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    return shape


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data", "frames"),
    shape: Optional[Tuple[int, ...]] = None,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """Build a mesh over the first `n_devices` ranks of the world.

    Default layout is 2D ('data', 'frames'): the 'data' axis shards
    independent streams (files / batch), the 'frames' axis shards the frame
    axis of one stream (the context-parallel direction, where the OLA halo
    travels).  The shape follows `mesh_shape`; pass `shape` explicitly to
    shard a single long stream over every rank, e.g. shape=(1, n).

    Every rank of the world calls it, with the same arguments (the groups
    of a mesh are made collectively).  With `n_devices` below the world
    size the mesh holds ranks 0..n−1, as the JAX package takes the first n
    devices; the other ranks get a mesh they are not in, and the sharded
    steps raise on them.

    `device_type` is where each rank's shard computes: "cuda" (the
    process's current CUDA device) or "cpu"; None is the port's default
    (`resolve_device`: $GLC_TORCH_DEVICE, else the card, else an error).
    Raises RuntimeError if no process group is initialized, and
    ValueError for more devices than the world has or a shape that does
    not cover them.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed world: call "
            "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} present")
    shape = mesh_shape(n, axis_names, shape)
    if device_type is None:
        device_type = resolve_device(None).type
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))
