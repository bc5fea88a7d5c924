"""Process meshes over ``torch.distributed``.

Port of ``eorb_slam_tpu/parallel/mesh_utils.py``. The reference has no
distributed computing (a single process). This system scales its data axes
instead: landmarks and observations shard for bundle adjustment, event
batches for tensorization. The JAX package lays one 1-D "lm" axis over its
devices and reduces with ``psum`` inside ``shard_map``; here the axis is a
process group, one process (rank) per shard, and every psum is an explicit
``dist.all_reduce``. A rank holds the contiguous block of the landmark (or
event) axis that ``shard_map`` gives the device at its place in the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from eorb_slam_tpu_torch._host import resolve_device

LM_AXIS = "lm"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the process group, this process's rank in it, its size,
    the device this rank computes on, and the axis name. ``group`` is None
    for a world of one without ``torch.distributed``: nothing is reduced."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    axis: str = LM_AXIS

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the mesh (``psum``), in place."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t


def _rank_device(device, rank: int) -> torch.device:
    """``device`` as given, or the card: rank r takes card r mod the cards
    this host has (one rank per card under NCCL; gloo ranks may share one)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return device


def make_mesh(n_devices: Optional[int] = None, axis: str = LM_AXIS,
              device=None) -> Mesh:
    """The mesh over every process of the initialized default group (a
    world of one if ``torch.distributed`` is not initialized), on ``device``
    (None: the card). ``n_devices``, if given, must be that world size."""
    if dist.is_available() and dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} needs a world of {n_devices} "
                         f"processes, not {size}")
    return Mesh(group, rank, size, _rank_device(device, rank), axis)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a leaf lives on the mesh (JAX's NamedSharding): ``sharded``
    leaves are split along dim 0, the rank keeping its contiguous block;
    the others are whole on every rank. ``place(x)`` gives this rank's
    part on the mesh's device."""

    mesh: Mesh
    sharded: bool

    def place(self, x) -> torch.Tensor:
        x = torch.as_tensor(x)
        if self.sharded:
            x = x[block(self.mesh, x.shape[0])]
        return x.to(self.mesh.device)


def block(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous block of an axis of length ``n``, which must
    divide by the mesh size."""
    if n % mesh.size != 0:
        # tail rows would be owned by no rank: the caller pads first
        raise ValueError(f"axis of {n} not divisible by the mesh size "
                         f"{mesh.size}; pad it first")
    chunk = n // mesh.size
    return slice(mesh.rank * chunk, (mesh.rank + 1) * chunk)


def lm_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """Shard the leading (landmark) axis, keep the other ``ndim - 1`` whole."""
    return Sharding(mesh, sharded=True)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, sharded=False)
