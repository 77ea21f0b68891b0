"""The data-parallel "mesh" of the port: a process group and the rank's
device.

The JAX package's ``make_dp_mesh`` builds a 1-D ``jax.sharding.Mesh`` over
devices of one controller process.  Here each rank is a process with one
device; ``DPMesh`` holds the group, this process's rank in it, its size
and the device.  With no process group initialized the mesh is a world of
one (the counterpart of ``make_dp_mesh(1)``): no collective runs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DPMesh:
    """``group`` None is a world of one with no process group; ``rank`` is
    -1 on a process outside the group."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    @property
    def member(self) -> bool:
        return self.rank >= 0


def _rank_device(device) -> torch.device:
    """"cuda" (the default) is this process's card, cuda:LOCAL_RANK, made
    the current device for NCCL; an explicit device is taken as given."""
    if device is None or str(device) == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def make_dp_mesh(n_devices: Optional[int] = None, group=None,
                 device=None) -> DPMesh:
    """The data-parallel mesh over ``group`` (default: the whole default
    process group, when one is initialized).  ``n_devices`` builds a
    subgroup of ranks 0..n-1 (``dist.new_group``: every rank of the
    default group must call this together).  ``device`` is the rank's
    device ("cuda" = cuda:LOCAL_RANK by default, or "cpu")."""
    device = _rank_device(device)
    if not dist.is_initialized():
        if group is not None or (n_devices or 1) != 1:
            raise ValueError("a mesh of more than one rank needs an "
                             "initialized torch.distributed process group")
        return DPMesh(group=None, rank=0, size=1, device=device)
    if group is None:
        group = dist.group.WORLD
        if n_devices is not None and n_devices != dist.get_world_size():
            if not 1 <= n_devices <= dist.get_world_size():
                raise ValueError(f"n_devices {n_devices} outside 1.."
                                 f"{dist.get_world_size()}")
            group = dist.new_group(list(range(n_devices)))
    return DPMesh(group=group, rank=dist.get_rank(group),
                  size=dist.get_world_size(group), device=device)


def replicated(mesh: DPMesh, arr) -> torch.Tensor:
    """A copy of ``arr`` on the rank's device (each rank holds the whole
    table; made once, by the caller that keeps it)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(mesh.device)


def dp_sharded(mesh: DPMesh, arr) -> torch.Tensor:
    """The rank's slice of the leading (document / batch) axis of ``arr``
    (which divides by the mesh size), on the rank's device."""
    arr = np.asarray(arr)
    if arr.shape[0] % mesh.size:
        raise ValueError(f"leading axis {arr.shape[0]} does not divide by "
                         f"the mesh size {mesh.size}")
    per = arr.shape[0] // mesh.size
    part = arr[mesh.rank * per:(mesh.rank + 1) * per]
    return torch.from_numpy(np.ascontiguousarray(part)).to(mesh.device)
