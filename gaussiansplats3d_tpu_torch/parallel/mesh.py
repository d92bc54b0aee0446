"""The ``(splat, tile)`` device mesh over the ranks of a torch.distributed
world (counterpart of the JAX package's ``parallel/mesh.py``).

Each rank is one process on one device.  Ranks are laid out row-major:
rank ``i * tile_shards + j`` holds splat shard ``i`` and tile slab ``j``,
as the JAX package reshapes its device list.  The mesh's ``splat`` groups
(one per slab) gather the exchange; its ``tile`` groups (one per splat
shard) reduce the losses and the replicated parameters' gradients.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

SPLAT_AXIS = "splat"
TILE_AXIS = "tile"


def make_mesh(device_type: str = "cuda", splat_shards: Optional[int] = None,
              tile_shards: Optional[int] = None,
              ranks: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A 2-D ``(splat, tile)`` DeviceMesh over ``ranks`` (default: every
    rank of the initialised world).

    The default factorisation puts more ranks on the splat axis
    (projection dominates at large N): ``tile_shards`` is the largest power
    of two not above sqrt(n).  Every rank of the world calls this (the
    groups are made collectively); a rank outside ``ranks`` gets a mesh
    whose ``get_coordinate()`` is None and takes no part in its work.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.distributed.initialize_distributed)")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    if splat_shards is None and tile_shards is None:
        tile_shards = _largest_pow2_leq(int(math.sqrt(n)))
        splat_shards = n // tile_shards
    elif splat_shards is None:
        splat_shards = n // tile_shards
    elif tile_shards is None:
        tile_shards = n // splat_shards
    if splat_shards * tile_shards != n:
        raise ValueError(f"mesh {splat_shards}x{tile_shards} != {n} ranks")
    layout = torch.tensor(ranks, dtype=torch.int64).reshape(splat_shards,
                                                            tile_shards)
    return DeviceMesh(device_type, layout,
                      mesh_dim_names=(SPLAT_AXIS, TILE_AXIS))


def mesh_shape(mesh: DeviceMesh) -> tuple:
    """``(splat_shards, tile_shards)``."""
    return mesh.size(0), mesh.size(1)


def mesh_coordinate(mesh: DeviceMesh) -> tuple:
    """This rank's ``(splat index, slab index)``; raises for a rank
    outside the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return int(coord[0]), int(coord[1])


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on: the current CUDA device for
    a ``cuda`` mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _largest_pow2_leq(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p
