"""Bootstrap of a torch.distributed world, and checkpoints (counterpart of
the JAX package's ``parallel/distributed.py``).

Every rank is one process on one device and calls the same functions with
its own shard (SPMD).  :func:`initialize_distributed` starts the process
group from its arguments or from ``torchrun``'s environment; the backend
follows the device the caller names (``nccl`` for ``cuda``, ``gloo`` for
``cpu``) and never changes on a failure.

Checkpoints follow the reference's view that the scene file is the
checkpoint: the splats go to a standard ``.ksplat`` (the port's
``save_ksplat``; any viewer loads it), the exact parameters, the
optimizer's per-parameter state and the step to ``.opt.npz`` beside it.
Under a mesh, the mesh's first rank writes what the ranks' shards gather
to while the others wait for the files, and every rank loads the whole
file and keeps its own shard.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: str = "cuda") -> bool:
    """Start the process group; True when the world has more than one rank.

    ``coordinator_address`` is ``host:port`` (a ``tcp://`` rendezvous) or a
    URL such as ``file:///path/store``.  Unset arguments come from
    ``torchrun``'s environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``); with neither, nothing starts and the result
    is False.  ``device`` names the ranks' device type: ``cuda`` (NCCL;
    each rank takes the GPU ``LOCAL_RANK``, else its rank modulo the
    card count) or ``cpu`` (gloo).  A world that is already initialised is
    kept as it is.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize_distributed needs the coordinator "
                         "address, the number of processes and this "
                         "process's id")
    dev_type = torch.device(device).type
    if dev_type not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}")
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda') found "
                               "no CUDA device")
        local = int(env.get("LOCAL_RANK",
                            process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(_BACKENDS[dev_type], init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return num_processes > 1


def _param_tensors(state):
    """{name: tensor} of the parameters and of the optimizer's
    per-parameter state (``opt.<field>.<key>``), detached."""
    from .train import SplatParams

    out = {f"params.{f}": getattr(state.params, f).detach()
           for f in SplatParams.FIELDS}
    if state.opt_state is not None:
        for f in SplatParams.FIELDS:
            for key, v in state.opt_state.state.get(
                    getattr(state.params, f), {}).items():
                if isinstance(v, torch.Tensor):
                    out[f"opt.{f}.{key}"] = v.detach()
    return out


def save_checkpoint(state, path_prefix: str, compression_level: int = 0,
                    mesh=None, route: str = "gather") -> None:
    """Save a TrainState: the splats as ``path_prefix.ksplat`` and the exact
    parameters, optimizer state and step as ``path_prefix.opt.npz``.

    With ``mesh`` (the state's shards placed by
    ``sharded.device_put_sharded_splats`` with ``route``), every rank of
    the mesh calls this: the shards are gathered over the splat groups
    (over the whole mesh for ``a2a``), the mesh's first rank (its (0, 0),
    rank 0 of a mesh over the world) writes, and the call returns on
    every rank once the files are complete.  The rows are written as
    the mesh holds them, the transparent pad splats included, as the JAX
    package writes its padded global arrays.
    """
    tensors = _param_tensors(state)
    if mesh is not None:
        from .mesh import mesh_coordinate
        from .sharded import gather_rows
        n_rows = state.params.num_splats
        tensors = {k: gather_rows(v, mesh, route)
                   if v.dim() and v.shape[0] == n_rows else v
                   for k, v in tensors.items()}
        if mesh_coordinate(mesh) == (0, 0):
            _write_checkpoint(state, tensors, path_prefix, compression_level)
        _mesh_barrier(mesh)
        return
    _write_checkpoint(state, tensors, path_prefix, compression_level)


def _write_checkpoint(state, tensors: dict, path_prefix: str,
                      compression_level: int) -> None:
    from ..io.ksplat import save_ksplat
    from .train import SplatParams

    host = {k: v.cpu().numpy() for k, v in tensors.items()}
    params = SplatParams(*(torch.from_numpy(host[f"params.{f}"])
                           for f in SplatParams.FIELDS))
    with torch.no_grad():
        save_ksplat(params.to_splats(), path_prefix + ".ksplat",
                    compression_level=compression_level)
    np.savez(path_prefix + ".opt.npz", step=np.int64(state.step), **host)


def _mesh_barrier(mesh) -> None:
    """Return on every rank of ``mesh`` only once its rank (0, 0) has
    reached it: a barrier over each splat group, then over each tile
    group (rank (i, j) waits for (i, 0), which waited for (0, 0))."""
    from .mesh import SPLAT_AXIS, TILE_AXIS
    dist.barrier(group=mesh.get_group(SPLAT_AXIS))
    dist.barrier(group=mesh.get_group(TILE_AXIS))


def load_checkpoint(path_prefix: str, optimizer, mesh=None,
                    route: str = "gather", device="cuda"):
    """Load a TrainState saved by :func:`save_checkpoint`.

    The ``.ksplat`` alone resumes rendering anywhere; the ``.opt.npz``, when
    present, restores the exact parameters, the optimizer's state and the
    step.  ``optimizer`` is a factory of parameters -> optimizer
    (``train.adam``).  With ``mesh`` each rank keeps its own shard (the
    layout of ``sharded.device_put_sharded_splats`` with ``route``) on its
    mesh device; else the whole state goes to ``device``.
    """
    from ..io.ksplat import load_ksplat
    from .train import SplatParams, TrainState

    npz_path = path_prefix + ".opt.npz"
    if os.path.exists(npz_path):
        with np.load(npz_path) as data:
            host = {k: torch.from_numpy(data[k]) for k in data.files}
        step = int(host.pop("step"))
    else:
        splats = load_ksplat(path_prefix + ".ksplat", device="cpu")
        if mesh is not None:
            from .sharded import pad_splats_for_mesh
            splats = pad_splats_for_mesh(splats, mesh, route)
        host = {f"params.{f}": getattr(SplatParams.from_splats(splats),
                                       f).detach()
                for f in SplatParams.FIELDS}
        step = 0
    if mesh is not None:
        from .mesh import mesh_device
        from .sharded import local_rows
        n_rows = host["params.means"].shape[0]
        host = {k: local_rows(v, mesh, route)
                if v.dim() and v.shape[0] == n_rows else v
                for k, v in host.items()}
        device = mesh_device(mesh)
    params = SplatParams(*(host[f"params.{f}"].to(device)
                           for f in SplatParams.FIELDS))
    opt = optimizer(params.parameters())
    opt_state = {i: {k.split(".", 2)[2]: v.to(device)
                     if v.dim() else v.clone()
                     for k, v in host.items() if k.startswith(f"opt.{f}.")}
                 for i, f in enumerate(SplatParams.FIELDS)}
    if any(opt_state.values()):
        sd = opt.state_dict()
        sd["state"] = {i: st for i, st in opt_state.items() if st}
        opt.load_state_dict(sd)
    return TrainState(params=params, opt_state=opt, step=step)
