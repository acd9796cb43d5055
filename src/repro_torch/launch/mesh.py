"""The sharded miner's mesh (port of ``repro.launch.mesh.make_mining_mesh``).

A 2-D ``torch.distributed.device_mesh.DeviceMesh`` with dimensions
``("block", "cls")`` over the initialised world: ``block`` shards the
TID-bitmap block axis (partial counts are all-reduced over it), ``cls``
splits each dispatch chunk's pairs (no reduction crosses it).  The
training meshes of the JAX module (``make_host_mesh``,
``make_production_mesh``) belong to the training slice and are not here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch.multihost import init_distributed


def make_mining_mesh(*, block: "int | None" = None, cls: int = 1,
                     multihost: bool = False) -> DeviceMesh:
    """``(block, cls)`` mesh over the default process group.  ``cls`` must
    divide the world size; ``block=None`` takes the rest.  With
    ``multihost=True`` :func:`init_distributed` runs first (a no-op where
    no world is named).  The mesh's device type follows the backend:
    ``cuda`` under NCCL, ``cpu`` under gloo (whose collectives the port
    stages through the host for CUDA tensors, ``kernels.ops``)."""
    if multihost:
        init_distributed()
    if not dist.is_initialized():
        raise RuntimeError("make_mining_mesh needs an initialised "
                           "torch.distributed world (init_distributed, or "
                           "launch.forcedevices.run_ranks)")
    world = dist.get_world_size()
    if cls < 1 or world % cls:
        raise ValueError(f"cls={cls} must divide the world size {world}")
    if block is None:
        block = world // cls
    if block * cls != world:
        raise ValueError(f"mesh ({block}, {cls}) does not cover the world "
                         f"of {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(world, dtype=torch.int64).reshape(block, cls)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("block", "cls"))
