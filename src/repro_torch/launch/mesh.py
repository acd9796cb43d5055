"""Meshes (port of ``repro.launch.mesh``): ``DeviceMesh`` objects over the
initialised ``torch.distributed`` world.

* :func:`make_mining_mesh`: the sharded miner's 2-D ``("block", "cls")``
  mesh: ``block`` shards the TID-bitmap block axis (partial counts are
  all-reduced over it), ``cls`` splits each dispatch chunk's pairs (no
  reduction crosses it).
* :func:`make_host_mesh` / :func:`make_production_mesh`: the training
  meshes, ``(data, model)`` or ``(pod, data, model)``; the production
  ones need a world of 256 (one pod, 16 x 16) or 512 ranks (2 x 16 x 16).

The mesh's device type follows the backend: ``cuda`` under NCCL, ``cpu``
under gloo (whose collectives the port stages through the host for CUDA
tensors).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

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
    world = _world("make_mining_mesh")
    if cls < 1 or world % cls:
        raise ValueError(f"cls={cls} must divide the world size {world}")
    if block is None:
        block = world // cls
    if block * cls != world:
        raise ValueError(f"mesh ({block}, {cls}) does not cover the world "
                         f"of {world}")
    return _mesh((block, cls), ("block", "cls"))


def _world(who: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{who} needs an initialised torch.distributed "
                           "world (init_distributed, or "
                           "launch.forcedevices.run_ranks)")
    return dist.get_world_size()


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> DeviceMesh:
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(math.prod(shape), dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def make_host_mesh(shape: Sequence[int] = (1, 1),
                   axes: Sequence[str] = ("data", "model")) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the whole world (tests,
    single-host runs).  Raises unless the world has ``prod(shape)``
    ranks."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    world = _world("make_host_mesh")
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape, strict=True))} "
                         f"needs {math.prod(shape)} ranks, the world has "
                         f"{world}")
    return _mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Single pod: (data=16, model=16), 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16), 512 ranks across 2 pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_host_mesh(shape, axes)
