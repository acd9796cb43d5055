"""Rank bodies of ``tests/test_torch_analysis.py``'s gloo worlds (run by
``repro_torch.launch.forcedevices.run_ranks``).  Imports no JAX."""

import numpy as np
import torch

from repro_torch.core.distributed import (make_mining_round,
                                          make_mining_round_v2)
from repro_torch.launch.mesh import make_host_mesh


def mining_rounds(rank, world, store, suffix1, pairs, pair_chunk, shape):
    """Both rounds on this rank's block slice of ``store`` (blocks split
    evenly in rank order over the ``shape`` mesh): ``(bound, count)`` of
    each, as numpy."""
    mesh = make_host_mesh(shape)
    nb = store.shape[1] // world
    local = torch.from_numpy(np.ascontiguousarray(
        store[:, rank * nb:(rank + 1) * nb]))
    p = torch.from_numpy(pairs)
    rho = torch.zeros(pairs.shape[0], dtype=torch.int32)
    b1, c1 = make_mining_round(mesh, pair_chunk=pair_chunk)(local, p, rho)
    s1 = torch.from_numpy(np.ascontiguousarray(suffix1[:, rank:rank + 1]))
    b2, c2 = make_mining_round_v2(mesh, pair_chunk=pair_chunk)(local, s1, p,
                                                                rho)
    return [t.numpy() for t in (b1, c1, b2, c2)]
