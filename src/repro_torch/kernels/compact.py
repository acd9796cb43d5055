"""Wrapper of the Hopper compaction gather (``csrc/compact.cu``).

Counterpart of ``repro.kernels.compact.compact_gather`` (the Pallas TPU
kernel): ``out[i] = slab[perm[i]]`` for ``0 <= perm[i] < capacity``,
zeros elsewhere.  It follows ``kernels.ref.compact_gather_ref`` — the
Pallas kernel clips ``perm >= capacity`` to ``capacity - 1`` and copies
that row; this kernel, like the jnp ref, zero-fills it.

CUDA tensors only (4-byte elements, contiguous); the plain version for
CPU tensors is ``kernels.ref.compact_gather_ref``, chosen by
``kernels.ops``.  Each launch adds one to ``compact_gather.launches``.
"""

from __future__ import annotations

import math

import torch

from . import _build

Tensor = torch.Tensor


def compact_gather(slab: Tensor, perm: Tensor) -> Tensor:
    """Gather ``slab`` rows by ``perm`` (int32, (new_capacity,)) into a
    fresh slab ``(new_capacity,) + slab.shape[1:]``."""
    if slab.device.type != "cuda" or perm.device != slab.device:
        raise ValueError("compact_gather takes CUDA tensors on one device, "
                         f"got {slab.device} and {perm.device}")
    if slab.element_size() != 4 or not slab.is_contiguous():
        raise ValueError("slab must be contiguous with 4-byte elements, got "
                         f"{slab.dtype}")
    if perm.dtype != torch.int32 or perm.dim() != 1 \
            or not perm.is_contiguous():
        raise ValueError("perm must be a contiguous int32 vector")
    n_out = int(perm.shape[0])
    out = torch.empty((n_out,) + tuple(slab.shape[1:]), dtype=slab.dtype,
                      device=slab.device)
    row_bytes = math.prod(slab.shape[1:]) * 4
    if n_out == 0 or row_bytes == 0:
        return out
    err = _build.load().repro_compact_gather(
        slab.data_ptr(), perm.data_ptr(), out.data_ptr(),
        int(slab.shape[0]), n_out, row_bytes,
        torch.cuda.current_stream(slab.device).cuda_stream)
    _build.check(err, "compact_gather")
    compact_gather.launches += 1
    return out


compact_gather.launches = 0
