"""Wrapper of the Hopper suffix-popcount table (``csrc/suffix_table.cu``).

It replaces no Pallas kernel: the JAX package's row store computes the
level-1 table with ``jnp`` on the device (``repro.core.rowstore``); the
port's row store computes it with this kernel from the rows it has just
uploaded.  Semantics: ``core.bitmap.suffix_popcounts`` on ``rows[:n]``,
written in place into ``suffix[:n]``; rows past ``n`` are not touched.

CUDA tensors only; the plain version for CPU tensors is
``core.bitmap.suffix_popcounts``, chosen by ``kernels.ops.suffix_tables``.
Each launch adds one to ``suffix_table.launches``.
"""

from __future__ import annotations

import torch

from . import _build

Tensor = torch.Tensor


def suffix_table(rows: Tensor, suffix: Tensor, n: int) -> Tensor:
    """Fill ``suffix[:n]`` (int32 ``(>= n, n_blocks + 1)``) with the
    suffix popcounts of ``rows[:n]`` (int32 ``(>= n, n_blocks,
    block_words)``) on the current stream; returns ``suffix``."""
    if rows.device.type != "cuda" or suffix.device != rows.device:
        raise ValueError("suffix_table takes CUDA tensors on one device, "
                         f"got {rows.device} and {suffix.device}")
    for name, t, dim in (("rows", rows, 3), ("suffix", suffix, 2)):
        if t.dtype != torch.int32 or t.dim() != dim \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-D int32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    n = int(n)
    _, nbl, bw = rows.shape
    if not 0 <= n <= min(rows.shape[0], suffix.shape[0]) \
            or suffix.shape[1] != nbl + 1:
        raise ValueError(f"suffix {tuple(suffix.shape)} and rows "
                         f"{tuple(rows.shape)} do not hold {n} rows' tables")
    if n == 0:
        return suffix
    err = _build.load().repro_suffix_table(
        rows.data_ptr(), suffix.data_ptr(), n, nbl, bw,
        torch.cuda.current_stream(rows.device).cuda_stream)
    _build.check(err, "suffix_table")
    suffix_table.launches += 1
    return suffix


suffix_table.launches = 0
