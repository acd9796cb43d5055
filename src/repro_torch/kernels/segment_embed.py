"""Wrapper of the Hopper EmbeddingBag kernel (``csrc/segment_embed.cu``).

Counterpart of ``repro.kernels.segment_embed.embedding_bag`` (the Pallas
TPU kernel): per bag, the masked sum (or mean, over ``max(count, 1)``)
of the table rows its ids name.  An all-masked bag gives zeros.  The
kernel walks each bag's valid slots in order, so its sums are bit-equal
to the plain version's; it takes a latency design for small batches and
a throughput design for large ones (``csrc/segment_embed.cu``).

CUDA tensors only: an fp32 ``(V, D)`` table, int32 ``(B, L)`` ids and an
int32 or bool ``(B, L)`` mask.  Ids on valid slots must lie in ``[0,
V)``; the kernel never reads a row outside the table.  The plain version
for CPU tensors is ``kernels.ref.embedding_bag_ref``, chosen by
``kernels.ops``.  Each launch adds one to ``embedding_bag.launches``;
launches are on ``torch.cuda.current_stream()`` and never synchronise.
"""

from __future__ import annotations

import torch

from . import _build

Tensor = torch.Tensor

_MASK_BYTES = {torch.int32: 4, torch.bool: 1}


def embedding_bag(table: Tensor, ids: Tensor, mask: Tensor, *,
                  combiner: str = "mean") -> Tensor:
    """``(B, D)`` fp32 bag embeddings; ``combiner`` is "sum" or "mean"."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    if table.device.type != "cuda" or ids.device != table.device \
            or mask.device != table.device:
        raise ValueError("embedding_bag takes CUDA tensors on one device, "
                         f"got {table.device}, {ids.device}, {mask.device}")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"table must be a 2-D float32 tensor, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if ids.dtype != torch.int32 or ids.dim() != 2:
        raise ValueError(f"ids must be a 2-D int32 tensor, got {ids.dtype}")
    if mask.dtype not in _MASK_BYTES or tuple(mask.shape) != tuple(ids.shape):
        raise ValueError(f"mask must be int32 or bool of shape "
                         f"{tuple(ids.shape)}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    V, D = table.shape
    B, L = ids.shape
    table, ids, mask = table.contiguous(), ids.contiguous(), mask.contiguous()
    out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    if B == 0 or D == 0:
        return out
    err = _build.load().repro_embedding_bag(
        table.data_ptr(), ids.data_ptr(), mask.data_ptr(), out.data_ptr(),
        V, D, B, L, _MASK_BYTES[mask.dtype], int(combiner == "mean"),
        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(err, "embedding_bag")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
