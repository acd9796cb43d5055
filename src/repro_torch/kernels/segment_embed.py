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

The kernel is reached through the custom op ``repro::embedding_bag``
(:func:`embedding_bag_op`): the kernel on CUDA tensors, the plain
version on CPU tensors (its checks), a shape function for fake tensors
(the dry-run traces the card's path without a card) and a FLOP formula
for ``FlopCounterMode`` (one add per slot and width, ``B * L * D``).

Under autograd (a table that requires grad, training) ``kernels.ops``
wraps the op in :class:`EmbeddingBagFn`: the forward launches it,
and the backward is :func:`embedding_bag_grad`, plain PyTorch.  That
backward is not a port of any TPU kernel: no Pallas kernel of the JAX
package has a backward pass, and JAX differentiates its jnp
``embedding_bag`` (a masked gather) instead; the function is that VJP.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .ref import embedding_bag_ref

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


def embedding_bag_grad(g: Tensor, ids: Tensor, mask: Tensor, n_rows: int,
                       combiner: str = "mean") -> Tensor:
    """The table's gradient of the masked sum/mean bag, as JAX
    differentiates ``repro.models.recsys.embedding_bag``: row ``ids[b, l]``
    gains ``g[b] / count[b] * mask[b, l]`` (``mean``; no division for
    ``sum``), accumulated with ``index_add_`` into a dense ``(n_rows, D)``
    table, as JAX's gradient is dense.  Masked slots add zero (their ids
    are clamped into the table).  Plain PyTorch: CPU or CUDA tensors."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    D = g.shape[-1]
    m = mask.to(g.dtype)
    if combiner == "mean":
        g = g / torch.clamp(m.sum(dim=-1, keepdim=True), min=1.0)
    contrib = (g[:, None, :] * m[:, :, None]).reshape(-1, D)
    safe = ids.clamp(0, max(n_rows - 1, 0)).reshape(-1)
    out = torch.zeros((n_rows, D), dtype=g.dtype, device=g.device)
    return out.index_add_(0, safe, contrib)


@torch.library.custom_op("repro::embedding_bag", mutates_args=())
def embedding_bag_op(table: Tensor, ids: Tensor, mask: Tensor,
                     combiner: str) -> Tensor:
    """:func:`embedding_bag` (the kernel) on CUDA tensors; the plain
    version on CPU tensors."""
    if table.device.type == "cuda":
        return embedding_bag(table, ids, mask, combiner=combiner)
    return embedding_bag_ref(table, ids, mask, combiner=combiner)


@embedding_bag_op.register_fake
def _embedding_bag_fake(table, ids, mask, combiner):
    return table.new_empty((ids.shape[0], table.shape[1]),
                           dtype=torch.float32)


@register_flop_formula(torch.ops.repro.embedding_bag)
def embedding_bag_flops(table_shape, ids_shape, *args, **kwargs) -> int:
    """One add per slot and column: ``B * L * D``."""
    return int(ids_shape[0]) * int(ids_shape[1]) * int(table_shape[1])


class EmbeddingBagFn(torch.autograd.Function):
    """:func:`embedding_bag` (the kernel) under autograd; the backward is
    :func:`embedding_bag_grad` (the VJP of the masked gather, no kernel)."""

    @staticmethod
    def forward(ctx, table: Tensor, ids: Tensor, mask: Tensor,
                combiner: str) -> Tensor:
        ctx.save_for_backward(ids, mask)
        ctx.n_rows, ctx.combiner = table.shape[0], combiner
        return embedding_bag_op(table, ids, mask, combiner)

    @staticmethod
    def backward(ctx, g: Tensor):
        ids, mask = ctx.saved_tensors
        return (embedding_bag_grad(g, ids, mask, ctx.n_rows, ctx.combiner),
                None, None, None)
