"""Collectives over a process group, with the autograd rules a program
split over ranks needs (what ``shard_map``'s transposes give the JAX
package).

Each rank runs the same program on its own shard and seeds its backward
with its own copy of the (replicated) loss.  The rules below make every
rank's gradients those of the one global function:

* :func:`reduce`: sum over the group forward; the backward is the
  identity, because what follows the sum is replicated on every rank of
  the group, and each replica carries the whole cotangent;
* :func:`replicate`: the identity forward; the backward sums the
  cotangents over the group, for a replicated tensor that each rank then
  uses in part (a column slice, a parameter shard);
* :func:`gather_rows`: concatenates every rank's rows forward; the
  backward sums the cotangents over the group and keeps this rank's
  rows (a reduce-scatter, run as an all-reduce so that gloo runs it).

Under gloo, CUDA tensors are staged through the host (copied there,
reduced or gathered, copied back), always in that configuration; under
NCCL and for CPU tensors under gloo they go to the collective as they
are.  A group of one rank is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def group_size(group) -> int:
    return dist.get_world_size(group)


def _staged(t: Tensor) -> bool:
    return t.device.type == "cuda" and dist.get_backend() == "gloo"


def all_reduce(t: Tensor, group) -> Tensor:
    """The sum of ``t`` over ``group`` (a new tensor)."""
    if group_size(group) == 1:
        return t.clone()
    h = t.detach().cpu() if _staged(t) else t.detach().clone()
    dist.all_reduce(h, group=group)
    return h.to(t.device)


def all_gather(t: Tensor, group) -> Tensor:
    """Every rank's ``t`` concatenated along dimension 0, in group-rank
    order (a new tensor; shapes equal on every rank)."""
    n = group_size(group)
    if n == 1:
        return t.clone()
    h = t.detach().cpu() if _staged(t) else t.detach()
    parts = [torch.empty_like(h) for _ in range(n)]
    dist.all_gather(parts, h.contiguous(), group=group)
    return torch.cat(parts).to(t.device)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return all_reduce(g, ctx.group)[r * ctx.rows:(r + 1) * ctx.rows], \
            None


def reduce(x: Tensor, group) -> Tensor:
    """Sum over ``group``; backward the identity (see the module)."""
    return x if group_size(group) == 1 else _Reduce.apply(x, group)


def replicate(x: Tensor, group) -> Tensor:
    """The identity; backward sums over ``group`` (see the module)."""
    return x if group_size(group) == 1 else _Replicate.apply(x, group)


def gather_rows(x: Tensor, group) -> Tensor:
    """Every rank's rows, in group-rank order; backward reduce-scatters
    (see the module)."""
    return x if group_size(group) == 1 else _GatherRows.apply(x, group)
