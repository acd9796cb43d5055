"""Step builders (port of ``repro.train.train_step``): the train step
(gradients + optimizer, microbatched) and the eval step.

``make_train_step(loss_fn, opt, n_microbatches)`` returns ``step(batch)
-> metrics``: ``loss_fn(batch) -> (loss, metrics)`` reads the parameters
of the model that ``opt`` updates, and the step updates them in place.
Microbatching splits every batch leaf's leading axis ``(B, ...) -> n_mb
x (B / n_mb, ...)`` and accumulates the gradients in fp32 (``lax.scan``
in the JAX package, a Python loop here); loss and gradients are divided
by ``n_mb`` and ``metrics`` are the last microbatch's.  Nothing here
syncs with the host: the returned metrics are device tensors (``lr``
a float).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.tree import flatten_with_paths, tree_from_paths

Tensor = torch.Tensor
LossFn = Callable[[Any], Tuple[Tensor, Dict[str, Tensor]]]


def _split_microbatches(batch, n_mb: int):
    flat = flatten_with_paths(batch)
    for path, x in flat:
        if x.shape[0] % n_mb:
            raise ValueError(f"batch leaf {path!r} of {x.shape[0]} rows "
                             f"does not split into {n_mb} microbatches")
    return [tree_from_paths((p, _chunk(x, n_mb, i)) for p, x in flat)
            for i in range(n_mb)]


def _chunk(x: Tensor, n_mb: int, i: int) -> Tensor:
    """Microbatch ``i`` of a batch leaf: its rows ``i * B / n_mb`` on.  A
    ``DTensor`` batch sharded along its rows (a traced cell on a mesh)
    keeps that sharding: each rank gives the ``i``-th share of its own
    rows (a global chunk would lie on a few ranks, and DTensor would
    replicate it), as XLA's partitioned reshape keeps the batch axis
    sharded."""
    if not (isinstance(x, DTensor) and any(
            isinstance(p, Shard) and p.dim == 0 for p in x.placements)):
        return x.chunk(n_mb, 0)[i]
    local = x._local_tensor.chunk(n_mb, 0)[i]
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False,
                              shape=(x.shape[0] // n_mb,) + x.shape[1:],
                              stride=local.stride())


def _grad(loss: Tensor, params):
    """d loss / d params; zeros for a parameter the loss does not use
    (as JAX gives)."""
    return torch.autograd.grad(loss, params, allow_unused=True,
                               materialize_grads=True)


def make_train_step(loss_fn: LossFn, opt: torch.optim.Optimizer,
                    n_microbatches: int = 1) -> Callable:
    """``opt`` is an optimizer of ``train.optimizer`` (its ``step`` takes
    the gradients and returns ``lr`` and ``grad_norm``)."""
    params = [p for g in opt.param_groups for p in g["params"]]

    def step(batch) -> Dict[str, Any]:
        if n_microbatches == 1:
            loss, metrics = loss_fn(batch)
            grads = list(_grad(loss, params))
            loss = loss.detach()
        else:
            grads, loss = None, 0.0
            for mb in _split_microbatches(batch, n_microbatches):
                loss_mb, metrics = loss_fn(mb)
                g = _grad(loss_mb, params)
                if grads is None:
                    grads = [x.to(torch.float32) for x in g]
                else:
                    for acc, x in zip(grads, g, strict=True):
                        acc.add_(x)
                loss = loss + loss_mb.detach()
                del g, loss_mb
            for acc in grads:
                acc.div_(n_microbatches)
            loss = loss / n_microbatches
        metrics = {k: v.detach() if isinstance(v, Tensor) else v
                   for k, v in metrics.items()}
        metrics.update(opt.step(grads=grads))
        metrics["loss"] = loss
        return metrics

    return step


def make_eval_step(loss_fn: LossFn) -> Callable:
    def step(batch) -> Dict[str, Any]:
        with torch.no_grad():
            loss, metrics = loss_fn(batch)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics

    return step
