"""Two-tower retrieval (port of the matching subset of
``repro.models.recsys``): the EmbeddingBag substrate, the tower MLPs,
the serving functions ``user_embed``, ``item_embed`` and
``retrieval_scores``, and the training loss ``twotower_loss``.

The user tower's history bag goes through ``kernels.ops.embedding_bag``
(the Hopper kernel on CUDA, its plain version on the CPU); under
autograd the kernel runs inside its autograd rule
(``kernels.segment_embed.EmbeddingBagFn``).  Parameters require grad
only when built with ``trainable=True``.  The ``max`` combiner, the
other recsys models and the screened retrieval wait for a later slice of
the port (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import DTYPES, _normal, _param, embed_lookup

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# EmbeddingBag substrate
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, table: Tensor, trainable: bool = False):
        super().__init__()
        self.table = _param(table, trainable)


def embedding_init(vocab: int, d: int, *, generator: torch.Generator,
                   dtype=torch.float32, scale: float = 0.02,
                   trainable: bool = False) -> Embedding:
    return Embedding(_normal((vocab, d), scale, dtype, generator), trainable)


def embedding_lookup(p: Embedding, ids: Tensor) -> Tensor:
    """Plain row gather; ids (...,) -> (..., D)."""
    return embed_lookup(p.table, ids)


def embedding_bag(p: Embedding, ids: Tensor, mask: Optional[Tensor],
                  combiner: str = "mean", backend: str = "auto") -> Tensor:
    """EmbeddingBag: ids (B, L) multi-hot bags -> (B, D); ``mask`` (B, L)
    marks the valid slots (``None``: all).  ``sum`` and ``mean`` go
    through ``ops.embedding_bag``; ``backend="plain"`` takes its plain
    version on CUDA (``chip_smoke.py`` only)."""
    if combiner == "max":
        raise NotImplementedError(
            "the max combiner has no kernel and no user on the ported "
            "paths yet (ROADMAP.md Queue 1)")
    if combiner not in ("sum", "mean"):
        raise ValueError(combiner)
    if mask is None:
        mask = torch.ones(ids.shape, dtype=torch.int32, device=ids.device)
    return ops.embedding_bag(p.table, ids, mask, combiner=combiner,
                             backend=backend)


class _Linear(nn.Module):
    def __init__(self, w: Tensor, b: Tensor, trainable: bool = False):
        super().__init__()
        self.w, self.b = _param(w, trainable), _param(b, trainable)


def _mlp_init(dims: Sequence[int], dtype, *, generator: torch.Generator,
              trainable: bool = False) -> nn.ModuleList:
    return nn.ModuleList(
        _Linear(_normal((dims[i], dims[i + 1]), 1.0 / dims[i] ** 0.5, dtype,
                        generator),
                torch.zeros((dims[i + 1],), dtype=dtype,
                            device=generator.device), trainable)
        for i in range(len(dims) - 1))


def _mlp(layers: nn.ModuleList, x: Tensor, act=torch.relu,
         final_act: bool = False) -> Tensor:
    for i, lp in enumerate(layers):
        x = x @ lp.w + lp.b
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# Two-tower retrieval (Yi et al., RecSys'19)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    n_users: int = 5_000_000
    n_items: int = 2_000_000
    n_user_hist: int = 50              # history bag length
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    temperature: float = 0.05
    dtype: str = "float32"

    @property
    def param_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


class TwoTower(nn.Module):
    """``user_emb``, ``item_emb`` and the ``user_tower`` / ``item_tower``
    MLPs (``nn.ModuleList`` of layers with ``w`` (d_in, d_out), ``b``)."""

    def __init__(self, user_emb: Embedding, item_emb: Embedding,
                 user_tower: nn.ModuleList, item_tower: nn.ModuleList):
        super().__init__()
        self.user_emb, self.item_emb = user_emb, item_emb
        self.user_tower, self.item_tower = user_tower, item_tower


def twotower_init(cfg: TwoTowerConfig, seed: int = 0,
                  device: DeviceLike = None,
                  trainable: bool = False) -> TwoTower:
    """A seeded random model on ``device`` (``None`` -> ``cuda``).  The
    user tower consumes ``[user_id_emb ; mean(history item embs)]``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    dt, tr = cfg.param_dtype, trainable
    user_emb = embedding_init(cfg.n_users, cfg.embed_dim, generator=g,
                              dtype=dt, trainable=tr)
    item_emb = embedding_init(cfg.n_items, cfg.embed_dim, generator=g,
                              dtype=dt, trainable=tr)
    u_dims = (2 * cfg.embed_dim,) + tuple(cfg.tower_mlp)
    i_dims = (cfg.embed_dim,) + tuple(cfg.tower_mlp)
    return TwoTower(user_emb, item_emb,
                    _mlp_init(u_dims, dt, generator=g, trainable=tr),
                    _mlp_init(i_dims, dt, generator=g, trainable=tr))


def user_embed(params: TwoTower, cfg: TwoTowerConfig, user_id: Tensor,
               hist_ids: Tensor, hist_mask: Tensor,
               backend: str = "auto") -> Tensor:
    ue = embedding_lookup(params.user_emb, user_id)
    he = embedding_bag(params.item_emb, hist_ids, hist_mask, "mean",
                       backend=backend)
    z = torch.cat([ue, he], dim=-1)
    z = _mlp(params.user_tower, z, final_act=False)
    return _l2norm(z)


def item_embed(params: TwoTower, cfg: TwoTowerConfig,
               item_id: Tensor) -> Tensor:
    z = embedding_lookup(params.item_emb, item_id)
    z = _mlp(params.item_tower, z, final_act=False)
    return _l2norm(z)


def _l2norm(z: Tensor) -> Tensor:
    n = torch.linalg.vector_norm(z.to(torch.float32), dim=-1, keepdim=True)
    return z / n.clamp_min(1e-12).to(z.dtype)


def twotower_loss(params: TwoTower, cfg: TwoTowerConfig, user_id: Tensor,
                  hist_ids: Tensor, hist_mask: Tensor, pos_item: Tensor,
                  item_logq: Tensor, backend: str = "auto",
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """In-batch sampled softmax with the logQ correction (Yi et al. '19).

    ``item_logq`` (B,) is the log of each positive item's sampling
    probability (its popularity under the in-batch negatives).  Returns
    ``(loss, {"ce", "in_batch_acc"})``."""
    u = user_embed(params, cfg, user_id, hist_ids, hist_mask,
                   backend=backend)                           # (B, D)
    it = item_embed(params, cfg, pos_item)                    # (B, D)
    logits = (u @ it.T) / cfg.temperature                     # (B, B)
    logits = logits.to(torch.float32) - item_logq[None, :]
    labels = torch.arange(u.shape[0], device=u.device)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.diagonal().mean()
    acc = (logits.argmax(dim=-1) == labels).to(torch.float32).mean()
    return loss, {"ce": loss.detach(), "in_batch_acc": acc}


def retrieval_scores(params: TwoTower, cfg: TwoTowerConfig, user_id: Tensor,
                     hist_ids: Tensor, hist_mask: Tensor,
                     candidate_ids: Tensor, topk: int = 100,
                     backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """Score a few queries against a large candidate set: batched dot and
    top-k (the ``retrieval_cand`` serving shape).  Returns ``(values,
    indices)`` of the ``topk`` best candidates per query, best first;
    indices are positions in ``candidate_ids``."""
    u = user_embed(params, cfg, user_id, hist_ids, hist_mask,
                   backend=backend)                           # (B, D)
    ie = item_embed(params, cfg, candidate_ids)               # (C, D)
    scores = u @ ie.T                                         # (B, C)
    return torch.topk(scores, topk, dim=-1)
