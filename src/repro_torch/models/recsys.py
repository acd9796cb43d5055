"""RecSys models (port of ``repro.models.recsys``): the EmbeddingBag
substrate, SASRec, DIN, xDeepFM and two-tower retrieval, with their
serving functions and training losses.

The two-tower user tower's history bag goes through
``kernels.ops.embedding_bag`` (the Hopper kernel on CUDA, its plain
version on the CPU); under autograd the kernel runs inside its autograd
rule (``kernels.segment_embed.EmbeddingBagFn``).  SASRec, DIN and
xDeepFM look rows up with a plain gather (``embedding_lookup``), as the
JAX models do: no kernel of the port is on their paths.  Their
parameters are a :class:`ParamTree`, the JAX ``*_init`` tree as modules
(the same keys and shapes), so ``models.weights`` carries it across and
lists its leaves.  Parameters require grad only when built with
``trainable=True``.  Losses follow the papers: SASRec per-position
sampled binary CE, DIN and xDeepFM binary CTR CE, two-tower in-batch
sampled softmax with the logQ correction.
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

class ParamTree(nn.Module):
    """A JAX parameter tree as modules: each dict key an attribute (a
    tensor a parameter, a dict a ``ParamTree``, a list of dicts an
    ``nn.ModuleList`` and a list of tensors an ``nn.ParameterList``), so
    ``named_parameters`` gives the tree's leaf paths (``.`` for ``/``)
    and the model functions read ``p.blocks[0].ln1.scale`` where JAX
    reads ``p["blocks"][0]["ln1"]["scale"]``."""

    def __init__(self, tree: Dict, trainable: bool = False):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                v = ParamTree(v, trainable)
            elif isinstance(v, (list, tuple)):
                v = (nn.ModuleList(ParamTree(x, trainable) for x in v)
                     if v and isinstance(v[0], dict) else
                     nn.ParameterList(_param(x, trainable) for x in v))
            else:
                v = _param(v, trainable)
            setattr(self, k, v)


def embedding_lookup(p: ParamTree, ids: Tensor) -> Tensor:
    """Plain row gather; ids (...,) -> (..., D)."""
    return embed_lookup(p.table, ids)


def embedding_bag(p: ParamTree, ids: Tensor, mask: Optional[Tensor],
                  combiner: str = "mean", backend: str = "auto") -> Tensor:
    """EmbeddingBag: ids (B, L) multi-hot bags -> (B, D); ``mask`` (B, L)
    marks the valid slots (``None``: all).  ``sum`` and ``mean`` go
    through ``ops.embedding_bag``; ``backend="plain"`` takes its plain
    version on CUDA (``chip_smoke.py`` only).  ``max`` is plain PyTorch
    on every device, as the JAX package computes it in jnp outside its
    kernel: the largest valid row entry, ``finfo.min`` for an empty bag
    (every slot's row is read, masked or not)."""
    if combiner == "max":
        e = embed_lookup(p.table, ids)                      # (B, L, D)
        if mask is None:
            return e.amax(dim=-2)
        neg = torch.finfo(e.dtype).min
        return torch.where(mask[..., None] != 0, e, neg).amax(dim=-2)
    if combiner not in ("sum", "mean"):
        raise ValueError(combiner)
    if mask is None:
        mask = torch.ones(ids.shape, dtype=torch.int32, device=ids.device)
    return ops.embedding_bag(p.table, ids, mask, combiner=combiner,
                             backend=backend)


def _mlp_tree(dims: Sequence[int], dtype, generator: torch.Generator):
    """The JAX ``_mlp_init`` layers as a tree: ``[{"w", "b"}, ...]``."""
    return [{"w": _normal((dims[i], dims[i + 1]), 1.0 / dims[i] ** 0.5,
                          dtype, generator),
             "b": torch.zeros((dims[i + 1],), dtype=dtype,
                              device=generator.device)}
            for i in range(len(dims) - 1)]


def _mlp(layers: Sequence[nn.Module], x: Tensor, act=torch.relu,
         final_act: bool = False) -> Tensor:
    for i, lp in enumerate(layers):
        x = x @ lp.w + lp.b
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def _bce_pointwise(logits: Tensor, label) -> Tensor:
    """Binary CE of logits, elementwise, in fp32 (stable form)."""
    logits = logits.to(torch.float32)
    return (torch.maximum(logits, torch.zeros_like(logits))
            - logits * label + torch.log1p(torch.exp(-logits.abs())))


def _bce_logits(logits: Tensor, labels: Tensor) -> Tensor:
    return _bce_pointwise(logits, labels).mean()


def _generator(seed: int, device: DeviceLike) -> torch.Generator:
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


# ---------------------------------------------------------------------------
# SASRec (arXiv:1808.09781)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    n_negatives: int = 100
    dropout: float = 0.0       # deterministic runs; kept for fidelity
    dtype: str = "float32"

    @property
    def param_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def sasrec_init(cfg: SASRecConfig, seed: int = 0, device: DeviceLike = None,
                trainable: bool = False) -> ParamTree:
    """A seeded random SASRec with the JAX ``sasrec_init`` tree: an item
    table, learned positions and ``n_blocks`` blocks (``wq``/``wk``/``wv``,
    ``ff1``/``ff2``, ``ln1``/``ln2``)."""
    g = _generator(seed, device)
    dt, d = cfg.param_dtype, cfg.embed_dim
    s = 1.0 / d ** 0.5

    def w():
        return _normal((d, d), s, dt, g)

    def vec(fill):
        return torch.full((d,), fill, dtype=dt, device=g.device)

    blocks = [{"wq": w(), "wk": w(), "wv": w(),
               "ff1": {"w": w(), "b": vec(0.0)},
               "ff2": {"w": w(), "b": vec(0.0)},
               "ln1": {"scale": vec(1.0), "bias": vec(0.0)},
               "ln2": {"scale": vec(1.0), "bias": vec(0.0)}}
              for _ in range(cfg.n_blocks)]
    return ParamTree({
        "item_emb": {"table": _normal((cfg.n_items, d), 0.02, dt, g)},
        "pos_emb": _normal((cfg.seq_len, d), 0.02, dt, g),
        "blocks": blocks}, trainable)


def _ln(p: ParamTree, x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    v = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(v + eps) * p.scale
            + p.bias).to(x.dtype)


def sasrec_encode(params: ParamTree, cfg: SASRecConfig,
                  seq_ids: Tensor) -> Tensor:
    """seq_ids (B, L) item history (0 = padding) -> (B, L, D) states."""
    B, Lq = seq_ids.shape
    x = embedding_lookup(params.item_emb, seq_ids)
    x = x * (cfg.embed_dim ** 0.5) + params.pos_emb[None, :Lq]
    pad = seq_ids == 0
    causal = torch.ones((Lq, Lq), dtype=torch.bool,
                        device=seq_ids.device).tril()
    mask = causal[None] & ~pad[:, None, :]
    H = cfg.n_heads
    for blk in params.blocks:
        h = _ln(blk.ln1, x)
        qh, kh, vh = ((h @ w).reshape(B, Lq, H, -1)
                      for w in (blk.wq, blk.wk, blk.wv))
        s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / (qh.shape[-1] ** 0.5)
        s = torch.where(mask[:, None], s.to(torch.float32), -1e30)
        a = torch.softmax(s, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", a, vh).reshape(B, Lq, -1)
        x = x + o
        h = _ln(blk.ln2, x)
        x = x + _mlp([blk.ff1, blk.ff2], h, final_act=False)
    return torch.where(pad[..., None], 0.0, x)


def sasrec_loss(params: ParamTree, cfg: SASRecConfig, seq_ids: Tensor,
                pos_ids: Tensor, neg_ids: Tensor,
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Per-position sampled CE: pos_ids (B, L); neg_ids (B, L, n_neg)."""
    h = sasrec_encode(params, cfg, seq_ids)                 # (B, L, D)
    pe = embedding_lookup(params.item_emb, pos_ids)         # (B, L, D)
    ne = embedding_lookup(params.item_emb, neg_ids)         # (B, L, n, D)
    pos_logit = (h * pe).sum(-1)
    neg_logit = torch.einsum("bld,blnd->bln", h, ne)
    valid = (pos_ids != 0).to(torch.float32)
    lpos = _bce_pointwise(pos_logit, 1.0) * valid
    lneg = (_bce_pointwise(neg_logit, 0.0)
            * valid[..., None]).sum(-1) / max(cfg.n_negatives, 1)
    denom = torch.clamp(valid.sum(), min=1.0)
    loss = (lpos + lneg).sum() / denom
    return loss, {"ce": loss.detach()}


def sasrec_score(params: ParamTree, cfg: SASRecConfig, seq_ids: Tensor,
                 candidate_ids: Optional[Tensor] = None) -> Tensor:
    """Serving: the last position's state dotted with ``candidate_ids``
    (B, C) (B, C scores), or with the whole catalog (``None``: B, V)."""
    h = sasrec_encode(params, cfg, seq_ids)[:, -1]          # (B, D)
    if candidate_ids is None:
        return h @ params.item_emb.table.T
    ce = embedding_lookup(params.item_emb, candidate_ids)
    return torch.einsum("bd,bcd->bc", h, ce)


# ---------------------------------------------------------------------------
# DIN (arXiv:1706.06978)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    n_items: int = 1_000_000
    n_context: int = 100_000          # context/profile feature vocab
    n_context_fields: int = 4
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: Tuple[int, ...] = (80, 40)
    mlp: Tuple[int, ...] = (200, 80)
    dtype: str = "float32"

    @property
    def param_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def din_init(cfg: DINConfig, seed: int = 0, device: DeviceLike = None,
             trainable: bool = False) -> ParamTree:
    """A seeded random DIN with the JAX ``din_init`` tree: item and
    context tables, the attention MLP (4D -> attn_mlp -> 1) and the main
    MLP ((2 + F) D -> mlp -> 1)."""
    g = _generator(seed, device)
    dt, d = cfg.param_dtype, cfg.embed_dim
    mlp_in = d + d + cfg.n_context_fields * d
    return ParamTree({
        "item_emb": {"table": _normal((cfg.n_items, d), 0.02, dt, g)},
        "ctx_emb": {"table": _normal((cfg.n_context, d), 0.02, dt, g)},
        "attn_mlp": _mlp_tree((4 * d,) + tuple(cfg.attn_mlp) + (1,), dt, g),
        "mlp": _mlp_tree((mlp_in,) + tuple(cfg.mlp) + (1,), dt, g)},
        trainable)


def din_forward(params: ParamTree, cfg: DINConfig, hist_ids: Tensor,
                target_id: Tensor, ctx_ids: Tensor) -> Tensor:
    """hist_ids (B, L); target_id (B,); ctx_ids (B, n_ctx_fields) ->
    logits (B,).  Target attention is a masked softmax over the history
    (the JAX package's production variant of the paper's weights)."""
    he = embedding_lookup(params.item_emb, hist_ids)       # (B, L, D)
    te = embedding_lookup(params.item_emb, target_id)      # (B, D)
    mask = hist_ids != 0
    tb = te[:, None].expand_as(he)
    feats = torch.cat([he, tb, he - tb, he * tb], dim=-1)
    w = _mlp(params.attn_mlp, feats)[..., 0]               # (B, L)
    w = torch.where(mask, w.to(torch.float32), -1e30)
    a = torch.softmax(w, dim=-1).to(he.dtype)
    user = torch.einsum("bl,bld->bd", a, he)
    ctx = embedding_lookup(params.ctx_emb, ctx_ids)        # (B, F, D)
    ctx = ctx.reshape(ctx.shape[0], -1)
    z = torch.cat([user, te, ctx], dim=-1)
    return _mlp(params.mlp, z)[..., 0]


# Candidates a DIN scoring block: the (block, L, 4D) attention features
# and the attention MLP's activations of 65,536 candidates take ~6.5 GB
# at DIN's full widths (L 100, D 18); those of 1,000,000 would not fit.
DIN_SCORE_BLOCK = 65_536


def din_score_candidates(params: ParamTree, cfg: DINConfig,
                         hist_ids: Tensor, ctx_ids: Tensor,
                         candidate_ids: Tensor) -> Tensor:
    """Rank a large candidate set for ONE user (the ``retrieval_cand``
    shape): hist_ids (1, L) and ctx_ids (1, F) describe the user;
    candidate_ids (C,) are scored through full target attention,
    ``DIN_SCORE_BLOCK`` candidates at a time (the JAX function scores all
    C at once and relies on sharding the candidate axis).  Each
    candidate's score is the same whatever the block."""
    out = []
    for i in range(0, candidate_ids.shape[0], DIN_SCORE_BLOCK):
        c = candidate_ids[i:i + DIN_SCORE_BLOCK]
        n = c.shape[0]
        out.append(din_forward(params, cfg, hist_ids.expand(n, -1), c,
                               ctx_ids.expand(n, -1)))
    return torch.cat(out)


def din_loss(params: ParamTree, cfg: DINConfig, hist_ids: Tensor,
             target_id: Tensor, ctx_ids: Tensor, labels: Tensor,
             ) -> Tuple[Tensor, Dict[str, Tensor]]:
    logits = din_forward(params, cfg, hist_ids, target_id, ctx_ids)
    loss = _bce_logits(logits, labels.to(torch.float32))
    return loss, {"ce": loss.detach()}


# ---------------------------------------------------------------------------
# xDeepFM (arXiv:1803.05170)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_fields: int = 39
    vocab_per_field: int = 100_000
    embed_dim: int = 10
    cin_layers: Tuple[int, ...] = (200, 200, 200)
    mlp: Tuple[int, ...] = (400, 400)
    dtype: str = "float32"

    @property
    def param_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def total_vocab(self) -> int:
        return self.n_fields * self.vocab_per_field


def xdeepfm_init(cfg: XDeepFMConfig, seed: int = 0,
                 device: DeviceLike = None,
                 trainable: bool = False) -> ParamTree:
    """A seeded random xDeepFM with the JAX ``xdeepfm_init`` tree: one
    concatenated table with per-field offsets (``emb``) and its linear
    weights, the CIN's layer maps ``cin[k]`` (H_k, H_{k-1} m), the deep
    MLP (m D -> mlp -> 1) and the CIN's output layer."""
    g = _generator(seed, device)
    dt, m = cfg.param_dtype, cfg.n_fields
    cin, h_prev = [], m
    for hk in cfg.cin_layers:
        cin.append(_normal((hk, h_prev * m), 1.0 / (h_prev * m) ** 0.5, dt,
                           g))
        h_prev = hk
    n_cin = sum(cfg.cin_layers)
    return ParamTree({
        "emb": {"table": _normal((cfg.total_vocab, cfg.embed_dim), 0.02, dt,
                                 g)},
        "linear": {"table": _normal((cfg.total_vocab, 1), 0.02, dt, g)},
        "cin": cin,
        "mlp": _mlp_tree((m * cfg.embed_dim,) + tuple(cfg.mlp) + (1,), dt,
                         g),
        "cin_out": {"w": _normal((n_cin, 1), 1.0 / n_cin ** 0.5, dt, g),
                    "b": torch.zeros((1,), dtype=dt, device=g.device)}},
        trainable)


def xdeepfm_forward(params: ParamTree, cfg: XDeepFMConfig,
                    field_ids: Tensor) -> Tensor:
    """field_ids (B, m), already offset into the concatenated vocab ->
    logits (B,): linear + CIN + deep parts.  The CIN's layer k is
    ``x^k_{h,d} = sum_{i,j} W^k_{h,(i,j)} x^{k-1}_{i,d} x^0_{j,d}``."""
    e = embedding_lookup(params.emb, field_ids)             # (B, m, D)
    B = e.shape[0]
    lin = embedding_lookup(params.linear, field_ids)[..., 0].sum(-1)
    x0 = xk = e
    pooled = []
    for wk in params.cin:
        z = (xk[:, :, None, :] * x0[:, None, :, :])         # (B, Hk, m, D)
        z = z.reshape(B, -1, cfg.embed_dim)                 # (B, Hk m, D)
        xk = torch.matmul(wk, z)                            # (B, H, D)
        pooled.append(xk.sum(-1))
    cin_feat = torch.cat(pooled, dim=-1)
    cin_logit = (cin_feat @ params.cin_out.w + params.cin_out.b)[..., 0]
    deep = _mlp(params.mlp, e.reshape(B, -1))[..., 0]
    return lin + cin_logit + deep


# Candidates an xDeepFM scoring block: its CIN maps (block, H m, D) hold
# 312 kB an example at the full widths (H 200, m 39, D 10), 10.2 GB for
# 32,768 candidates; those of 1,000,000 would take 312 GB.
XDEEPFM_SCORE_BLOCK = 32_768


def xdeepfm_score_candidates(params: ParamTree, cfg: XDeepFMConfig,
                             field_ids: Tensor) -> Tensor:
    """Score a large candidate set (the ``retrieval_cand`` shape): the
    (C, m) field rows are scored ``XDEEPFM_SCORE_BLOCK`` at a time through
    :func:`xdeepfm_forward` (the JAX cell scores all C at once and relies
    on sharding the candidate axis); (C,) logits."""
    return torch.cat([xdeepfm_forward(params, cfg,
                                      field_ids[i:i + XDEEPFM_SCORE_BLOCK])
                      for i in range(0, field_ids.shape[0],
                                     XDEEPFM_SCORE_BLOCK)])


def xdeepfm_loss(params: ParamTree, cfg: XDeepFMConfig, field_ids: Tensor,
                 labels: Tensor) -> Tuple[Tensor, Dict[str, Tensor]]:
    logits = xdeepfm_forward(params, cfg, field_ids)
    loss = _bce_logits(logits, labels.to(torch.float32))
    return loss, {"ce": loss.detach()}


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


def twotower_init(cfg: TwoTowerConfig, seed: int = 0,
                  device: DeviceLike = None,
                  trainable: bool = False) -> ParamTree:
    """A seeded random model on ``device`` (``None`` -> ``cuda``) with the
    JAX ``twotower_init`` tree: ``user_emb``, ``item_emb`` and the
    ``user_tower`` / ``item_tower`` MLPs (layers with ``w`` (d_in, d_out)
    and ``b``).  The user tower consumes ``[user_id_emb ; mean(history
    item embs)]``."""
    g = _generator(seed, device)
    dt, d = cfg.param_dtype, cfg.embed_dim
    return ParamTree({
        "user_emb": {"table": _normal((cfg.n_users, d), 0.02, dt, g)},
        "item_emb": {"table": _normal((cfg.n_items, d), 0.02, dt, g)},
        "user_tower": _mlp_tree((2 * d,) + tuple(cfg.tower_mlp), dt, g),
        "item_tower": _mlp_tree((d,) + tuple(cfg.tower_mlp), dt, g)},
        trainable)


def user_embed(params: ParamTree, cfg: TwoTowerConfig, user_id: Tensor,
               hist_ids: Tensor, hist_mask: Tensor,
               backend: str = "auto") -> Tensor:
    ue = embedding_lookup(params.user_emb, user_id)
    he = embedding_bag(params.item_emb, hist_ids, hist_mask, "mean",
                       backend=backend)
    z = torch.cat([ue, he], dim=-1)
    z = _mlp(params.user_tower, z, final_act=False)
    return _l2norm(z)


def item_embed(params: ParamTree, cfg: TwoTowerConfig,
               item_id: Tensor) -> Tensor:
    z = embedding_lookup(params.item_emb, item_id)
    z = _mlp(params.item_tower, z, final_act=False)
    return _l2norm(z)


def _l2norm(z: Tensor) -> Tensor:
    n = torch.linalg.vector_norm(z.to(torch.float32), dim=-1, keepdim=True)
    return z / n.clamp_min(1e-12).to(z.dtype)


def twotower_loss(params: ParamTree, cfg: TwoTowerConfig, user_id: Tensor,
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


def retrieval_scores(params: ParamTree, cfg: TwoTowerConfig, user_id: Tensor,
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


def _topk_ordered(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k`` of fp32 ``x`` along its last axis: the ``k``
    largest, best first, equal values by lower index first (``torch.topk``
    leaves ties in no set order).  It ranks an int64 key: the value's
    bits mapped to an order-keeping integer (XLA's total order, so
    ``-0.0`` ranks below ``0.0``) above the reversed index."""
    bits = x.to(torch.float32).view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    n = x.shape[-1]
    rev = n - 1 - torch.arange(n, device=x.device)
    idx = torch.topk(key * (1 << 32) + rev, k, dim=-1).indices
    return torch.gather(x, -1, idx), idx


def retrieval_scores_screened(params: ParamTree, cfg: TwoTowerConfig,
                              user_id: Tensor, hist_ids: Tensor,
                              hist_mask: Tensor, candidate_ids: Tensor,
                              topk: int = 100, shortlist: int = 4096,
                              ) -> Tuple[Tensor, Tensor]:
    """Two-phase retrieval: the paper's early stopping carried over to
    top-k scoring.  Phase 1 (screen): the item tower and the dot run in
    bf16 over all candidates, and the ``shortlist`` best survive (ties
    to the lower index, as ``jax.lax.top_k``).  Phase 2 (exact): the fp32
    tower rescores the shortlist only, and its ``topk`` best are
    returned as ``(values (B, topk), indices (1, topk))``, indices being
    positions in ``candidate_ids``.

    Batch-1 semantics, as the JAX function's: the shortlist and the
    returned indices are the first query's (``short_idx[0]``); for B > 1
    the other queries' values are their scores of that shortlist."""
    u = user_embed(params, cfg, user_id, hist_ids, hist_mask)  # (B, D)
    bf = torch.bfloat16
    z = embedding_lookup(params.item_emb, candidate_ids).to(bf)
    for i, lp in enumerate(params.item_tower):
        z = z @ lp.w.to(bf) + lp.b.to(bf)
        if i < len(params.item_tower) - 1:
            z = torch.relu(z)
    z = _l2norm(z)
    approx = (u.to(bf) @ z.T).to(torch.float32)               # (B, C)
    del z
    short = _topk_ordered(approx, shortlist)[1][0]            # (S,)
    ie = item_embed(params, cfg, candidate_ids[short])        # (S, D)
    vals, pos = _topk_ordered(u @ ie.T, topk)                 # (B, topk)
    return vals, short[pos[0]][None]
