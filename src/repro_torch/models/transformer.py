"""Decoder-only LM, dense stack (port of the matching subset of
``repro.models.transformer``): ``LMConfig``, ``init_params``,
``forward`` and ``loss_fn`` (training), ``prefill``, ``init_cache`` and
``decode_step`` (serving).

``LMConfig`` keeps every field of the JAX config, but the port runs
only the dense, full-attention stack (qwen1.5, granite, command-r):
MoE, MLA and sliding windows raise ``NotImplementedError`` and wait for
a later slice (ROADMAP.md Queue 1).  The layers are an
``nn.ModuleList`` run in a Python loop where the JAX package scans a
stacked pytree; the weights keep the JAX names and shapes, one layer per
module (``models.weights`` stacks and unstacks them).

Training (``forward``/``loss_fn``) attends through
``layers.chunked_attention``, as the JAX trainer does, and maps
``cfg.remat`` onto ``torch.utils.checkpoint`` per layer.  Serving
(``prefill``/``decode_step``) runs forward under
``torch.inference_mode()`` (``launch.serve``): prefill attention goes
through the flash kernel, and ``decode_step`` updates the KV cache **in
place** (the JAX version returns a new one).  ``backend="plain"`` makes
prefill attention take the flash kernel's plain version on CUDA
(``chip_smoke.py`` only).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 => d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # MLA
    mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # attention flavour
    sliding_window: int = 0          # 0 => full causal
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    # execution
    attn_chunk: int = 1024
    vocab_pad_multiple: int = 128
    dtype: str = "bfloat16"
    remat: str = "dots"              # none | dots | full
    unroll_layers: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def param_dtype(self) -> torch.dtype:
        return L.DTYPES[self.dtype]


def _check_dense(cfg: LMConfig) -> None:
    for flag, what in ((cfg.moe, "MoE"), (cfg.mla, "MLA"),
                       (cfg.sliding_window, "sliding-window attention")):
        if flag:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported to PyTorch yet "
                "(ROADMAP.md Queue 1); this slice runs dense, "
                "full-attention stacks")


class DecoderLayer(nn.Module):
    def __init__(self, attn_norm: L.RMSNorm, attn: L.GQA,
                 mlp_norm: L.RMSNorm, mlp: L.SwiGLU):
        super().__init__()
        self.attn_norm, self.attn = attn_norm, attn
        self.mlp_norm, self.mlp = mlp_norm, mlp


class TransformerLM(nn.Module):
    """``embed``, ``layers`` (``nn.ModuleList`` of ``DecoderLayer``),
    ``final_norm`` and, unless embeddings are tied, ``lm_head``."""

    def __init__(self, embed: L.Embed, layers, final_norm: L.RMSNorm,
                 lm_head: Optional[L.Embed] = None):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = lm_head

    def head_table(self) -> Tensor:
        return (self.embed if self.lm_head is None else self.lm_head).table


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: LMConfig, seed: int = 0, device: DeviceLike = None,
                trainable: bool = False) -> TransformerLM:
    """A seeded random model on ``device`` (``None`` -> ``cuda``), drawn
    from one ``torch.Generator`` on that device; its parameters require
    grad when ``trainable``.  The numbers differ from the JAX package's
    for the same seed; carry JAX weights across with
    ``models.weights.lm_from_numpy``."""
    _check_dense(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    dt, tr = cfg.param_dtype, trainable
    embed = L.embed_init(cfg.padded_vocab, cfg.d_model, generator=g,
                         dtype=dt, trainable=tr)
    layers = []
    for _ in range(cfg.n_layers):
        attn_norm = L.rmsnorm_init(cfg.d_model, dt, dev, trainable=tr)
        attn = L.gqa_init(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, generator=g, qkv_bias=cfg.qkv_bias,
                          dtype=dt, trainable=tr)
        mlp_norm = L.rmsnorm_init(cfg.d_model, dt, dev, trainable=tr)
        mlp = L.swiglu_init(cfg.d_model, cfg.d_ff, generator=g, dtype=dt,
                            trainable=tr)
        layers.append(DecoderLayer(attn_norm, attn, mlp_norm, mlp))
    final_norm = L.rmsnorm_init(cfg.d_model, dt, dev, trainable=tr)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = L.embed_init(cfg.padded_vocab, cfg.d_model, generator=g,
                               dtype=dt, trainable=tr)
    return TransformerLM(embed, layers, final_norm, lm_head)


# ---------------------------------------------------------------------------
# forward / loss (training)
# ---------------------------------------------------------------------------

# The dots without batch dimensions: the JAX policy
# ``checkpoint_dots_with_no_batch_dims`` keeps their outputs.  The
# projections run as ``aten.mm`` (``layers._proj``); attention's batched
# products (``aten.bmm``) are recomputed.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _layer_fwd(cfg: LMConfig, lp: DecoderLayer, x: Tensor,
               positions: Tensor) -> Tensor:
    h = L.rmsnorm(lp.attn_norm, x, cfg.norm_eps)
    x = x + L.gqa_apply(lp.attn, h, positions=positions,
                        rope_theta=cfg.rope_theta,
                        window=cfg.sliding_window, attn_chunk=cfg.attn_chunk,
                        compute_dtype=cfg.param_dtype, attention="chunked")
    h = L.rmsnorm(lp.mlp_norm, x, cfg.norm_eps)
    return x + L.swiglu(lp.mlp, h, cfg.param_dtype)


def _remat(cfg: LMConfig, fn):
    """``cfg.remat`` per layer: "none" keeps every activation, "full"
    recomputes the layer in the backward pass, "dots" keeps only the
    outputs of the dots without batch dims (the JAX policy)."""
    if cfg.remat == "none":
        return fn
    # No layer draws random numbers, so no RNG state is kept for replay.
    remat = functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                              preserve_rng_state=False)
    if cfg.remat == "full":
        return remat
    if cfg.remat == "dots":
        return functools.partial(
            remat, context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat {cfg.remat!r}")


def forward(model: TransformerLM, cfg: LMConfig, tokens: Tensor,
            ) -> Tuple[Tensor, Tensor]:
    """tokens (B, S) -> (logits (B, S, Vpad) in the param dtype, MoE aux
    loss (0: dense stacks))."""
    _check_dense(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = L.embed_lookup(model.embed.table, tokens)
    layer = _remat(cfg, functools.partial(_layer_fwd, cfg))
    for lp in model.layers:
        x = layer(lp, x, positions)
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    dt = cfg.param_dtype
    logits = x.to(dt) @ model.head_table().to(dt).T
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


class _ExpSum(torch.autograd.Function):
    """``sum(exp((logits - m).float()), -1)`` for a constant ``m``,
    saving only the logits (param dtype): the fp32 exponentials are
    recomputed in the backward pass, so no fp32 (B, S, V) buffer outlives
    either pass."""

    @staticmethod
    def forward(ctx, logits: Tensor, m: Tensor) -> Tensor:
        ctx.save_for_backward(logits, m)
        return torch.exp((logits - m).to(torch.float32)).sum(dim=-1)

    @staticmethod
    def backward(ctx, g: Tensor):
        logits, m = ctx.saved_tensors
        e = torch.exp((logits - m).to(torch.float32))
        return (e.mul_(g[..., None])).to(logits.dtype), None


def loss_fn(model: TransformerLM, cfg: LMConfig, tokens: Tensor,
            labels: Tensor) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Causal LM loss; labels are next-token ids, -1 = masked.  As in the
    JAX package: pad-vocab logits are masked to ``finfo(float32).min /
    2``, the max is taken without gradient, lse is an fp32 exp-sum, and
    ``ce = sum((lse - logit[label]) * valid) / max(n_valid, 1)``.
    Metrics ``{"ce", "aux", "ppl"}`` (``aux`` = 0)."""
    logits, aux = forward(model, cfg, tokens)
    pad = torch.arange(cfg.padded_vocab, device=logits.device) \
        >= cfg.vocab_size
    logits = logits.masked_fill(pad, torch.finfo(torch.float32).min / 2)
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = torch.log(_ExpSum.apply(logits, m)) + m[..., 0].to(torch.float32)
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).to(torch.int64)
    label_logit = torch.gather(logits, -1, safe[..., None])[..., 0].to(
        torch.float32)
    n_valid = torch.clamp(valid.sum(), min=1)
    ce = ((lse - label_logit) * valid).sum() / n_valid
    total = ce + cfg.moe_aux_weight * aux
    ce = ce.detach()
    return total, {"ce": ce, "aux": aux,
                   "ppl": torch.exp(torch.clamp(ce, max=20.0))}


# ---------------------------------------------------------------------------
# prefill / decode (serve path)
# ---------------------------------------------------------------------------

def _mlp_block(lp: DecoderLayer, cfg: LMConfig, x: Tensor) -> Tensor:
    h = L.rmsnorm(lp.mlp_norm, x, cfg.norm_eps)
    return x + L.swiglu(lp.mlp, h, cfg.param_dtype)


def _logits(model: TransformerLM, cfg: LMConfig, x: Tensor) -> Tensor:
    """x (B, D) -> fp32 logits (B, Vpad) over the (tied) head table."""
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    dt = cfg.param_dtype
    return (x.to(dt) @ model.head_table().to(dt).T).to(torch.float32)


def prefill(model: TransformerLM, cfg: LMConfig, tokens: Tensor,
            max_len: Optional[int] = None, backend: str = "auto",
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Run the full prompt ``tokens (B, S)``; return last-token logits
    ``(B, Vpad)`` fp32 and the populated KV cache, ready for
    :func:`decode_step`.  The cache holds ``cap = max(max_len, S)`` slots
    (``max_len`` defaults to ``S``), the prompt's keys and values in the
    first ``S``."""
    _check_dense(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = L.embed_lookup(model.embed.table, tokens)
    cache = init_cache(cfg, B, max(max_len or S, S), device=tokens.device)
    for i, lp in enumerate(model.layers):
        h = L.rmsnorm(lp.attn_norm, x, cfg.norm_eps)
        a, (k, v) = L.gqa_apply(lp.attn, h, positions=positions,
                                rope_theta=cfg.rope_theta,
                                compute_dtype=cfg.param_dtype,
                                return_kv=True, attention="flash",
                                backend=backend)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
        x = _mlp_block(lp, cfg, x + a)
    cache["len"].fill_(S)
    return _logits(model, cfg, x[:, -1]), cache


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None) -> Dict[str, Tensor]:
    """KV cache: ``k``/``v`` ``(n_layers, B, max_len, KH, Dh)`` zeros in
    the param dtype (or ``dtype``), ``len`` ``(B,)`` int32 zeros."""
    _check_dense(cfg)
    dev = resolve_device(device)
    dt = dtype or cfg.param_dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def decode_step(model: TransformerLM, cfg: LMConfig, token: Tensor,
                cache: Dict[str, Tensor],
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One token for every sequence: ``token (B,)`` -> fp32 logits ``(B,
    Vpad)`` and the cache, updated in place, with ``len + 1``."""
    x = L.embed_lookup(model.embed.table, token[:, None])      # (B, 1, D)
    pos = cache["len"]
    for i, lp in enumerate(model.layers):
        lcache = {"k": cache["k"][i], "v": cache["v"][i], "len": pos}
        h = L.rmsnorm(lp.attn_norm, x, cfg.norm_eps)
        a, _ = L.gqa_decode(lp.attn, h, lcache, rope_theta=cfg.rope_theta,
                            compute_dtype=cfg.param_dtype)
        x = _mlp_block(lp, cfg, x + a)
    new_cache = dict(cache)
    new_cache["len"] = pos + 1
    return _logits(model, cfg, x[:, 0]), new_cache
