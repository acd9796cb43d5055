"""Decoder-only LM (port of ``repro.models.transformer``): ``LMConfig``,
``init_params``, ``forward`` and ``loss_fn`` (training), ``prefill``,
``init_cache``, ``cache_logical`` and ``decode_step`` (serving), for
every stack the JAX package builds: dense GQA (qwen1.5, granite,
command-r), sliding-window GQA with MoE (mixtral: a ring KV cache of
``window`` slots) and MLA with MoE and shared experts behind
``first_k_dense`` dense layers (deepseek-v2: a latent cache of ``c_kv``
and ``k_rope``).  The layers
are an ``nn.ModuleList`` run in a Python loop where the JAX package
scans two stacked pytrees (``dense_layers``, then ``moe_layers``); the
weights keep the JAX names and shapes, one layer per module
(``models.weights`` stacks and unstacks them).  Every stack trains:
``loss_fn``'s gradients through the MoE dispatch, MLA and the window
mask are held against ``jax.value_and_grad``.

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
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as ckpt

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (axis_start, constrain,
                                              local_index, local_region,
                                              make_like)
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

    @property
    def mla_dims(self) -> L.MLADims:
        return L.MLADims(self.d_model, self.n_heads, self.q_lora,
                         self.kv_lora, self.qk_nope_dim, self.qk_rope_dim,
                         self.v_head_dim)

    @property
    def moe_dims(self) -> L.MoEDims:
        return L.MoEDims(self.d_model, self.n_experts, self.top_k,
                         self.moe_d_ff or self.d_ff, self.n_shared_experts,
                         self.capacity_factor)

    @property
    def n_dense_layers(self) -> int:
        """Leading dense layers (the JAX ``dense_layers`` stack); the rest
        are MoE layers (``moe_layers``)."""
        return self.first_k_dense if self.moe else self.n_layers

    def param_count(self) -> int:
        """Total parameters: the size of the ``init_params`` tree, counted
        from the shapes (the JAX ``param_count`` traces its init)."""
        d, H = self.d_model, self.n_heads
        if self.mla:
            m = self.mla_dims
            dq = m.d_nope + m.d_rope
            q = (d * m.q_lora + m.q_lora + m.q_lora * H * dq if m.q_lora
                 else d * H * dq)
            attn = (q + d * (m.kv_lora + m.d_rope) + m.kv_lora
                    + m.kv_lora * H * (m.d_nope + m.d_v) + H * m.d_v * d)
        else:
            Dh, KH = self.head_dim, self.n_kv_heads
            attn = 2 * d * (H + KH) * Dh
            if self.qkv_bias:
                attn += (H + 2 * KH) * Dh
        dense = 2 * d + attn + 3 * d * self.d_ff
        moe = 0
        if self.moe:
            e = self.moe_dims
            moe = (2 * d + attn + d * e.n_experts
                   + 3 * d * e.d_ff * (e.n_experts + e.n_shared))
        heads = 1 if self.tie_embeddings else 2
        return (self.n_dense_layers * dense
                + (self.n_layers - self.n_dense_layers) * moe
                + heads * self.padded_vocab * d + d)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only): the
        JAX ``active_param_count``, the N of a step's 6 N T flops."""
        if not self.moe:
            return self.param_count()
        total = self.param_count()
        f = self.moe_d_ff or self.d_ff
        n_moe_layers = self.n_layers - self.first_k_dense
        per_expert = 3 * self.d_model * f
        inactive = n_moe_layers * (self.n_experts - self.top_k) * per_expert
        return total - inactive


class DecoderLayer(nn.Module):
    """``attn`` is a :class:`~repro_torch.models.layers.GQA` or an
    ``MLA``; ``mlp`` a ``SwiGLU`` or a ``MoE``."""

    def __init__(self, attn_norm: L.RMSNorm, attn: nn.Module,
                 mlp_norm: L.RMSNorm, mlp: nn.Module):
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
    ``models.weights.lm_from_numpy``.  The first ``cfg.n_dense_layers``
    layers are dense, the rest MoE; attention is MLA when ``cfg.mla``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    dt, tr = cfg.param_dtype, trainable
    embed = L.embed_init(cfg.padded_vocab, cfg.d_model, generator=g,
                         dtype=dt, trainable=tr)
    layers = []
    for i in range(cfg.n_layers):
        attn_norm = L.rmsnorm_init(cfg.d_model, dt, dev, trainable=tr)
        if cfg.mla:
            attn = L.mla_init(cfg.mla_dims, generator=g, dtype=dt,
                              trainable=tr)
        else:
            attn = L.gqa_init(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, generator=g,
                              qkv_bias=cfg.qkv_bias, dtype=dt, trainable=tr)
        mlp_norm = L.rmsnorm_init(cfg.d_model, dt, dev, trainable=tr)
        if i < cfg.n_dense_layers:
            mlp = L.swiglu_init(cfg.d_model, cfg.d_ff, generator=g,
                                dtype=dt, trainable=tr)
        else:
            mlp = L.moe_init(cfg.moe_dims, generator=g, dtype=dt,
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


def _attn(cfg: LMConfig, lp: DecoderLayer, h: Tensor, positions: Tensor,
          attention: str, backend: str = "auto", return_kv: bool = False):
    """The layer's attention over a whole sequence (GQA, windowed when
    the config says so, or MLA), by ``attention`` ("chunked" or
    "flash")."""
    if isinstance(lp.attn, L.MLA):
        return L.mla_apply(lp.attn, h, cfg.mla_dims, positions=positions,
                           rope_theta=cfg.rope_theta,
                           attn_chunk=cfg.attn_chunk,
                           compute_dtype=cfg.param_dtype,
                           return_kv=return_kv, attention=attention,
                           backend=backend)
    return L.gqa_apply(lp.attn, h, positions=positions,
                       rope_theta=cfg.rope_theta, window=cfg.sliding_window,
                       attn_chunk=cfg.attn_chunk,
                       compute_dtype=cfg.param_dtype, return_kv=return_kv,
                       attention=attention, backend=backend)


def _mlp(cfg: LMConfig, lp: DecoderLayer, x: Tensor
         ) -> Tuple[Tensor, Optional[Tensor]]:
    """``x + mlp(norm(x))`` and the layer's MoE aux loss (``None`` for a
    dense layer)."""
    # the attention residual is reduced before the norm (on a mesh the
    # output projection leaves a partial sum)
    x = constrain(x, ("batch", None, "act_embed"))
    h = L.rmsnorm(lp.mlp_norm, x, cfg.norm_eps)
    if isinstance(lp.mlp, L.MoE):
        m, aux = L.moe_apply(lp.mlp, h, cfg.moe_dims,
                             compute_dtype=cfg.param_dtype)
    else:
        m, aux = L.swiglu(lp.mlp, h, cfg.param_dtype), None
    return constrain(x + m, ("batch", None, "act_embed")), aux


def _layer_fwd(cfg: LMConfig, lp: DecoderLayer, x: Tensor,
               positions: Tensor) -> Tuple[Tensor, Optional[Tensor]]:
    h = L.rmsnorm(lp.attn_norm, x, cfg.norm_eps)
    x = x + _attn(cfg, lp, h, positions, "chunked")
    return _mlp(cfg, lp, x)


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
    loss summed over the MoE layers (0: dense stacks))."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = L.embed_lookup(model.embed.table, tokens)
    x = constrain(x, ("batch", None, "act_embed"))
    layer = _remat(cfg, functools.partial(_layer_fwd, cfg))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in model.layers:
        x, aux = layer(lp, x, positions)
        if aux is not None:
            aux_total = aux_total + aux
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    dt = cfg.param_dtype
    # FSDP: the head gathered along ``embed`` for its use (layers._qkv)
    table = constrain(model.head_table().to(dt), ("vocab", None))
    logits = x.to(dt) @ table.T
    logits = constrain(logits, ("batch", None, "vocab_act"))
    return logits, aux_total


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


def _label_logit(logits: Tensor, labels: Tensor) -> Tensor:
    """``logits[..., labels]``: (B, S, V), (B, S) -> (B, S).  On a
    vocab-sharded mesh each rank takes the labels that fall in its
    vocab shard (zeros for the others), a partial sum reduced here while
    it has the labels' shape; so the gather's backward writes into the
    rank's logits shard only, never a whole (B, S, V) gradient."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    n_vocab = logits.shape[-1]

    def local(lg, lab):
        loc, held = local_index(lab, axis_start("vocab_act", n_vocab),
                                lg.shape[-1])
        got = torch.gather(lg, -1, loc[..., None])
        return torch.where(held, got[..., 0], got.new_zeros(()))

    out = local_region(local, (("batch", None, "vocab_act"), ("batch", None)),
                       ("batch", None), partial="vocab_act")(logits, labels)
    return constrain(out, ("batch", None))


def loss_fn(model: TransformerLM, cfg: LMConfig, tokens: Tensor,
            labels: Tensor) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Causal LM loss; labels are next-token ids, -1 = masked.  As in the
    JAX package: pad-vocab logits are masked to ``finfo(float32).min /
    2``, the max is taken without gradient, lse is an fp32 exp-sum, and
    ``ce = sum((lse - logit[label]) * valid) / max(n_valid, 1)``.
    Metrics ``{"ce", "aux", "ppl"}`` (``aux``: the MoE aux loss, 0 for
    dense stacks), and the total is ``ce + moe_aux_weight * aux``."""
    logits, aux = forward(model, cfg, tokens)
    pad = torch.arange(cfg.padded_vocab, device=logits.device) \
        >= cfg.vocab_size
    logits = logits.masked_fill(pad, torch.finfo(torch.float32).min / 2)
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = torch.log(_ExpSum.apply(logits, m)) + m[..., 0].to(torch.float32)
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).to(torch.int64)
    label_logit = _label_logit(logits, safe).to(torch.float32)
    n_valid = torch.clamp(valid.sum(), min=1)
    ce = ((lse - label_logit) * valid).sum() / n_valid
    total = ce + cfg.moe_aux_weight * aux
    ce = ce.detach()
    return total, {"ce": ce, "aux": aux,
                   "ppl": torch.exp(torch.clamp(ce, max=20.0))}


# ---------------------------------------------------------------------------
# prefill / decode (serve path)
# ---------------------------------------------------------------------------

def _logits(model: TransformerLM, cfg: LMConfig, x: Tensor) -> Tensor:
    """x (B, D) -> fp32 logits (B, Vpad) over the (tied) head table."""
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    dt = cfg.param_dtype
    return (x.to(dt) @ model.head_table().to(dt).T).to(torch.float32)


def _cache_keys(cfg: LMConfig) -> Tuple[str, str]:
    return ("c_kv", "k_rope") if cfg.mla else ("k", "v")


def prefill(model: TransformerLM, cfg: LMConfig, tokens: Tensor,
            max_len: Optional[int] = None, backend: str = "auto",
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Run the full prompt ``tokens (B, S)``; return last-token logits
    ``(B, Vpad)`` fp32 and the populated cache, ready for
    :func:`decode_step`.  The cache holds ``cap = max(max_len, S)`` slots
    (``max_len`` defaults to ``S``), the prompt's entries in the first
    ``S``; with a sliding window ``w`` it is a ring of ``cap = w`` slots
    holding the trailing ``min(S, w)`` positions, position ``p`` in slot
    ``p % w`` (the JAX package's roll by ``(S - w) % w``).  MLA caches the
    latent ``c_kv`` and the shared ``k_rope``, GQA the RoPE'd K and V."""
    B, S = tokens.shape
    w = cfg.sliding_window
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = L.embed_lookup(model.embed.table, tokens)
    x = constrain(x, ("batch", None, "act_embed"))
    cap = w if w else max(max_len or S, S)
    cache = make_like(lambda dev: init_cache(cfg, B, cap, device=dev),
                      cache_logical(cfg), tokens)
    keys = _cache_keys(cfg)
    for i, lp in enumerate(model.layers):
        h = L.rmsnorm(lp.attn_norm, x, cfg.norm_eps)
        a, kv = _attn(cfg, lp, h, positions, "flash", backend=backend,
                      return_kv=True)
        for name, t in zip(keys, kv):
            if w and S > w:
                t = torch.roll(t[:, S - w:], (S - w) % w, dims=1)
            axes = (L.head_axes(cfg.n_heads, cfg.n_kv_heads) if t.dim() == 4
                    else ("batch", None, None))
            local_region(_write_prefix, (axes, axes), axes)(cache[name][i], t)
        del kv
        x, _ = _mlp(cfg, lp, x + a)
    cache["len"].fill_(S)
    return _logits(model, cfg, x[:, -1]), cache


def _write_prefix(buf: Tensor, t: Tensor) -> Tensor:
    """``buf[:, :S] = t`` in place for ``t (B, S, ...)``; returns
    ``buf``."""
    buf[:, :t.shape[1]] = t
    return buf


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None) -> Dict[str, Tensor]:
    """Zeros in the param dtype (or ``dtype``) and ``len`` ``(B,)`` int32
    zeros: ``k``/``v`` ``(n_layers, B, S, KH, Dh)`` for GQA, where ``S``
    is ``min(max_len, window)`` with a sliding window (a ring buffer);
    ``c_kv`` ``(n_layers, B, S, kv_lora)`` and ``k_rope`` ``(n_layers, B,
    S, qk_rope_dim)`` for MLA."""
    dev = resolve_device(device)
    dt = dtype or cfg.param_dtype
    S = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    nl = cfg.n_layers
    if cfg.mla:
        shapes = {"c_kv": (nl, batch, S, cfg.kv_lora),
                  "k_rope": (nl, batch, S, cfg.qk_rope_dim)}
    else:
        shape = (nl, batch, S, cfg.n_kv_heads, cfg.head_dim)
        shapes = {"k": shape, "v": shape}
    cache = {k: torch.zeros(sh, dtype=dt, device=dev)
             for k, sh in shapes.items()}
    cache["len"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return cache


def cache_logical(cfg: LMConfig) -> Dict[str, Tuple]:
    """Logical axes for the cache (sharded like activations;
    ``distributed.sharding``)."""
    if cfg.mla:
        return {"c_kv": (None, "batch", "kv_seq", None),
                "k_rope": (None, "batch", "kv_seq", None),
                "len": ("batch",)}
    return {"k": (None, "batch", "kv_seq", "kv_heads", None),
            "v": (None, "batch", "kv_seq", "kv_heads", None),
            "len": ("batch",)}


def decode_step(model: TransformerLM, cfg: LMConfig, token: Tensor,
                cache: Dict[str, Tensor],
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One token for every sequence: ``token (B,)`` -> fp32 logits ``(B,
    Vpad)`` and the cache, updated in place, with ``len + 1``: GQA
    writes slot ``min(len, S - 1)``, or ring slot ``len % S`` with a
    sliding window; MLA writes its latent entries (absorbed decode)."""
    x = L.embed_lookup(model.embed.table, token[:, None])      # (B, 1, D)
    x = constrain(x, ("batch", None, "act_embed"))
    pos = cache["len"]
    keys = _cache_keys(cfg)
    for i, lp in enumerate(model.layers):
        lcache = {name: cache[name][i] for name in keys}
        lcache["len"] = pos
        h = L.rmsnorm(lp.attn_norm, x, cfg.norm_eps)
        if isinstance(lp.attn, L.MLA):
            a, _ = L.mla_decode(lp.attn, h, lcache, cfg.mla_dims,
                                rope_theta=cfg.rope_theta,
                                compute_dtype=cfg.param_dtype)
        else:
            a, _ = L.gqa_decode(lp.attn, h, lcache,
                                rope_theta=cfg.rope_theta,
                                window=cfg.sliding_window,
                                compute_dtype=cfg.param_dtype)
        x, _ = _mlp(cfg, lp, x + a)
    new_cache = dict(cache)
    new_cache["len"] = pos + 1
    return _logits(model, cfg, x[:, 0]), new_cache
