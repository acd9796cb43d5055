"""Decoder-only LM, dense stack (port of the matching subset of
``repro.models.transformer``): ``LMConfig``, ``init_params``,
``prefill``, ``init_cache`` and ``decode_step``.

``LMConfig`` keeps every field of the JAX config, but this slice of the
port runs only the dense, full-attention stack (qwen1.5, granite,
command-r): MoE, MLA and sliding windows raise ``NotImplementedError``
and wait for a later slice (ROADMAP.md Queue 1).  The layers are an
``nn.ModuleList`` run in a Python loop where the JAX package scans a
stacked pytree; the weights keep the JAX names and shapes, one layer per
module (``models.weights`` unstacks a JAX tree into them).

Serve only: ``prefill`` and ``decode_step`` run forward, and
``decode_step`` updates the KV cache **in place** (the JAX version
returns a new one).  ``backend="plain"`` makes prefill attention take
the flash kernel's plain version on CUDA (``chip_smoke.py`` only).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

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

def init_params(cfg: LMConfig, seed: int = 0,
                device: DeviceLike = None) -> TransformerLM:
    """A seeded random model on ``device`` (``None`` -> ``cuda``), drawn
    from one ``torch.Generator`` on that device.  The numbers differ from
    the JAX package's for the same seed; carry JAX weights across with
    ``models.weights.lm_from_numpy``."""
    _check_dense(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.param_dtype
    embed = L.embed_init(cfg.padded_vocab, cfg.d_model, generator=g,
                         dtype=dt)
    layers = []
    for _ in range(cfg.n_layers):
        attn_norm = L.rmsnorm_init(cfg.d_model, dt, dev)
        attn = L.gqa_init(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, generator=g, qkv_bias=cfg.qkv_bias,
                          dtype=dt)
        mlp_norm = L.rmsnorm_init(cfg.d_model, dt, dev)
        mlp = L.swiglu_init(cfg.d_model, cfg.d_ff, generator=g, dtype=dt)
        layers.append(DecoderLayer(attn_norm, attn, mlp_norm, mlp))
    final_norm = L.rmsnorm_init(cfg.d_model, dt, dev)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = L.embed_init(cfg.padded_vocab, cfg.d_model, generator=g,
                               dtype=dt)
    return TransformerLM(embed, layers, final_norm, lm_head)


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
    x = model.embed.table[tokens.to(torch.int64)]
    cache = init_cache(cfg, B, max(max_len or S, S), device=tokens.device)
    for i, lp in enumerate(model.layers):
        h = L.rmsnorm(lp.attn_norm, x, cfg.norm_eps)
        a, (k, v) = L.gqa_apply(lp.attn, h, positions=positions,
                                rope_theta=cfg.rope_theta,
                                compute_dtype=cfg.param_dtype,
                                return_kv=True, backend=backend)
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
    x = model.embed.table[token.to(torch.int64)][:, None, :]   # (B, 1, D)
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
