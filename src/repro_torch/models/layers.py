"""Dense-attention transformer blocks (port of the matching subset of
``repro.models.layers``): dense, RMSNorm (with the JAX package's
hand-written VJP), token embedding, rotary embeddings, GQA attention for
training, prefill and decode, the chunked online-softmax attention and
the SwiGLU MLP.

Each ``*_init`` draws its weights from an explicit ``torch.Generator``
(on the device the weights live on) and returns an ``nn.Module`` whose
parameters carry the JAX package's names and shapes (``wq`` is ``(d,
H, Dh)``, ``wo`` ``(H, Dh, d)`` and so on), so weights pass across as
numpy arrays (``models.weights``).  The apply functions take that
module and keep the JAX dtype policy (weights in the param dtype,
matmuls in ``compute_dtype``, softmax and statistics in fp32).
Parameters require grad only when built with ``trainable=True`` (the
trainers); serving builds them frozen and runs under
``torch.inference_mode()``.

Attention takes one of two routes, chosen by the caller
(``gqa_apply(attention=...)``): prefill goes through
``kernels.ops.flash_attention`` (the Hopper kernel on CUDA, its plain
version on the CPU); training goes through :func:`chunked_attention`,
plain differentiable torch ops, as the JAX trainer attends through its
``chunked_attention`` (the flash kernel has no backward in either
package).  Decode attention is plain torch ops, as the JAX package
leaves it to XLA, and none of them syncs with the host.  Projections
are ``torch.matmul`` over the weights viewed 2-D, so they run as
``aten.mm`` (the dots that ``remat="dots"`` keeps).  Sliding windows,
MLA and MoE wait for a later slice of the port (ROADMAP.md Queue 1), and
the JAX package's sharding hints (``constrain``) have no job on one
card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops

Tensor = torch.Tensor

# The configs' ``dtype`` strings.
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _param(t: Tensor, trainable: bool = False) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=trainable)


def _normal(shape, scale: float, dtype: torch.dtype,
            generator: torch.Generator) -> Tensor:
    """``N(0, 1) * scale`` drawn in fp32 on the generator's device, then
    cast, as the JAX package draws its weights."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """``kernel`` (d_in, d_out) and an optional ``bias`` (d_out,)."""

    def __init__(self, kernel: Tensor, bias: Optional[Tensor] = None,
                 trainable: bool = False):
        super().__init__()
        self.kernel = _param(kernel, trainable)
        self.bias = None if bias is None else _param(bias, trainable)


def dense_init(d_in: int, d_out: int, *, generator: torch.Generator,
               bias: bool = False, dtype=torch.bfloat16,
               trainable: bool = False) -> Dense:
    kernel = _normal((d_in, d_out), 1.0 / d_in ** 0.5, dtype, generator)
    b = (torch.zeros((d_out,), dtype=dtype, device=generator.device)
         if bias else None)
    return Dense(kernel, b, trainable)


def dense(p: Dense, x: Tensor, compute_dtype=torch.bfloat16) -> Tensor:
    y = x.to(compute_dtype) @ p.kernel.to(compute_dtype)
    if p.bias is not None:
        y = y + p.bias.to(compute_dtype)
    return y


class RMSNorm(nn.Module):
    def __init__(self, scale: Tensor, trainable: bool = False):
        super().__init__()
        self.scale = _param(scale, trainable)


def rmsnorm_init(d: int, dtype=torch.bfloat16, device=None,
                 trainable: bool = False) -> RMSNorm:
    return RMSNorm(torch.ones((d,), dtype=dtype, device=device), trainable)


class _RMSNormFn(torch.autograd.Function):
    """``x * rsqrt(mean(x^2) + eps) * scale`` with the JAX package's
    hand-written VJP (``repro.models.layers._rmsnorm_bwd``): every
    x-sized product stays in x's dtype; fp32 appears only in the
    per-token scalars (``inv``) and the dot accumulators, and ``d_scale``
    is summed in fp32 and cast to the scale's dtype.  The residuals are
    x, the scale and the fp32 ``inv``: no fp32 image of x is saved."""

    @staticmethod
    def forward(ctx, x: Tensor, scale: Tensor, eps: float) -> Tensor:
        xf = x.to(torch.float32)
        ss = (xf * xf).sum(dim=-1, keepdim=True)
        inv = torch.rsqrt(ss / x.shape[-1] + eps)              # fp32 (..., 1)
        ctx.save_for_backward(x, scale, inv)
        return x * inv.to(x.dtype) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, g: Tensor):
        x, scale, inv = ctx.saved_tensors
        d = x.shape[-1]
        inv_b = inv.to(x.dtype)
        gs = g * scale.to(x.dtype)                             # (..., d)
        dot = (gs.to(torch.float32) * x.to(torch.float32)).sum(
            dim=-1, keepdim=True)
        coeff = (inv * inv * inv * dot / d).to(x.dtype)        # (..., 1)
        d_x = gs * inv_b - x * coeff
        xin = x * inv_b
        d_scale = (g.to(torch.float32) * xin.to(torch.float32)).reshape(
            -1, d).sum(dim=0).to(scale.dtype)
        return d_x, d_scale, None


def rmsnorm(p: RMSNorm, x: Tensor, eps: float = 1e-5) -> Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale``: the sum of squares and the
    inverse in fp32, the products in x's type."""
    return _RMSNormFn.apply(x, p.scale, eps)


class Embed(nn.Module):
    def __init__(self, table: Tensor, trainable: bool = False):
        super().__init__()
        self.table = _param(table, trainable)


def embed_init(vocab: int, d: int, *, generator: torch.Generator,
               dtype=torch.bfloat16, trainable: bool = False) -> Embed:
    return Embed(_normal((vocab, d), 0.02, dtype, generator), trainable)


def embed_lookup(table: Tensor, ids: Tensor) -> Tensor:
    """``table[ids]``: ids (...,) -> (..., D).  An ``index_select``, whose
    gradient is an ``index_add_`` (no host sync on CUDA)."""
    return table.index_select(0, ids.reshape(-1)).reshape(
        *ids.shape, table.shape[-1])


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float = 1e4, device=None) -> Tensor:
    ar = torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / d_head))


def apply_rope(x: Tensor, positions: Tensor, theta: float = 1e4) -> Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    if x.dim() == angles.dim() + 1:                      # has a heads axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (MHA, GQA, QKV bias)
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """``wq`` (d, H, Dh), ``wk``/``wv`` (d, KH, Dh), ``wo`` (H, Dh, d) and,
    with QKV bias, ``bq`` (H, Dh), ``bk``/``bv`` (KH, Dh)."""

    def __init__(self, wq: Tensor, wk: Tensor, wv: Tensor, wo: Tensor,
                 bq: Optional[Tensor] = None, bk: Optional[Tensor] = None,
                 bv: Optional[Tensor] = None, trainable: bool = False):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (_param(w, trainable) for w in
                                              (wq, wk, wv, wo))
        self.qkv_bias = bq is not None
        if self.qkv_bias:
            self.bq, self.bk, self.bv = (_param(b, trainable)
                                         for b in (bq, bk, bv))


def gqa_init(d_model: int, n_heads: int, n_kv_heads: int, d_head: int, *,
             generator: torch.Generator, qkv_bias: bool = False,
             dtype=torch.bfloat16, trainable: bool = False) -> GQA:
    s = 1.0 / d_model ** 0.5
    w = [_normal(shape, s, dtype, generator) for shape in (
        (d_model, n_heads, d_head), (d_model, n_kv_heads, d_head),
        (d_model, n_kv_heads, d_head), (n_heads, d_head, d_model))]
    b = [None] * 3
    if qkv_bias:
        b = [torch.zeros((h, d_head), dtype=dtype, device=generator.device)
             for h in (n_heads, n_kv_heads, n_kv_heads)]
    return GQA(*w, *b, trainable=trainable)


def _proj(x: Tensor, w: Tensor) -> Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one 2-D matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _qkv(p: GQA, x: Tensor, cd: torch.dtype) -> Tuple[Tensor, Tensor, Tensor]:
    xc = x.to(cd)
    q = _proj(xc, p.wq.to(cd))
    k = _proj(xc, p.wk.to(cd))
    v = _proj(xc, p.wv.to(cd))
    if p.qkv_bias:
        q = q + p.bq.to(cd)
        k = k + p.bk.to(cd)
        v = v + p.bv.to(cd)
    return q, k, v


def _out(p: GQA, o: Tensor, cd: torch.dtype) -> Tensor:
    """``einsum("bshk,hkd->bsd", o, wo)`` as one 2-D matmul."""
    h, k, d = p.wo.shape
    return o.to(cd).flatten(-2) @ p.wo.to(cd).reshape(h * k, d)


def chunked_attention(q: Tensor,            # (B, Sq, H, Dh)
                      k: Tensor,            # (B, Sk, KH, Dh)
                      v: Tensor,            # (B, Sk, KH, Dv)
                      *,
                      causal: bool,
                      q_offset: int = 0,
                      window: int = 0,
                      kv_valid_len: Optional[Tensor] = None,
                      chunk: int = 1024,
                      softmax_scale: Optional[float] = None) -> Tensor:
    """Memory-efficient attention (port of the JAX package's
    ``chunked_attention``): a loop over KV chunks with the online softmax,
    statistics in fp32, differentiable by autograd.

    GQA folds the query heads into ``(KH, G)`` groups, so KV is never
    repeated.  ``q_offset`` is the absolute position of ``q[:, 0]``;
    ``kv_valid_len`` (B,) masks a partially filled cache.  Masked scores
    are -1e30 and the denominator is clamped at 1e-30.  The chunk falls
    back to ``Sk`` when it does not divide ``Sk``.  A nonzero ``window``
    (sliding-window attention) waits for ROADMAP.md Queue 1 item 14."""
    if window:
        raise NotImplementedError(
            "sliding-window attention is not ported to PyTorch yet "
            "(ROADMAP.md Queue 1 item 14)")
    B, Sq, H, Dh = q.shape
    _, Sk, KH, _ = k.shape
    Dv = v.shape[-1]
    if H % KH:
        raise ValueError(f"{H} query heads do not group into {KH} kv heads")
    G = H // KH
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5
    if Sk % chunk:
        chunk = Sk          # a single chunk for odd cache sizes
    dev = q.device
    qg = q.reshape(B, Sq, KH, G, Dh).to(torch.float32)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Sq, KH, G), -1e30, dtype=torch.float32, device=dev)
    den = torch.zeros((B, Sq, KH, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KH, G, Dv), dtype=torch.float32, device=dev)
    for j0 in range(0, Sk, chunk):
        k_j = k[:, j0:j0 + chunk].to(torch.float32)
        v_j = v[:, j0:j0 + chunk].to(torch.float32)
        kv_pos = j0 + torch.arange(chunk, device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, k_j) * scale
        keep = torch.ones((Sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            keep = keep & (q_pos[:, None] >= kv_pos[None, :])
        if kv_valid_len is not None:
            keep = keep[None] & (kv_pos[None, None, :]
                                 < kv_valid_len[:, None, None])
            s = s.masked_fill(~keep[:, :, None, None, :], -1e30)
        else:
            s = s.masked_fill(~keep[None, :, None, None, :], -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckv->bqkgv", p,
                                                   v_j)
        m = m_new
    out = acc / torch.clamp(den[..., None], min=1e-30)
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def gqa_apply(p: GQA, x: Tensor, *, positions: Tensor,
              rope_theta: float = 1e4, window: int = 0,
              attn_chunk: int = 1024, compute_dtype=torch.bfloat16,
              return_kv: bool = False, attention: str = "flash",
              backend: str = "auto"):
    """Full-sequence causal attention for training (``attention=
    "chunked"``: :func:`chunked_attention`, differentiable torch ops, what
    the JAX trainer runs) or prefill (``"flash"``: ``ops.flash_attention``,
    the Hopper kernel, which has no backward in either package).
    ``return_kv=True`` also returns the RoPE'd K and raw V, exactly what
    the decode cache stores.  ``backend="plain"`` takes the flash kernel's
    plain version on CUDA (``chip_smoke.py`` only)."""
    cd = compute_dtype
    q, k, v = _qkv(p, x, cd)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    if attention == "chunked":
        o = chunked_attention(q, k, v, causal=True, window=window,
                              chunk=attn_chunk)
    elif attention == "flash":
        if window:
            raise NotImplementedError(
                "the flash kernel has no sliding window yet (ROADMAP.md "
                "Queue 1 item 14)")
        o = ops.flash_attention(q, k, v, causal=True, backend=backend)
    else:
        raise ValueError(f"unknown attention {attention!r}")
    y = _out(p, o, cd)
    if return_kv:
        return y, (k, v)
    return y


def gqa_decode(p: GQA, x: Tensor, cache: Dict[str, Tensor], *,
               rope_theta: float = 1e4, compute_dtype=torch.bfloat16,
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One decode step.  cache = {k: (B, S, KH, Dh), v: ..., len: (B,)}.

    The new key (post-RoPE, at its absolute position) and value go to
    slot ``min(len, S - 1)``, written **in place** into the cache tensors
    (the JAX version returns new buffers); the returned cache holds the
    same tensors and ``len + 1``."""
    cd = compute_dtype
    B, one, _ = x.shape
    if one != 1:
        raise ValueError(f"gqa_decode takes one token per sequence, got "
                         f"{one}")
    pos = cache["len"]                                    # (B,) int32
    q, k_new, v_new = _qkv(p, x, cd)
    q = apply_rope(q, pos[:, None], rope_theta)
    k_new = apply_rope(k_new, pos[:, None], rope_theta)

    S = cache["k"].shape[1]
    slot = torch.clamp(pos, max=S - 1)
    k_cache = _batched_set(cache["k"], k_new[:, 0], slot)
    v_cache = _batched_set(cache["v"], v_new[:, 0], slot)
    valid = torch.clamp(pos + 1, max=S)
    o = _direct_decode_attention(q, k_cache, v_cache, valid)
    y = _out(p, o, cd)
    return y, {"k": k_cache, "v": v_cache, "len": pos + 1}


def _direct_decode_attention(q: Tensor,       # (B, 1, H, Dh)
                             k: Tensor,       # (B, S, KH, Dh)
                             v: Tensor,       # (B, S, KH, Dv)
                             valid: Tensor,   # (B,)
                             ) -> Tensor:
    """Single-token attention over the whole cache, fp32 softmax over the
    first ``valid`` slots of each sequence (no host sync)."""
    B, _, H, Dh = q.shape
    _, S, KH, Dv = v.shape
    G = H // KH
    qg = q.reshape(B, 1, KH, G, Dh).to(torch.float32)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg,
                     k.to(torch.float32)) * (Dh ** -0.5)
    masked = torch.arange(S, device=q.device)[None, :] >= valid[:, None]
    # masked_fill with a Python scalar: a scalar *tensor* made here would
    # be an upload from pageable memory, which syncs with the host.
    s = s.masked_fill(masked[:, None, None, None, :], -1e30)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskv->bqkgv", a, v.to(torch.float32))
    return o.reshape(B, 1, H, Dv).to(q.dtype)


def _batched_set(buf: Tensor, val: Tensor, idx: Tensor) -> Tensor:
    """buf: (B, S, ...); val: (B, ...); idx: (B,) -> ``buf[b, idx[b]] =
    val[b]`` in place; returns ``buf``."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, idx.to(torch.int64)] = val.to(buf.dtype)
    return buf


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

class SwiGLU(nn.Module):
    """``w_gate``/``w_up`` (d, f) and ``w_down`` (f, d)."""

    def __init__(self, w_gate: Tensor, w_up: Tensor, w_down: Tensor,
                 trainable: bool = False):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = (_param(w, trainable) for w in
                                               (w_gate, w_up, w_down))


def swiglu_init(d: int, f: int, *, generator: torch.Generator,
                dtype=torch.bfloat16, trainable: bool = False) -> SwiGLU:
    s_in, s_out = 1.0 / d ** 0.5, 1.0 / f ** 0.5
    return SwiGLU(_normal((d, f), s_in, dtype, generator),
                  _normal((d, f), s_in, dtype, generator),
                  _normal((f, d), s_out, dtype, generator), trainable)


def swiglu(p: SwiGLU, x: Tensor, compute_dtype=torch.bfloat16) -> Tensor:
    cd = compute_dtype
    xc = x.to(cd)
    g = xc @ p.w_gate.to(cd)
    u = xc @ p.w_up.to(cd)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(cd) * u
    return h @ p.w_down.to(cd)
