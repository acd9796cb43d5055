"""Transformer blocks (port of ``repro.models.layers``): dense, RMSNorm
(with the JAX package's hand-written VJP), LayerNorm, token embedding, rotary
embeddings, GQA attention (full or sliding-window) for training, prefill
and decode, the chunked online-softmax attention, DeepSeek-V2's MLA
(expanded prefill, absorbed decode over a latent cache), the SwiGLU MLP
and the sort-based top-k MoE with shared experts.

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
(``gqa_apply``/``mla_apply(attention=...)``): prefill goes through
``kernels.ops.flash_attention`` (the Hopper kernel on CUDA, its plain
version on the CPU), sliding window and MLA's 192-wide heads included;
training goes through :func:`chunked_attention`, plain differentiable
torch ops, as the JAX trainer attends through its ``chunked_attention``
(the flash kernel has no backward in either package).  Decode attention
is plain torch ops, as the JAX package leaves it to XLA, and neither it
nor the MoE dispatch syncs with the host (no boolean-mask indexing, no
``.item()``, expert counts by ``index_add_``), so decode runs under the
device-purity guard.  Projections are ``torch.matmul`` over the weights
viewed 2-D, so they run as ``aten.mm`` (the dots that ``remat="dots"``
keeps); the MoE's expert products are batched GEMMs (``torch.bmm``),
which the JAX package leaves to XLA.  Its sharding hints have no job
on one card: on DTensors (the dry-run's traced cells) attention, the
decode attention and the cache writes run per rank
(``distributed.sharding.local_region``), batch over the data axes and
heads over the model axis where both head counts divide it, or the
cache's sequence over it where the rules shard ``kv_seq``; a sharded
embedding table is looked up where its rows lie.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)

from repro_torch.distributed.sharding import (axis_size, axis_start,
                                              constrain, current_mesh,
                                              local_index, local_region,
                                              logical_spec, placed_region,
                                              placements, shard_start)
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


class LayerNorm(nn.Module):
    def __init__(self, scale: Tensor, bias: Tensor, trainable: bool = False):
        super().__init__()
        self.scale = _param(scale, trainable)
        self.bias = _param(bias, trainable)


def layernorm_init(d: int, dtype=torch.float32, device=None,
                   trainable: bool = False) -> Tuple[LayerNorm, Dict]:
    """Ones and zeros, and the JAX logical axes of the two leaves."""
    return (LayerNorm(torch.ones((d,), dtype=dtype, device=device),
                      torch.zeros((d,), dtype=dtype, device=device),
                      trainable),
            {"scale": ("embed",), "bias": ("embed",)})


def layernorm(p: LayerNorm, x: Tensor, eps: float = 1e-5) -> Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` in fp32, cast
    back to x's type."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p.scale + p.bias).to(x.dtype)


class Embed(nn.Module):
    def __init__(self, table: Tensor, trainable: bool = False):
        super().__init__()
        self.table = _param(table, trainable)


def embed_init(vocab: int, d: int, *, generator: torch.Generator,
               dtype=torch.bfloat16, trainable: bool = False) -> Embed:
    return Embed(_normal((vocab, d), 0.02, dtype, generator), trainable)


def embed_lookup(table: Tensor, ids: Tensor) -> Tensor:
    """``table[ids]``: ids (...,) -> (..., D).  An ``index_select``, whose
    gradient is an ``index_add_`` (no host sync on CUDA).  A ``DTensor``
    table (a traced cell on a mesh) is looked up where its rows lie:
    :func:`_sharded_lookup`."""
    if isinstance(table, DTensor):
        return _sharded_lookup(table, ids)
    return table.index_select(0, ids.reshape(-1)).reshape(
        *ids.shape, table.shape[-1])


def _masked_rows(table: Tensor, ids: Tensor, first: int) -> Tensor:
    """Row ``ids - first`` of ``table`` (a shard of a table's rows that
    starts at row ``first``) where the shard holds it, zeros elsewhere:
    ids (...,) -> (..., D)."""
    loc, held = local_index(ids, first, table.shape[0])
    e = table.index_select(0, loc.reshape(-1)).reshape(*ids.shape,
                                                       table.shape[-1])
    return torch.where(held[..., None], e, e.new_zeros(()))


def _sharded_lookup(table: DTensor, ids: Tensor) -> DTensor:
    """``table[ids]`` per rank: each rank looks up the ids on its rows
    (:func:`_masked_rows`), so no rank gathers the table's rows (the JAX
    package's row-sharded ``jnp.take``, which XLA partitions the same
    way).  The ids may have any placement (a plain tensor is
    replicated).  Per mesh dimension: where the table's rows are sharded
    every rank takes all the ids and the output is a partial sum; where
    its columns are, either the columns are gathered (as FSDP gathers a
    weight) and the ids keep their sharding, or every rank takes all the
    ids and the output is sharded along D, whichever moves fewer
    elements (the rank's table shard against the ids' rows of its
    columns: a prefill gathers, a decode step does not); elsewhere the
    output is placed as the ids are."""
    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, (Replicate(),) * mesh.ndim,
                                 run_check=False)
    t_pls, id_pls, out_pls = [], [], []
    held = table._local_tensor.numel()
    for md, (pt, pi) in enumerate(zip(table.placements, ids.placements,
                                      strict=True)):
        if isinstance(pt, Shard) and pt.dim == 0:
            t_pls.append(pt)
            id_pls.append(Replicate())
            out_pls.append(Partial())
        elif isinstance(pt, Shard) and isinstance(pi, Shard) and \
                held * (mesh.size(md) - 1) < ids.numel() * table.shape[1]:
            t_pls.append(Replicate())
            id_pls.append(pi)
            out_pls.append(pi)
        elif isinstance(pt, Shard):
            t_pls.append(pt)
            id_pls.append(Replicate())
            out_pls.append(Shard(ids.dim()))
        else:
            t_pls.append(pt)
            id_pls.append(pi)
            out_pls.append(pi)
    first = shard_start(table.shape, table.placements, mesh)
    return placed_region(lambda t, i: _masked_rows(t, i, first),
                         (tuple(t_pls), tuple(id_pls)), (tuple(out_pls),),
                         mesh)(table, ids)


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
    """``einsum("bsd,dhk->bshk", x, w)`` as one 2-D matmul.  On a mesh
    whose model axis would cut a head (8 kv heads over 16; the weight's
    head_dim sharded, as the decode rules then shard it), per rank
    (DTensor cannot unflatten an uneven split, where GSPMD pads), the
    weight kept as placed wherever the tokens are not split: a
    ``head_dim`` shard gives the rank's columns of every head, an
    ``embed`` shard (:func:`_for_use`) a partial product of the rank's
    slice of ``x``, and the heads are gathered whole.  So a decode step
    moves its token's activations, not the weights."""
    d, h, k = w.shape
    if isinstance(w, DTensor) and (h % axis_size("heads") or any(
            isinstance(p, Shard) and p.dim == 2 for p in w.placements)):
        x_pls, w_pls, out = [], [], []
        x_in = x.placements if isinstance(x, DTensor) else (
            (Replicate(),) * w.device_mesh.ndim)
        for px, pw in zip(x_in, w.placements, strict=True):
            if not _splits_tokens(px, x) and isinstance(pw, Shard) \
                    and pw.dim == 0:
                x_pls.append(Shard(2))
                w_pls.append(pw)
                out.append(Partial())
            elif not _splits_tokens(px, x) and isinstance(pw, Shard) \
                    and pw.dim == 2:
                x_pls.append(Replicate())
                w_pls.append(pw)
                out.append(Shard(3))
            else:
                x_pls.append(px if isinstance(px, Shard) and px.dim == 0
                             else Replicate())
                w_pls.append(Replicate())
                out.append(x_pls[-1])
        return placed_region(_proj, (tuple(x_pls), tuple(w_pls)),
                             (tuple(out),), w.device_mesh)(x, w)
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _for_use(w: Tensor, logical, x: Tensor, k_dims: Tuple[int, ...]
             ) -> Tensor:
    """``w`` constrained to ``logical`` for its use in a product with
    ``x`` over ``w``'s dimensions ``k_dims``.  On a mesh whose rules
    shard ``embed`` over the data axes (FSDP) that gathers the weight
    along it, as XLA gathers it for a prefill or a train step, so
    DTensor reshards no activation.  Along a mesh dimension where the
    tokens are not split (a decode step of one sequence) and each rank's
    share of the product moves fewer elements than its weight shard
    (rows of ``x`` fewer than the rank's contraction length), the shard
    stays: the product is then a partial sum (``embed`` contracted) or
    sharded (``embed`` out), reduced or gathered where it is next read,
    as XLA keeps it.  The identity on one card."""
    mesh = current_mesh()
    if mesh is None or not isinstance(w, DTensor):
        return constrain(w, logical)
    return w.redistribute(mesh, _use_placements(w, logical, x, k_dims))


def _use_placements(w: DTensor, logical, x: Tensor, k_dims: Tuple[int, ...]
                    ) -> Tuple[Placement, ...]:
    """The placements :func:`_for_use` gives ``w`` on the active mesh."""
    mesh = current_mesh()
    target = placements(logical_spec(logical, mesh), mesh)
    k_loc = math.prod(w._local_tensor.shape[d] for d in k_dims)
    x_pls = x.placements if isinstance(x, DTensor) else (
        (Replicate(),) * mesh.ndim)
    xl = x._local_tensor if isinstance(x, DTensor) else x
    rows = xl.numel() // max(xl.shape[-1], 1)
    return tuple(
        p if (isinstance(p, Shard) and not isinstance(t, Shard)
              and not _splits_tokens(px, x) and rows < k_loc) else t
        for p, t, px in zip(w.placements, target, x_pls, strict=True))


def _splits_tokens(p: Placement, x: Tensor) -> bool:
    """Whether placement ``p`` of activations ``x`` (..., features)
    splits their token rows (a shard of any dimension but the last)."""
    return isinstance(p, Shard) and p.dim < x.dim() - 1


def _qkv(p: GQA, x: Tensor, cd: torch.dtype) -> Tuple[Tensor, Tensor, Tensor]:
    xc = x.to(cd)
    q = _proj(xc, _for_use(p.wq.to(cd), (None, "heads", "head_dim"), xc,
                           (0,)))
    k = _proj(xc, _for_use(p.wk.to(cd), (None, "kv_heads", "head_dim"), xc,
                           (0,)))
    v = _proj(xc, _for_use(p.wv.to(cd), (None, "kv_heads", "head_dim"), xc,
                           (0,)))
    if p.qkv_bias:
        q = q + p.bq.to(cd)
        k = k + p.bk.to(cd)
        v = v + p.bv.to(cd)
    return q, k, v


def _out(p: GQA, o: Tensor, cd: torch.dtype) -> Tensor:
    """``einsum("bshk,hkd->bsd", o, wo)`` as one 2-D matmul."""
    h, k, d = p.wo.shape
    of = o.to(cd).flatten(-2)
    wo = _for_use(p.wo.to(cd), ("heads", "head_dim", None), of, (0, 1))
    return of @ wo.reshape(h * k, d)


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
    adds the sliding-window mask ``q_pos - kv_pos < window``
    (Mistral-style)."""
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
        if window:
            keep = keep & ((q_pos[:, None] - kv_pos[None, :]) < window)
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


def _attend(q: Tensor, k: Tensor, v: Tensor, attention: str, *,
            window: int = 0, chunk: int = 1024,
            softmax_scale: Optional[float] = None,
            backend: str = "auto") -> Tensor:
    """Causal attention of a whole sequence by ``attention``: "chunked"
    (:func:`chunked_attention`, differentiable) or "flash"
    (``ops.flash_attention``: the kernel on CUDA)."""
    if attention == "chunked":
        fn = functools.partial(chunked_attention, causal=True, window=window,
                               chunk=chunk, softmax_scale=softmax_scale)
    elif attention == "flash":
        fn = functools.partial(ops.flash_attention, causal=True,
                               window=window, softmax_scale=softmax_scale,
                               backend=backend)
    else:
        raise ValueError(f"unknown attention {attention!r}")
    H, KH = q.shape[2], k.shape[2]
    axes = head_axes(H, KH)
    n, G = axis_size("heads"), H // KH
    if axes[2] is None and n > 1 and H % n == 0 and (
            (H // n) % G == 0 or G % (H // n) == 0):
        # the query heads divide the model axis, the kv heads do not: each
        # rank attends its query heads with the kv heads they group into,
        # taken from the replicated k and v
        q_axes, kv_axes = ("batch", None, "heads", None), ("batch",) + (
            None,) * 3

        def grouped(q_, k_, v_):
            first = axis_start("heads", H)
            kv = slice(first // G, (first + q_.shape[2] - 1) // G + 1)
            return fn(q_, k_[:, :, kv], v_[:, :, kv])
        return local_region(grouped, (q_axes, kv_axes, kv_axes),
                            q_axes)(q, k, v)
    return local_region(fn, (axes, axes, axes), axes)(q, k, v)


def head_axes(n_heads: int, n_kv_heads: int) -> Tuple:
    """Logical axes of a ``(B, S, heads, D)`` attention operand inside a
    :func:`local_region`: batch over the data axes, heads over the model
    axis when both head counts divide it (else replicated)."""
    n = axis_size("heads")
    heads = "heads" if n_heads % n == 0 and n_kv_heads % n == 0 else None
    return ("batch", None, heads, None)


def gqa_apply(p: GQA, x: Tensor, *, positions: Tensor,
              rope_theta: float = 1e4, window: int = 0,
              attn_chunk: int = 1024, compute_dtype=torch.bfloat16,
              return_kv: bool = False, attention: str = "flash",
              backend: str = "auto"):
    """Full-sequence causal attention, sliding-window when ``window`` >
    0, for training (``attention="chunked"``: :func:`chunked_attention`,
    differentiable torch ops, what the JAX trainer runs) or prefill
    (``"flash"``: ``ops.flash_attention``, the Hopper kernel, which has no
    backward in either package).
    ``return_kv=True`` also returns the RoPE'd K and raw V, exactly what
    the decode cache stores.  ``backend="plain"`` takes the flash kernel's
    plain version on CUDA (``chip_smoke.py`` only)."""
    cd = compute_dtype
    q, k, v = _qkv(p, x, cd)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    o = _attend(q, k, v, attention, window=window, chunk=attn_chunk,
                backend=backend)
    y = _out(p, o, cd)
    if return_kv:
        return y, (k, v)
    return y


def gqa_decode(p: GQA, x: Tensor, cache: Dict[str, Tensor], *,
               rope_theta: float = 1e4, window: int = 0,
               compute_dtype=torch.bfloat16,
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One decode step.  cache = {k: (B, S, KH, Dh), v: ..., len: (B,)}.

    The new key (post-RoPE, at its absolute position) and value go to
    slot ``min(len, S - 1)`` or, with ``window`` > 0, to ring slot ``len
    % S`` (the cache is a ring of ``S`` = window slots; keys carry their
    absolute positions, so slot order does not matter).  They are written
    **in place** into the cache tensors (the JAX version returns new
    buffers); the returned cache holds the same tensors and ``len + 1``."""
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
    slot = torch.remainder(pos, S) if window else torch.clamp(pos, max=S - 1)
    valid = torch.clamp(pos + 1, max=S)
    if isinstance(cache["k"], DTensor) and axis_size("kv_seq") > 1:
        return _seq_sharded_decode(p, q, k_new, v_new, cache, slot, valid,
                                   cd)
    axes = head_axes(q.shape[2], k_new.shape[2])
    # the cache is written as the rules place it (kv heads whole where an
    # arch's rules say so), so the write lands in its own shards, not in
    # a redistributed copy
    c_axes = ("batch", None, "kv_heads", None)
    row = (c_axes[0],) + c_axes[2:]
    put = local_region(_batched_set, (c_axes, row, ("batch",)), c_axes)
    k_cache = put(cache["k"], k_new[:, 0], slot)
    v_cache = put(cache["v"], v_new[:, 0], slot)
    o = local_region(_direct_decode_attention,
                     (axes, axes, axes, ("batch",)), axes)(
        q, k_cache, v_cache, valid)
    y = _out(p, o, cd)
    return y, {"k": k_cache, "v": v_cache, "len": pos + 1}


def _seq_sharded_decode(p: GQA, q, k_new, v_new, cache, slot, valid, cd):
    """:func:`gqa_decode` on a mesh whose cache is sharded along its
    sequence (``kv_seq``: kv heads that do not cover the model axis), as
    the JAX rules place it: each rank writes the new entry only where the
    slot is its own, and attends over its slots alone; the ranks' softmax
    statistics (max, sum, weighted values) are then combined, so only
    those cross the links, never the cache."""
    S = cache["k"].shape[1]
    c_axes = ("batch", "kv_seq", None, None)

    def put_local(buf, val, slot_):
        return _batched_set(buf, val, slot_, axis_start("kv_seq", S))

    def stats_local(q_, k_, v_, valid_):
        m, den, acc = _decode_partial(q_, k_, v_, valid_,
                                      axis_start("kv_seq", S))
        return m[None], den[None], acc[None]

    put = local_region(put_local, (c_axes, ("batch", None, None),
                                   ("batch",)), c_axes)
    k_cache = put(cache["k"], k_new[:, 0], slot)
    v_cache = put(cache["v"], v_new[:, 0], slot)
    st = ("kv_seq", "batch", None, None, None)
    m, den, acc = local_region(
        stats_local, (("batch", None, None, None), c_axes, c_axes,
                      ("batch",)), (st, st, st + (None,)))(
        q, k_cache, v_cache, valid)
    w = torch.exp(m - m.amax(0))                 # (n, B, 1, KH, G)
    o = (acc * w[..., None]).sum(0) / torch.clamp(
        (den * w).sum(0)[..., None], min=1e-30)
    B, _, H, _ = q.shape
    o = o.reshape(B, 1, H, o.shape[-1]).to(q.dtype)
    y = _out(p, o, cd)
    return y, {"k": k_cache, "v": v_cache, "len": cache["len"] + 1}


def _decode_partial(q: Tensor, k: Tensor, v: Tensor, valid: Tensor,
                    first: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Single-token attention over a run of cache slots that starts at
    slot ``first``, the slots from ``valid`` on masked, unnormalised: the
    fp32 max ``(B, 1, KH, G)``, the sum of ``exp(score - max)`` and the
    weighted values ``(B, 1, KH, G, Dv)``.  A run of masked slots only
    gives weights that the combination with slot 0's run (always valid)
    sends to zero."""
    B, _, H, Dh = q.shape
    _, S, KH, Dv = v.shape
    qg = q.reshape(B, 1, KH, H // KH, Dh).to(torch.float32)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg,
                     k.to(torch.float32)) * (Dh ** -0.5)
    slots = first + torch.arange(S, device=q.device)
    # masked_fill with a Python scalar: a scalar *tensor* made here would
    # be an upload from pageable memory, which syncs with the host.
    s = s.masked_fill((slots[None, :] >= valid[:, None])
                      [:, None, None, None, :], -1e30)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    return m, e.sum(dim=-1), torch.einsum("bqkgs,bskv->bqkgv", e,
                                          v.to(torch.float32))


def _direct_decode_attention(q: Tensor,       # (B, 1, H, Dh)
                             k: Tensor,       # (B, S, KH, Dh)
                             v: Tensor,       # (B, S, KH, Dv)
                             valid: Tensor,   # (B,)
                             ) -> Tensor:
    """Single-token attention over the whole cache, fp32 softmax over the
    first ``valid`` slots of each sequence (no host sync):
    :func:`_decode_partial` from slot 0, normalised."""
    B, _, H, _ = q.shape
    _, den, acc = _decode_partial(q, k, v, valid, 0)
    return (acc / den[..., None]).reshape(B, 1, H, -1).to(q.dtype)


def _batched_set(buf: Tensor, val: Tensor, idx: Tensor,
                 first: int = 0) -> Tensor:
    """buf: (B, S, ...), a run of slots that starts at slot ``first``;
    val: (B, ...); idx: (B,) -> ``buf[b, idx[b] - first] = val[b]`` in
    place where the run holds slot ``idx[b]``; returns ``buf``."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    loc, held = local_index(idx.to(torch.int64), first, buf.shape[1])
    cur = buf[rows, loc]
    keep = held.reshape((-1,) + (1,) * (cur.dim() - 1))
    buf[rows, loc] = torch.where(keep, val.to(buf.dtype), cur)
    return buf


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLADims:
    d_model: int
    n_heads: int
    q_lora: int          # 0 => no query compression
    kv_lora: int
    d_nope: int          # per-head non-rotary qk dim
    d_rope: int          # per-head rotary qk dim (key side is shared)
    d_v: int


class MLA(nn.Module):
    """``wq_a`` (d, q_lora), ``q_norm`` (q_lora,) and ``wq_b`` (q_lora, H,
    d_nope + d_rope), or ``wq`` (d, H, d_nope + d_rope) without query
    compression; ``wkv_a`` (d, kv_lora + d_rope), ``kv_norm`` (kv_lora,),
    ``wk_b`` (kv_lora, H, d_nope), ``wv_b`` (kv_lora, H, d_v) and ``wo``
    (H, d_v, d).  The norms are bare scale vectors, as in the JAX tree."""

    def __init__(self, w: Dict[str, Tensor], trainable: bool = False):
        super().__init__()
        for name, t in w.items():
            setattr(self, name, _param(t, trainable))
        self.q_lora = "wq_a" in w


def mla_init(dims: MLADims, *, generator: torch.Generator,
             dtype=torch.bfloat16, trainable: bool = False) -> MLA:
    d, H = dims.d_model, dims.n_heads
    s = 1.0 / d ** 0.5
    dq = dims.d_nope + dims.d_rope
    dev = generator.device

    def w(shape):
        return _normal(shape, s, dtype, generator)

    p: Dict[str, Tensor] = {}
    if dims.q_lora:
        p["wq_a"] = w((d, dims.q_lora))
        p["q_norm"] = torch.ones((dims.q_lora,), dtype=dtype, device=dev)
        p["wq_b"] = w((dims.q_lora, H, dq))
    else:
        p["wq"] = w((d, H, dq))
    p["wkv_a"] = w((d, dims.kv_lora + dims.d_rope))
    p["kv_norm"] = torch.ones((dims.kv_lora,), dtype=dtype, device=dev)
    p["wk_b"] = w((dims.kv_lora, H, dims.d_nope))
    p["wv_b"] = w((dims.kv_lora, H, dims.d_v))
    p["wo"] = w((H, dims.d_v, d))
    return MLA(p, trainable)


def _mla_q(p: MLA, x: Tensor, dims: MLADims,
           cd: torch.dtype) -> Tuple[Tensor, Tensor]:
    """(q_nope, q_rope), each (B, S, H, *).  The query latent's norm takes
    ``rmsnorm``'s default eps (1e-5), as the JAX package's does."""
    if p.q_lora:
        q_c = x.to(cd) @ p.wq_a.to(cd)
        q_c = _RMSNormFn.apply(q_c, p.q_norm, 1e-5)
        q = _proj(q_c.to(cd), p.wq_b.to(cd))
    else:
        q = _proj(x.to(cd), p.wq.to(cd))
    return q[..., :dims.d_nope], q[..., dims.d_nope:]


def _mla_kv(p: MLA, x: Tensor, dims: MLADims, positions: Tensor,
            rope_theta: float, cd: torch.dtype) -> Tuple[Tensor, Tensor]:
    """The latent cache entries: ``c_kv`` (B, S, kv_lora), normed with the
    default eps, and the shared RoPE'd key ``k_rope`` (B, S, d_rope)."""
    kv = x.to(cd) @ p.wkv_a.to(cd)
    c_kv = _RMSNormFn.apply(kv[..., :dims.kv_lora], p.kv_norm, 1e-5)
    k_rope = apply_rope(kv[..., dims.kv_lora:], positions, rope_theta)
    return c_kv, k_rope


def mla_qkv(p: MLA, x: Tensor, dims: MLADims, positions: Tensor,
            rope_theta: float, cd: torch.dtype):
    """The expanded heads ``(q, k, v)``: q and k ``(B, S, H, d_nope +
    d_rope)`` (k's rotary part shared by the heads), v ``(B, S, H,
    d_v)``; and the latent cache entries ``(c_kv, k_rope)``."""
    q_nope, q_rope = _mla_q(p, x, dims, cd)
    q_rope = apply_rope(q_rope, positions, rope_theta)
    c_kv, k_rope = _mla_kv(p, x, dims, positions, rope_theta, cd)
    k_nope = _proj(c_kv.to(cd), p.wk_b.to(cd))
    v = _proj(c_kv.to(cd), p.wv_b.to(cd))
    k_rope_h = k_rope[:, :, None, :].expand(*k_rope.shape[:2], dims.n_heads,
                                            dims.d_rope)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope_h], -1)
    return (q, k, v), (c_kv, k_rope)


def mla_apply(p: MLA, x: Tensor, dims: MLADims, *, positions: Tensor,
              rope_theta: float = 1e4, attn_chunk: int = 1024,
              compute_dtype=torch.bfloat16, return_kv: bool = False,
              attention: str = "flash", backend: str = "auto"):
    """Training/prefill forward, the expanded formulation: per-head keys
    ``[k_nope, k_rope]`` (d_nope + d_rope wide) and values (d_v wide),
    causal attention at scale ``(d_nope + d_rope) ** -0.5`` by
    ``attention`` (as :func:`gqa_apply`).  ``return_kv=True`` also returns
    ``(c_kv, k_rope)``, the latent cache entries :func:`mla_decode` reads."""
    cd = compute_dtype
    (q, k, v), (c_kv, k_rope) = mla_qkv(p, x, dims, positions, rope_theta, cd)
    scale = (dims.d_nope + dims.d_rope) ** -0.5
    o = _attend(q, k, v, attention, chunk=attn_chunk, softmax_scale=scale,
                backend=backend)
    h, dv, d = p.wo.shape
    y = o.to(cd).flatten(-2) @ p.wo.to(cd).reshape(h * dv, d)
    if return_kv:
        return y, (c_kv, k_rope)
    return y


def mla_decode(p: MLA, x: Tensor, cache: Dict[str, Tensor], dims: MLADims,
               *, rope_theta: float = 1e4, compute_dtype=torch.bfloat16,
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Absorbed-matmul decode over the latent cache ``{c_kv: (B, S,
    kv_lora), k_rope: (B, S, d_rope), len: (B,)}``: ``wk_b`` is absorbed
    into the query and ``wv_b`` into the output, so a step's work scales
    with kv_lora, not heads x head dim x S (DeepSeek-V2 §2.1).  The new
    entries go to slot ``min(len, S - 1)``, written **in place**."""
    cd = compute_dtype
    pos = cache["len"]
    q_nope, q_rope = _mla_q(p, x, dims, cd)                # (B, 1, H, *)
    q_rope = apply_rope(q_rope, pos[:, None], rope_theta)
    c_new, kr_new = _mla_kv(p, x, dims, pos[:, None], rope_theta, cd)

    S = cache["c_kv"].shape[1]
    slot = torch.clamp(pos, max=S - 1)
    put = local_region(_batched_set, (("batch", None, None),
                                      ("batch", None), ("batch",)),
                       ("batch", None, None))
    c_kv = put(cache["c_kv"], c_new[:, 0], slot)
    k_rope = put(cache["k_rope"], kr_new[:, 0], slot)
    valid = torch.clamp(pos + 1, max=S)

    f32 = torch.float32
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p.wk_b.to(cd))
    s_lat = torch.einsum("bshr,btr->bhst", q_lat.to(f32), c_kv.to(f32))
    s_rope = torch.einsum("bshk,btk->bhst", q_rope.to(f32), k_rope.to(f32))
    scale = (dims.d_nope + dims.d_rope) ** -0.5
    s = (s_lat + s_rope) * scale                           # (B, H, 1, S)
    masked = torch.arange(S, device=x.device)[None, :] >= valid[:, None]
    s = s.masked_fill(masked[:, None, None, :], -1e30)
    a = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", a, c_kv.to(f32))
    o = torch.einsum("bshr,rhk->bshk", o_lat.to(cd), p.wv_b.to(cd))
    h, dv, d = p.wo.shape
    y = o.flatten(-2) @ p.wo.to(cd).reshape(h * dv, d)
    return y, {"c_kv": c_kv, "k_rope": k_rope, "len": pos + 1}


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
    return _swiglu(x, p.w_gate, p.w_up, p.w_down, compute_dtype)


def _swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor,
            cd: torch.dtype) -> Tensor:
    xc = x.to(cd)
    # FSDP-sharded weights for their use (_for_use)
    g = xc @ _for_use(w_gate.to(cd), (None, "ff"), xc, (0,))
    u = xc @ _for_use(w_up.to(cd), (None, "ff"), xc, (0,))
    h = torch.nn.functional.silu(g.to(torch.float32)).to(cd) * u
    h = constrain(h, ("batch",) + (None,) * (h.dim() - 2) + ("act_ff",))
    return h @ _for_use(w_down.to(cd), ("ff", None), h, (0,))



# ---------------------------------------------------------------------------
# sort-based top-k MoE
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    n_experts: int
    top_k: int
    d_ff: int            # per-expert hidden
    n_shared: int = 0    # shared experts (DeepSeek)
    capacity_factor: float = 1.25
    # Dispatch groups: routing, sort and scatter run independently per
    # token group (the JAX package shards them like the batch).
    dispatch_groups: int = 32


class MoE(nn.Module):
    """``router`` (d, E) fp32, ``w_gate``/``w_up`` (E, d, f), ``w_down``
    (E, f, d) and, with shared experts, ``shared`` (a :class:`SwiGLU` of
    width ``n_shared * f``)."""

    def __init__(self, router: Tensor, w_gate: Tensor, w_up: Tensor,
                 w_down: Tensor, shared: Optional[SwiGLU] = None,
                 trainable: bool = False):
        super().__init__()
        self.router = _param(router, trainable)
        self.w_gate, self.w_up, self.w_down = (_param(w, trainable) for w in
                                               (w_gate, w_up, w_down))
        self.shared = shared


def moe_init(dims: MoEDims, *, generator: torch.Generator,
             dtype=torch.bfloat16, trainable: bool = False) -> MoE:
    d, E, f = dims.d_model, dims.n_experts, dims.d_ff
    s_in, s_out = 1.0 / d ** 0.5, 1.0 / f ** 0.5
    router = _normal((d, E), s_in, dtype, generator).to(torch.float32)
    w_gate = _normal((E, d, f), s_in, dtype, generator)
    w_up = _normal((E, d, f), s_in, dtype, generator)
    w_down = _normal((E, f, d), s_out, dtype, generator)
    shared = None
    if dims.n_shared:
        shared = swiglu_init(d, dims.n_shared * f, generator=generator,
                             dtype=dtype, trainable=trainable)
    return MoE(router, w_gate, w_up, w_down, shared, trainable)


def _pick_groups(preferred: int, T: int) -> int:
    g = min(preferred, T)
    while T % g:
        g -= 1
    return max(g, 1)


def moe_capacity(dims: MoEDims, tokens_per_group: int) -> int:
    """Slots per expert and group: ``int(Tg K / E * cf) + 1`` rounded up
    to a multiple of 4, at least 4."""
    C = int((tokens_per_group * dims.top_k / dims.n_experts)
            * dims.capacity_factor) + 1
    return max(4, -(-C // 4) * 4)


def moe_route(p: MoE, x: Tensor, top_k: int
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """The router in fp32: ``(probs (..., E), gates (..., K), ids (...,
    K))``, the top ``K`` experts of each token by probability, in
    falling order as ``jax.lax.top_k`` gives them, their gates
    renormalised to sum 1."""
    return _route(p.router, x, top_k)


def _route(router: Tensor, x: Tensor, top_k: int
           ) -> Tuple[Tensor, Tensor, Tensor]:
    logits = x.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, ids


def moe_apply(p: MoE, x: Tensor, dims: MoEDims, *,
              compute_dtype=torch.bfloat16) -> Tuple[Tensor, Tensor]:
    """Sort-based dropping MoE (MegaBlocks/MaxText style), group-local, as
    the JAX package's ``moe_apply``: x (B, S, D) -> (y, Switch aux loss).

    The ``T = B S`` tokens split into ``G = _pick_groups(32, T)`` groups of
    ``Tg``.  In each group the ``Tg K`` routed copies are sorted by expert
    (a stable sort, as ``jnp.argsort(stable=True)``: it decides which
    copies overflow) and the first ``C`` of each expert fill its slots;
    the rest are dropped, sent to a trash row past the ``E G C`` real
    slots (the JAX scatter drops them with ``mode="drop"``).  The slots
    are laid out expert-major, ``(E, G C, D)``, so the expert products
    are three ``torch.bmm`` over the experts; the combine gathers each
    copy's row, weighs it by its gate (0 if dropped) and adds it to its
    token with ``index_add_``.  Shared experts add a SwiGLU of every token.
    Nothing here waits for the device.  On a mesh (the dry-run's traced
    cells) it runs expert-parallel: :func:`_moe_sharded`."""
    cd = compute_dtype
    B, S, D = x.shape
    E, K = dims.n_experts, dims.top_k
    T = B * S
    G = _pick_groups(dims.dispatch_groups, T)
    if isinstance(x, DTensor) and current_mesh() is not None:
        return _moe_sharded(p, x, dims, cd, G)
    y, probs, ids = _moe_experts(x, p.router, p.w_gate, p.w_up, p.w_down,
                                 dims, cd, G, 0)
    # load-balancing aux loss (Switch): E * sum_e f_e * p_e over all tokens
    me = probs.mean(dim=(0, 1))
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, ids.reshape(-1), torch.ones((T * K,), dtype=torch.float32,
                                       device=x.device)) / (T * K)
    aux = E * torch.sum(me * ce)
    if p.shared is not None:
        y = y + swiglu(p.shared, x.reshape(G, T // G, D), cd)
    return y.reshape(B, S, D).to(x.dtype), aux


def _moe_experts(x: Tensor, router: Tensor, w_gate: Tensor, w_up: Tensor,
                 w_down: Tensor, dims: MoEDims, cd: torch.dtype, G: int,
                 e0: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The routed experts of :func:`moe_apply` over ``G`` groups of ``x``
    (B, S, D), for the experts ``[e0, e0 + len(w_gate))`` (all of them
    unless the weights are a shard): ``(y (G, Tg, D) in cd, probs (G, Tg,
    E), ids (G, Tg, K))``.  Copies routed to other experts add nothing,
    so over expert shards ``y`` is a partial sum."""
    hb, route, probs, ids = _moe_dispatch(x, router, dims, cd, G, e0,
                                          w_gate.shape[0])
    g = torch.bmm(hb, w_gate.to(cd))
    u = torch.bmm(hb, w_up.to(cd))
    del hb
    h = torch.nn.functional.silu(g.to(torch.float32)).to(cd) * u
    del g, u
    yb = torch.bmm(h, w_down.to(cd))                             # (E G C, D)
    del h
    return _moe_combine(yb, route, x.shape[0] * x.shape[1], cd), probs, ids


def _moe_dispatch(x: Tensor, router: Tensor, dims: MoEDims, cd: torch.dtype,
                  G: int, e0: int, E_loc: int):
    """Route ``G`` groups of ``x`` (B, S, D) and lay the copies of experts
    ``[e0, e0 + E_loc)`` out expert-major: ``(hb (E_loc, G C, D), route,
    probs, ids)``, ``route`` the ``(G, Tg K)`` slot, kept flag, gate and
    token of each copy (:func:`_moe_combine` takes them)."""
    B, S, D = x.shape
    E, K = dims.n_experts, dims.top_k
    T = B * S
    Tg = T // G
    dev = x.device
    xg = x.reshape(G, Tg, D)
    probs, gates, ids = _route(router, xg, K)

    C = moe_capacity(dims, Tg)
    n = Tg * K
    expert_of = ids.reshape(G, n)
    se, order = torch.sort(expert_of, dim=-1, stable=True)       # (G, n)
    st = torch.div(order, K, rounding_mode="floor")              # token
    sg = torch.gather(gates.reshape(G, n), 1, order)             # gate
    starts = torch.searchsorted(
        se, torch.arange(E, device=dev, dtype=se.dtype).expand(G, E)
        .contiguous(), side="left")
    pos = torch.arange(n, device=dev) - torch.gather(starts, 1, se)
    keep = pos < C
    if E_loc != E:                       # an expert shard: its copies only
        keep = keep & (se >= e0) & (se < e0 + E_loc)
        se = se - e0
    grp = torch.arange(G, device=dev)[:, None]
    trash = E_loc * G * C
    slot = torch.where(keep, se * (G * C) + grp * C + pos, trash)  # (G, n)
    tok = grp * Tg + st                                          # (G, n)
    xs = xg.reshape(T, D).index_select(0, tok.reshape(-1)).to(cd)
    buf = torch.zeros((trash + 1, D), dtype=cd, device=dev)
    buf.index_copy_(0, slot.reshape(-1), xs)
    del xs
    return buf[:trash].view(E_loc, G * C, D), (slot, keep, sg, tok), probs, \
        ids


def _moe_combine(yb: Tensor, route, T: int, cd: torch.dtype) -> Tensor:
    """Each kept copy's expert output ``yb`` (E_loc, G C, D') weighed by
    its gate and added to its token of the ``T``: ``(G, T / G, D')`` in
    cd."""
    slot, keep, sg, tok = route
    G = slot.shape[0]
    trash = yb.shape[0] * yb.shape[1]
    yb = yb.view(trash, yb.shape[-1])
    y_cp = yb.index_select(0, torch.clamp(slot, max=trash - 1).reshape(-1))
    y_cp = (y_cp * keep.reshape(-1, 1).to(cd)
            * sg.reshape(-1, 1).to(cd))
    y = torch.zeros((T, yb.shape[-1]), dtype=cd, device=yb.device
                    ).index_add_(0, tok.reshape(-1), y_cp)
    return y.view(G, T // G, yb.shape[-1])


def _moe_sharded(p: MoE, x: Tensor, dims: MoEDims, cd: torch.dtype,
                 G: int) -> Tuple[Tensor, Tensor]:
    """:func:`moe_apply` on a mesh, per rank (``local_region``): the token
    groups split like the batch, each rank runs its own experts (the
    ``experts`` axis) over its groups, and the routed and shared outputs
    are partial sums over the expert and hidden axes; the aux loss is
    made from the routing statistics summed over the batch axes, so it is
    the whole batch's."""
    B, S, D = x.shape
    E, K = dims.n_experts, dims.top_k
    e0 = axis_start("experts", E)
    g_loc = G // axis_size("batch")
    w_in = _use_placements(p.w_gate, ("experts", None, "expert_ff"), x,
                           (1,))
    if p.shared is None and any(isinstance(q, Shard) and q.dim == 1
                                for q in w_in) and not any(
            _splits_tokens(q, x) for q in x.placements):
        return _moe_partials(p, x, dims, cd, G)
    shared = () if p.shared is None else (
        p.shared.w_gate, p.shared.w_up, p.shared.w_down)

    def local(x_, router, w_gate, w_up, w_down, *sh):
        y, probs, ids = _moe_experts(x_, router, w_gate, w_up, w_down, dims,
                                     cd, g_loc, e0)
        if sh:
            y = y + _swiglu(x_.reshape(y.shape), *sh, cd)
        me_sum = probs.sum(dim=(0, 1))
        counts = torch.zeros((E,), dtype=torch.float32,
                             device=x_.device).index_add_(
            0, ids.reshape(-1), torch.ones((ids.numel(),),
                                           dtype=torch.float32,
                                           device=x_.device))
        return y.reshape(x_.shape).to(x_.dtype), me_sum, counts

    expert_in = ("experts", None, "expert_ff")
    weights = (expert_in, expert_in, ("experts", "expert_ff", None))
    shared_in = ((None, "ff"), (None, "ff"), ("ff", None))[:len(shared)]
    y, me_sum, counts = local_region(
        local, (("batch", None, None), (None, None)) + weights + shared_in,
        (("batch", None, None), (None,), (None,)),
        partial=(("experts", "expert_ff", "ff"), "batch", "batch"))(
            x, p.router, p.w_gate, p.w_up, p.w_down, *shared)
    T = B * S
    aux = E * torch.sum((me_sum / T) * (counts / (T * K)))
    return y, aux


def _moe_partials(p: MoE, x: Tensor, dims: MoEDims, cd: torch.dtype,
                  G: int) -> Tuple[Tensor, Tensor]:
    """:func:`moe_apply` without shared experts on a mesh for tokens that
    no mesh axis splits (a decode step of one sequence) when
    :func:`_for_use` keeps the experts' ``embed`` shard (FSDP): the
    weights stay as placed, as XLA keeps them.  Each rank routes every token, multiplies its ``embed`` slice
    of the dispatched copies by its shard of the up projections (partial
    sums over the ``embed`` axes, reduced before the SiLU: one token's
    ``(E, C, d_ff)`` products, not the weights, cross the links), and
    its hidden slice by its shard of the down projection, which leaves
    the rank's ``embed`` columns of the output, a partial sum over the
    expert and hidden axes."""
    B, S, D = x.shape
    E, K = dims.n_experts, dims.top_k
    mesh = current_mesh()
    e0 = axis_start("experts", E)
    c0 = shard_start(p.w_gate.shape, p.w_gate.placements, mesh, dim=1)
    rep = (Replicate(),) * mesh.ndim

    def up(x_, router, w_gate, w_up):
        hb, route, probs, ids = _moe_dispatch(x_, router, dims, cd, G, e0,
                                              w_gate.shape[0])
        hb = hb[..., c0:c0 + w_gate.shape[1]]
        counts = torch.zeros((E,), dtype=torch.float32,
                             device=x_.device).index_add_(
            0, ids.reshape(-1), torch.ones((ids.numel(),),
                                           dtype=torch.float32,
                                           device=x_.device))
        return (torch.bmm(hb, w_gate.to(cd)), torch.bmm(hb, w_up.to(cd)),
                *route, probs.sum(dim=(0, 1)), counts)

    g_pls = tuple(Partial() if isinstance(q, Shard) and q.dim == 1 else q
                  for q in p.w_gate.placements)
    g, u, *route, me_sum, counts = placed_region(
        up, (rep, rep, p.w_gate.placements, p.w_up.placements),
        (g_pls, g_pls) + (rep,) * 6, mesh)(x, p.router, p.w_gate, p.w_up)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(cd) * u
    h_pls = tuple(Replicate() if q.is_partial() else q for q in g_pls)

    def down(h_, w_down, *route_):
        y = _moe_combine(torch.bmm(h_, w_down.to(cd)), route_, B * S, cd)
        return y.reshape(B, S, y.shape[-1]).to(x.dtype)

    y_pls = tuple(Shard(2) if isinstance(q, Shard) and q.dim == 2 else
                  Partial() if isinstance(q, Shard) else q
                  for q in p.w_down.placements)
    y = placed_region(down, (h_pls, p.w_down.placements) + (rep,) * 4,
                      (y_pls,), mesh)(h, p.w_down, *route)
    T = B * S
    aux = E * torch.sum((me_sum / T) * (counts / (T * K)))
    return y, aux
