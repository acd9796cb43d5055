"""GraphSAGE (Hamilton et al., arXiv:1706.02216; port of
``repro.models.gnn``).

Message passing is a gather and a segment sum over an edge index: the
messages are ``index_select(h, edge_src)`` and the aggregate is an
``index_add_`` over ``edge_dst`` (the JAX package's ``segment_sum``),
under an autograd rule that keeps only the indices (``_GatherSum``; its
backward is the same pair the other way round).  On CUDA the sums run in
fp32 atomics, so its order (and the last bits of
each aggregate) varies from run to run unless deterministic algorithms
are on.  No kernel of the port is on these paths.  Two execution modes:

  * full-batch (``full_graph_sm``, ``ogb_products``, ``molecule``):
    the whole edge list is aggregated per layer (:func:`forward_full`);
    the edge arrays are used as given (int32 or int64, on the device) and
    never cast in the layer loop;
  * sampled minibatch (``minibatch_lg``): dense neighbor blocks (B, f1,
    F) and (B, f1, f2, F) from ``data.graph_data.NeighborSampler`` and
    masked means (:func:`forward_sampled`).

Aggregator: mean.  Layer rule (paper Alg. 1):
    h_v^k = relu(W_k . concat(h_v^{k-1}, mean_{u in N(v)} h_u^{k-1}))
followed by L2 normalisation (no ReLU on the last layer).

:func:`make_sharded_loss` is the locality-partitioned full-batch loss
over a ``(data, model)`` mesh of ranks: edges partitioned by destination
node shard, features by column shard (:func:`shard_graph` cuts them);
its loss and every rank's gradients are those of :func:`loss_full`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (constrain, current_mesh,
                                              local_region, logical_spec,
                                              placed_region, placements)
from repro_torch.models.layers import _normal
from repro_torch.models.recsys import ParamTree

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 128
    d_feat: int = 602
    n_classes: int = 41
    aggregator: str = "mean"
    fanouts: Tuple[int, ...] = (25, 10)   # layer-1, layer-2 sample sizes
    dtype: str = "float32"
    l2_normalize: bool = True

    @property
    def param_dtype(self) -> torch.dtype:
        """The torch dtype of that name: float32, bfloat16 (the
        hillclimb variant), or float64, which a check of the sharded
        loss needs (PERF.md §6, PR 21)."""
        if self.dtype not in _PARAM_DTYPES:
            raise ValueError(f"SAGEConfig {self.name!r}: dtype "
                             f"{self.dtype!r} is not one of "
                             f"{sorted(_PARAM_DTYPES)}")
        return _PARAM_DTYPES[self.dtype]


_PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float64": torch.float64}


def init_params(cfg: SAGEConfig, seed: int = 0, device: DeviceLike = None,
                trainable: bool = False) -> Tuple[ParamTree, Dict]:
    """A seeded random model on ``device`` (``None`` -> ``cuda``), drawn
    from an explicit ``torch.Generator`` there, with the JAX
    ``init_params`` tree (``layers[i]``: ``w_self``, ``w_neigh`` (d_in,
    d_hidden), ``bias``; ``head``: ``w`` (d_hidden, n_classes), ``bias``),
    and that tree's logical axes."""
    g = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    dt = cfg.param_dtype
    layers, logical_layers = [], []
    d_in = cfg.d_feat
    for _ in range(cfg.n_layers):
        s = 1.0 / (d_in ** 0.5)
        layers.append({
            "w_self": _normal((d_in, cfg.d_hidden), s, dt, g),
            "w_neigh": _normal((d_in, cfg.d_hidden), s, dt, g),
            "bias": torch.zeros((cfg.d_hidden,), dtype=dt, device=g.device)})
        logical_layers.append({"w_self": ("feat", "hidden"),
                               "w_neigh": ("feat", "hidden"),
                               "bias": ("hidden",)})
        d_in = cfg.d_hidden
    head = {"w": _normal((d_in, cfg.n_classes), 1.0 / (d_in ** 0.5), dt, g),
            "bias": torch.zeros((cfg.n_classes,), dtype=dt, device=g.device)}
    logical = {"layers": logical_layers,
               "head": {"w": ("hidden", None), "bias": (None,)}}
    return ParamTree({"layers": layers, "head": head}, trainable), logical


def _l2_normalize(y: Tensor) -> Tensor:
    n = torch.linalg.vector_norm(y.to(torch.float32), dim=-1, keepdim=True)
    return y / n.clamp_min(1e-12).to(y.dtype)


def _sage_combine(lp: ParamTree, h_self: Tensor, h_neigh: Tensor,
                  cfg: SAGEConfig, last: bool) -> Tensor:
    """The layer in the type the inputs and weights promote to (JAX's
    rule: fp32 features with bf16 weights compute in fp32)."""
    dt = torch.promote_types(h_self.dtype, lp.w_self.dtype)
    y = (h_self.to(dt) @ lp.w_self.to(dt)
         + h_neigh.to(dt) @ lp.w_neigh.to(dt) + lp.bias.to(dt))
    if not last:
        y = torch.relu(y)
    return _l2_normalize(y) if cfg.l2_normalize else y


class _GatherSum(torch.autograd.Function):
    """``agg[v] = sum_{e: dst_e = v} h[src_e]``: the messages ``h[src]``
    (E, F) exist only inside the forward, and their cotangent
    ``g[dst]`` only inside the backward (``grad_h[u] = sum_{e: src_e =
    u} g[dst_e]``).  Autograd of ``index_add`` would save the messages
    for the backward, so two E x F tensors (31.7 GB each at
    ``ogb_products``' second layer) would be live at once; this saves
    the two index arrays only."""

    @staticmethod
    def forward(ctx, h: Tensor, src: Tensor, dst: Tensor, n: int) -> Tensor:
        ctx.save_for_backward(src, dst)
        ctx.n_src = h.shape[0]
        msgs = h.index_select(0, src)
        return h.new_zeros((n, h.shape[1])).index_add_(0, dst, msgs)

    @staticmethod
    def backward(ctx, g: Tensor):
        src, dst = ctx.saved_tensors
        gh = g.new_zeros((ctx.n_src, g.shape[1]))
        return gh.index_add_(0, src, g.index_select(0, dst)), None, None, \
            None


# On a mesh (the dry-run's traced cells) the edge lists are sharded and
# each rank sums its own edges' messages into every node: partial sums
# over the edge axes, reduced where the sum is next read.
_EDGES = ("edges",)


def _row_set(ids: Tensor, n_block: int, n_sub: int, m: int
              ) -> Tuple[Tensor, Tensor]:
    """Where node ``ids`` lie in row set ``m``: sub-block ``m`` (of
    ``n_sub`` rows) of every node block of ``n_block`` rows, the sets'
    blocks in order; ``(held, position)``, the position of a node the
    set does not hold being that of another row."""
    w = ids % n_block
    return w // n_sub == m, (ids // n_block) * n_sub + w % n_sub


def _over(t: Tensor, groups, op) -> Tensor:
    """``op`` (a ``distributed.collectives`` function) over each process
    group of ``groups`` in turn."""
    for g in groups:
        t = op(t, g)
    return t


class _RowSetGatherSum(torch.autograd.Function):
    """XLA's partition of the JAX package's gather and ``segment_sum``
    when every rank of a node block holds its rows whole (the first
    layer's features), on a rank whose edges vary over the ``rows``
    groups (the node axes) and not over the ``cols`` groups (the model
    axis): the node rows are laid out again over ``cols`` (row set
    ``m``: sub-block ``m`` of every node block, gathered over ``rows``),
    each rank gathers its edges' sources from its row set (zeros for the
    others) and the messages are summed over ``cols``; each rank then
    scatters them into its row set's destinations, the sums are
    reduce-scattered over ``rows`` to sub-block ``(r, m)`` and gathered
    over ``cols`` into the node block.  No rank holds more than about
    ``N / |cols|`` node rows.  Sub-blocks are ``ceil(block / |cols|)``
    rows, the last padded.  The backward is the same pair the other way
    round."""

    @staticmethod
    def forward(ctx, h: Tensor, src: Tensor, dst: Tensor, rows, cols,
                m: int, n_cols: int) -> Tensor:
        ctx.rows, ctx.cols, ctx.m, ctx.n_cols = rows, cols, m, n_cols
        ctx.save_for_backward(src, dst)
        return _RowSetGatherSum._pair(h, src, dst, rows, cols, m, n_cols)

    @staticmethod
    def _pair(block: Tensor, take: Tensor, put: Tensor, rows, cols, m: int,
              n_cols: int) -> Tensor:
        """``out[v] = sum_{e: put_e = v} t[take_e]`` for the node rows
        ``v`` of this rank's block, ``t`` given as every rank's
        ``block``."""
        n_block = block.shape[0]
        n_sub = -(-n_block // n_cols)
        sub = block[m * n_sub:(m + 1) * n_sub]
        if sub.shape[0] < n_sub:
            sub = torch.cat([sub, sub.new_zeros(
                (n_sub - sub.shape[0],) + tuple(sub.shape[1:]))])
        t = _over(sub, reversed(rows), C.all_gather)
        held, pos = _row_set(take, n_block, n_sub, m)
        msgs = torch.where(held[:, None], t.index_select(0, pos),
                           t.new_zeros(()))
        buf = torch.zeros_like(t)
        del t
        msgs = _over(msgs, cols, C.all_reduce)
        held, pos = _row_set(put, n_block, n_sub, m)
        buf.index_add_(0, pos, torch.where(held[:, None], msgs,
                                           msgs.new_zeros(())))
        del msgs
        out = _over(_over(buf, rows, C.reduce_scatter), reversed(cols),
                    C.all_gather)
        return out[:n_block]

    @staticmethod
    def backward(ctx, g: Tensor):
        src, dst = ctx.saved_tensors
        return (_RowSetGatherSum._pair(g, dst, src, ctx.rows, ctx.cols,
                                       ctx.m, ctx.n_cols),
                None, None, None, None, None, None)


def _gather_sum(h: Tensor, edge_src: Tensor, edge_dst: Tensor,
                n: int) -> Tensor:
    """:class:`_GatherSum`; on a mesh, per rank as XLA partitions the
    JAX package's gather and ``segment_sum`` of edges sharded over the
    node axes.  Where ``h``'s columns are sharded over the other axes
    (the hidden axis over ``model``), every rank gathers the node rows
    of its columns and scatters its edge shard's messages into an
    ``(N, columns of its own)`` partial sum over the edge axes, the
    backward the same pair the other way round (its gradient of ``h`` a
    partial sum); where they are whole (the features), the rows go over
    the other axes instead (:class:`_RowSetGatherSum`, the sums of
    sub-block ``(r, m)``).  No rank holds a whole ``(N, H)`` or ``(N,
    F)`` array."""
    def fn(h_, s_, d_):
        return _GatherSum.apply(h_, s_, d_, n)
    mesh = current_mesh()
    if mesh is None or not isinstance(h, DTensor):
        return fn(h, edge_src, edge_dst)
    edges = placements(logical_spec(_EDGES, mesh), mesh)
    r_dims = [i for i, e in enumerate(edges) if isinstance(e, Shard)]
    m_dims = [i for i in range(mesh.ndim) if i not in r_dims]
    if r_dims and m_dims and h.shape[0] % math.prod(
            mesh.size(i) for i in r_dims) == 0 and not any(
            isinstance(h.placements[i], Shard) for i in m_dims):
        m = 0
        for i in m_dims:
            m = m * mesh.size(i) + mesh.get_local_rank(i)
        rows = tuple(mesh.get_group(i) for i in r_dims)
        cols = tuple(mesh.get_group(i) for i in m_dims)
        n_cols = math.prod(mesh.size(i) for i in m_dims)
        h_pls = tuple(e if isinstance(e, Shard) else Replicate()
                      for e in edges)
        return placed_region(
            lambda h_, s_, d_: _RowSetGatherSum.apply(
                h_, s_, d_, rows, cols, m, n_cols),
            (h_pls, edges, edges), (h_pls,), mesh,
            grad_pls=(h_pls, edges, edges))(h, edge_src, edge_dst)
    cols = tuple(p if isinstance(p, Shard) and p.dim == 1
                 and not isinstance(e, Shard) else Replicate()
                 for p, e in zip(h.placements, edges, strict=True))
    out = tuple(Partial() if isinstance(e, Shard) else c
                for c, e in zip(cols, edges, strict=True))
    agg = placed_region(fn, (cols, edges, edges), (out,), mesh)(
        h, edge_src, edge_dst)
    # reduced into node rows before the layer's matmul reads it, so no
    # rank's matmul makes an (N, H) partial product
    return agg.redistribute(mesh, tuple(
        e if isinstance(e, Shard) else c
        for c, e in zip(cols, edges, strict=True)))


def _segment_mean(h: Tensor, edge_src: Tensor, edge_dst: Tensor,
                  inv_deg: Tensor, n: int) -> Tensor:
    """mean over in-edges: ``sum_{e: dst=v} h[src_e] * inv_deg[v]``."""
    return _gather_sum(h, edge_src, edge_dst, n) * inv_deg[:, None]


def _degree(edge_dst: Tensor, n: int) -> Tensor:
    deg = torch.zeros(n, dtype=torch.float32, device=edge_dst.device)
    return deg.index_add_(0, edge_dst, torch.ones(
        edge_dst.shape, dtype=deg.dtype, device=deg.device))


def _inv_degree(edge_dst: Tensor, n: int, dtype: torch.dtype) -> Tensor:
    """``1 / max(in-degree, 1)``: the degree summed in fp32, then cast."""
    deg = local_region(lambda d: _degree(d, n), (_EDGES,), (None,),
                       partial="edges")(edge_dst)
    return (1.0 / deg.clamp_min(1.0)).to(dtype)


# ---------------------------------------------------------------------------
# full-batch forward: a segment sum over the global edge list
# ---------------------------------------------------------------------------

def forward_full(params: ParamTree, cfg: SAGEConfig, x: Tensor,
                 edge_src: Tensor, edge_dst: Tensor) -> Tensor:
    """x (N, F); edge arrays (E,) int32 or int64 (src -> dst messages).

    Mean aggregation = segment_sum(messages) / segment_sum(1).  Self loops
    are NOT assumed; isolated nodes see a zero neighbor vector."""
    n = x.shape[0]
    h = x.to(cfg.param_dtype)
    inv_deg = _inv_degree(edge_dst, n, h.dtype)
    for li, lp in enumerate(params.layers):
        agg = _segment_mean(h, edge_src, edge_dst, inv_deg, n)
        h = _sage_combine(lp, h, agg, cfg, last=(li == cfg.n_layers - 1))
        h = constrain(h, ("nodes", "hidden"))
    return h @ params.head.w + params.head.bias


# ---------------------------------------------------------------------------
# sampled minibatch forward: dense fanout blocks
# ---------------------------------------------------------------------------

def _mean_agg(xs: Tensor, mask: Tensor) -> Tensor:   # (..., k, F), (..., k)
    """The masked mean over the samples; on a mesh, per rank with the
    blocks placed as given (the nodes over the batch axes, the columns
    over ``model`` where they are), so the backward's cotangent of a
    ``(B, f1, H)`` block is this rank's rows and columns, never a
    partial sum over ``model``."""
    if isinstance(xs, DTensor) and current_mesh() is not None:
        x_pls = xs.placements
        out = tuple(Shard(p.dim - 1) if isinstance(p, Shard)
                    and p.dim == xs.dim() - 1 else p for p in x_pls)
        m_pls = tuple(p if isinstance(p, Shard) and p.dim < xs.dim() - 1
                      else Replicate() for p in x_pls)
        return placed_region(_mean_agg, (x_pls, m_pls), (out,),
                             xs.device_mesh)(xs, mask)
    s = (xs * mask[..., None]).sum(-2)
    d = mask.sum(-1, keepdim=True).clamp_min(1.0)
    return s / d


def forward_sampled(params: ParamTree, cfg: SAGEConfig,
                    feats: Tuple[Tensor, ...],
                    masks: Optional[Tuple[Tensor, ...]] = None) -> Tensor:
    """2-layer sampled forward (GraphSAGE minibatch regime).

    feats = (x_root (B,F), x_hop1 (B,f1,F), x_hop2 (B,f1,f2,F)) where f1 is
    the root fanout and f2 the second-hop fanout.  ``masks`` marks real
    (non-padded) samples.  Aggregation collapses hop2 -> hop1 -> root."""
    if cfg.n_layers != 2:
        raise ValueError("the sampled path implements the assigned 2-layer "
                         f"net, not {cfg.n_layers} layers")
    x_root, x_h1, x_h2 = feats
    if masks is None:
        m1 = torch.ones(x_h1.shape[:-1], dtype=x_root.dtype,
                        device=x_root.device)
        m2 = torch.ones(x_h2.shape[:-1], dtype=x_root.dtype,
                        device=x_root.device)
    else:
        m1, m2 = (m.to(x_root.dtype) for m in masks)
    lp1, lp2 = params.layers
    # layer 1 at depth-1 nodes (and the root) from depth-2 neighbors
    h1 = _sage_combine(lp1, x_h1, _mean_agg(x_h2, m2), cfg, last=False)
    h_root = _sage_combine(lp1, x_root, _mean_agg(x_h1, m1), cfg,
                           last=False)
    # layer 2 at the root from depth-1 hidden states
    h = _sage_combine(lp2, h_root, _mean_agg(h1, m1), cfg, last=True)
    h = constrain(h, ("nodes", "hidden"))
    return h @ params.head.w + params.head.bias


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def loss_full(params: ParamTree, cfg: SAGEConfig, x: Tensor,
              edge_src: Tensor, edge_dst: Tensor, labels: Tensor,
              label_mask: Tensor) -> Tuple[Tensor, Dict[str, Tensor]]:
    logits = forward_full(params, cfg, x, edge_src, edge_dst)
    return _masked_ce(logits, labels, label_mask)


def loss_sampled(params: ParamTree, cfg: SAGEConfig, feats, masks,
                 labels: Tensor) -> Tuple[Tensor, Dict[str, Tensor]]:
    logits = forward_sampled(params, cfg, feats, masks)
    return _masked_ce(logits, labels, torch.ones_like(labels,
                                                      dtype=torch.bool))


def _label_logp(logits: Tensor, labels: Tensor) -> Tensor:
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return logp.gather(-1, labels.long()[..., None])[..., 0]


def _masked_ce(logits: Tensor, labels: Tensor, mask: Tensor,
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Mean CE over the masked-in nodes (fp32 log-softmax), and ``acc``:
    ``argmax`` (the first maximum, as in JAX) equal to the label."""
    mask = mask.to(torch.float32)
    denom = mask.sum().clamp_min(1.0)
    loss = -(_label_logp(logits, labels) * mask).sum() / denom
    acc = ((logits.argmax(-1) == labels) * mask).sum() / denom
    return loss, {"ce": loss.detach(), "acc": acc.detach()}


# ---------------------------------------------------------------------------
# locality-partitioned full-batch loss over (data, model) ranks
# ---------------------------------------------------------------------------
#
# Edges are partitioned so that data shard d holds exactly the edges whose
# dst lies in its node range, node features are sharded (nodes x
# features) over (data x model), and per layer:
#   * the feature slice is all-gathered over the node axis: (N, F/M);
#   * messages and the segment sum stay shard-local;
#   * the W contraction over the sharded feature axis is summed over
#     "model", before the bias, ReLU and norm.
# The loss sum and the mask count are summed over "data".  The autograd
# rules of ``distributed.collectives`` make each rank's gradients those of
# the global loss; the parameters enter through ``replicate`` over the
# groups that use them in part (weights: both axes; biases and the head:
# "data"), so every rank ends with loss_full's whole gradient.

def shard_graph(x, edge_src, edge_dst, labels, mask, data: int, model: int,
                n_data: int, n_model: int, f_pad: int):
    """Rank ``(data, model)``'s pieces of a graph on an ``(n_data,
    n_model)`` mesh: its node range's rows of ``x`` zero-padded to
    ``f_pad`` columns, column block ``model`` of them; the edges whose
    dst lies in the range, dst made local (``src`` stays global), in
    their original order; the range's labels and mask.  Works on numpy
    arrays and tensors alike; N must divide ``n_data`` and ``f_pad``
    ``n_model``."""
    n, f = x.shape
    if n % n_data or f_pad % n_model or f_pad < f:
        raise ValueError(f"{n} nodes over {n_data} data shards, {f} "
                         f"features padded to {f_pad} over {n_model}")
    nl, fl = n // n_data, f_pad // n_model
    lo = data * nl
    cols = slice(model * fl, (model + 1) * fl)
    if isinstance(x, Tensor):
        xp = torch.zeros((nl, f_pad), dtype=x.dtype, device=x.device)
    else:
        xp = np.zeros((nl, f_pad), dtype=x.dtype)
    xp[:, :f] = x[lo:lo + nl]
    keep = (edge_dst >= lo) & (edge_dst < lo + nl)
    return (xp[:, cols], edge_src[keep], edge_dst[keep] - lo,
            labels[lo:lo + nl], mask[lo:lo + nl])


def make_sharded_loss(mesh, cfg: SAGEConfig, n_nodes: int, f_pad: int):
    """``loss_fn(params, x, edge_src, edge_dst_local, labels, mask)`` for
    this rank of ``mesh`` (a ``DeviceMesh`` with dimensions ``data`` and
    ``model``): ``x`` (N / data, f_pad / model) its block,
    ``edge_src`` (E_r,) global sources of its dst-local edges,
    ``edge_dst_local`` (E_r,) their destinations within its node range,
    ``labels`` and ``mask`` (N / data,) (:func:`shard_graph`).  ``params``
    are the whole model (``d_feat == f_pad``), the same on every rank.
    Returns the global masked CE, equal on every rank.  The edge lists
    may differ in length from rank to rank."""
    if cfg.n_layers != 2 or cfg.d_feat != f_pad:
        raise ValueError(f"a 2-layer config with d_feat = f_pad ({f_pad}) "
                         f"is needed, got {cfg.n_layers} layers, d_feat "
                         f"{cfg.d_feat}")
    g_data = mesh.get_group("data")
    g_model = mesh.get_group("model")
    m_size, r = C.group_size(g_model), mesh.get_local_rank("model")
    n_local = n_nodes // C.group_size(g_data)
    if f_pad % m_size or cfg.d_hidden % m_size:
        raise ValueError(f"f_pad {f_pad} and d_hidden {cfg.d_hidden} must "
                         f"divide the model size {m_size}")

    def both(w):             # a weight used by rows on every rank
        return C.replicate(C.replicate(w, g_model), g_data)

    def rows(w, width, dt):
        return both(w)[r * width:(r + 1) * width].to(dt)

    def layer(lp, h_local, edge_src, edge_dst_local, inv_deg, width, last):
        dt = h_local.dtype
        xg = C.gather_rows(h_local, g_data)          # (N, width)
        agg = _segment_mean(xg, edge_src, edge_dst_local, inv_deg, n_local)
        y = (h_local @ rows(lp.w_self, width, dt)
             + agg @ rows(lp.w_neigh, width, dt))
        y = C.reduce(y, g_model) + C.replicate(lp.bias, g_data).to(dt)
        if not last:
            y = torch.relu(y)
        return _l2_normalize(y) if cfg.l2_normalize else y

    def loss_fn(params, x, edge_src, edge_dst_local, labels, mask):
        if x.shape != (n_local, f_pad // m_size):
            raise ValueError(f"x block {tuple(x.shape)}, expected "
                             f"{(n_local, f_pad // m_size)}")
        lp1, lp2 = params.layers
        # x's type and the parameters' promote, as in the JAX function
        dt = torch.promote_types(x.dtype, cfg.param_dtype)
        inv_deg = _inv_degree(edge_dst_local, n_local, x.dtype).to(dt)
        h = layer(lp1, x.to(dt), edge_src, edge_dst_local, inv_deg,
                  f_pad // m_size, last=False)
        hw = cfg.d_hidden // m_size
        hf = C.replicate(h, g_model)[:, r * hw:(r + 1) * hw]
        h2 = layer(lp2, hf, edge_src, edge_dst_local, inv_deg, hw,
                   last=True)
        logits = (h2 @ C.replicate(params.head.w, g_data).to(dt)
                  + C.replicate(params.head.bias, g_data).to(dt))
        m = mask.to(torch.float32)
        loss_sum = C.reduce(-(_label_logp(logits, labels) * m).sum(),
                            g_data)
        n = C.all_reduce(m.sum(), g_data)
        return loss_sum / n.clamp_min(1.0)

    return loss_fn
