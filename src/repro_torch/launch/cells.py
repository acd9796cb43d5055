"""Cells (port of ``repro.launch.cells``): (arch x shape) -> a
traceable SPMD step.

``build_cell(arch_id, shape_id, mesh)`` returns everything the dry-run /
roofline harness needs:

  * ``step_fn``       the step over its arguments,
  * ``abstract_args`` the arguments as fake tensors (``FakeTensorMode``:
                      shapes, dtypes and devices, nothing allocated), or
                      real tensors on the card with ``fake=False``,
  * ``in_shardings``  :class:`~repro_torch.distributed.sharding.NamedSharding`
                      trees resolved through the logical rules (arch
                      overrides + shape overrides applied),
  * bookkeeping for the roofline (model param counts, family, kind).

Training cells run the FULL train step (forward + backward + optimizer
update, microbatched); decode cells one ``decode_step``; the FIM cells
one distributed mining round.  Model arguments are the port's modules;
a train cell's optimizer is built by ``prepare`` over the distributed
parameters (its state placed as they are) and is the step's second
argument, as the JAX cell's ``opt_a``: its state is held apart from the
step's allocations and counted in ``args_bytes`` in the JAX layout
(``state_tree()``, the int32 step included).

:func:`trace_cell` is the counterpart of ``lower_cell`` + ``compile``:
on a mesh of more than one rank it distributes the arguments as
``DTensor``\\ s (each rank's shard made locally, no communication; DTensor
keeps shards on the mesh's device type, the CPU on the fake world, and a
"cuda" cell traces under ``kernels.ops.card_path()``, so its fake shards
take the kernels' route, the custom ops, as on the card) and
runs ``step_fn`` once under the counters
(``roofline.counters.StepCounter``: flops, bytes, collectives, peak
memory), inside the cell's fake mode.  On one rank the arguments stay plain tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ArchSpec, ShapeDef, get_arch, get_shape
from repro_torch.kernels import ops
from repro_torch.distributed.sharding import (NamedSharding, active_mesh,
                                              dtensor_of, local_shape,
                                              make_param_shardings,
                                              use_rules)
from repro_torch.train.optimizer import OptConfig, opt_init
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import is_axes


@dataclasses.dataclass
class BuiltCell:
    arch_id: str
    shape_id: str
    kind: str
    step_fn: Callable
    abstract_args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    donate_argnums: Tuple[int, ...]
    rules: Dict[str, Any]
    model_params: int = 0
    active_params: int = 0
    skip_reason: Optional[str] = None
    notes: str = ""
    # the port's own: the fake mode the arguments live in (None: real
    # tensors), and the hook that finishes the arguments once they are
    # distributed (a train cell builds its optimizer there)
    fake_mode: Optional[FakeTensorMode] = None
    prepare: Optional[Callable] = None
    # a step written per rank (its own collectives): the arguments are
    # this rank's blocks already, never distributed
    per_rank: bool = False
    # where the arguments live: a "cuda" cell traces the card's path
    device: Optional[torch.device] = None


def _sds(shape, dtype, device) -> torch.Tensor:
    """An input of zeros (a fake tensor inside the cell's fake mode: no
    allocation); zero ids and masks are valid inputs for a real run."""
    return torch.zeros(tuple(shape), dtype=getattr(torch, dtype),
                       device=device)


def _shard_tree(mesh, logical_tree):
    return make_param_shardings(mesh, logical_tree)


def _opt_cfg_for(arch_id: str) -> OptConfig:
    # Adafactor for the >=100B models (moment memory), AdamW elsewhere.
    if arch_id in ("command-r-plus-104b", "deepseek-v2-236b",
                   "mixtral-8x22b"):
        return OptConfig(kind="adafactor", lr=1e-4)
    return OptConfig(kind="adamw", lr=3e-4)


# ---------------------------------------------------------------------------
# logical axes of the port's parameters (the JAX ``*_init`` trees')
# ---------------------------------------------------------------------------

# LM leaves by (name, ndim) of one layer's tensor (the JAX stacked
# leaves carry a leading None for the layer axis; the port keeps one
# module per layer).
_LM_AXES = {
    ("wq", 3): ("embed", "heads", "head_dim"),
    ("wk", 3): ("embed", "kv_heads", "head_dim"),
    ("wv", 3): ("embed", "kv_heads", "head_dim"),
    ("wo", 3): ("heads", "head_dim", "embed"),
    ("bq", 2): ("heads", "head_dim"),
    ("bk", 2): ("kv_heads", "head_dim"),
    ("bv", 2): ("kv_heads", "head_dim"),
    ("wq_a", 2): ("embed", "lora"),
    ("wkv_a", 2): ("embed", "lora"),
    ("q_norm", 1): ("lora",),
    ("kv_norm", 1): ("lora",),
    ("wq_b", 3): ("lora", "heads", "head_dim"),
    ("wk_b", 3): ("lora", "heads", "head_dim"),
    ("wv_b", 3): ("lora", "heads", "head_dim"),
    ("scale", 1): ("embed",),
    ("w_gate", 2): ("embed", "ff"),
    ("w_up", 2): ("embed", "ff"),
    ("w_down", 2): ("ff", "embed"),
    ("w_gate", 3): ("experts", "embed", "expert_ff"),
    ("w_up", 3): ("experts", "embed", "expert_ff"),
    ("w_down", 3): ("experts", "expert_ff", "embed"),
    ("router", 2): ("embed", None),
    ("table", 2): ("vocab", "embed"),
}


def lm_logical(model: nn.Module) -> Dict[str, Tuple]:
    """``{parameter name: logical axes}`` of a ``TransformerLM``, the
    JAX ``init_params`` logical tree's entries."""
    return {name: _LM_AXES[(name.rsplit(".", 1)[-1], p.dim())]
            for name, p in model.named_parameters()}


def recsys_logical(model: nn.Module) -> Dict[str, Tuple]:
    """The JAX recsys trees' axes: embedding tables row-sharded
    (``table_rows``, ``table_dim``), everything else replicated."""
    return {name: (("table_rows", "table_dim") if re.search(r"(^|\.)table$",
                                                            name)
                   else (None,) * p.dim())
            for name, p in model.named_parameters()}


def _named(logical_tree, prefix: str = "") -> Dict[str, Tuple]:
    """A nested logical tree (GNN's) as ``{parameter name: axes}``."""
    if is_axes(logical_tree):
        return {prefix: logical_tree}
    items = (logical_tree.items() if isinstance(logical_tree, dict)
             else enumerate(logical_tree))
    out = {}
    for k, v in items:
        out.update(_named(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


# ---------------------------------------------------------------------------
# the families
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Ctx:
    """Where a cell's arguments are made: the device and the fake mode
    (``None``: real tensors on ``device``)."""
    device: torch.device
    fake_mode: Optional[FakeTensorMode]
    seed: int = 0


def _abstract_init(init_fn, ctx: _Ctx) -> nn.Module:
    """The model built WITHOUT allocating when the cell is fake: inside
    the fake mode the weights are drawn on the (fake) CPU, where a
    generator exists without a card, and each parameter is then made a
    fake tensor on the cell's device.  Real cells draw on the device."""
    if ctx.fake_mode is None:
        return init_fn(ctx.device)
    model = init_fn(torch.device("cpu"))
    if ctx.device.type != "cpu":
        for mod in model.modules():
            for name, p in list(mod._parameters.items()):
                if p is not None:
                    mod._parameters[name] = nn.Parameter(
                        torch.empty_like(p, device=ctx.device),
                        requires_grad=p.requires_grad)
    return model


def _count(model: nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))


def _active_count(cfg, total: int) -> int:
    if not getattr(cfg, "moe", False):
        return total
    f = cfg.moe_d_ff or cfg.d_ff
    n_moe_layers = cfg.n_layers - cfg.first_k_dense
    per_expert = 3 * cfg.d_model * f
    return total - n_moe_layers * (cfg.n_experts - cfg.top_k) * per_expert


def _train_prepare(opt_cfg: OptConfig, leaves_fn):
    """``prepare(model, batch) -> (model, opt, batch)``: the optimizer over
    the (distributed) parameters, its state made here, before the counted
    step, and so an argument of it as the JAX cell's ``opt_a`` is.  Each
    state tensor is placed as its parameter is, aligned from the right
    (``optimizer._zeros``): the placements ``opt_state_logical`` gives."""
    def prepare(model, batch):
        return model, opt_init(leaves_fn(model), opt_cfg), batch
    return prepare


def _train_step(loss_of, n_mb: int):
    """The cell's ``step_fn(model, opt, batch)``: one microbatched train
    step (gradients and the optimizer's update)."""
    def run(model, opt, batch):
        return make_train_step(lambda b: loss_of(model, b), opt, n_mb)(batch)
    return run


def _build_lm(spec: ArchSpec, shape: ShapeDef, mesh, rules: Dict[str, Any],
              ctx: _Ctx, cfg=None) -> BuiltCell:
    from repro_torch.models import transformer as T
    from repro_torch.models.weights import lm_leaves

    cfg = cfg or spec.config_fn(shape.shape_id)
    train = shape.kind == "train"
    model = _abstract_init(lambda dev: T.init_params(
        cfg, seed=ctx.seed, device=dev, trainable=train), ctx)
    p_sh = _shard_tree(mesh, lm_logical(model))
    n_params = _count(model)
    n_active = _active_count(cfg, n_params)
    dims, dev = shape.dims, ctx.device

    if train:
        opt_cfg = _opt_cfg_for(spec.arch_id)
        B, S = dims["global_batch"], dims["seq"]
        batch_a = {"tokens": _sds((B, S), "int32", dev),
                   "labels": _sds((B, S), "int32", dev)}
        b_sh = _shard_tree(mesh, {"tokens": ("batch", None),
                                  "labels": ("batch", None)})

        def loss_of(m, b):
            return T.loss_fn(m, cfg, b["tokens"], b["labels"])

        return BuiltCell(spec.arch_id, shape.shape_id, shape.kind,
                         _train_step(loss_of, dims["n_microbatches"]),
                         (model, batch_a), (p_sh, b_sh),
                         donate_argnums=(0, 1), rules=rules,
                         model_params=n_params, active_params=n_active,
                         prepare=_train_prepare(opt_cfg, lm_leaves))

    if shape.kind == "prefill":
        B, S = dims["batch"], dims["seq"]
        tokens_a = _sds((B, S), "int32", dev)
        t_sh = _shard_tree(mesh, ("batch", None))

        def step(m, tokens):
            with torch.no_grad():
                return T.prefill(m, cfg, tokens)

        return BuiltCell(spec.arch_id, shape.shape_id, shape.kind, step,
                         (model, tokens_a), (p_sh, t_sh),
                         donate_argnums=(), rules=rules,
                         model_params=n_params, active_params=n_active)

    if shape.kind == "decode":
        B, KV = dims["batch"], dims["kv_len"]
        cache_a = T.init_cache(cfg, B, KV, device=dev)
        c_logical = T.cache_logical(cfg)
        c_sh = _shard_tree(mesh, {k: c_logical[k] for k in cache_a})
        token_a = _sds((B,), "int32", dev)
        tok_sh = _shard_tree(mesh, ("batch",))

        def step(m, token, cache):
            with torch.no_grad():
                return T.decode_step(m, cfg, token, cache)

        return BuiltCell(spec.arch_id, shape.shape_id, shape.kind, step,
                         (model, token_a, cache_a), (p_sh, tok_sh, c_sh),
                         donate_argnums=(2,), rules=rules,
                         model_params=n_params, active_params=n_active)

    raise ValueError(shape.kind)


def _build_gnn(spec: ArchSpec, shape: ShapeDef, mesh, rules: Dict[str, Any],
               ctx: _Ctx) -> BuiltCell:
    from repro_torch.models import gnn as G
    from repro_torch.models.weights import recsys_leaves

    cfg = spec.config_fn(shape.shape_id)
    box = {}

    def init(dev):
        model, box["logical"] = G.init_params(cfg, seed=ctx.seed, device=dev,
                                              trainable=True)
        return model

    model = _abstract_init(init, ctx)
    p_sh = _shard_tree(mesh, _named(box["logical"]))
    n_params = _count(model)
    opt_cfg = _opt_cfg_for(spec.arch_id)
    d, dev = shape.dims, ctx.device

    if shape.kind == "train_full":
        N, E, F = d["n_nodes"], d["n_edges"], d["d_feat"]
        batch_a = {
            "x": _sds((N, F), "float32", dev),
            "edge_src": _sds((E,), "int32", dev),
            "edge_dst": _sds((E,), "int32", dev),
            "labels": _sds((N,), "int32", dev),
            "mask": _sds((N,), "bool", dev),
        }
        b_log = {"x": ("nodes", "feat"), "edge_src": ("edges",),
                 "edge_dst": ("edges",), "labels": ("nodes",),
                 "mask": ("nodes",)}

        def loss_of(m, b):
            return G.loss_full(m, cfg, b["x"], b["edge_src"], b["edge_dst"],
                               b["labels"], b["mask"])

    elif shape.kind == "train_sampled":
        B, (f1, f2), F = d["batch_nodes"], d["fanouts"], d["d_feat"]
        batch_a = {
            "x_root": _sds((B, F), "float32", dev),
            "x_h1": _sds((B, f1, F), "float32", dev),
            "x_h2": _sds((B, f1, f2, F), "float32", dev),
            "m1": _sds((B, f1), "bool", dev),
            "m2": _sds((B, f1, f2), "bool", dev),
            "labels": _sds((B,), "int32", dev),
        }
        b_log = {"x_root": ("nodes", "feat"),
                 "x_h1": ("nodes", None, "feat"),
                 "x_h2": ("nodes", None, None, "feat"),
                 "m1": ("nodes", None), "m2": ("nodes", None, None),
                 "labels": ("nodes",)}

        def loss_of(m, b):
            return G.loss_sampled(m, cfg, (b["x_root"], b["x_h1"],
                                           b["x_h2"]), (b["m1"], b["m2"]),
                                  b["labels"])

    else:
        raise ValueError(shape.kind)

    b_sh = _shard_tree(mesh, b_log)
    return BuiltCell(spec.arch_id, shape.shape_id, shape.kind,
                     _train_step(loss_of, 1), (model, batch_a), (p_sh, b_sh),
                     donate_argnums=(0, 1), rules=rules,
                     model_params=n_params, active_params=n_params,
                     prepare=_train_prepare(opt_cfg, recsys_leaves))


def _build_recsys(spec: ArchSpec, shape: ShapeDef, mesh,
                  rules: Dict[str, Any], ctx: _Ctx) -> BuiltCell:
    from repro_torch.models import recsys as R
    from repro_torch.models.weights import recsys_leaves

    cfg = spec.config_fn(shape.shape_id)
    arch = spec.arch_id
    d, dev = shape.dims, ctx.device
    train = shape.kind == "train"
    init_map = {
        "sasrec": R.sasrec_init, "din": R.din_init,
        "xdeepfm": R.xdeepfm_init, "two-tower-retrieval": R.twotower_init,
    }
    model = _abstract_init(lambda dev_: init_map[arch](
        cfg, seed=ctx.seed, device=dev_, trainable=train), ctx)
    p_sh = _shard_tree(mesh, recsys_logical(model))
    n_params = _count(model)

    def sds(shape_, dtype):
        return _sds(shape_, dtype, dev)

    if train:
        B = d["batch"]
        opt_cfg = _opt_cfg_for(arch)
        if arch == "sasrec":
            batch_a = {"seq_ids": sds((B, cfg.seq_len), "int32"),
                       "pos_ids": sds((B, cfg.seq_len), "int32"),
                       "neg_ids": sds((B, cfg.seq_len, cfg.n_negatives),
                                      "int32")}
            b_log = {"seq_ids": ("batch", None), "pos_ids": ("batch", None),
                     "neg_ids": ("batch", None, None)}
            loss_fn = lambda m, b: R.sasrec_loss(  # noqa: E731
                m, cfg, b["seq_ids"], b["pos_ids"], b["neg_ids"])
        elif arch == "din":
            batch_a = {"hist_ids": sds((B, cfg.seq_len), "int32"),
                       "target_id": sds((B,), "int32"),
                       "ctx_ids": sds((B, cfg.n_context_fields), "int32"),
                       "labels": sds((B,), "float32")}
            b_log = {"hist_ids": ("batch", None), "target_id": ("batch",),
                     "ctx_ids": ("batch", None), "labels": ("batch",)}
            loss_fn = lambda m, b: R.din_loss(  # noqa: E731
                m, cfg, b["hist_ids"], b["target_id"], b["ctx_ids"],
                b["labels"])
        elif arch == "xdeepfm":
            batch_a = {"field_ids": sds((B, cfg.n_fields), "int32"),
                       "labels": sds((B,), "float32")}
            b_log = {"field_ids": ("batch", None), "labels": ("batch",)}
            loss_fn = lambda m, b: R.xdeepfm_loss(  # noqa: E731
                m, cfg, b["field_ids"], b["labels"])
        else:
            batch_a = {"user_id": sds((B,), "int32"),
                       "hist_ids": sds((B, cfg.n_user_hist), "int32"),
                       "hist_mask": sds((B, cfg.n_user_hist), "bool"),
                       "pos_item": sds((B,), "int32"),
                       "item_logq": sds((B,), "float32")}
            b_log = {k: ("batch",) + (None,) * (v.dim() - 1)
                     for k, v in batch_a.items()}
            loss_fn = lambda m, b: R.twotower_loss(  # noqa: E731
                m, cfg, b["user_id"], b["hist_ids"], b["hist_mask"],
                b["pos_item"], b["item_logq"])

        def loss_of(m, b):
            out = loss_fn(m, b)
            return out if isinstance(out, tuple) else (out, {})

        b_sh = _shard_tree(mesh, b_log)
        return BuiltCell(arch, shape.shape_id, shape.kind,
                         _train_step(loss_of, d.get("n_microbatches", 1)),
                         (model, batch_a), (p_sh, b_sh),
                         donate_argnums=(0, 1), rules=rules,
                         model_params=n_params, active_params=n_params,
                         prepare=_train_prepare(opt_cfg, recsys_leaves))

    if shape.kind == "serve":
        B = d["batch"]
        if arch == "sasrec":
            batch_a = {"seq_ids": sds((B, cfg.seq_len), "int32"),
                       "cand": sds((B, 200), "int32")}
            b_log = {"seq_ids": ("batch", None), "cand": ("batch", None)}
            fwd = lambda m, b: R.sasrec_score(  # noqa: E731
                m, cfg, b["seq_ids"], b["cand"])
        elif arch == "din":
            batch_a = {"hist_ids": sds((B, cfg.seq_len), "int32"),
                       "target_id": sds((B,), "int32"),
                       "ctx_ids": sds((B, cfg.n_context_fields), "int32")}
            b_log = {"hist_ids": ("batch", None), "target_id": ("batch",),
                     "ctx_ids": ("batch", None)}
            fwd = lambda m, b: R.din_forward(  # noqa: E731
                m, cfg, b["hist_ids"], b["target_id"], b["ctx_ids"])
        elif arch == "xdeepfm":
            batch_a = {"field_ids": sds((B, cfg.n_fields), "int32")}
            b_log = {"field_ids": ("batch", None)}
            fwd = lambda m, b: R.xdeepfm_forward(  # noqa: E731
                m, cfg, b["field_ids"])
        else:
            batch_a = {"user_id": sds((B,), "int32"),
                       "hist_ids": sds((B, cfg.n_user_hist), "int32"),
                       "hist_mask": sds((B, cfg.n_user_hist), "bool"),
                       "item_id": sds((B,), "int32")}
            b_log = {k: ("batch",) + (None,) * (v.dim() - 1)
                     for k, v in batch_a.items()}

            def fwd(m, b):
                u = R.user_embed(m, cfg, b["user_id"], b["hist_ids"],
                                 b["hist_mask"])
                it = R.item_embed(m, cfg, b["item_id"])
                return (u * it).sum(-1)

        def step(m, b):
            with torch.no_grad():
                return fwd(m, b)

        return BuiltCell(arch, shape.shape_id, shape.kind, step,
                         (model, batch_a), (p_sh, _shard_tree(mesh, b_log)),
                         donate_argnums=(), rules=rules,
                         model_params=n_params, active_params=n_params)

    if shape.kind == "retrieval":
        C = d["n_candidates"]
        if arch == "sasrec":
            batch_a = {"seq_ids": sds((1, cfg.seq_len), "int32")}
            b_log = {"seq_ids": (None, None)}
            fwd = lambda m, b: torch.topk(  # noqa: E731
                R.sasrec_score(m, cfg, b["seq_ids"]), 100)
        elif arch == "din":
            batch_a = {"hist_ids": sds((1, cfg.seq_len), "int32"),
                       "ctx_ids": sds((1, cfg.n_context_fields), "int32"),
                       "cand": sds((C,), "int32")}
            b_log = {"hist_ids": (None, None), "ctx_ids": (None, None),
                     "cand": ("candidates",)}
            fwd = lambda m, b: torch.topk(  # noqa: E731
                R.din_score_candidates(m, cfg, b["hist_ids"], b["ctx_ids"],
                                       b["cand"]), 100)
        elif arch == "xdeepfm":
            batch_a = {"field_ids": sds((C, cfg.n_fields), "int32")}
            b_log = {"field_ids": ("candidates", None)}
            fwd = lambda m, b: torch.topk(  # noqa: E731
                R.xdeepfm_score_candidates(m, cfg, b["field_ids"]), 100)
        else:
            batch_a = {"user_id": sds((1,), "int32"),
                       "hist_ids": sds((1, cfg.n_user_hist), "int32"),
                       "hist_mask": sds((1, cfg.n_user_hist), "bool"),
                       "cand": sds((C,), "int32")}
            b_log = {"user_id": (None,), "hist_ids": (None, None),
                     "hist_mask": (None, None), "cand": ("candidates",)}
            fwd = lambda m, b: R.retrieval_scores(  # noqa: E731
                m, cfg, b["user_id"], b["hist_ids"], b["hist_mask"],
                b["cand"], topk=100)

        def step(m, b):
            with torch.no_grad():
                return fwd(m, b)

        return BuiltCell(arch, shape.shape_id, shape.kind, step,
                         (model, batch_a), (p_sh, _shard_tree(mesh, b_log)),
                         donate_argnums=(), rules=rules,
                         model_params=n_params, active_params=n_params)

    raise ValueError(shape.kind)


def _fim_shardings(mesh, *logical):
    """The round's operand shardings: the TID-block axis over EVERY mesh
    dimension (the JAX ``P(None, all_axes, ...)``), the rest
    replicated."""
    all_axes = tuple(mesh.mesh_dim_names)
    rules = {"all_mesh": all_axes}
    return tuple(make_param_shardings(mesh, names, rules) for names in
                 [tuple("all_mesh" if n == "tid" else None for n in lg)
                  for lg in logical])


def _build_fim(spec: ArchSpec, shape: ShapeDef, mesh, rules: Dict[str, Any],
               ctx: _Ctx, pair_chunk: int = 2048) -> BuiltCell:
    from repro_torch.core.distributed import make_mining_round

    d, dev = shape.dims, ctx.device
    round_fn = make_mining_round(mesh, pair_chunk=pair_chunk)
    store_a = _sds((d["store_rows"], d["n_blocks"], d["block_words"]),
                   "int32", dev)
    pairs_a = _sds((d["pairs"], 2), "int32", dev)
    rho_a = _sds((d["pairs"],), "int32", dev)
    shardings = _fim_shardings(mesh, (None, "tid", None), (None, None),
                               (None,))
    return BuiltCell(spec.arch_id, shape.shape_id, shape.kind, round_fn,
                     (store_a, pairs_a, rho_a), shardings,
                     donate_argnums=(), rules=rules,
                     model_params=0, active_params=0,
                     notes=f"{d['n_trans']:,} transactions")


_FAMILY_BUILDERS = {
    "lm": _build_lm,
    "gnn": _build_gnn,
    "recsys": _build_recsys,
    "fim": _build_fim,
}


def _context(device, fake: bool, seed: int = 0) -> _Ctx:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return _Ctx(dev, FakeTensorMode(allow_non_fake_inputs=True)
                if fake else None, seed)


def _in_mode(ctx: _Ctx, fn):
    if ctx.fake_mode is None:
        return fn()
    with ctx.fake_mode:
        return fn()


# ---------------------------------------------------------------------------
# costing variants (the cost fit: layers and chunks are identical)
# ---------------------------------------------------------------------------
#
# The JAX package compiles small UNROLLED depths because cost_analysis()
# counts a scan body once.  Eager tracing counts every layer and chunk,
# so the port's fit is a check instead: the same step at depths L = 1, 2
# (pair chunks n = 1, 2 for the FIM round) extrapolated linearly,
#
#   total = base + per_layer * L_full,
#
# must equal the traced full-depth totals.  DeepSeek's leading dense
# layer is pinned (absorbed into base); only the MoE stack depth is
# extrapolated.

def _model_size(mesh) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True)).get(
        "model", 1)


def _decode_rules(cfg0, mesh, rules: Dict[str, Any]) -> None:
    """Decode serving: when kv heads cannot cover the model axis (GQA kv=8
    vs model=16, or MLA's single latent), shard the KV cache's SEQUENCE
    axis over "model" instead; head_dim takes "model" for the kv
    projection weights so nothing big replicates."""
    if cfg0.mla or cfg0.n_kv_heads % _model_size(mesh) != 0:
        rules["kv_seq"] = "model"
        rules["head_dim"] = "model"


def build_lm_costing(arch_id: str, shape_id: str, mesh, n_layers: int,
                     cfg_overrides: Optional[Dict[str, Any]] = None,
                     dims_overrides: Optional[Dict[str, Any]] = None,
                     device="cuda", fake: bool = True) -> BuiltCell:
    """The cell's full step at reduced depth ``n_layers`` (+ the pinned
    leading dense layers of a MoE stack)."""
    spec = get_arch(arch_id)
    shape = get_shape(spec, shape_id)
    if dims_overrides:
        shape = dataclasses.replace(
            shape, dims={**shape.dims, **dims_overrides})
    cfg0 = spec.config_fn(shape_id)
    if cfg_overrides:
        cfg0 = dataclasses.replace(cfg0, **cfg_overrides)
    extra_dense = cfg0.first_k_dense if cfg0.moe else 0
    cfg = dataclasses.replace(cfg0, n_layers=n_layers + extra_dense,
                              first_k_dense=extra_dense, unroll_layers=True)
    rules: Dict[str, Any] = dict(spec.rules_override)
    if shape.dims.get("batch") == 1:
        rules["batch"] = None
    if shape.kind == "decode":
        _decode_rules(cfg0, mesh, rules)
    ctx = _context(device, fake)
    with use_rules(rules), active_mesh(mesh):
        cell = _in_mode(ctx, lambda: _build_lm(spec, shape, mesh, rules, ctx,
                                               cfg=cfg))
    cell.kind = f"costing-{shape.kind}"
    cell.fake_mode, cell.device = ctx.fake_mode, ctx.device
    return cell


def build_opt_costing(arch_id: str, shape_id: str, mesh, device="cuda",
                      fake: bool = True) -> BuiltCell:
    """The optimizer update alone, at full parameter shapes (the fp32
    gradients an argument)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.weights import lm_leaves

    spec = get_arch(arch_id)
    cfg = spec.config_fn(shape_id)
    rules = dict(spec.rules_override)
    ctx = _context(device, fake)

    def build():
        model = _abstract_init(lambda dev: T.init_params(
            cfg, device=dev, trainable=True), ctx)
        return model

    with use_rules(rules), active_mesh(mesh):
        model = _in_mode(ctx, build)
        p_sh = _shard_tree(mesh, lm_logical(model))
    opt_cfg = _opt_cfg_for(arch_id)

    def prepare(m):
        opt = opt_init(lm_leaves(m), opt_cfg)
        grads = [torch.zeros_like(p, dtype=torch.float32)
                 for g in opt.param_groups for p in g["params"]]
        return opt, grads

    def step(opt, grads):
        return opt.step(grads=grads)

    return BuiltCell(arch_id, shape_id, "costing-opt", step, (model,),
                     (p_sh,), donate_argnums=(), rules=rules,
                     fake_mode=ctx.fake_mode, prepare=prepare,
                     device=ctx.device)


def build_fim_costing(arch_id: str, shape_id: str, mesh, n_chunks: int,
                      pair_chunk: int = 2048, device="cuda",
                      fake: bool = True) -> BuiltCell:
    """Reduced-pairs mining round for the cost fit."""
    spec = get_arch(arch_id)
    shape = get_shape(spec, shape_id)
    shape = dataclasses.replace(
        shape, dims={**shape.dims, "pairs": n_chunks * pair_chunk})
    ctx = _context(device, fake)
    cell = _in_mode(ctx, lambda: _build_fim(
        spec, shape, mesh, dict(spec.rules_override), ctx, pair_chunk))
    cell.kind = "costing-mine"
    cell.fake_mode, cell.device = ctx.fake_mode, ctx.device
    return cell


def build_cell(arch_id: str, shape_id: str, mesh,
               extra_rules: Optional[Dict[str, Any]] = None,
               cfg_overrides: Optional[Dict[str, Any]] = None,
               dims_overrides: Optional[Dict[str, Any]] = None,
               device="cuda", fake: bool = True, seed: int = 0
               ) -> BuiltCell:
    """``cfg_overrides`` / ``dims_overrides`` / ``extra_rules`` are the
    hillclimb knobs: dataclasses.replace fields on the arch config, shape
    dim tweaks (e.g. n_microbatches), and sharding-rule swaps.
    ``device`` is where the arguments live (``cuda`` traces the card's
    path); ``fake=False`` makes them real (random weights from ``seed``,
    uninitialised inputs), to run the step on the card."""
    spec = get_arch(arch_id)
    shape = get_shape(spec, shape_id)
    if cfg_overrides:
        base_fn = spec.config_fn
        spec = dataclasses.replace(
            spec, config_fn=lambda s=None: dataclasses.replace(
                base_fn(s), **cfg_overrides))
    if dims_overrides:
        shape = dataclasses.replace(
            shape, dims={**shape.dims, **dims_overrides})

    skip = spec.skip_reason(shape_id)
    rules: Dict[str, Any] = dict(spec.rules_override)
    # batch=1 cells cannot shard the batch axis
    if shape.dims.get("batch") == 1 and shape.kind != "retrieval":
        rules["batch"] = None
    if spec.family == "lm" and shape.kind == "decode":
        _decode_rules(spec.config_fn(shape_id), mesh, rules)
    if extra_rules:
        rules.update(extra_rules)

    if skip:
        return BuiltCell(arch_id, shape_id, shape.kind, lambda: None,
                         (), (), (), rules, skip_reason=skip)

    ctx = _context(device, fake, seed)
    with use_rules(rules), active_mesh(mesh):
        cell = _in_mode(ctx, lambda: _FAMILY_BUILDERS[spec.family](
            spec, shape, mesh, rules, ctx))
    cell.fake_mode, cell.device = ctx.fake_mode, ctx.device
    return cell


# ---------------------------------------------------------------------------
# tracing (the counterpart of lower_cell + compile + the analyses)
# ---------------------------------------------------------------------------

def _distribute(x, sh):
    """``x`` as a ``DTensor`` placed by ``sh``: a tensor becomes its
    first-rank shard (made here, no communication); a module has each
    parameter swapped in place; trees follow their shardings."""
    if isinstance(x, nn.Module):
        named = dict(x.named_parameters())
        for name, p in named.items():
            s = sh[name]
            mod_name, _, leaf = name.rpartition(".")
            mod = x.get_submodule(mod_name) if mod_name else x
            mod._parameters[leaf] = nn.Parameter(
                _distribute(p.detach(), s), requires_grad=p.requires_grad)
        return x
    if isinstance(sh, NamedSharding):
        local = torch.empty(local_shape(x.shape, sh.placements, sh.mesh),
                            dtype=x.dtype, device=x.device)
        return dtensor_of(local, x.shape, sh.placements, sh.mesh)
    if isinstance(sh, dict):
        return {k: _distribute(x[k], sh[k]) for k in x}
    return type(x)(_distribute(a, s) for a, s in zip(x, sh, strict=True))


def _tensors(tree) -> list:
    """Every tensor in ``tree`` (modules' parameters and optimizers'
    state included), each once."""
    out, seen = [], set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, nn.Module):
            walk(list(x.parameters()))
        elif isinstance(x, torch.optim.Optimizer):
            # the JAX layout (``opt_a``): the moments and the int32 step
            walk(x.state_tree())
        elif isinstance(x, dict):
            walk(list(x.values()))
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(tree)
    return out


def _local_bytes(tree) -> int:
    """Bytes this rank holds for every tensor in ``tree``."""
    total = 0
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        total += t.numel() * t.element_size()
    return total


def args_on_mesh(cell: BuiltCell, mesh) -> Tuple[Any, ...]:
    """The cell's arguments ready for ``step_fn`` on ``mesh``: distributed
    on a mesh of more than one rank, then ``prepare``\\ d.  Run inside the
    cell's fake mode, active mesh and rules."""
    args = cell.abstract_args
    if mesh.size() > 1 and not cell.per_rank:
        args = tuple(_distribute(a, s)
                     for a, s in zip(args, cell.in_shardings, strict=True))
    if cell.prepare is not None:
        args = cell.prepare(*args)
    return args


def trace_cell(cell: BuiltCell, mesh, device=None) -> Dict[str, Any]:
    """Run ``cell.step_fn`` once on ``mesh`` under the counters; returns
    ``{"flops", "bytes", "ops", "collectives" (events), "args_bytes",
    "temp_peak_bytes"}`` per rank.  ``device`` is accepted for symmetry
    with ``build_cell`` (the cell's arguments already live on theirs)."""
    from repro_torch.roofline.counters import StepCounter

    del device
    fake = cell.fake_mode

    card = (ops.card_path() if cell.device is not None
            and cell.device.type == "cuda" else contextlib.nullcontext())

    def run():
        with use_rules(cell.rules), active_mesh(mesh), \
                implicit_replication(), card:
            args = args_on_mesh(cell, mesh)
            counter = StepCounter()
            # the arguments count apart, so that an op writing into one
            # in place is not taken for a new allocation
            counter.hold(_tensors(args))
            with counter:
                cell.step_fn(*args)
            return {"flops": counter.flops, "bytes": counter.bytes,
                    "ops": counter.ops, "collectives": counter.collectives,
                    "args_bytes": _local_bytes(args),
                    "temp_peak_bytes": counter.peak}

    if fake is None:
        return run()
    with fake:
        return run()
