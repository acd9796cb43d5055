"""Carry weights between the JAX package's layout and the port's models.

The JAX models are pytrees of arrays; their tests pass them across as
numpy arrays (``jax.tree.map(np.asarray, params)``), layer weights
stacked on a leading layer axis under ``dense_layers`` and, for MoE
stacks, ``moe_layers`` (after ``first_k_dense`` dense layers).  The
port keeps one module per layer.  ``*_from_numpy`` build a port model
from such a tree (numpy arrays or tensors; bf16 numpy arrays from
``ml_dtypes`` are reinterpreted bit for bit), ``*_leaves`` list a
model's parameters as the JAX package's leaves (``(path, parts,
stacked)``, what ``train.optimizer`` and the checkpoints work on), and
``*_to_numpy`` give the JAX tree back.  Nothing here imports JAX.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import Leaf
from repro_torch.tree import flatten_with_paths, tree_from_paths, tree_map

Tensor = torch.Tensor
Tree = Dict[str, Any]


def _tensor(a, device: torch.device) -> Tensor:
    if isinstance(a, Tensor):
        return a.detach().to(device, copy=True)
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _lm_layer(tree: Tree, i: int, t, trainable: bool) -> T.DecoderLayer:
    """Layer ``i`` of a stacked JAX layer tree (``dense_layers`` or
    ``moe_layers``): GQA or MLA attention, SwiGLU or MoE MLP, told apart
    by their keys (``wkv_a``, ``router``) as the JAX package does."""
    a = tree["attn"]
    if "wkv_a" in a:
        attn = L.MLA({k: t(a[k][i]) for k in sorted(a)}, trainable)
    else:
        bias = [t(a[k][i]) for k in ("bq", "bk", "bv")] if "bq" in a \
            else []
        attn = L.GQA(t(a["wq"][i]), t(a["wk"][i]), t(a["wv"][i]),
                     t(a["wo"][i]), *bias, trainable=trainable)
    m = tree["mlp"]

    def swiglu(m):
        return L.SwiGLU(t(m["w_gate"][i]), t(m["w_up"][i]),
                        t(m["w_down"][i]), trainable)

    if "router" in m:
        shared = swiglu(m["shared"]) if "shared" in m else None
        mlp = L.MoE(t(m["router"][i]), t(m["w_gate"][i]), t(m["w_up"][i]),
                    t(m["w_down"][i]), shared, trainable)
    else:
        mlp = swiglu(m)
    return T.DecoderLayer(
        L.RMSNorm(t(tree["attn_norm"]["scale"][i]), trainable), attn,
        L.RMSNorm(t(tree["mlp_norm"]["scale"][i]), trainable), mlp)


def lm_from_numpy(cfg: T.LMConfig, tree: Tree, device: DeviceLike = None,
                  trainable: bool = False) -> T.TransformerLM:
    """The port's model holding the weights of a JAX ``init_params`` tree
    (numpy or tensor leaves; layer weights stacked on a leading layer axis
    under ``dense_layers`` and, for MoE stacks, ``moe_layers``)."""
    dev = resolve_device(device)

    def t(a):
        return _tensor(a, dev)

    layers = []
    for key, want in (("dense_layers", cfg.n_dense_layers),
                      ("moe_layers", cfg.n_layers - cfg.n_dense_layers)):
        st = tree.get(key)
        n = 0 if st is None else int(
            np.asarray(st["attn_norm"]["scale"]).shape[0])
        if n != want:
            raise ValueError(f"tree holds {n} {key}, config {cfg.name} "
                             f"{want}")
        layers += [_lm_layer(st, i, t, trainable) for i in range(n)]
    lm_head = (L.Embed(t(tree["lm_head"]["table"]), trainable)
               if "lm_head" in tree else None)
    return T.TransformerLM(L.Embed(t(tree["embed"]["table"]), trainable),
                           layers,
                           L.RMSNorm(t(tree["final_norm"]["scale"]),
                                     trainable),
                           lm_head)


def twotower_from_numpy(cfg: R.TwoTowerConfig, tree: Tree,
                        device: DeviceLike = None,
                        trainable: bool = False) -> R.TwoTower:
    """The port's two-tower model holding the weights of a JAX
    ``twotower_init`` tree (numpy or tensor leaves)."""
    dev = resolve_device(device)

    def tower(layers):
        return torch.nn.ModuleList(
            R._Linear(_tensor(lp["w"], dev), _tensor(lp["b"], dev),
                      trainable)
            for lp in layers)

    return R.TwoTower(
        R.Embedding(_tensor(tree["user_emb"]["table"], dev), trainable),
        R.Embedding(_tensor(tree["item_emb"]["table"], dev), trainable),
        tower(tree["user_tower"]), tower(tree["item_tower"]))


def _stacked(prefix: str, layers) -> List[Leaf]:
    """The stacked leaves of ``layers`` (all of one kind): the JAX paths
    under ``prefix``, which are the attribute paths in the port's modules,
    in the JAX leaf order (sorted paths)."""
    if not layers:
        return []
    paths = sorted(n.replace(".", "/") for n, _ in
                   layers[0].named_parameters())
    return [(f"{prefix}/{path}",
             [functools.reduce(getattr, path.split("/"), lp)
              for lp in layers], True) for path in paths]


def _all_leaves(model: T.TransformerLM) -> List[Leaf]:
    layers = list(model.layers)
    moe = [lp for lp in layers if isinstance(lp.mlp, L.MoE)]
    dense = layers[:len(layers) - len(moe)]
    out = _stacked("dense_layers", dense)
    out.append(("embed/table", [model.embed.table], False))
    out.append(("final_norm/scale", [model.final_norm.scale], False))
    if model.lm_head is not None:
        out.append(("lm_head/table", [model.lm_head.table], False))
    return out + _stacked("moe_layers", moe)


def lm_leaves(model: T.TransformerLM) -> List[Leaf]:
    """The model's parameters as the JAX ``init_params`` leaves, in its
    leaf order: each ``dense_layers`` leaf is stacked from the layers.
    Dense GQA stacks only: training MoE and MLA stacks (the trainer's
    leaves, gradients through the dispatch) is ROADMAP.md Queue 1's
    next item."""
    for lp in model.layers:
        if isinstance(lp.mlp, L.MoE) or isinstance(lp.attn, L.MLA):
            raise NotImplementedError(
                "training MoE/MLA stacks is not ported yet (ROADMAP.md "
                "Queue 1: training for MoE, MLA and sliding windows); "
                "lm_to_numpy carries their weights")
    return _all_leaves(model)


def twotower_leaves(model: R.TwoTower) -> List[Leaf]:
    """The model's parameters as the JAX ``twotower_init`` leaves, in its
    leaf order."""
    def tower(name):
        return [(f"{name}/{i}/{k}", [getattr(lp, k)], False)
                for i, lp in enumerate(getattr(model, name))
                for k in ("b", "w")]
    return ([("item_emb/table", [model.item_emb.table], False)]
            + tower("item_tower")
            + [("user_emb/table", [model.user_emb.table], False)]
            + tower("user_tower"))


def leaves_to_tree(leaves: List[Leaf]):
    """The JAX tree of ``leaves`` on their device: stacked leaves stacked
    on their leading axis (a copy), the others the parameters themselves
    (detached)."""
    return tree_from_paths(
        (path, torch.stack([p.detach() for p in parts]) if stacked
         else parts[0].detach()) for path, parts, stacked in leaves)


@torch.no_grad()
def load_leaves(leaves: List[Leaf], tree) -> None:
    """Copy a JAX tree (numpy or tensor leaves) into ``leaves`` in place."""
    src = dict(flatten_with_paths(tree))
    for path, parts, stacked in leaves:
        x = src[path]
        x = x if isinstance(x, Tensor) else _tensor(x, torch.device("cpu"))
        for i, p in enumerate(parts):
            p.copy_(x[i] if stacked else x)


def _numpy(t: Tensor) -> np.ndarray:
    """A tensor as numpy (on the host); bf16 as ``ml_dtypes.bfloat16``
    where that is installed, else as its raw ``uint16`` bits (the model's
    ``dtype`` names it)."""
    t = t.cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    raw = t.view(torch.int16).numpy().view(np.uint16)
    try:
        import ml_dtypes
    except ImportError:
        return raw
    return raw.view(ml_dtypes.bfloat16)


def lm_to_numpy(model: T.TransformerLM) -> Tree:
    """The JAX ``init_params`` tree (numpy leaves) of the model, MoE and
    MLA stacks included."""
    return tree_map(_numpy, leaves_to_tree(_all_leaves(model)))


def twotower_to_numpy(model: R.TwoTower) -> Tree:
    """The JAX ``twotower_init`` tree (numpy leaves) of the model."""
    return tree_map(_numpy, leaves_to_tree(twotower_leaves(model)))
