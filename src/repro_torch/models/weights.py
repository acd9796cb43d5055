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
``*_to_numpy`` give the JAX tree back: ``lm_*`` for the LMs and
``recsys_*`` for the recsys models (two-tower, SASRec, DIN, xDeepFM).
Nothing here imports JAX.
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


def lm_leaves(model: T.TransformerLM) -> List[Leaf]:
    """The model's parameters as the JAX ``init_params`` leaves, in its
    leaf order (``dense_layers``, ``embed``, ``final_norm``, ``lm_head``,
    ``moe_layers``): each ``dense_layers`` and ``moe_layers`` leaf is
    stacked from its layers, so a stacked expert leaf is ``(L, E, d, f)``
    to the optimizers.  Every stack: GQA or MLA, dense or MoE (the
    router fp32 whatever the model's dtype, as in the JAX package)."""
    layers = list(model.layers)
    moe = [lp for lp in layers if isinstance(lp.mlp, L.MoE)]
    dense = layers[:len(layers) - len(moe)]
    out = _stacked("dense_layers", dense)
    out.append(("embed/table", [model.embed.table], False))
    out.append(("final_norm/scale", [model.final_norm.scale], False))
    if model.lm_head is not None:
        out.append(("lm_head/table", [model.lm_head.table], False))
    return out + _stacked("moe_layers", moe)


def recsys_from_numpy(tree: Tree, device: DeviceLike = None,
                      trainable: bool = False) -> R.ParamTree:
    """The port's recsys model holding the weights of a JAX
    ``sasrec_init`` / ``din_init`` / ``xdeepfm_init`` / ``twotower_init``
    tree (numpy or tensor leaves): the same tree as a
    ``recsys.ParamTree``."""
    dev = resolve_device(device)
    return R.ParamTree(tree_map(lambda a: _tensor(a, dev), tree), trainable)


def recsys_leaves(model: torch.nn.Module) -> List[Leaf]:
    """A recsys model's parameters (a ``ParamTree``: SASRec, DIN,
    xDeepFM, two-tower) as its JAX tree's leaves, in the JAX leaf
    order."""
    tree = tree_from_paths((name.replace(".", "/"), p)
                           for name, p in model.named_parameters())
    return [(path, [p], False) for path, p in flatten_with_paths(tree)]


def recsys_to_numpy(model: torch.nn.Module) -> Tree:
    """The JAX ``*_init`` tree (numpy leaves) of a recsys model."""
    return tree_map(_numpy, leaves_to_tree(recsys_leaves(model)))


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
    return tree_map(_numpy, leaves_to_tree(lm_leaves(model)))
