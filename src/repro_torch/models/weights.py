"""Carry the JAX package's weights into the port's models.

The JAX models are pytrees of arrays; their tests pass them across as
numpy arrays (``jax.tree.map(np.asarray, params)``).  bf16 arrays arrive
as ``ml_dtypes.bfloat16`` numpy arrays and are reinterpreted bit for bit.
Neither function imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T

Tensor = torch.Tensor
Tree = Dict[str, Any]


def _tensor(a, device: torch.device) -> Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def lm_from_numpy(cfg: T.LMConfig, tree: Tree,
                  device: DeviceLike = None) -> T.TransformerLM:
    """The port's model holding the weights of a JAX ``init_params`` tree
    (numpy leaves; layer weights stacked on a leading ``n_layers`` axis
    under ``dense_layers``).  Dense stacks only."""
    T._check_dense(cfg)
    dev = resolve_device(device)
    if "moe_layers" in tree or "dense_layers" not in tree:
        raise ValueError("lm_from_numpy takes a dense stack "
                         "(tree['dense_layers'] and no 'moe_layers')")

    def t(a):
        return _tensor(a, dev)

    st = tree["dense_layers"]
    n = int(np.asarray(st["attn_norm"]["scale"]).shape[0])
    if n != cfg.n_layers:
        raise ValueError(f"tree holds {n} layers, config {cfg.n_layers}")
    layers = []
    for i in range(n):
        a = st["attn"]
        bias = [t(a[k][i]) for k in ("bq", "bk", "bv")] if "bq" in a \
            else []
        attn = L.GQA(t(a["wq"][i]), t(a["wk"][i]), t(a["wv"][i]),
                     t(a["wo"][i]), *bias)
        m = st["mlp"]
        mlp = L.SwiGLU(t(m["w_gate"][i]), t(m["w_up"][i]),
                       t(m["w_down"][i]))
        layers.append(T.DecoderLayer(
            L.RMSNorm(t(st["attn_norm"]["scale"][i])), attn,
            L.RMSNorm(t(st["mlp_norm"]["scale"][i])), mlp))
    lm_head = (L.Embed(t(tree["lm_head"]["table"])) if "lm_head" in tree
               else None)
    return T.TransformerLM(L.Embed(t(tree["embed"]["table"])), layers,
                           L.RMSNorm(t(tree["final_norm"]["scale"])),
                           lm_head)


def twotower_from_numpy(cfg: R.TwoTowerConfig, tree: Tree,
                        device: DeviceLike = None) -> R.TwoTower:
    """The port's two-tower model holding the weights of a JAX
    ``twotower_init`` tree (numpy leaves)."""
    dev = resolve_device(device)

    def tower(layers):
        return torch.nn.ModuleList(
            R._Linear(_tensor(lp["w"], dev), _tensor(lp["b"], dev))
            for lp in layers)

    return R.TwoTower(R.Embedding(_tensor(tree["user_emb"]["table"], dev)),
                      R.Embedding(_tensor(tree["item_emb"]["table"], dev)),
                      tower(tree["user_tower"]), tower(tree["item_tower"]))
