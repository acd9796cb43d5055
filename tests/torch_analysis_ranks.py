"""Rank bodies of the gloo worlds of ``tests/test_torch_analysis.py`` and
``tests/test_torch_parity.py`` (run by
``repro_torch.launch.forcedevices.run_ranks``).  Imports no JAX."""

import numpy as np
import torch

from repro_torch.core.distributed import (make_mining_round,
                                          make_mining_round_v2)
from repro_torch.launch import mesh_ranks
from repro_torch.launch.mesh import make_host_mesh


def mining_rounds(rank, world, store, suffix1, pairs, pair_chunk, shape):
    """Both rounds on this rank's block slice of ``store`` (blocks split
    evenly in rank order over the ``shape`` mesh): ``(bound, count)`` of
    each, as numpy."""
    mesh = make_host_mesh(shape)
    nb = store.shape[1] // world
    local = torch.from_numpy(np.ascontiguousarray(
        store[:, rank * nb:(rank + 1) * nb]))
    p = torch.from_numpy(pairs)
    rho = torch.zeros(pairs.shape[0], dtype=torch.int32)
    b1, c1 = make_mining_round(mesh, pair_chunk=pair_chunk)(local, p, rho)
    s1 = torch.from_numpy(np.ascontiguousarray(suffix1[:, rank:rank + 1]))
    b2, c2 = make_mining_round_v2(mesh, pair_chunk=pair_chunk)(local, s1, p,
                                                                rho)
    return [t.numpy() for t in (b1, c1, b2, c2)]


def row_sharded_bags(rank, world, table, ids, mask, shape):
    """``recsys.embedding_bag`` (sum, mean, max) on a ``shape`` mesh: the
    table row-sharded over ``model`` as the recsys rules place it, the
    bags over ``data``; each result, and the table's gradient of a
    weighted sum of the sum and mean bags, gathered whole, as numpy."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import (active_mesh,
                                                  make_param_shardings,
                                                  shard_like, use_rules)
    from repro_torch.models.recsys import ParamTree, embedding_bag

    mesh = make_host_mesh(shape)
    with use_rules({}), active_mesh(mesh), implicit_replication():
        sh = make_param_shardings(mesh, {"table": ("table_rows", "table_dim"),
                                         "ids": ("batch", None),
                                         "mask": ("batch", None)})
        d = shard_like({"table": torch.from_numpy(table),
                        "ids": torch.from_numpy(ids),
                        "mask": torch.from_numpy(mask)}, sh)
        p = ParamTree({"table": d["table"]}, trainable=True)
        out = {}
        for c in ("sum", "mean", "max"):
            bag = embedding_bag(p, d["ids"], d["mask"], c)
            out[c] = bag.full_tensor().detach().numpy()
            if c != "max":
                w = torch.arange(bag.shape[-1], dtype=torch.float32)
                (g,) = torch.autograd.grad((bag * w).sum(), [p.table])
                out[c + " grad"] = g.full_tensor().numpy()
        return out


def int8_index_ids(rank, world, shape, seed, batch, shortlist, topk):
    """The two-tower hillclimb's int8 index step (smoke config, weights
    from ``seed``) with the model and the index distributed as the cell
    places them on a ``shape`` mesh: ``(values, ids)`` gathered whole."""
    from torch.distributed.tensor.experimental import implicit_replication

    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import (active_mesh, shard_like,
                                                  use_rules)
    from repro_torch.launch.cells import _shard_tree, recsys_logical
    from repro_torch.launch.hillclimb import index_int8_step
    from repro_torch.models.recsys import twotower_init

    cfg = get_arch("two-tower-retrieval").smoke_config_fn()
    mesh = make_host_mesh(shape)
    model = twotower_init(cfg, seed=seed, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    b_log = {"user_id": (None,), "hist_ids": (None, None),
             "hist_mask": (None, None), "q8": ("candidates", None),
             "scale": ("candidates",)}
    with use_rules({}), active_mesh(mesh), implicit_replication():
        sh = _shard_tree(mesh, recsys_logical(model))
        for name, prm in list(model.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            mod._parameters[leaf] = torch.nn.Parameter(
                distribute_tensor(prm.detach(), mesh, sh[name].placements),
                requires_grad=False)
        b = shard_like(b, _shard_tree(mesh, b_log))
        vals, ids = index_int8_step(cfg, shortlist, topk)(model, b)
        return vals.full_tensor().numpy(), ids.full_tensor().numpy()


def seq_sharded_decode(rank, world, shape, seed, window):
    """``layers.gqa_decode`` with the cache sharded along its sequence
    over ``model`` (the ``kv_seq`` rule) and the batch over ``data``,
    the weights replicated: ``(y, k cache, v cache)`` gathered whole,
    and the same step on plain tensors, as numpy."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import (active_mesh,
                                                  make_param_shardings,
                                                  shard_like, use_rules)
    from repro_torch.models.layers import gqa_decode, gqa_init

    g = torch.Generator().manual_seed(seed)
    p = gqa_init(16, 4, 2, 8, generator=g, qkv_bias=True,
                 dtype=torch.float32)
    B, S = 4, 8
    x = torch.randn(B, 1, 16, generator=g)
    cache = {"k": torch.randn(B, S, 2, 8, generator=g),
             "v": torch.randn(B, S, 2, 8, generator=g),
             "len": torch.tensor([0, 3, S - 1, S + 2], dtype=torch.int32)}

    def step(p_, x_, c_):
        y, c = gqa_decode(p_, x_, dict(c_), window=window,
                          compute_dtype=torch.float32)
        return y, c["k"], c["v"]

    plain = step(p, x, {k: v.clone() for k, v in cache.items()})
    mesh = make_host_mesh(shape)
    with use_rules({"kv_seq": "model"}), active_mesh(mesh), \
            implicit_replication():
        for name, prm in list(p.named_parameters()):
            p._parameters[name] = torch.nn.Parameter(
                distribute_tensor(prm.detach(), mesh,
                                  (Replicate(),) * mesh.ndim),
                requires_grad=False)
        sh = make_param_shardings(mesh, {
            "x": ("batch", None, None), "k": ("batch", "kv_seq", None, None),
            "v": ("batch", "kv_seq", None, None), "len": ("batch",)})
        d = shard_like({"x": x, **cache}, sh)
        got = step(p, d.pop("x"), d)
        got = [t.full_tensor() for t in got]
    return [t.numpy() for t in plain], [t.numpy() for t in got]


def lm_loss_on_mesh(rank, world, shape, arch, seed, tokens, labels):
    """``transformer.loss_fn`` of ``arch``'s smoke config (fp32, weights
    from ``seed``) with the weights placed by the JAX rules on a
    ``shape`` mesh (the vocab over ``model``) and the batch over
    ``data``: the loss and the gradient of the embedding table gathered
    whole, and the same on plain tensors, as numpy."""
    import dataclasses

    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import (active_mesh, shard_like,
                                                  use_rules)
    from repro_torch.launch.cells import _shard_tree, lm_logical
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_arch(arch).smoke_config_fn(),
                              dtype="float32")

    def run(model, tok, lab):
        loss, _ = T.loss_fn(model, cfg, tok, lab)
        table = model.embed.table
        (g,) = torch.autograd.grad(loss, [table])
        return loss, g

    model = T.init_params(cfg, seed=seed, device="cpu", trainable=True)
    tok, lab = torch.from_numpy(tokens), torch.from_numpy(labels)
    plain = [t.detach().numpy() for t in run(model, tok, lab)]
    mesh = make_host_mesh(shape)
    with use_rules({}), active_mesh(mesh), implicit_replication():
        sh = _shard_tree(mesh, lm_logical(model))
        for name, prm in list(model.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            mod._parameters[leaf] = torch.nn.Parameter(
                distribute_tensor(prm.detach(), mesh, sh[name].placements))
        b = shard_like({"t": tok, "l": lab},
                       _shard_tree(mesh, {"t": ("batch", None),
                                          "l": ("batch", None)}))
        got = [t.full_tensor().detach().numpy()
               for t in run(model, b["t"], b["l"])]
    return plain, got


def grouped_attention(rank, world, shape, seed, attention):
    """``layers._attend`` of 8 query heads over 2 kv heads on a ``shape``
    mesh whose model axis divides the query heads but not the kv heads:
    the output and the gradients of q, k and v (through a weighted sum)
    gathered whole, and the same on plain tensors, as numpy."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import active_mesh, use_rules
    from repro_torch.models.layers import _attend

    g = torch.Generator().manual_seed(seed)
    q = torch.randn(2, 8, 8, 4, generator=g)
    k, v = (torch.randn(2, 8, 2, 4, generator=g) for _ in range(2))
    w = torch.randn(2, 8, 8, 4, generator=g)

    def run(q_, k_, v_, w_):
        q_, k_, v_ = (t.requires_grad_() for t in (q_, k_, v_))
        o = _attend(q_, k_, v_, attention, chunk=4)
        return [o] + list(torch.autograd.grad((o * w_).sum(), [q_, k_, v_]))

    plain = [t.detach().numpy() for t in run(q.clone(), k.clone(),
                                             v.clone(), w)]
    mesh = make_host_mesh(shape)
    with use_rules({}), active_mesh(mesh), implicit_replication():
        rep = (Replicate(),) * mesh.ndim
        got = run(*(distribute_tensor(t, mesh, rep) for t in (q, k, v, w)))
        got = [t.full_tensor().detach().numpy() for t in got]
    return plain, got


def twotower_loss_on_mesh(rank, world, shape, seed, batch):
    """``recsys.twotower_loss`` (smoke config, weights from ``seed``) with
    the tables row-sharded over ``model`` and the batch over ``data``:
    the loss and the item table's gradient gathered whole, and the same
    on plain tensors, as numpy."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import (active_mesh, shard_like,
                                                  use_rules)
    from repro_torch.launch.cells import _shard_tree, recsys_logical
    from repro_torch.models.recsys import twotower_init, twotower_loss

    cfg = get_arch("two-tower-retrieval").smoke_config_fn()
    keys = ("user_id", "hist_ids", "hist_mask", "pos_item", "item_logq")

    def run(model, b):
        loss, _ = twotower_loss(model, cfg, *(b[k] for k in keys))
        (g,) = torch.autograd.grad(loss, [model.item_emb.table])
        return loss, g

    model = twotower_init(cfg, seed=seed, device="cpu", trainable=True)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    plain = [t.detach().numpy() for t in run(model, b)]
    mesh = make_host_mesh(shape)
    with use_rules({}), active_mesh(mesh), implicit_replication():
        sh = _shard_tree(mesh, recsys_logical(model))
        for name, prm in list(model.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            mod._parameters[leaf] = torch.nn.Parameter(
                distribute_tensor(prm.detach(), mesh, sh[name].placements))
        b = shard_like(b, _shard_tree(mesh, {
            k: ("batch",) + (None,) * (v.dim() - 1) for k, v in b.items()}))
        got = [t.full_tensor().detach().numpy() for t in run(model, b)]
    return plain, got


def jobs(rank, world, todo):
    """Each ``(name, body, args)`` of ``todo`` in turn on this rank of one
    gloo world, ``body`` a function of this module: ``{name: result}``,
    a job that raised giving its traceback."""
    import traceback

    out = {}
    for name, body, args in todo:
        try:
            out[name] = globals()[body](rank, world, *args)
        except Exception:
            out[name] = traceback.format_exc()
    return out



def gnn_loss_on_mesh(rank, world, shape, seed, kind, batch):
    return mesh_ranks.gnn_loss_on_mesh(shape, seed, kind, batch)


def lm_decode_on_mesh(rank, world, shape, arch, seed, prompt, token,
                      overrides=None):
    return mesh_ranks.lm_decode_on_mesh(shape, arch, seed, prompt, token,
                                        overrides)


def twotower_grads_on_mesh(rank, world, shape, seed, batch):
    return mesh_ranks.twotower_grads_on_mesh(shape, seed, batch)
