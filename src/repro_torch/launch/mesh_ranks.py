"""Per-rank bodies of the checks that hold the port's mesh paths against
one rank: GraphSAGE's full-batch and sampled losses, a decode step of an
LM with the dry-run decode cell's placement (the MoE experts' ``embed``
shard kept for one sequence, kv heads that do not cover the model axis),
and the two-tower loss.  Each places the weights and the batch as the
dry-run's cells place them on a mesh of the world it runs in, runs the
step there and on plain tensors, and returns both, gathered whole, as
numpy.  The CPU tests run them in gloo worlds of 2 and 4 ranks
(``tests/torch_analysis_ranks.py``); ``chip_smoke.py`` runs them on a
one-rank NCCL mesh on the card.  Imports torch and the port only.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.mesh import make_host_mesh


def _to_mesh(tree, mesh, logical, device):
    """``tree`` (a dict of numpy arrays or tensors) on ``device``,
    distributed over ``mesh`` by ``logical`` (its logical axes, key by
    key)."""
    from repro_torch.distributed.sharding import shard_like
    from repro_torch.launch.cells import _shard_tree

    return shard_like({k: torch.as_tensor(v, device=device)
                       for k, v in tree.items()}, _shard_tree(mesh, logical))


def _placed_params(model, mesh, logical):
    """Every parameter of ``model`` replaced by a DTensor placed by
    ``logical`` (``{parameter name: axes}``) on ``mesh``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.cells import _shard_tree

    sh = _shard_tree(mesh, logical)
    for name, prm in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = torch.nn.Parameter(
            distribute_tensor(prm.detach(), mesh, sh[name].placements),
            requires_grad=prm.requires_grad)


def _numpy(ts):
    return [(t.full_tensor() if hasattr(t, "full_tensor") else t)
            .detach().cpu().numpy() for t in ts]


def _loss_and_grads(model, loss_of):
    """``(names, [loss, each parameter's gradient])``, gathered whole, as
    numpy."""
    named = list(model.named_parameters())
    loss = loss_of(model)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return [n for n, _ in named], _numpy([loss, *grads])


def gnn_loss_on_mesh(shape, seed, kind, batch, device="cpu"):
    """GraphSAGE's smoke config in float64 (weights from ``seed``): the
    full-batch loss (``kind`` "full": ``batch`` holds x, edge_src,
    edge_dst, labels, mask) or the sampled one ("sampled": x_root, x_h1,
    x_h2, m1, m2, labels), with the weights and the batch placed as the
    dry-run's cells place them on a ``shape`` mesh (edges and nodes over
    ``data``, hidden over ``model``): ``(names, plain, mesh)``, the loss
    and every weight's gradient."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import active_mesh, use_rules
    from repro_torch.launch.cells import _named
    from repro_torch.models import gnn as G

    cfg = dataclasses.replace(
        get_arch("graphsage-reddit").smoke_config_fn(), dtype="float64")
    b_log = ({"x": ("nodes", "feat"), "edge_src": ("edges",),
              "edge_dst": ("edges",), "labels": ("nodes",),
              "mask": ("nodes",)} if kind == "full" else
             {"x_root": ("nodes", "feat"), "x_h1": ("nodes", None, "feat"),
              "x_h2": ("nodes", None, None, "feat"), "m1": ("nodes", None),
              "m2": ("nodes", None, None), "labels": ("nodes",)})

    def loss_of(b):
        def run(m):
            if kind == "full":
                return G.loss_full(m, cfg, b["x"], b["edge_src"],
                                   b["edge_dst"], b["labels"], b["mask"])[0]
            return G.loss_sampled(m, cfg, (b["x_root"], b["x_h1"],
                                           b["x_h2"]), (b["m1"], b["m2"]),
                                  b["labels"])[0]
        return run

    model, logical = G.init_params(cfg, seed=seed, device=device,
                                   trainable=True)
    names, plain = _loss_and_grads(model, loss_of(
        {k: torch.as_tensor(v, device=device) for k, v in batch.items()}))
    mesh = make_host_mesh(shape)
    with use_rules({}), active_mesh(mesh), implicit_replication():
        _placed_params(model, mesh, _named(logical))
        got = _loss_and_grads(model, loss_of(
            _to_mesh(batch, mesh, b_log, device)))[1]
    return names, plain, got


def decode_rules(arch, cfg, mesh, batch: int, force_seq: bool = False):
    """The rules the dry-run's decode cell of ``arch`` takes on ``mesh``:
    the arch's own, the batch whole when it is 1, and the cache's
    sequence and the kv weights' head_dim over ``model`` when the kv
    heads do not cover it (``force_seq``: always, as a one-rank mesh
    cannot cut a kv head)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.cells import _decode_rules

    rules = dict(get_arch(arch).rules_override)
    if batch == 1:
        rules["batch"] = None
    _decode_rules(cfg, mesh, rules)
    if force_seq:
        rules.update(kv_seq="model", head_dim="model")
    return rules


def lm_decode_on_mesh(shape, arch, seed, prompt, token, overrides=None,
                      device="cpu", force_seq=False):
    """One ``transformer.decode_step`` of ``arch``'s smoke config (fp32,
    ``overrides`` replaced, weights from ``seed``) after a plain prefill
    of ``prompt`` (B, S), with the weights, the cache and the token
    placed as the dry-run's decode cell places them on a ``shape`` mesh
    (:func:`decode_rules`): ``(plain, mesh)``, the logits and the new
    cache."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import active_mesh, use_rules
    from repro_torch.launch.cells import lm_logical
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_arch(arch).smoke_config_fn(),
                              dtype="float32", **(overrides or {}))
    model = T.init_params(cfg, seed=seed, device=device)
    prompt_t = torch.as_tensor(prompt, device=device)
    with torch.no_grad():
        _, cache = T.prefill(model, cfg, prompt_t,
                             max_len=prompt.shape[1] + 4)
    keys = [k for k in cache if k != "len"]

    def run(m, tok, c):
        with torch.no_grad():
            logits, c = T.decode_step(m, cfg, tok, c)
        return [logits] + [c[k] for k in keys]

    tok = torch.as_tensor(token, device=device)
    plain = _numpy(run(model, tok, {k: v.clone() for k, v in
                                    cache.items()}))
    mesh = make_host_mesh(shape)
    rules = decode_rules(arch, cfg, mesh, prompt.shape[0], force_seq)
    with use_rules(rules), active_mesh(mesh), implicit_replication():
        _placed_params(model, mesh, lm_logical(model))
        c_log = T.cache_logical(cfg)
        d = _to_mesh({**cache, "tok": tok}, mesh,
                     {**{k: c_log[k] for k in cache}, "tok": ("batch",)},
                     device)
        got = _numpy(run(model, d.pop("tok"), d))
    return plain, got


def twotower_grads_on_mesh(shape, seed, batch, device="cpu"):
    """``recsys.twotower_loss`` (smoke config, weights from ``seed``) with
    the tables row-sharded over ``model`` and the batch over ``data``:
    ``(names, plain, mesh)``, the loss and every weight's gradient."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import active_mesh, use_rules
    from repro_torch.launch.cells import recsys_logical
    from repro_torch.models.recsys import twotower_init, twotower_loss

    cfg = get_arch("two-tower-retrieval").smoke_config_fn()
    keys = ("user_id", "hist_ids", "hist_mask", "pos_item", "item_logq")

    def loss_of(b):
        return lambda m: twotower_loss(m, cfg, *(b[k] for k in keys))[0]

    model = twotower_init(cfg, seed=seed, device=device, trainable=True)
    names, plain = _loss_and_grads(model, loss_of(
        {k: torch.as_tensor(v, device=device) for k, v in batch.items()}))
    mesh = make_host_mesh(shape)
    with use_rules({}), active_mesh(mesh), implicit_replication():
        _placed_params(model, mesh, recsys_logical(model))
        b = _to_mesh(batch, mesh, {k: ("batch",) + (None,) * (v.ndim - 1)
                                   for k, v in batch.items()}, device)
        got = _loss_and_grads(model, loss_of(b))[1]
    return names, plain, got
