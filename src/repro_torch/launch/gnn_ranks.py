"""Per-rank bodies of the GraphSAGE sharded-loss and int8 compression
checks, run in gloo worlds by :func:`repro_torch.launch.forcedevices.run_ranks`
(the CPU tests, the card tests and ``chip_smoke.py`` phase 15 share them),
and :func:`probe` (``python -m repro_torch.launch.gnn_ranks``), which
shows where the sharded and the whole fp32 sums part.

Inputs and results are numpy, so they cross the process boundary without
tensors; this module imports torch and the port only, so a spawned rank
starts without JAX.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def rank_checks(rank, world, sharded=(), comp=None, device="cpu"):
    """This rank's part of the checks, on ``device`` (``cuda:0`` shared by
    every rank, or the CPU).

    ``sharded``: jobs ``(shape, cfg, tree, graph, f_pad)``, each
    ``make_sharded_loss`` on a ``shape`` = (data, model) mesh of this
    world, from the whole model ``tree`` (numpy leaves by JAX path,
    ``d_feat == f_pad``) and the whole graph ``(x, edge_src, edge_dst,
    labels, mask)`` (numpy), which each rank cuts with ``shard_graph``.
    On CUDA they run under deterministic algorithms, so the segment sums'
    order is fixed.

    ``comp``: ``(shape, axes, trees)``: this rank's tree ``trees[rank]``
    (numpy leaves) through ``compressed_psum_int8`` over the world and
    ``compressed_crosspod_allreduce`` over a ``shape`` mesh named
    ``axes``.

    Returns ``{"sharded": [(loss, {path: grad})] per job, "comp": (psum,
    cross) or None}``, all numpy."""
    from repro_torch.distributed.compression import (
        compressed_crosspod_allreduce, compressed_psum_int8)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import gnn as G
    from repro_torch.models import weights as W
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out = {"sharded": [], "comp": None}
    for shape, cfg, tree, graph, f_pad in sharded:
        mesh = make_host_mesh(shape, ("data", "model"))
        d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        model = W.gnn_from_numpy(tree, device=dev, trainable=True)
        leaves = W.gnn_leaves(model)
        parts = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                 G.shard_graph(*graph, d, m, shape[0], shape[1], f_pad)]
        with _deterministic(dev.type == "cuda"):
            loss = G.make_sharded_loss(mesh, cfg, graph[0].shape[0], f_pad)(
                model, *parts)
            grads = torch.autograd.grad(loss, [ps[0] for _, ps, _ in leaves])
        out["sharded"].append((float(loss.detach()), {
            p: g.cpu().numpy() for (p, _, _), g in zip(leaves, grads,
                                                         strict=True)}))
    if comp is not None:
        shape, axes, trees = comp
        mesh = make_host_mesh(shape, axes)
        tree = {k: torch.from_numpy(v).to(dev)
                for k, v in trees[rank].items()}
        out["comp"] = (
            {k: compressed_psum_int8(v).cpu().numpy()
             for k, v in tree.items()},
            {k: v.cpu().numpy() for k, v in
             compressed_crosspod_allreduce(tree, mesh).items()})
    return out


@contextlib.contextmanager
def _deterministic(on: bool):
    if not on:
        yield
        return
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


# ---------------------------------------------------------------------------
# probe: where fp32's sharded and whole sums part
# ---------------------------------------------------------------------------

PROBE_MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}


def probe(cases, device="cuda:0", dtypes=("float32", "float64")):
    """``make_sharded_loss`` against ``loss_full`` at ``full_graph_sm``
    (2816 nodes, 10,752 edges, 1433 features padded to 1434) for each
    ``(graph_seed, weight_seed)`` of ``cases``, on the meshes of
    ``PROBE_MESHES`` in gloo worlds on ``device``, in each of ``dtypes``
    (one fp32 draw of the weights, cast), deterministic algorithms on
    CUDA.  Per case, dtype and mesh: the worst loss error over ranks and
    the worst gradient entry (leaf, index, error over the leaf's largest
    entry).  Per case: the fp32 layer-1 pre-activation nearest 0 (node,
    unit, value), where a ReLU can fall on either side of its kink."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data import graph_data as GD
    from repro_torch.launch.forcedevices import run_ranks
    from repro_torch.models import gnn as G
    from repro_torch.models import weights as W
    from repro_torch.tree import tree_map
    dev = torch.device(device)
    base = get_arch("graphsage-reddit").config_fn("full_graph_sm")
    f_pad = base.d_feat + 1
    out = []
    for gseed, wseed in cases:
        g = GD.gen_powerlaw_graph(2816, 10752 / 2816, base.d_feat,
                                  base.n_classes, seed=gseed)
        xp = np.zeros((g.x.shape[0], f_pad), np.float32)
        xp[:, :base.d_feat] = g.x
        mask = np.arange(g.x.shape[0]) % 3 != 0
        cfg32 = dataclasses.replace(base, d_feat=f_pad)
        tree32 = W.gnn_to_numpy(G.init_params(cfg32, seed=wseed,
                                              device=dev)[0])
        jobs, refs = {}, {}
        for dt in dtypes:
            cfg = dataclasses.replace(cfg32, dtype=dt)
            tree = tree_map(lambda a, t=dt: a.astype(t), tree32)
            graph = (xp.astype(dt), g.edge_src, g.edge_dst, g.labels, mask)
            model = W.gnn_from_numpy(tree, dev, trainable=True)
            leaves = W.gnn_leaves(model)
            with _deterministic(dev.type == "cuda"):
                loss, _ = G.loss_full(model, cfg, *(
                    torch.from_numpy(a).to(dev) for a in graph))
                grads = torch.autograd.grad(loss, [ps[0] for _, ps, _ in
                                                   leaves])
            refs[dt] = (float(loss.detach()), {p: gr.cpu().numpy() for (p, _, _), gr
                                      in zip(leaves, grads, strict=True)})
            for world, shapes in PROBE_MESHES.items():
                jobs.setdefault(world, []).extend(
                    (s, cfg, tree, graph, f_pad) for s in shapes)
        for world, js in jobs.items():
            res = run_ranks(rank_checks, world, (js, None, str(dev)),
                            timeout_s=600.0, threads=0)
            for j, (shape, cfg, *_r) in enumerate(js):
                wl, wg = refs[cfg.dtype]
                worst = (0.0, "", 0)
                l_err = 0.0
                for r in res:
                    loss, grads = r["sharded"][j]
                    l_err = max(l_err, abs(loss - wl) / abs(wl))
                    for p, want in wg.items():
                        d = np.abs(grads[p].astype(np.float64) - want)
                        e = float(d.max() / np.abs(want).max())
                        if e > worst[0]:
                            worst = (e, p, int(d.argmax()))
                out.append({"graph_seed": gseed, "weight_seed": wseed,
                            "dtype": cfg.dtype, "mesh": list(shape),
                            "loss_rel_err": l_err, "grad_rel_err": worst[0],
                            "worst_leaf": worst[1], "worst_index": worst[2]})
        # layer 1's pre-activation in fp32 on the whole graph
        model = W.gnn_from_numpy(tree32, dev)
        lp = model.layers[0]
        x = torch.from_numpy(xp).to(dev)
        src, dst = (torch.from_numpy(a).to(dev) for a in (g.edge_src,
                                                           g.edge_dst))
        with torch.no_grad(), _deterministic(dev.type == "cuda"):
            n = x.shape[0]
            agg = G._segment_mean(x, src, dst, G._inv_degree(dst, n,
                                                             x.dtype), n)
            y = x @ lp.w_self + agg @ lp.w_neigh + lp.bias
        i = int(y.abs().argmin())
        out.append({"graph_seed": gseed, "weight_seed": wseed,
                    "layer1_nearest_zero": float(y.flatten()[i]),
                    "node": i // y.shape[1], "unit": i % y.shape[1]})
    return out


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=probe.__doc__.split("\n")[0])
    ap.add_argument("--cases", default="0:0,5:3",
                    help="graph_seed:weight_seed pairs (chip_smoke.py "
                         "phase 15's and the card test's)")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cases = [tuple(int(v) for v in c.split(":"))
             for c in args.cases.split(",")]
    for row in probe(cases, args.device):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
