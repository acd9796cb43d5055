"""Perf hillclimb (port of ``repro.launch.hillclimb``) on the fake
256-rank world.

Targets (the JAX package's, chosen from its 40-cell baseline table):
  * deepseek-v2-236b x train_4k   — worst roofline fraction among trains
  * graphsage-reddit x ogb_products — most collective-bound cell
  * two-tower-retrieval x retrieval_cand — most representative of the
    paper's technique (early-stopping screened top-k)
plus the paper's own workload (fim-eclat x mine_1g) as the
paper-faithful-vs-optimised pair.

Each VARIANT is (hypothesis, knobs); ``measure`` re-traces the cell
(``launch.cells.trace_cell``), re-fits the LM costs and records the three
roofline terms (``roofline.analysis``, H100 figures) before/after in
``results/hillclimb/<target>.json``.  The port's byte counter keeps bf16
as bf16 (no float normalisation), so a bf16 variant's bytes move here.

    python -m repro_torch.launch.hillclimb --target fim
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.launch import dryrun as DR
from repro_torch.launch.cells import (BuiltCell, _abstract_init, _context,
                                      _count, _fim_shardings, _in_mode,
                                      _opt_cfg_for, _sds, _shard_tree,
                                      _train_prepare, _train_step,
                                      build_cell, recsys_logical, trace_cell)
from repro_torch.distributed.sharding import active_mesh, use_rules
from repro_torch.roofline.analysis import RooflineTerms


def measure(arch, shape, mesh, mesh_name, *, cfg_overrides=None,
            dims_overrides=None, extra_rules=None, step_builder=None,
            family=None, tokens=0, n_active=0, train=False,
            device="cuda"):
    """Trace a (possibly overridden) cell and return roofline terms."""
    t0 = time.time()
    if step_builder is not None:
        cell = step_builder(mesh)
    else:
        cell = build_cell(arch, shape, mesh, extra_rules=extra_rules,
                          cfg_overrides=cfg_overrides,
                          dims_overrides=dims_overrides, device=device)
    traced = trace_cell(cell, mesh)
    peak = traced["args_bytes"] + traced["temp_peak_bytes"]
    fam = family or DR.REGISTRY[arch].family
    total = DR._metrics(traced)
    fit_equal = None
    if fam == "lm":
        fit = DR._lm_cost_fit(arch, shape, mesh, cell.kind,
                              cfg_overrides=cfg_overrides,
                              dims_overrides=dims_overrides, device=device)
        fit_equal = DR._fit_equal(total, fit["total"])
    link = sum(v for k, v in total.items() if k.endswith("_link_bytes"))
    terms = RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=mesh.size(),
        flops_per_chip=total["flops"], bytes_per_chip=total["bytes"],
        link_bytes_per_chip=link,
        model_flops=(6.0 if train else 2.0) * n_active * tokens,
        peak_memory_per_chip=peak)
    d = terms.as_dict()
    d["collectives"] = {k: v for k, v in total.items()
                        if k.startswith("coll_")}
    if fit_equal is not None:
        d["fit_equal"] = fit_equal
    d["trace_s"] = round(time.time() - t0, 1)
    return d


def log_variant(results, name, hypothesis, d, base=None):
    entry = {"variant": name, "hypothesis": hypothesis, **d}
    if base is not None:
        for t in ("t_compute_s", "t_memory_s", "t_collective_s",
                  "step_time_lb_s"):
            if base[t] > 0:
                entry[f"delta_{t}"] = round(d[t] / base[t] - 1, 4)
    results.append(entry)
    print(f"[{name}] comp={d['t_compute_s']*1e3:.3f}ms "
          f"mem={d['t_memory_s']*1e3:.3f}ms "
          f"coll={d['t_collective_s']*1e3:.3f}ms "
          f"bound={d['bottleneck']} "
          f"peak={d['peak_memory_per_chip']/2**30:.2f}GiB "
          f"bytes={d['bytes_per_chip']:.6e} "
          f"frac={d['roofline_fraction']:.4f}", flush=True)
    return entry


def climb_deepseek(mesh, mesh_name, results, device="cuda"):
    arch, shape = "deepseek-v2-236b", "train_4k"
    d = get_shape(get_arch(arch), shape).dims
    tok = d["global_batch"] * d["seq"]
    probe = build_cell(arch, shape, mesh, device=device)
    n_act = probe.active_params
    del probe
    kw = dict(tokens=tok, n_active=n_act, train=True, device=device)

    base = measure(arch, shape, mesh, mesh_name, **kw)
    log_variant(results, "baseline(paper-faithful shardings)",
                "remat=full, n_mb=8, attn_chunk=1024, FSDPxTP", base)
    v = measure(arch, shape, mesh, mesh_name,
                cfg_overrides={"attn_chunk": 4096}, **kw)
    log_variant(results, "attn_chunk=4096",
                "one online-softmax chunk: the (m, l, acc) carries are read "
                "and written once instead of 4x, so attention bytes drop; "
                "the score block grows 4x (watch peak)", v, base)
    v2 = measure(arch, shape, mesh, mesh_name,
                 dims_overrides={"n_microbatches": 2}, **kw)
    log_variant(results, "n_microbatches=2",
                "weight redistributions and re-reads scale with n_mb: "
                "8->2 cuts collective bytes ~4x; activation memory x4",
                v2, base)
    v3 = measure(arch, shape, mesh, mesh_name,
                 cfg_overrides={"attn_chunk": 4096},
                 dims_overrides={"n_microbatches": 2}, **kw)
    log_variant(results, "combined(chunk4096+mb2)",
                "both wins are independent terms; expect ~product", v3,
                base)
    v4 = measure(arch, shape, mesh, mesh_name,
                 cfg_overrides={"attn_chunk": 4096, "remat": "dots"},
                 dims_overrides={"n_microbatches": 2}, **kw)
    log_variant(results, "plus remat=dots",
                "recompute only non-dot ops: the backward's recomputed "
                "projections go (fewer FLOPs and bytes); peak memory rises "
                "(saved dots)", v4, base)
    return results


def climb_gnn(mesh, mesh_name, results, device="cuda"):
    from repro_torch.models import gnn as G
    from repro_torch.models.weights import recsys_leaves

    arch, shape = "graphsage-reddit", "ogb_products"
    base = measure(arch, shape, mesh, mesh_name, device=device)
    log_variant(results, "baseline(DTensor segment sum)",
                "scatter-add over globally sharded edges: DTensor "
                "redistributes the (N, H) node array per layer", base)
    v = measure(arch, shape, mesh, mesh_name, device=device,
                cfg_overrides={"dtype": "bfloat16"})
    log_variant(results, "bf16 features",
                "halve every gather/scatter and collective byte: the "
                "counter keeps bf16 as bf16, so bytes should fall ~2x", v,
                base)

    def build_partitioned(mesh):
        spec = get_arch(arch)
        cfg = spec.config_fn(shape)
        d = get_shape(spec, shape).dims
        N, E = d["n_nodes"], d["n_edges"]
        F_pad = 112   # d_feat 100 padded to /16 for feature sharding
        cfg_p = dataclasses.replace(cfg, d_feat=F_pad)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))
        n_data, n_model = sizes["data"], sizes["model"]
        # no kernel on this path: its per-rank blocks are fake CPU
        # tensors, as the fake world's DTensor shards are
        ctx = _context("cpu", fake=True)
        loss_sharded = G.make_sharded_loss(mesh, cfg_p, N, F_pad)
        box = {}

        def init(dev):
            model, box["logical"] = G.init_params(cfg_p, device=dev,
                                                  trainable=True)
            return model

        def build():
            model = _abstract_init(init, ctx)
            e_r = E // (n_data * n_model)
            batch_a = {"x": _sds((N // n_data, F_pad // n_model),
                                 "float32", ctx.device),
                       "edge_src": _sds((e_r,), "int32", ctx.device),
                       "edge_dst_local": _sds((e_r,), "int32", ctx.device),
                       "labels": _sds((N // n_data,), "int32", ctx.device),
                       "mask": _sds((N // n_data,), "bool", ctx.device)}
            return model, batch_a

        with use_rules({}), active_mesh(mesh):
            model, batch_a = _in_mode(ctx, build)

        def loss_of(m, b):
            loss = loss_sharded(m, b["x"], b["edge_src"],
                                b["edge_dst_local"], b["labels"], b["mask"])
            return loss, {"ce": loss.detach()}

        # each rank's blocks are its own (the loss makes its own
        # collectives): the arguments stay plain tensors
        cell = BuiltCell(arch, shape, "train_full_partitioned",
                         _train_step(loss_of, 1), (model, batch_a),
                         (None, None), (0, 1), {},
                         model_params=_count(model), fake_mode=ctx.fake_mode,
                         prepare=_train_prepare(_opt_cfg_for(arch),
                                                recsys_leaves),
                         per_rank=True, device=ctx.device)
        return cell

    v2 = measure(arch, shape, mesh, mesh_name,
                 step_builder=build_partitioned, family="gnn")
    log_variant(results, "dst-partitioned edges + feature sharding",
                "edges pre-partitioned by destination shard => the "
                "scatter is shard-local (no (N, H) redistribution); "
                "features sharded over model => per-layer all-gather "
                "moves (N, F/16); predict t_coll down ~10x", v2, base)
    return results


def index_fp32_step(cfg, topk: int = 100):
    """The "offline item index (fp32)" variant's step: the query against
    a precomputed ``(C, D)`` fp32 item index, ``(values, positions)``."""
    from repro_torch.models import recsys as R

    def step(m, b):
        with torch.no_grad():
            u = R.user_embed(m, cfg, b["user_id"], b["hist_ids"],
                             b["hist_mask"])
            return torch.topk(u @ b["index"].T, topk)
    return step


def index_int8_step(cfg, shortlist: int = 4096, topk: int = 100):
    """The "offline index + int8 ES screen" variant's step: an int8 index
    (``q8`` rows times their ``scale``) screens every candidate, and the
    fp32 item tower rescores the ``shortlist`` best; returns ``(values
    (1, topk), candidate ids (1, topk))``."""
    from repro_torch.models import recsys as R

    def step(m, b):
        with torch.no_grad():
            u = R.user_embed(m, cfg, b["user_id"], b["hist_ids"],
                             b["hist_mask"])                  # (1, D)
            # phase 1: int8 index scan (1/4 the bytes)
            approx = (b["q8"].to(torch.float32) @ u[0]) * b["scale"]
            short = torch.topk(approx[None], shortlist).indices[0]
            # phase 2: exact fp32 tower on the shortlist
            exact = u @ R.item_embed(m, cfg, short).T
            vals, pos = torch.topk(exact, topk)
            return vals, short.index_select(0, pos[0])[None]
    return step


def climb_twotower(mesh, mesh_name, results, device="cuda"):
    from repro_torch.models import recsys as R

    arch, shape = "two-tower-retrieval", "retrieval_cand"
    base = measure(arch, shape, mesh, mesh_name, device=device)
    log_variant(results, "baseline(fp32 full scan)",
                "item tower fp32 over 1M candidates; memory-bound", base)

    spec = get_arch(arch)
    cfg = spec.config_fn(None)
    C = get_shape(spec, shape).dims["n_candidates"]

    def cell_of(kind, step, extra_a, extra_log):
        ctx = _context(device, fake=True)

        def build():
            model = _abstract_init(lambda dev: R.twotower_init(
                cfg, device=dev), ctx)
            batch_a = {"user_id": _sds((1,), "int32", ctx.device),
                       "hist_ids": _sds((1, cfg.n_user_hist), "int32",
                                        ctx.device),
                       "hist_mask": _sds((1, cfg.n_user_hist), "bool",
                                         ctx.device)}
            batch_a.update(extra_a(ctx.device))
            return model, batch_a

        with use_rules({}), active_mesh(mesh):
            model, batch_a = _in_mode(ctx, build)
            b_log = {"user_id": (None,), "hist_ids": (None, None),
                     "hist_mask": (None, None), **extra_log}
            shs = (_shard_tree(mesh, recsys_logical(model)),
                   _shard_tree(mesh, b_log))
        return BuiltCell(arch, shape, kind, step, (model, batch_a), shs,
                         (), {}, fake_mode=ctx.fake_mode, device=ctx.device)

    def screened(m, b):
        with torch.no_grad():
            return R.retrieval_scores_screened(
                m, cfg, b["user_id"], b["hist_ids"], b["hist_mask"],
                b["cand"], topk=100, shortlist=4096)

    v = measure(arch, shape, mesh, mesh_name, family="recsys",
                step_builder=lambda m: cell_of(
                    "retrieval-screened", screened,
                    lambda dev: {"cand": _sds((C,), "int32", dev)},
                    {"cand": ("candidates",)}))
    log_variant(results, "ES-screened (bf16 screen + fp32 shortlist)",
                "paper transfer: cheap certified bf16 screen over all 1M, "
                "exact fp32 rescore of 4096 survivors; the counter keeps "
                "bf16, so predict ~2x bytes down", v, base)

    index_fp32, index_int8 = index_fp32_step(cfg), index_int8_step(cfg)

    v2 = measure(arch, shape, mesh, mesh_name, family="recsys",
                 step_builder=lambda m: cell_of(
                     "retrieval-index", index_fp32,
                     lambda dev: {"index": _sds((C, cfg.embed_dim),
                                                "float32", dev)},
                     {"index": ("candidates", None)}))
    log_variant(results, "offline item index (fp32)",
                "the item tower is query-independent: precompute it "
                "offline; per-query work = one (1M x D) dot; predict "
                "bytes ~8x down", v2, base)

    v3 = measure(arch, shape, mesh, mesh_name, family="recsys",
                 step_builder=lambda m: cell_of(
                     "retrieval-index-int8", index_int8,
                     lambda dev: {"q8": _sds((C, cfg.embed_dim), "int8",
                                             dev),
                                  "scale": _sds((C,), "float32", dev)},
                     {"q8": ("candidates", None), "scale": ("candidates",)}))
    log_variant(results, "offline index + int8 ES screen",
                "paper transfer on the index scan: int8 approx pass (1/4 "
                "bytes) + exact fp32 tower on 4096 survivors; predict "
                "another ~3x bytes down", v3, base)
    return results


def climb_fim(mesh, mesh_name, results, device="cuda"):
    from repro_torch.core.distributed import make_mining_round_v2

    arch, shape = "fim-eclat", "mine_1g"
    base = measure(arch, shape, mesh, mesh_name, device=device)
    log_variant(results, "baseline(paper-faithful round)",
                "screen suffix recomputed per pair from full rows", base)

    def build_v2(mesh):
        d = get_shape(get_arch(arch), shape).dims
        ctx = _context(device, fake=True)
        n_shards = mesh.size()

        def build():
            return (_sds((d["store_rows"], d["n_blocks"], d["block_words"]),
                         "int32", ctx.device),
                    _sds((d["store_rows"], n_shards), "int32", ctx.device),
                    _sds((d["pairs"], 2), "int32", ctx.device),
                    _sds((d["pairs"],), "int32", ctx.device))

        args = _in_mode(ctx, build)
        shs = _fim_shardings(mesh, (None, "tid", None), (None, "tid"),
                             (None, None), (None,))
        return BuiltCell(arch, shape, "mine-v2", make_mining_round_v2(mesh),
                         args, shs, (), {}, fake_mode=ctx.fake_mode,
                         device=ctx.device)

    v = measure(arch, shape, mesh, mesh_name, step_builder=build_v2,
                family="fim")
    log_variant(results, "v2: precomputed suffix + shared-a chunks",
                "suffix tables are row invariants (stop recomputing); "
                "u-row gathered once per chunk; predict ~2x bytes down",
                v, base)
    return results


TARGETS = {
    "deepseek": climb_deepseek,
    "gnn": climb_gnn,
    "twotower": climb_twotower,
    "fim": climb_fim,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", choices=sorted(TARGETS) + ["all"],
                    default="all")
    ap.add_argument("--outdir", default="results/hillclimb")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import make_production_mesh
    DR.fake_world(256)
    mesh = make_production_mesh(multi_pod=False)
    mesh_name = "1pod_16x16"

    targets = sorted(TARGETS) if args.target == "all" else [args.target]
    os.makedirs(args.outdir, exist_ok=True)
    n_fail = 0
    for t in targets:
        print(f"=== hillclimb: {t} ===", flush=True)
        results = []
        try:
            TARGETS[t](mesh, mesh_name, results, device=args.device)
        except Exception as e:  # record partial progress
            import traceback
            results.append({"error": f"{type(e).__name__}: {e}"[:2000],
                            "traceback": traceback.format_exc()[-2000:]})
            print("ERROR:", type(e).__name__, str(e)[:300], flush=True)
            n_fail += 1
        with open(os.path.join(args.outdir, f"{t}.json"), "w") as f:
            json.dump(results, f, indent=1)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
