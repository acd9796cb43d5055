"""Multi-pod dry-run (port of ``repro.launch.dryrun``): trace every (arch
x shape) cell on a fake world of 256 or 512 ranks.

For each cell on each production mesh (16x16 single-pod, 2x16x16
multi-pod) this module:

  1. builds the cell (fake tensors on the card's device, shardings), no
     allocation,
  2. distributes the arguments as ``DTensor``\\ s on the mesh and runs
     the step once under the counters (``launch.cells.trace_cell``),
  3. records per rank: ``flops`` (``FlopCounterMode``'s formulas, this
     rank's share), ``bytes accessed`` (every aten and custom op's input
     and output bytes, views excluded: an UNFUSED UPPER BOUND on HBM
     traffic, where XLA's figure counts fused kernels), the
     peak memory (the arguments' shards + the step's own peak, counted
     as ``MemTracker`` counts but on local shards),
     and the collectives (``roofline.comms``), into
     ``results/dryrun/<cell>.json``.

The world is ``torch.distributed``'s ``"fake"`` backend: every rank but
this one is imagined, collectives return at once, and the mesh is built
by ``launch.mesh.make_production_mesh`` unchanged.  It replaces the JAX
package's ``--xla_force_host_platform_device_count=512``.

Eager tracing counts every layer and pair chunk, so the JAX scan
workaround (costing small unrolled depths) is not needed; the fits are
kept as a check: ``cost_fit`` extrapolates the same step at L = 1, 2
(FIM: 1, 2 pair chunks) and ``fit_equal`` says whether it equals the
traced totals, as it must, layers being identical; a cell whose totals
differ is recorded as failed (``ok`` false, ``error`` names the
metrics).

Usage:
  python -m repro_torch.launch.dryrun                      # everything
  python -m repro_torch.launch.dryrun --mesh single        # one mesh
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --skip-existing      # resume a sweep
  python -m repro_torch.launch.dryrun --device cpu         # the CPU path
  python -m repro_torch.launch.dryrun --jobs 4             # cells in parallel
  python -m repro_torch.launch.dryrun --compare <jax_outdir>  # port vs JAX

``--compare`` reads the records of ``--outdir`` and those a run of
``python -m repro.launch.dryrun --outdir <jax_outdir>`` wrote (JSON: no
JAX import), and prints, for every cell and mesh both traced, per chip:
FLOPs, argument bytes, peak (arguments + temporaries + the outputs that
alias no argument) and collective link bytes by kind, each as port /
JAX (ratio).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

from repro_torch.configs import REGISTRY, all_cells, get_arch, get_shape
from repro_torch.launch.cells import (build_cell, build_fim_costing,
                                      build_lm_costing, build_opt_costing,
                                      trace_cell)
from repro_torch.roofline.comms import COLLECTIVE_KINDS, parse_collectives

MESHES = {"single": ("1pod_16x16", False, 256),
          "multi": ("2pod_2x16x16", True, 512)}


def _metrics(traced: dict) -> dict:
    """Flat metric dict: flops, bytes, per-kind collective link bytes."""
    out = {"flops": float(traced["flops"]), "bytes": float(traced["bytes"])}
    coll = parse_collectives(traced["collectives"])
    for kind in COLLECTIVE_KINDS:
        v = coll.get(kind, {})
        out[f"coll_{kind}_link_bytes"] = float(v.get("link_bytes", 0.0))
        out[f"coll_{kind}_count"] = float(v.get("count", 0.0))
    return out


def _lin(a: dict, b: dict, ca: float, cb: float) -> dict:
    """ca*a + cb*b elementwise (missing keys = 0), clamped at >= 0."""
    keys = set(a) | set(b)
    return {k: max(ca * a.get(k, 0.0) + cb * b.get(k, 0.0), 0.0)
            for k in keys}


def _lm_cost_fit(arch_id: str, shape_id: str, mesh, kind: str,
                 cfg_overrides=None, dims_overrides=None,
                 device="cuda") -> dict:
    """The step traced at L = 1, 2, extrapolated linearly to full depth
    (the whole step: every microbatch and the optimizer for a train
    cell)."""
    spec = get_arch(arch_id)
    cfg = spec.config_fn(shape_id)
    if cfg_overrides:
        import dataclasses as _dc
        cfg = _dc.replace(cfg, **cfg_overrides)
    n_full = (cfg.n_layers - cfg.first_k_dense) if cfg.moe else cfg.n_layers

    m = {}
    for n in (1, 2):
        cc = build_lm_costing(arch_id, shape_id, mesh, n,
                              cfg_overrides=cfg_overrides,
                              dims_overrides=dims_overrides, device=device)
        m[n] = _metrics(trace_cell(cc, mesh))
    per_layer = _lin(m[2], m[1], 1.0, -1.0)
    base = _lin(m[1], per_layer, 1.0, -1.0)
    total = _lin(base, per_layer, 1.0, float(n_full))
    detail = {"per_layer": per_layer, "base": base,
              "n_layers_extrapolated": n_full}
    if kind == "train":
        dims = dict(get_shape(spec, shape_id).dims)
        if dims_overrides:
            dims.update(dims_overrides)
        detail["n_microbatches"] = dims["n_microbatches"]
        # the optimizer update alone, a part of every layer's and the
        # base's cost (read apart, as the JAX package's fit has it)
        detail["opt"] = _metrics(trace_cell(
            build_opt_costing(arch_id, shape_id, mesh, device=device), mesh))
    detail["total"] = total
    return detail


def _fim_cost_fit(arch_id: str, shape_id: str, mesh, device="cuda") -> dict:
    """Mining-round totals from 1-chunk and 2-chunk rounds,
    extrapolated to the cell's pair count."""
    m = {}
    for n in (1, 2):
        cc = build_fim_costing(arch_id, shape_id, mesh, n, device=device)
        m[n] = _metrics(trace_cell(cc, mesh))
    per_chunk = _lin(m[2], m[1], 1.0, -1.0)
    base = _lin(m[1], per_chunk, 1.0, -1.0)
    pairs = get_shape(get_arch(arch_id), shape_id).dims["pairs"]
    n_chunks = max(pairs // 2048, 1)
    total = _lin(base, per_chunk, 1.0, float(n_chunks))
    return {"per_chunk": per_chunk, "base": base,
            "n_chunks": n_chunks, "total": total}


def _fit_equal(traced: dict, fit: dict) -> bool:
    """The traced totals equal the extrapolation, key by key (both are
    sums of integers held in floats, exact at these magnitudes)."""
    keys = set(traced) | set(fit)
    return all(traced.get(k, 0.0) == fit.get(k, 0.0) for k in keys)


def run_cell(arch_id: str, shape_id: str, mesh, mesh_name: str,
             outdir: str, skip_existing: bool = False,
             device: str = "cuda") -> dict:
    name = f"{mesh_name}__{arch_id}__{shape_id}".replace("/", "_")
    path = os.path.join(outdir, name + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)

    chips = mesh.size()
    rec = {"arch": arch_id, "shape": shape_id, "mesh": mesh_name,
           "chips": chips, "device": device, "ok": False}
    t0 = time.time()
    try:
        cell = build_cell(arch_id, shape_id, mesh, device=device)
        rec["model_params"] = cell.model_params
        rec["active_params"] = cell.active_params
        if cell.skip_reason:
            rec["skip_reason"] = cell.skip_reason
            rec["ok"] = True
        else:
            traced = trace_cell(cell, mesh)
            rec["memory_analysis"] = {
                "argument_size_in_bytes": traced["args_bytes"],
                "temp_size_in_bytes": traced["temp_peak_bytes"]}
            rec["peak_memory_per_chip"] = (traced["args_bytes"]
                                           + traced["temp_peak_bytes"])
            rec["cpu_bf16_shadow_bytes"] = 0
            rec["ops_traced"] = traced["ops"]
            raw = _metrics(traced)
            rec["raw_traced_cost"] = raw
            total = raw
            family = REGISTRY[arch_id].family
            if family == "lm":
                fit = _lm_cost_fit(arch_id, shape_id, mesh, cell.kind,
                                   device=device)
            elif family == "fim":
                fit = _fim_cost_fit(arch_id, shape_id, mesh, device=device)
            else:
                fit = None      # no repeated layers to extrapolate
            if fit is not None:
                rec["cost_fit"] = fit
                rec["fit_equal"] = _fit_equal(raw, fit["total"])
            rec["cost_analysis"] = {"flops": total["flops"],
                                    "bytes accessed": total["bytes"]}
            coll = parse_collectives(traced["collectives"])
            rec["collectives"] = {kind: coll.get(kind, {
                "count": 0, "operand_bytes": 0.0, "link_bytes": 0.0})
                for kind in COLLECTIVE_KINDS}
            rec["collectives"]["total"] = coll["total"]
            tokens = _tokens_per_step(arch_id, shape_id)
            rec["tokens_per_step"] = tokens
            if tokens and cell.active_params:
                rec["model_flops"] = 6.0 * cell.active_params * tokens
            rec["ok"] = rec.get("fit_equal") is not False
            if not rec["ok"]:
                rec["error"] = ("cost fit: the traced totals differ from the "
                                "extrapolation in " + ", ".join(
                                    k for k in sorted(raw) if raw[k] !=
                                    fit["total"].get(k, 0.0)))
    except Exception as e:  # recorded, not fatal — a failed cell is a bug
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["elapsed_s"] = round(time.time() - t0, 1)

    os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _tokens_per_step(arch_id: str, shape_id: str) -> int:
    """Tokens processed per step (train/prefill) or per decode step."""
    spec = get_arch(arch_id)
    if spec.family != "lm":
        return 0
    d = get_shape(spec, shape_id).dims
    if "global_batch" in d:
        return d["global_batch"] * d["seq"]
    if shape_id.startswith("prefill"):
        return d["batch"] * d["seq"]
    return d.get("batch", 0)      # decode: one token per sequence


def fake_world(world_size: int, rank: int = 0) -> None:
    """Initialise the ``"fake"`` process group: ``world_size`` ranks, of
    which this process is ``rank``; collectives return at once."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def _status(rec: dict) -> str:
    if rec.get("skip_reason"):
        return f"SKIP ({rec['skip_reason'][:48]}…)"
    if rec.get("ok"):
        mem = rec.get("peak_memory_per_chip", 0) / 2 ** 30
        fl = rec.get("cost_analysis", {}).get("flops", 0)
        fit = rec.get("fit_equal")
        return (f"OK   mem/chip={mem:7.2f}GiB flops/chip={fl:.3e}"
                + ("" if fit is None else f" fit={'equal' if fit else 'DIFF'}"))
    return "FAIL " + rec.get("error", "?")[:120]


def _run_one_mesh(which: str, cells, args) -> int:
    from repro_torch.launch.mesh import make_production_mesh

    mesh_name, multi, world = MESHES[which]
    fake_world(world)
    mesh = make_production_mesh(multi_pod=multi)
    n_fail = 0
    for arch_id, shape_id in cells:
        t0 = time.time()
        rec = run_cell(arch_id, shape_id, mesh, mesh_name, args.outdir,
                       args.skip_existing, device=args.device)
        n_fail += not rec.get("ok")
        print(f"[{mesh_name}] {arch_id:24s} {shape_id:14s} "
              f"{time.time() - t0:7.1f}s  {_status(rec)}", flush=True)
    return n_fail


def _load(outdir: str) -> dict:
    """``{(mesh, arch, shape): record}`` of the records in ``outdir``."""
    out = {}
    for name in sorted(os.listdir(outdir)):
        if name.endswith(".json"):
            with open(os.path.join(outdir, name)) as f:
                rec = json.load(f)
            if {"mesh", "arch", "shape"} <= set(rec):
                out[(rec["mesh"], rec["arch"], rec["shape"])] = rec
    return out


def _per_chip(rec: dict) -> dict:
    """The compared figures of one record, per chip: FLOPs, argument
    bytes, peak and link bytes by kind.  The peak is the arguments, the
    temporaries and the outputs that alias no argument: XLA's
    temporaries leave the step's outputs out (a prefill's new cache),
    where the port's peak, the most bytes live at once, holds them (its
    records have no output field)."""
    mem = rec.get("memory_analysis", {})
    out = {"flops": rec.get("cost_analysis", {}).get("flops", 0.0),
           "args": mem.get("argument_size_in_bytes", 0),
           "peak": (mem.get("argument_size_in_bytes", 0)
                    + mem.get("temp_size_in_bytes", 0)
                    + mem.get("output_size_in_bytes", 0)
                    - mem.get("alias_size_in_bytes", 0))}
    coll = rec.get("collectives", {})
    for kind in COLLECTIVE_KINDS + ("total",):
        out[f"link {kind}"] = coll.get(kind, {}).get("link_bytes", 0.0)
    return out


def compare(port_dir: str, jax_dir: str) -> list:
    """One row per (mesh, arch, shape) that both dry-runs traced (ok and
    not skipped): each figure of :func:`_per_chip` as ``(port, jax)``."""
    port, ref = _load(port_dir), _load(jax_dir)
    rows = []
    for key in sorted(set(port) & set(ref)):
        a, b = port[key], ref[key]
        if a.get("skip_reason") or b.get("skip_reason") \
                or "memory_analysis" not in a or "memory_analysis" not in b:
            continue
        pa, pb = _per_chip(a), _per_chip(b)
        rows.append({"cell": key, "ok": (a.get("ok"), b.get("ok")),
                     **{k: (pa[k], pb[k]) for k in pa}})
    return rows


def _ratio(a: float, b: float) -> str:
    if b == 0:
        return "=" if a == 0 else "inf"
    return f"{a / b:.3g}"


def format_compare(rows: list) -> str:
    """A markdown table: each figure as ``port / jax (ratio)``, link
    bytes by kind where either side has any."""
    head = ("| mesh | arch | shape | FLOPs | args | peak | link bytes "
            "(total; by kind) |\n|---|---|---|---|---|---|---|")
    lines = [head]
    for r in rows:
        mesh, arch, shape = r["cell"]
        cells = [f"{a:.3g} / {b:.3g} ({_ratio(a, b)})"
                 for a, b in (r[k] for k in ("flops", "args", "peak"))]
        kinds = "; ".join(
            f"{k[5:]} {r[k][0]:.3g} / {r[k][1]:.3g}"
            for k in (f"link {c}" for c in COLLECTIVE_KINDS)
            if r[k][0] or r[k][1])
        a, b = r["link total"]
        link = f"{a:.3g} / {b:.3g} ({_ratio(a, b)})" + (
            f"; {kinds}" if kinds else "")
        lines.append(f"| {mesh} | {arch} | {shape} | " + " | ".join(cells)
                     + f" | {link} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--outdir", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-fim", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the fake tensors live: cuda traces the "
                         "card's path (the custom-op kernels)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in its own process")
    ap.add_argument("--compare", metavar="JAX_OUTDIR", default=None,
                    help="trace nothing: print the records in --outdir "
                         "against a JAX dry-run's, per chip")
    args = ap.parse_args(argv)
    if args.compare:
        print(format_compare(compare(args.outdir, args.compare)))
        return

    cells = all_cells(include_fim=not args.no_fim)
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.jobs > 1 and len(cells) > 1:
        raise SystemExit(_fan_out(cells, meshes, args))
    n_fail = 0
    for which in meshes:
        n_fail += _run_one_mesh(which, cells, args)
    print(f"done; failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


def _fan_out(cells, meshes, args) -> int:
    """Each (mesh, cell) in a process of its own, ``--jobs`` at a time."""
    base = [sys.executable, "-m", "repro_torch.launch.dryrun",
            "--outdir", args.outdir, "--device", args.device]
    if args.skip_existing:
        base.append("--skip-existing")
    todo = [(w, a, s) for w in meshes for a, s in cells]
    running, n_fail = [], 0
    while todo or running:
        while todo and len(running) < args.jobs:
            w, a, s = todo.pop(0)
            running.append(subprocess.Popen(
                base + ["--mesh", w, "--arch", a, "--shape", s]))
        time.sleep(0.2)
        for p in [p for p in running if p.poll() is not None]:
            n_fail += p.returncode != 0
            running.remove(p)
    print(f"done; failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    main()
