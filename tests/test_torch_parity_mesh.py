"""The port's sharded programs held against one rank and against the JAX
package's, for the mesh paths that follow XLA's placement: GraphSAGE's
segment sums (full batch) and sampled means, the MoE decode step whose
experts keep their FSDP ``embed`` shard, the decode step whose kv heads
do not cover the model axis, and the two-tower loss whose (B, B)
backward is split over ``model``.

Each path runs in gloo worlds of 2 and 4 ranks against the same step on
one rank (every job of this file in one world of each size).  Each
repaired dry-run cell is traced on a fake 4x4 world (1x16 where the kv
heads must not divide the model axis) and held against the JAX program
of the same cell on 16 XLA host devices, both in subprocesses started
at once.  JAX's collectives are read twice: as its dry-run records them
(``repro.roofline.hlo.parse_collectives``) and with the HLO's
``/*index=N*/`` comments stripped first; the parser skips every
collective whose tuple of operands holds such a comment (it holds an
``=``), so the recorded links of the train cells miss their largest
all-reduce (``PERF.md`` §6).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.launch.forcedevices import run_ranks

import torch_analysis_ranks as ranks

RANK_TIMEOUT_S = 300.0
SUB_TIMEOUT_S = 600
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="src")

# (arch, shape, mesh shape) of each repaired cell
CELLS = [("graphsage-reddit", "molecule", (4, 4)),
         ("graphsage-reddit", "full_graph_sm", (4, 4)),
         ("graphsage-reddit", "minibatch_lg", (4, 4)),
         ("graphsage-reddit", "ogb_products", (4, 4)),
         ("mixtral-8x22b", "long_500k", (4, 4)),
         ("granite-3-8b", "decode_32k", (1, 16)),
         ("two-tower-retrieval", "train_batch", (4, 4)),
         ("xdeepfm", "train_batch", (4, 4))]


# ---------------------------------------------------------------------------
# the fake world and the JAX programs, two subprocesses run at once
# ---------------------------------------------------------------------------

# Each script reads ``{"cells", "outdir"}`` as JSON from its first
# argument and prints one JSON object, ``{"arch/shape": figures}``, a
# cell that raised giving ``{"error": traceback}``.
PORT = """
    import json, sys, traceback
    sys.path.insert(0, "src")
    ARG = json.loads(sys.argv[1])
    from repro_torch.launch.dryrun import _per_chip, fake_world, run_cell
    fake_world(16)
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    for arch, shape, m in ARG["cells"]:
        try:
            rec = run_cell(arch, shape, make_host_mesh(tuple(m)), "t",
                           ARG["outdir"], device="cpu")
            assert rec["ok"], rec.get("error")
            out[arch + "/" + shape] = {
                **_per_chip(rec),
                "per_layer": rec.get("cost_fit", {}).get("per_layer")}
        except Exception:
            out[arch + "/" + shape] = {"error": traceback.format_exc()}
    print(json.dumps(out))
"""

JAX = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    import json, re, sys, traceback
    sys.path.insert(0, "src")
    ARG = json.loads(sys.argv[1])
    import jax
    assert len(jax.devices()) == 16
    from repro.compat import make_mesh
    from repro.launch import dryrun
    from repro.launch.cells import build_cell, lower_cell
    from repro.roofline.hlo import parse_collectives

    def peak(mem):
        return (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                + mem.get("output_size_in_bytes", 0)
                - mem.get("alias_size_in_bytes", 0))

    out = {}
    for arch, shape, m in ARG["cells"]:
        try:
            mesh = make_mesh(tuple(m), ("data", "model"))
            if arch in ("mixtral-8x22b", "granite-3-8b"):
                rec = dryrun.run_cell(arch, shape, mesh, "t", ARG["outdir"])
                out[arch + "/" + shape] = {
                    "flops": rec["cost_analysis"]["flops"],
                    "peak": peak(rec["memory_analysis"]),
                    "link": rec["collectives"]["total"]["link_bytes"],
                    "per_layer": rec["cost_fit"]["per_layer"]}
                continue
            comp = lower_cell(build_cell(arch, shape, mesh), mesh).compile()
            cost = comp.cost_analysis()
            cost = cost[0] if isinstance(cost, (list, tuple)) else cost
            mem = comp.memory_analysis()
            txt = comp.as_text()
            out[arch + "/" + shape] = {
                "flops": cost["flops"],
                "peak": peak({k: getattr(mem, k) for k in (
                    "argument_size_in_bytes", "temp_size_in_bytes",
                    "output_size_in_bytes", "alias_size_in_bytes")}),
                "link": parse_collectives(txt)["total"]["link_bytes"],
                "link_stripped": parse_collectives(re.sub(
                    r"/\\*index=\\d+\\*/", "", txt))["total"]["link_bytes"]}
        except Exception:
            out[arch + "/" + shape] = {"error": traceback.format_exc()}
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The port's fake world and the JAX package on 16 XLA host devices,
    each in a subprocess, both started at once: ``{process: (Popen,
    stdout file, stderr file)}``."""
    d = tmp_path_factory.mktemp("parity_mesh")
    arg = json.dumps({"cells": [[a, s, list(m)] for a, s, m in CELLS],
                      "outdir": str(d / "records")})
    got = {}
    try:
        for name, script in (("port", PORT), ("jax", JAX)):
            out, err = (open(d / f"{name}.{k}", "w+") for k in ("out", "err"))
            got[name] = (subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(script), arg],
                stdout=out, stderr=err, text=True, cwd=".", env=ENV),
                out, err)
        yield got
    finally:
        for proc, out, err in got.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()


@pytest.fixture(scope="module")
def records(started, gloo):
    """``{process: {"arch/shape": figures}}``, waited for after the gloo
    worlds (which run meanwhile)."""
    got = {}
    for name, (proc, out, err) in started.items():
        rc = proc.wait(timeout=SUB_TIMEOUT_S)
        out.seek(0)
        err.seek(0)
        assert rc == 0, f"{name}: {err.read()[-4000:]}"
        got[name] = json.loads(out.read().strip().splitlines()[-1])
    return got


# ---------------------------------------------------------------------------
# the gloo worlds
# ---------------------------------------------------------------------------

GNN_SHAPES = [(1, 2), (2, 1), (2, 2), (1, 4)]
MOE_SHAPES = [(2, 1), (1, 2), (2, 2), (4, 1)]
KV_SHAPES = [((1, 2), {"n_kv_heads": 1}), ((1, 4), {})]
TWOTOWER_SHAPES = [(1, 2), (2, 2), (1, 4)]


def _graph(seed=0, N=24, E=70, F=24, C=5):
    """A random graph at the smoke config's widths: 24 nodes, 70 edges
    (duplicates and self loops among them), 5 classes."""
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((N, F)),
            "edge_src": rng.integers(0, N, E).astype(np.int32),
            "edge_dst": rng.integers(0, N, E).astype(np.int32),
            "labels": rng.integers(0, C, N).astype(np.int32),
            "mask": rng.random(N) < 0.7}


def _blocks(seed=1, B=8, f1=3, f2=2, F=24, C=5):
    """Random sampled blocks (B, f1, f2) with some samples masked out."""
    rng = np.random.default_rng(seed)
    return {"x_root": rng.standard_normal((B, F)),
            "x_h1": rng.standard_normal((B, f1, F)),
            "x_h2": rng.standard_normal((B, f1, f2, F)),
            "m1": rng.random((B, f1)) < 0.8,
            "m2": rng.random((B, f1, f2)) < 0.8,
            "labels": rng.integers(0, C, B).astype(np.int32)}


def _twotower_batch(seed=8, B=8):
    from repro_torch.configs import get_arch

    cfg = get_arch("two-tower-retrieval").smoke_config_fn()
    rng = np.random.default_rng(seed)
    return {"user_id": rng.integers(0, cfg.n_users, B).astype(np.int32),
            "hist_ids": rng.integers(0, cfg.n_items, (B, cfg.n_user_hist)
                                     ).astype(np.int32),
            "hist_mask": rng.random((B, cfg.n_user_hist)) < 0.7,
            "pos_item": rng.integers(0, cfg.n_items, B).astype(np.int32),
            "item_logq": rng.standard_normal(B).astype(np.float32)}


def _prompt(seed, B):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 500, (B, 6)).astype(np.int32),
            rng.integers(0, 500, B).astype(np.int32))


@pytest.fixture(scope="module")
def gloo(started):
    """``{job: [each rank's result]}``: ``ranks.jobs`` runs each job of a
    world in turn, while :func:`started`'s subprocesses run."""
    todo = {2: [], 4: []}

    def add(name, fn, shape, *args):
        todo[shape[0] * shape[1]].append((name, fn, (*args,)))
    for shape in GNN_SHAPES:
        add(f"full{shape}", "gnn_loss_on_mesh", shape, shape, 0, "full",
            _graph())
        add(f"sampled{shape}", "gnn_loss_on_mesh", shape, shape, 0,
            "sampled", _blocks())
    for shape in MOE_SHAPES:
        add(f"moe{shape}", "lm_decode_on_mesh", shape, shape,
            "mixtral-8x22b", 4, *_prompt(3, 1))
    for shape, over in KV_SHAPES:
        add(f"kv{shape}", "lm_decode_on_mesh", shape, shape, "granite-3-8b",
            5, *_prompt(4, 4), over)
    for shape in TWOTOWER_SHAPES:
        add(f"twotower{shape}", "twotower_grads_on_mesh", shape, shape, 9,
            _twotower_batch())
    out = {}
    for world, jobs in todo.items():
        for per_rank in run_ranks(ranks.jobs, world, (jobs,),
                                  timeout_s=RANK_TIMEOUT_S):
            for name, got in per_rank.items():
                out.setdefault(name, []).append(got)
    return out


def _ranks(gloo, job):
    for got in gloo[job]:
        assert not isinstance(got, str), got
    return gloo[job]


def _close(got, want, tol=1e-5):
    """Within ``tol`` of ``want``'s largest entry (at least 1)."""
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("kind", ["full", "sampled"])
@pytest.mark.parametrize("shape", GNN_SHAPES)
def test_gnn_loss_on_a_mesh_equals_one_rank(gloo, kind, shape):
    """GraphSAGE's smoke config (float64) with its weights and batch
    placed as the dry-run's cells place them: the full-batch loss (edges
    over ``data``; the first layer's rows laid out over ``model``, the
    second's hidden columns kept there) or the sampled one (the means
    per rank), and every weight's gradient, within 1e-5 of one rank's."""
    for names, plain, got in _ranks(gloo, f"{kind}{shape}"):
        assert len(got) == len(plain) == len(names) + 1
        for g, w in zip(got, plain, strict=True):
            _close(g, w)


@pytest.mark.parametrize("shape", MOE_SHAPES)
def test_moe_decode_on_a_mesh_equals_plain(gloo, shape):
    """mixtral's smoke config (fp32), one sequence: a decode step after
    a plain prefill with mixtral's rules (``embed`` over ``data``, the
    experts' hidden over ``model``) and the batch whole, so the experts
    and the attention weights keep their ``embed`` shard and only the
    token's partial products cross ranks: the logits and the cache
    within 1e-5 of the plain step."""
    for plain, got in _ranks(gloo, f"moe{shape}"):
        for g, w in zip(got, plain, strict=True):
            _close(g, w)


@pytest.mark.parametrize("shape,overrides", KV_SHAPES)
def test_uneven_kv_decode_on_a_mesh_equals_plain(gloo, shape, overrides):
    """granite's smoke config (fp32; one kv head on a model axis of 2,
    two on one of 4): the kv heads do not cover the model axis, so the
    cache's sequence and the kv weights' head_dim go over it, and the
    kv projections run per rank on the weights' head_dim shards: the
    logits and the cache within 1e-5 of the plain step."""
    for plain, got in _ranks(gloo, f"kv{shape}"):
        for g, w in zip(got, plain, strict=True):
            _close(g, w)


@pytest.mark.parametrize("shape", TWOTOWER_SHAPES)
def test_twotower_gradients_on_a_mesh_equal_one_rank(gloo, shape):
    """The two-tower in-batch softmax with the (B, B) backward split over
    ``model``: the loss and every weight's gradient (both tables, both
    towers) within 1e-5 of one rank's."""
    for names, plain, got in _ranks(gloo, f"twotower{shape}"):
        assert len(got) == len(names) + 1
        for g, w in zip(got, plain, strict=True):
            _close(g, w)


# ---------------------------------------------------------------------------
# the repaired cells against the JAX programs
# ---------------------------------------------------------------------------

def _within(a, b):
    return 0.5 <= a / b <= 2.0


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_repaired_cell_against_the_jax_program(records, arch, shape, mesh):
    """Per chip, the port's fake-world record against the JAX program of
    the same cell: FLOPs, peak and link bytes within [0.5, 2] of JAX's,
    the links against JAX's collectives with the HLO's comments
    stripped; where ``PERF.md`` §6 gives a J verdict, the relation its
    hand count states instead."""
    key = f"{arch}/{shape}"
    got, want = records["port"][key], records["jax"][key]
    assert "error" not in got, got.get("error")
    assert "error" not in want, want.get("error")
    port = got
    if arch in ("graphsage-reddit", "two-tower-retrieval", "xdeepfm"):
        assert _within(port["flops"], want["flops"])
        assert _within(port["peak"], want["peak"])
        assert _within(port["link total"], want["link_stripped"])
        if arch != "graphsage-reddit":
            # J: the recorded count drops the tuple all-reduce of the
            # weights' gradients (the tables' shards, the CIN's)
            assert want["link"] < want["link_stripped"] / 2
        return
    layer, jlayer = got["per_layer"], want["per_layer"]
    if arch == "mixtral-8x22b":
        assert _within(port["flops"], want["flops"])
        # the experts keep their embed shard: nothing near one expert
        # weight's shard (8 x 1536 x 4096 bf16) is gathered, and the up
        # projections' partial products (8 experts x 4 slots x 4096,
        # gate in fp32 for the SiLU, up in bf16) are reduce-scattered
        assert layer["coll_all-gather_link_bytes"] < 8 * 1536 * 4096 * 2 / 100
        assert layer["coll_reduce-scatter_link_bytes"] == 8 * 4 * 4096 * 6
    else:
        # the step's dots a chip (batch 128, 16 model ranks): q, k and v
        # projections on head_dim shards, attention over 2048 cache
        # slots, the output projection and the MLP; JAX's per-layer
        # count is above its own dots (J)
        B, d, Hl, KVl, S, ff = 128, 4096, 256, 64, 2048, 800
        dots = (2 * B * d * Hl + 2 * 2 * B * d * KVl + 4 * B * 32 * 128 * S
                + 2 * B * Hl * d + 3 * 2 * B * d * ff)
        assert layer["flops"] == dots <= jlayer["flops"]
        # the kv weights' head_dim shards (4096 x 8 x 8 bf16) stay put
        assert layer["coll_all-gather_link_bytes"] < 4096 * 8 * 8 * 2
    assert sum(v for k, v in layer.items() if k.endswith("_link_bytes")) \
        <= sum(v for k, v in jlayer.items() if k.endswith("_link_bytes"))
