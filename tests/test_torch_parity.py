"""The port's dry-run records held against the JAX package's, cell by
cell, on the CPU: every cell's argument bytes per rank on a fake 4x4
world against the sum of JAX's ``NamedSharding.shard_shape`` bytes over
``repro.launch.cells.build_cell``'s arguments (the optimizer state of
the train cells included); the row-sharded EmbeddingBag (values and
gradients) in gloo worlds of 2 and 4 ranks against one rank's and the
JAX ``embedding_bag``; two-tower ``serve_p99`` on a fake 4x4 world
against the JAX dry-run of the same cell on 16 XLA host devices;
Adafactor's bytes linear in the depth of a stacked leaf, and an
Adafactor arch's cost fit; the two-tower hillclimb's int8 index step on
a fake world and in a gloo world; the mesh paths the parity repairs
added (decode over a sequence-sharded cache, query heads grouped over
a model axis the kv heads do not divide, the LM and two-tower losses'
label entries per shard) in gloo worlds against one rank; and what XLA
and the port charge a gather.

Every fake world and every JAX program on more than one device runs in
a subprocess, the three of them at once; the gloo jobs run in one world
of 2 ranks and one of 4.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import recsys as jrecsys

from repro_torch.launch.forcedevices import run_ranks
from repro_torch.models.recsys import ParamTree, embedding_bag
from repro_torch.roofline.counters import StepCounter
from repro_torch.train.optimizer import OptConfig, opt_init

import torch_analysis_ranks as ranks

RANK_TIMEOUT_S = 300.0
SUB_TIMEOUT_S = 600
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="src")

CELLS = [c for c in jconfigs.all_cells(True)
         if not jconfigs.get_arch(c[0]).skip_reason(c[1])]


# ---------------------------------------------------------------------------
# the fake worlds and the JAX programs, three subprocesses run at once
# ---------------------------------------------------------------------------

# Each script reads ``{"cells", "outdir"}`` as JSON from its first
# argument and prints one JSON object of its parts, a part that raised
# giving ``{"error": traceback}``.
PARTS = """
    import json, sys, traceback

    def run_parts(parts):
        out = {}
        for name, fn in parts:
            try:
                out[name] = fn()
            except Exception:
                out[name] = {"error": traceback.format_exc()}
        print(json.dumps(out, default=str))
"""

PORT = PARTS + """
    sys.path.insert(0, "src")
    ARG = json.loads(sys.argv[1])
    from repro_torch.launch.dryrun import fake_world, run_cell
    fake_world(16)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed.sharding import active_mesh, use_rules
    from repro_torch.launch.cells import _local_bytes, args_on_mesh, build_cell
    from repro_torch.launch.hillclimb import climb_twotower
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh((4, 4))

    def args():
        out = {}
        for arch, shape in ARG["cells"]:
            cell = build_cell(arch, shape, mesh, device="cpu")
            with cell.fake_mode, use_rules(cell.rules), active_mesh(mesh), \\
                    implicit_replication():
                out[arch + "/" + shape] = _local_bytes(args_on_mesh(cell,
                                                                    mesh))
        return out

    def serve():
        return run_cell("two-tower-retrieval", "serve_p99", mesh, "test4x4",
                        ARG["outdir"], device="cpu")

    def hillclimb():
        results = []
        climb_twotower(mesh, "test4x4", results, device="cpu")
        return results

    run_parts((("args", args), ("serve", serve), ("hillclimb", hillclimb)))
"""

JAX = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
""" + PARTS + """
    import math
    sys.path.insert(0, "src")
    ARG = json.loads(sys.argv[1])
    import jax
    from repro.compat import make_mesh
    from repro.launch.cells import build_cell, lower_cell
    from repro.roofline.hlo import parse_collectives
    mesh = make_mesh((4, 4), ("data", "model"))

    def args():
        out = {}
        for arch, shape in ARG["cells"]:
            cell = build_cell(arch, shape, mesh)
            sizes = jax.tree.map(
                lambda a, s: math.prod(s.shard_shape(a.shape))
                * a.dtype.itemsize, cell.abstract_args, cell.in_shardings)
            out[arch + "/" + shape] = int(sum(jax.tree.leaves(sizes)))
        return out

    def serve():
        comp = lower_cell(build_cell("two-tower-retrieval", "serve_p99",
                                     mesh), mesh).compile()
        mem = comp.memory_analysis()
        return {"args": mem.argument_size_in_bytes,
                "temp": mem.temp_size_in_bytes,
                "coll": parse_collectives(comp.as_text())}

    run_parts((("args", args), ("serve", serve)))
"""

ADAFACTOR_FIT = PARTS + """
    import dataclasses
    sys.path.insert(0, "src")
    ARG = json.loads(sys.argv[1])
    from repro_torch.launch.dryrun import fake_world, run_cell
    fake_world(16)
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    arch = "command-r-plus-104b"
    spec = configs.REGISTRY[arch]
    full = spec.config_fn
    configs.REGISTRY[arch] = dataclasses.replace(
        spec, config_fn=lambda s=None: dataclasses.replace(
            full(s), n_layers=3))
    lm = configs.FAMILY_SHAPES["lm"]
    lm["train_4k"] = dataclasses.replace(lm["train_4k"], dims=dict(
        lm["train_4k"].dims, global_batch=16, n_microbatches=2))

    def fit():
        return run_cell(arch, "train_4k", make_host_mesh((4, 4)), "test4x4",
                        ARG["outdir"], device="cpu")

    run_parts((("fit", fit),))
"""


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The port's fake 4x4 world (every cell's argument bytes, two-tower
    ``serve_p99``'s record, the two-tower hillclimb), the JAX package on
    16 XLA host devices (the argument bytes, ``serve_p99`` compiled) and
    the Adafactor fit, each in a subprocess of its own, all started at
    once: ``{process: (Popen, stdout file, stderr file)}``."""
    d = tmp_path_factory.mktemp("parity")
    arg = json.dumps({"cells": [list(c) for c in CELLS],
                      "outdir": str(d / "records")})
    got = {}
    try:
        for name, script in (("port", PORT), ("jax", JAX),
                             ("adafactor", ADAFACTOR_FIT)):
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
def procs(started, gloo):
    """``{process: {part: result}}`` of :func:`started`'s subprocesses,
    waited for after the gloo worlds (which run meanwhile)."""
    got = {}
    for name, (proc, out, err) in started.items():
        rc = proc.wait(timeout=SUB_TIMEOUT_S)
        out.seek(0)
        err.seek(0)
        assert rc == 0, f"{name}: {err.read()[-4000:]}"
        got[name] = json.loads(out.read().strip().splitlines()[-1])
    return got


def _part(procs, proc, part):
    got = procs[proc][part]
    assert not (isinstance(got, dict) and "error" in got), got["error"]
    return got


# ---------------------------------------------------------------------------
# argument bytes per rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id,shape_id", CELLS)
def test_argument_bytes_per_rank_equal_jax(procs, arch_id, shape_id):
    """``argument_size_in_bytes``'s meaning: the parameters, the train
    cells' optimizer state (``opt_a``, its int32 step included), the
    batch or cache, each rank's shard of each, against the sum of JAX's
    ``NamedSharding.shard_shape`` bytes over ``build_cell``'s
    arguments."""
    got, want = _part(procs, "port", "args"), _part(procs, "jax", "args")
    key = f"{arch_id}/{shape_id}"
    assert got[key] == want[key] > 0


# ---------------------------------------------------------------------------
# the gloo worlds: every job of this file in one world of 2 ranks and one
# of 4
# ---------------------------------------------------------------------------

BAG_SHAPES = [(1, 2), (1, 4), (2, 2)]
DECODES = [((1, 2), 0), ((2, 2), 0), ((1, 4), 8)]
LOSS_SHAPES = [(1, 2), (2, 2)]
ATTENTIONS = [((1, 4), "chunked"), ((2, 2), "chunked"), ((1, 4), "flash")]
INT8_SHAPE, INT8_SHORTLIST, INT8_TOPK = (2, 2), 32, 10


@pytest.fixture(scope="module")
def gloo(started):
    """``{job: [each rank's result]}``: ``ranks.jobs`` runs each job of a
    world in turn, while :func:`started`'s subprocesses run."""
    todo = {2: [], 4: []}

    def add(name, fn, shape, *args):
        todo[shape[0] * shape[1]].append((name, fn, (*args,)))
    for shape in BAG_SHAPES:
        add(f"bag{shape}", "row_sharded_bags", shape, *_bag_inputs(2), shape)
    for shape, window in DECODES:
        add(f"decode{shape}{window}", "seq_sharded_decode", shape, shape, 4,
            window)
    for shape in LOSS_SHAPES:
        add(f"lm{shape}", "lm_loss_on_mesh", shape, shape, "qwen1.5-0.5b", 2,
            *_lm_inputs())
        add(f"twotower{shape}", "twotower_loss_on_mesh", shape, shape, 9,
            _twotower_batch())
    for shape, attention in ATTENTIONS:
        add(f"attend{shape}{attention}", "grouped_attention", shape, shape, 7,
            attention)
    add("int8", "int8_index_ids", INT8_SHAPE, INT8_SHAPE, 3, _int8_batch(),
        INT8_SHORTLIST, INT8_TOPK)
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


# ---------------------------------------------------------------------------
# the row-sharded bag
# ---------------------------------------------------------------------------

def _bag_inputs(seed=0, V=40, D=8, B=8, L=6):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    mask = rng.random((B, L)) < 0.6
    mask[1] = False                      # an empty bag
    mask[4, :] = True                    # a full one
    return table, ids, mask


def _plain_bags(table, ids, mask):
    """Each combiner's bags, and the table's gradient of a weighted sum
    of the sum and mean bags (the rank bodies' ``w``), on one rank."""
    p = ParamTree({"table": torch.from_numpy(table)}, trainable=True)
    out = {}
    for c in ("sum", "mean", "max"):
        bag = embedding_bag(p, torch.from_numpy(ids), torch.from_numpy(mask),
                            c)
        out[c] = bag.detach().numpy()
        if c != "max":
            w = torch.arange(bag.shape[-1], dtype=torch.float32)
            (g,) = torch.autograd.grad((bag * w).sum(), [p.table])
            out[c + " grad"] = g.numpy()
    return out


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_plain_bag_equals_jax_embedding_bag(combiner):
    table, ids, mask = _bag_inputs(1)
    got = _plain_bags(table, ids, mask)[combiner]
    want = np.asarray(jrecsys.embedding_bag(
        {"table": jnp.asarray(table)}, jnp.asarray(ids),
        jnp.asarray(mask), combiner))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", BAG_SHAPES)
def test_row_sharded_bag_in_gloo_worlds_equals_one_rank(gloo, shape):
    """The table row-sharded over ``model`` (2 or 4 ways), the bags over
    ``data``: sum, mean and max, empty bags and masked slots included,
    and the table's gradient through sum and mean, within 1e-6 of one
    rank's, on every rank."""
    table, ids, mask = _bag_inputs(2)
    want = _plain_bags(table, ids, mask)
    assert (want["max"][1] == np.finfo(np.float32).min).all()
    for got in _ranks(gloo, f"bag{shape}"):
        for c in want:
            np.testing.assert_allclose(got[c], want[c], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# two-tower serve_p99 against the JAX dry-run of the cell
# ---------------------------------------------------------------------------

def test_twotower_serve_p99_against_the_jax_dry_run(procs):
    """On 4x4: the arguments equal, the peak within 1.5x of JAX's, no
    rank holding more of the item table than its rows.  The links carry
    three all-reduces of each data shard's (128, 256) fp32 partial sums
    (the user and item lookups, the history bag); JAX's carry the bag's
    gathered (128, 50, 256) rows instead of their sums (``PERF.md`` §6,
    ROADMAP Queue 3): the port's are the smaller."""
    got = _part(procs, "port", "serve")
    want = _part(procs, "jax", "serve")
    assert got["ok"], got.get("error")
    mem = got["memory_analysis"]
    assert mem["argument_size_in_bytes"] == want["args"]
    peak = got["peak_memory_per_chip"]
    assert peak <= 1.5 * (want["args"] + want["temp"])
    assert peak >= (want["args"] + want["temp"]) / 1.5
    cfg = jconfigs.get_arch("two-tower-retrieval").config_fn()
    table = cfg.n_items * cfg.embed_dim * 4
    assert mem["temp_size_in_bytes"] < table / 4      # 4 row shards
    rows = 512 // 4 * cfg.embed_dim * 4
    link = got["collectives"]["total"]["link_bytes"]
    assert got["collectives"]["all-reduce"]["count"] == 3
    assert link == 3 * 2 * rows
    jlink = want["coll"]["total"]["link_bytes"]
    assert jlink == 2 * (2 * rows + rows * cfg.n_user_hist)
    assert link < jlink


# ---------------------------------------------------------------------------
# Adafactor: linear in depth, and the cost fit of an Adafactor arch
# ---------------------------------------------------------------------------

def _adafactor_step(n_layers, part_shape):
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(part_shape, generator=g) for _ in range(n_layers)]
    grads = [torch.randn(part_shape, generator=g) for _ in range(n_layers)]
    opt = opt_init([("dense_layers/w", parts, True)],
                   OptConfig(kind="adafactor", lr=1e-2))
    counter = StepCounter()
    counter.hold(parts + grads + [t for st in opt.state.values()
                                  for t in st["v"].values()])
    with counter:
        opt.step(grads=grads)
    return counter.bytes, counter.flops, counter.ops


@pytest.mark.parametrize("part_shape", [(6, 10), (12,), (2, 3, 5)])
def test_adafactor_step_is_linear_in_the_stack_depth(part_shape):
    """The bytes, FLOPs and op count of one update of a stacked leaf at
    L = 1, 2, 3: every layer moves what the others do (the one-layer
    stack is no cheaper than linear)."""
    b1, b2, b3 = (_adafactor_step(n, part_shape) for n in (1, 2, 3))
    for i in range(3):
        assert b3[i] - b2[i] == b2[i] - b1[i]


def test_adafactor_cell_fits_on_a_fake_world(procs):
    """command-r-plus-104b ``train_4k`` (Adafactor) at 3 of 64 layers, a
    global batch of 16 in 2 microbatches (of 256 in 8), on a fake 4x4
    world: the traced totals equal the L = 1, 2 fit."""
    rec = _part(procs, "adafactor", "fit")
    assert rec["ok"], rec.get("error")
    assert rec["fit_equal"] is True, rec["cost_fit"]["total"]
    assert rec["cost_fit"]["n_layers_extrapolated"] == 3


# ---------------------------------------------------------------------------
# the two-tower hillclimb's int8 index step
# ---------------------------------------------------------------------------

def test_twotower_hillclimb_runs_every_variant_on_a_fake_world(procs):
    results = _part(procs, "port", "hillclimb")
    assert len(results) == 4, results
    assert all("error" not in r for r in results), results


def _int8_batch():
    from repro_torch.configs import get_arch

    cfg = get_arch("two-tower-retrieval").smoke_config_fn()
    rng = np.random.default_rng(5)
    C = 256
    return {"user_id": np.array([7], np.int32),
            "hist_ids": rng.integers(0, cfg.n_items, (1, cfg.n_user_hist)
                                     ).astype(np.int32),
            "hist_mask": rng.random((1, cfg.n_user_hist)) < 0.7,
            "q8": rng.integers(-127, 128, (C, cfg.embed_dim)
                               ).astype(np.int8),
            "scale": (rng.random(C) + 0.5).astype(np.float32)}


def test_int8_index_step_in_a_gloo_world_equals_one_device(gloo):
    """The int8 variant's ids (a shortlist from ``topk`` over the
    candidate-sharded screen, looked up in the row-sharded item table) on
    a (2, 2) gloo world equal the plain one-device step's."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.hillclimb import index_int8_step
    from repro_torch.models.recsys import twotower_init

    cfg = get_arch("two-tower-retrieval").smoke_config_fn()
    batch = _int8_batch()
    model = twotower_init(cfg, seed=3, device="cpu")
    vals, ids = index_int8_step(cfg, INT8_SHORTLIST, INT8_TOPK)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    for got_vals, got_ids in _ranks(gloo, "int8"):
        assert np.array_equal(got_ids, ids.numpy())
        np.testing.assert_allclose(got_vals, vals.numpy(), rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# decode over a sequence-sharded cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,window", DECODES)
def test_seq_sharded_decode_equals_plain(gloo, shape, window):
    """``gqa_decode`` with the cache's sequence sharded over ``model`` (the
    rule the decode cells take when kv heads do not cover the model
    axis; a ring with ``window``): the output within 1e-5 of the plain
    step, and the cache written at the same slot, on every rank."""
    for plain, got in _ranks(gloo, f"decode{shape}{window}"):
        np.testing.assert_allclose(got[0], plain[0], rtol=0, atol=1e-5)
        for g, w in zip(got[1:], plain[1:], strict=True):
            assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# the LM loss's label logit on a vocab-sharded mesh
# ---------------------------------------------------------------------------

def _lm_inputs():
    from repro_torch.configs import get_arch

    cfg = get_arch("qwen1.5-0.5b").smoke_config_fn()
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    labels[0, :3] = -1
    return tokens, labels


@pytest.mark.parametrize("shape", LOSS_SHAPES)
def test_lm_loss_on_a_vocab_sharded_mesh_equals_plain(gloo, shape):
    """qwen1.5's smoke LM in fp32 with the vocab over ``model``: the loss
    (its label logit taken per vocab shard) and the embedding table's
    gradient within 1e-5 of the plain step, some labels masked."""
    for plain, got in _ranks(gloo, f"lm{shape}"):
        np.testing.assert_allclose(got[0], plain[0], rtol=0, atol=1e-5)
        scale = np.abs(plain[1]).max()
        np.testing.assert_allclose(got[1], plain[1], rtol=0,
                                   atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# what a gather is charged
# ---------------------------------------------------------------------------

def test_a_gather_is_charged_its_whole_table_by_xla_and_the_port():
    """``bytes accessed`` of ``jnp.take`` of 4096 rows of a (1M, 256) fp32
    table counts the whole table (1.024e9 B) as XLA compiles it on the
    CPU, and the port's unfused count of ``index_select`` does the same:
    charging a gather its rows read is a question for the benchmark's
    count, not a difference between the two."""
    import jax

    table = jax.ShapeDtypeStruct((1_000_000, 256), jnp.float32)
    ids = jax.ShapeDtypeStruct((4096,), jnp.int32)
    cost = jax.jit(lambda t, i: jnp.take(t, i, axis=0)).lower(
        table, ids).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    table_bytes = 1_000_000 * 256 * 4
    assert cost["bytes accessed"] >= table_bytes
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        t = torch.empty(1_000_000, 256)
        i = torch.zeros(4096, dtype=torch.int64)
        counter = StepCounter()
        counter.hold([t, i])
        with counter:
            t.index_select(0, i)
    assert counter.bytes == table_bytes + 4096 * 8 + 4096 * 256 * 4


# ---------------------------------------------------------------------------
# attention with fewer kv heads than the model axis has ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,attention", ATTENTIONS)
def test_grouped_attention_on_a_mesh_equals_plain(gloo, shape, attention):
    """8 query heads over 2 kv heads.  On a model axis of 4 each rank
    attends its 2 query heads with the kv head they group into (no rank
    repeats another's heads); on one of 2 both head counts divide it.
    The output and the gradients of q, k and v within 1e-5 of the plain
    step."""
    for plain, got in _ranks(gloo, f"attend{shape}{attention}"):
        for g, w in zip(got, plain, strict=True):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def _twotower_batch():
    from repro_torch.configs import get_arch

    cfg = get_arch("two-tower-retrieval").smoke_config_fn()
    rng = np.random.default_rng(8)
    B = 8
    return {"user_id": rng.integers(0, cfg.n_users, B).astype(np.int32),
            "hist_ids": rng.integers(0, cfg.n_items, (B, cfg.n_user_hist)
                                     ).astype(np.int32),
            "hist_mask": rng.random((B, cfg.n_user_hist)) < 0.7,
            "pos_item": rng.integers(0, cfg.n_items, B).astype(np.int32),
            "item_logq": rng.standard_normal(B).astype(np.float32)}


@pytest.mark.parametrize("shape", LOSS_SHAPES)
def test_twotower_loss_on_a_mesh_equals_plain(gloo, shape):
    """The two-tower in-batch softmax with its tables row-sharded and the
    batch over ``data`` (the history bag per row shard, the items
    gathered for the logits, each rank's label entries from its own
    rows): the loss and the item table's gradient within 1e-5 of the
    plain step."""
    for plain, got in _ranks(gloo, f"twotower{shape}"):
        np.testing.assert_allclose(got[0], plain[0], rtol=0, atol=1e-5)
        scale = np.abs(plain[1]).max()
        np.testing.assert_allclose(got[1], plain[1], rtol=0,
                                   atol=1e-5 * scale)
