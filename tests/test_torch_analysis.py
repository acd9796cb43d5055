"""The port's analysis tooling held against the JAX package's, on the CPU:
the cell registry (``configs``: ``FIM_SHAPES``, the fim ``SPEC``,
``all_cells``, ``skip_reason``), the cells' parameter and token counts
(``launch.cells`` against ``repro.launch.cells.build_cell`` on a 1x1
mesh), the roofline terms and table (``roofline.analysis`` under the
JAX package's TPU v5e constants), the mining round programs
(``core.distributed.make_mining_round`` / ``_v2``: bit-equal on one rank
and, in gloo worlds of 2 and 4 ranks, to the sum over shards of the JAX
1x1 round), the round's collective bytes (``roofline.comms`` on a fake
4-rank world against ``parse_collectives`` on 4 XLA host devices), the
dry-run (``launch.dryrun.run_cell`` on fake 4x4 and 256-rank worlds) and
the two custom ops' shape functions and FLOP formulas.

Each fake world runs in a subprocess, and the in-process one-rank gloo
world is a module fixture that destroys its group: no default group
outlives this file.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.compat import make_mesh
from repro.configs import fim_eclat as jfim
from repro.core import distributed as jdist
from repro.core.bitmap import popcount32_np
from repro.launch import cells as jcells
from repro.roofline import analysis as janalysis

from repro_torch import configs as tconfigs
from repro_torch.configs import fim_eclat as tfim
from repro_torch.core.distributed import (make_mining_round,
                                          make_mining_round_v2)
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as R
from repro_torch.kernels import segment_embed as SE
from repro_torch.launch import cells as tcells
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch.forcedevices import free_port, run_ranks
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline.counters import StepCounter

import torch_analysis_ranks as ranks


def _jax_tokens_per_step():
    """``repro.launch.dryrun._tokens_per_step``, imported with the
    environment restored (the module sets ``XLA_FLAGS`` on import)."""
    saved = dict(os.environ)
    try:
        from repro.launch import dryrun
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return dryrun._tokens_per_step


RANK_TIMEOUT_S = 120.0
SUB_TIMEOUT_S = 600
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="src")


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo world in this process and its (1, 1) mesh."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        yield make_host_mesh((1, 1))
    finally:
        dist.destroy_process_group()


def _run(script: str) -> str:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                          capture_output=True, text=True,
                          timeout=SUB_TIMEOUT_S, cwd=".", env=ENV)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


# ---------------------------------------------------------------------------
# the cell registry
# ---------------------------------------------------------------------------

def test_cell_lists_equal_jax():
    assert list(tconfigs.REGISTRY) == list(jconfigs.REGISTRY)
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert tconfigs.all_cells(True) == jconfigs.all_cells(True)
    assert tconfigs.all_cells(False) == jconfigs.all_cells(False)
    assert len(tconfigs.all_cells(True)) == 42
    assert len(tconfigs.all_cells(False)) == 40


def test_fim_shapes_and_spec_equal_jax():
    assert list(tconfigs.FIM_SHAPES) == list(jconfigs.FIM_SHAPES)
    for k, s in tconfigs.FIM_SHAPES.items():
        j = jconfigs.FIM_SHAPES[k]
        assert (s.shape_id, s.kind, s.dims) == (j.shape_id, j.kind, j.dims)
    assert list(tconfigs.FAMILY_SHAPES) == list(jconfigs.FAMILY_SHAPES)
    for f in ("arch_id", "family", "source", "shape_ids", "rules_override",
              "notes"):
        assert getattr(tfim.SPEC, f) == getattr(jfim.SPEC, f), f
    for fn in ("config_fn", "smoke_config_fn"):
        got = getattr(tfim.SPEC, fn)()
        want = getattr(jfim.SPEC, fn)()
        assert (got.name, got.scheme, got.early_stop, got.block_words) == \
            (want.name, want.scheme, want.early_stop, want.block_words)


@pytest.mark.parametrize("arch_id,shape_id", jconfigs.all_cells(True))
def test_skip_reason_and_tokens_equal_jax(arch_id, shape_id):
    got = tconfigs.get_arch(arch_id)
    want = jconfigs.get_arch(arch_id)
    assert got.skip_reason(shape_id) == want.skip_reason(shape_id)
    assert tconfigs.get_shape(got, shape_id).dims == \
        jconfigs.get_shape(want, shape_id).dims
    assert tdryrun._tokens_per_step(arch_id, shape_id) == \
        _jax_tokens_per_step()(arch_id, shape_id)


# One cell per arch: every family's cells (decode builds the
# cache, train the optimizer's leaves).
COUNT_CELLS = [("command-r-plus-104b", "prefill_32k"),
               ("qwen1.5-0.5b", "decode_32k"),
               ("granite-3-8b", "train_4k"),
               ("deepseek-v2-236b", "prefill_32k"),
               ("mixtral-8x22b", "decode_32k"),
               ("graphsage-reddit", "ogb_products"),
               ("sasrec", "serve_p99"),
               ("din", "retrieval_cand"),
               ("xdeepfm", "train_batch"),
               ("two-tower-retrieval", "serve_bulk"),
               ("fim-eclat", "mine_1g")]


@pytest.mark.parametrize("arch_id,shape_id", COUNT_CELLS)
def test_cell_param_counts_equal_jax(mesh1, arch_id, shape_id):
    jmesh = make_mesh((1, 1), ("data", "model"))
    want = jcells.build_cell(arch_id, shape_id, jmesh)
    got = tcells.build_cell(arch_id, shape_id, mesh1, device="cpu")
    assert got.model_params == want.model_params
    assert got.active_params == want.active_params
    assert got.kind == want.kind
    assert got.skip_reason == want.skip_reason


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

RECORDS = {
    "1pod_16x16__a__train_4k": {
        "arch": "a", "shape": "train_4k", "mesh": "1pod_16x16",
        "chips": 256, "ok": True, "active_params": 7.5e9,
        "tokens_per_step": 1_048_576, "peak_memory_per_chip": 3.2e10,
        "cost_analysis": {"flops": 3.1e14, "bytes accessed": 9.7e11},
        "collectives": {"total": {"link_bytes": 4.4e10, "count": 812}}},
    "1pod_16x16__a__decode_32k": {
        "arch": "a", "shape": "decode_32k", "mesh": "1pod_16x16",
        "chips": 256, "ok": True, "active_params": 7.5e9,
        "tokens_per_step": 128, "peak_memory_per_chip": 1.1e9,
        "cost_analysis": {"flops": 2.1e9, "bytes accessed": 3.3e9},
        "collectives": {"total": {"link_bytes": 7.9e5, "count": 25}}},
    "1pod_16x16__fim__mine": {
        "arch": "fim", "shape": "mine_128m", "mesh": "1pod_16x16",
        "chips": 256, "ok": True, "cost_analysis": {
            "flops": 0.0, "bytes accessed": 1.5e13},
        "collectives": {"total": {"link_bytes": 1_048_576, "count": 2}}},
    "1pod_16x16__a__long_500k": {
        "arch": "a", "shape": "long_500k", "mesh": "1pod_16x16",
        "chips": 256, "ok": True,
        "skip_reason": "full-attention arch: 500k-token decode requires "
                       "sub-quadratic attention (DESIGN.md §4)"},
}


def test_roofline_terms_and_table_equal_jax_under_tpu_v5e():
    for rec in RECORDS.values():
        got = tanalysis.terms_from_record(rec, tanalysis.TPU_V5E)
        want = janalysis.terms_from_record(rec)
        if want is None:
            assert got is None
            continue
        assert got.as_dict() == want.as_dict()
        args = dict(arch="x", shape="train_y", mesh="m", chips=16,
                    flops_per_chip=1e12, bytes_per_chip=2e9,
                    link_bytes_per_chip=3e8, model_flops=5e12,
                    peak_memory_per_chip=7.0)
        assert tanalysis.RooflineTerms(
            **args, chip=tanalysis.TPU_V5E).as_dict() == \
            janalysis.RooflineTerms(**args).as_dict()
    assert tanalysis.format_table(RECORDS, tanalysis.TPU_V5E) == \
        janalysis.format_table(RECORDS)
    assert (tanalysis.TPU_V5E.peak_flops, tanalysis.TPU_V5E.hbm_bw,
            tanalysis.TPU_V5E.link_bw) == (janalysis.PEAK_FLOPS,
                                           janalysis.HBM_BW,
                                           janalysis.LINK_BW)


@pytest.mark.parametrize("chip", ["h100", "tpu-v5e"])
def test_roofline_terms_math(chip):
    """The JAX package's ``test_roofline_terms_math``, under each chip."""
    spec = tanalysis.CHIPS[chip]
    t = tanalysis.RooflineTerms(
        arch="a", shape="train_x", mesh="m", chips=256,
        flops_per_chip=spec.peak_flops,       # exactly 1s compute
        bytes_per_chip=spec.hbm_bw * 0.5,     # 0.5s memory
        link_bytes_per_chip=0.0,
        model_flops=0.5 * 256 * spec.peak_flops, chip=spec)
    assert t.t_compute == pytest.approx(1.0)
    assert t.t_memory == pytest.approx(0.5)
    assert t.bottleneck == "compute"
    assert t.step_time_lower_bound == pytest.approx(1.0)
    assert t.useful_flops_ratio == pytest.approx(0.5)
    assert t.roofline_fraction == pytest.approx(0.5)
    assert tanalysis.H100_SXM.peak_flops == 989.4e12
    assert tanalysis.H100_SXM.hbm_bw == 3.35e12
    assert tanalysis.H100_SXM.link_bw == 450e9


def test_roofline_cli_prints_the_table(tmp_path):
    import json
    for name, rec in RECORDS.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    out = _run(f"""
        import sys
        sys.argv = ["analysis", "--dir", {str(tmp_path)!r}, "--chip",
                    "tpu-v5e"]
        from repro_torch.roofline import analysis
        analysis.main()
    """)
    assert out.strip() == tanalysis.format_table(
        tanalysis.load_records(str(tmp_path)), tanalysis.TPU_V5E).strip()


# ---------------------------------------------------------------------------
# the mining round programs
# ---------------------------------------------------------------------------

def _round_inputs(seed, rows=16, nb=4, bw=8, n=32):
    rng = np.random.default_rng(seed)
    store = rng.integers(0, 2 ** 32, (rows, nb, bw), dtype=np.uint64
                         ).astype(np.uint32)
    a = np.repeat(rng.integers(0, rows, n // 8), 8)     # shared-'a' chunks
    pairs = np.stack([a, rng.integers(0, rows, n)], 1).astype(np.int32)
    return store, pairs


def _jax_rounds(store, pairs, pair_chunk=8):
    """Both JAX rounds on a 1x1 mesh: ``(b1, c1, b2, c2)`` numpy."""
    mesh = make_mesh((1, 1), ("data", "model"))
    rho = np.zeros(pairs.shape[0], np.int32)
    b1, c1 = jax.jit(jdist.make_mining_round(mesh, pair_chunk=pair_chunk))(
        store, pairs, rho)
    suffix1 = popcount32_np(store[:, 1:]).reshape(store.shape[0], -1).sum(1)
    b2, c2 = jax.jit(jdist.make_mining_round_v2(mesh, pair_chunk=pair_chunk))(
        store, suffix1.astype(np.int32)[:, None], pairs, rho)
    return [np.asarray(x) for x in (b1, c1, b2, c2)]


@pytest.mark.parametrize("seed", [0, 1])
def test_mining_rounds_bit_equal_jax_on_one_rank(mesh1, seed):
    store, pairs = _round_inputs(seed)
    want = _jax_rounds(store, pairs)
    st = torch.from_numpy(store.view(np.int32))
    p = torch.from_numpy(pairs)
    rho = torch.zeros(pairs.shape[0], dtype=torch.int32)
    b1, c1 = make_mining_round(mesh1, pair_chunk=8)(st, p, rho)
    suffix1 = popcount32_np(store[:, 1:]).reshape(store.shape[0], -1).sum(1)
    b2, c2 = make_mining_round_v2(mesh1, pair_chunk=8)(
        st, torch.from_numpy(suffix1.astype(np.int32)[:, None]), p, rho)
    for g, w in zip((b1, c1, b2, c2), want, strict=True):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)
    true = popcount32_np(store[pairs[:, 0]] & store[pairs[:, 1]]
                         ).reshape(len(pairs), -1).sum(1)
    assert np.array_equal(c1.numpy(), true)
    assert (b1.numpy() >= true).all()
    with pytest.raises(ValueError, match="chunks"):
        make_mining_round(mesh1, pair_chunk=5)(st, p, rho)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_mining_rounds_in_gloo_worlds_sum_the_jax_shards(shape):
    """Each rank holds its block slice; the all-reduced bound and count
    equal the sum over ranks of the JAX 1x1 round on each slice (what
    ``psum`` computes)."""
    world = shape[0] * shape[1]
    store, pairs = _round_inputs(3, nb=8)
    nb = store.shape[1] // world
    # each rank's local suffix mass: popcount of its blocks 1..
    suffix1 = np.stack([
        popcount32_np(store[:, r * nb + 1:(r + 1) * nb]).reshape(
            store.shape[0], -1).sum(1) for r in range(world)], 1
    ).astype(np.int32)
    per_rank = run_ranks(ranks.mining_rounds, world,
                         (store.view(np.int32), suffix1, pairs, 8, shape),
                         timeout_s=RANK_TIMEOUT_S)
    want = [0, 0, 0, 0]
    for r in range(world):
        part = _jax_rounds(np.ascontiguousarray(
            store[:, r * nb:(r + 1) * nb]), pairs)
        want = [w + p for w, p in zip(want, part, strict=True)]
    for got in per_rank:
        for g, w in zip(got, want, strict=True):
            assert np.array_equal(g, w)


ROUND_COLLECTIVES = """
    import sys
    sys.path.insert(0, "src")
    from repro_torch.launch.dryrun import fake_world
    fake_world(4)
    from repro_torch.launch.cells import build_fim_costing, trace_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.roofline.comms import parse_collectives
    mesh = make_host_mesh((2, 2))
    cell = build_fim_costing("fim-eclat", "mine_128m", mesh, 2,
                             pair_chunk=8, device="cpu")
    print(parse_collectives(trace_cell(cell, mesh)["collectives"]))
"""

JAX_ROUND_COLLECTIVES = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import sys
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp
    from repro.compat import make_mesh
    from repro.core.distributed import make_mining_round
    from repro.roofline.hlo import parse_collectives
    mesh = make_mesh((2, 2), ("data", "model"))
    args = (jax.ShapeDtypeStruct((16, 8, 8), jnp.uint32),
            jax.ShapeDtypeStruct((16, 2), jnp.int32),
            jax.ShapeDtypeStruct((16,), jnp.int32))
    comp = jax.jit(make_mining_round(mesh, pair_chunk=8)).lower(
        *args).compile()
    print(parse_collectives(comp.as_text())["total"]["operand_bytes"])
"""


def test_round_collective_bytes_equal_jax():
    """The round on a fake 4-rank world: two all-reduces of int32[16]
    (2 x 16 x 4 operand bytes, twice that on the links), equal in total
    to ``parse_collectives`` of the JAX round on 4 XLA host devices (XLA
    may combine its two psums, so totals are compared, not counts)."""
    got = eval(_run(ROUND_COLLECTIVES).strip().splitlines()[-1])
    assert got["total"]["operand_bytes"] == 2 * 16 * 4
    assert got["total"]["link_bytes"] == 2 * 2 * 16 * 4
    assert got["all-reduce"]["count"] == 2
    want = float(_run(JAX_ROUND_COLLECTIVES).strip().splitlines()[-1])
    assert got["total"]["operand_bytes"] == want


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------

DRYRUN_SMALL = """
    import sys
    sys.path.insert(0, "src")
    from repro_torch.launch.dryrun import fake_world, run_cell
    fake_world(16)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh((4, 4))
    rec = run_cell("qwen1.5-0.5b", "decode_32k", mesh, "test4x4",
                   {outdir!r}, device="cpu")
    assert rec.get("ok"), rec.get("error")
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["collectives"]["total"]["count"] >= 0
    assert rec["peak_memory_per_chip"] > 0
    assert "cost_fit" in rec and rec["cost_fit"]["n_layers_extrapolated"] == 24
    assert rec["fit_equal"] is True, rec["cost_fit"]["total"]
    print("DRYRUN_SMALL_OK")
"""


def test_dryrun_machinery_small_mesh(tmp_path):
    """JAX's ``DRYRUN_SMALL`` on a fake 4x4 world, the CPU path, plus the
    traced totals equal to the L = 1, 2 extrapolation."""
    out = _run(DRYRUN_SMALL.format(outdir=str(tmp_path)))
    assert "DRYRUN_SMALL_OK" in out


DRYRUN_FIM = """
    import sys
    sys.path.insert(0, "src")
    from repro_torch.launch.dryrun import main
    try:
        main(["--mesh", "single", "--arch", "fim-eclat", "--shape",
              "mine_128m", "--outdir", {outdir!r}])
    except SystemExit as e:
        assert e.code == 0, e.code
    print("DRYRUN_FIM_OK")
"""


def test_dryrun_fim_on_the_fake_256_rank_world(tmp_path):
    """``dryrun --mesh single`` traces mine_128m on 256 fake ranks: the
    two all-reduces of int32[65,536] put 1,048,576 bytes on the links,
    and the traced totals equal the 1-, 2-chunk extrapolation."""
    out = _run(DRYRUN_FIM.format(outdir=str(tmp_path)))
    assert "DRYRUN_FIM_OK" in out
    recs = tanalysis.load_records(str(tmp_path))
    rec = recs["1pod_16x16__fim-eclat__mine_128m"]
    assert rec["ok"] and rec["chips"] == 256 and rec["fit_equal"] is True
    assert rec["collectives"]["total"]["link_bytes"] == 1_048_576
    assert rec["collectives"]["all-reduce"]["count"] == 2
    assert rec["cost_fit"]["n_chunks"] == 32
    # the rank's store shard: 8192 rows x 128 blocks x 128 words
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        8192 * 128 * 128 * 4 + 65536 * 2 * 4 + 65536 * 4
    assert "SKIP" not in tanalysis.format_table(recs)


# ---------------------------------------------------------------------------
# the counters and the custom ops
# ---------------------------------------------------------------------------

def test_step_counter_equals_flop_counter_and_mem_tracker_on_plain():
    """On plain tensors the counter's FLOPs are ``FlopCounterMode``'s and
    its peak is ``MemTracker``'s."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import transformer as T

    cfg = tconfigs.get_arch("qwen1.5-0.5b").smoke_config_fn()
    model = T.init_params(cfg, device="cpu", trainable=True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))

    def step():
        loss, _ = T.loss_fn(model, cfg, tokens, tokens)
        torch.autograd.grad(loss, list(model.parameters()))

    with FlopCounterMode(display=False) as fc:
        step()
    counter = StepCounter()
    counter.hold(list(model.parameters()) + [tokens])
    with counter:
        step()
    assert counter.flops == fc.get_total_flops() > 0
    mem = MemTracker()
    mem.track_external(model, tokens)
    with mem:
        base = sum(v["Total"] for v in
                   mem.get_tracker_snapshot("current").values())
        step()
    peak = sum(v["Total"] for v in mem.get_tracker_snapshot("peak").values())
    assert counter.peak == peak - base > 0


def _visible(sq, skv, causal, window):
    i = np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    keep = np.ones((sq, skv), bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= (i - j) < window
    return int(keep.sum())


FLASH_SHAPES = [((2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8), True, 0),
                ((1, 24, 6, 12), (1, 24, 3, 12), (1, 24, 3, 8), True, 5),
                ((2, 8, 2, 16), (2, 20, 2, 16), (2, 20, 2, 16), True, 0),
                ((1, 9, 2, 4), (1, 13, 1, 4), (1, 13, 1, 4), False, 0)]


@pytest.mark.parametrize("qs,ks,vs,causal,window", FLASH_SHAPES)
def test_flash_op_shape_function_and_flops(qs, ks, vs, causal, window):
    """The fake output has the plain version's shape and dtype; the FLOP
    formula is ``2 B H pairs (D + Dv)`` over the pairs the mask keeps
    (counted here from the mask), and ``FlopCounterMode`` reads it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in (qs, ks, vs))
    want = R.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = FA.flash_attention_op(q, k, v, causal, window, None)
    assert torch.equal(got, want)
    with FakeTensorMode(allow_non_fake_inputs=True) as fm:
        fq, fk, fv = (fm.from_tensor(t) for t in (q, k, v))
        with FlopCounterMode(display=False) as fc:
            out = FA.flash_attention_op(fq, fk, fv, causal, window, None)
    assert out.shape == want.shape and out.dtype == want.dtype
    B, Sq, H, D = qs
    pairs = _visible(Sq, ks[1], causal, window)
    assert FA.visible_pairs(Sq, ks[1], causal, window) == pairs
    assert fc.get_total_flops() == 2 * B * H * pairs * (D + vs[-1])


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_op_shape_function_and_flops(combiner):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    g = torch.Generator().manual_seed(1)
    table = torch.randn(40, 6, generator=g)
    ids = torch.randint(0, 40, (5, 7), dtype=torch.int32, generator=g)
    mask = torch.rand(5, 7, generator=g) < 0.6
    want = R.embedding_bag_ref(table, ids, mask, combiner=combiner)
    assert torch.equal(SE.embedding_bag_op(table, ids, mask, combiner), want)
    with FakeTensorMode(allow_non_fake_inputs=True) as fm:
        with FlopCounterMode(display=False) as fc:
            out = SE.embedding_bag_op(fm.from_tensor(table),
                                      fm.from_tensor(ids),
                                      fm.from_tensor(mask), combiner)
    assert out.shape == want.shape and out.dtype == want.dtype
    assert fc.get_total_flops() == 5 * 7 * 6


def test_custom_ops_pass_opcheck():
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 12, 4, 8, generator=g)
    k = torch.randn(2, 12, 2, 8, generator=g)
    torch.library.opcheck(FA.flash_attention_op, (q, k, k, True, 0, None))
    torch.library.opcheck(FA.flash_attention_op, (q, k, k, True, 3, 0.5))
    table = torch.randn(30, 4, generator=g)
    ids = torch.randint(0, 30, (3, 5), dtype=torch.int32, generator=g)
    mask = torch.rand(3, 5, generator=g) < 0.5
    torch.library.opcheck(SE.embedding_bag_op, (table, ids, mask, "mean"))
