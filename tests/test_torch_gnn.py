"""The port's GraphSAGE (``repro_torch.models.gnn``), its graph data and
config held against the JAX package on the CPU: the smoke config, the
``molecule`` shape at its real size and the ``minibatch_lg`` widths on a
small graph, weights from the JAX ``init_params`` carried across as
numpy.

Tolerances: graph data, configs and the weights' round trip are equal
bit for bit; logits within 1e-5 of their largest entry and ``acc``
equal (XLA and torch sum the products and segment sums in other orders,
~1e-7 here); every gradient within 1e-5 of its leaf's largest entry
(``jax.value_and_grad``); two AdamW steps through ``make_train_step``
with losses and gradient norms within 1e-5, every parameter within 1e-5
of its leaf's largest entry plus 1e-2 of the learning rate a step (the
rule of ``test_torch_recsys_models.py``: Adam moves an entry by about lr
whatever its gradient's size).  ``make_sharded_loss`` in gloo worlds of
1, 2 and 4 ranks (``launch.forcedevices.run_ranks``, each with a
timeout) gives on every rank ``loss_full``'s loss within 1e-5 relative
and every gradient within 1e-5 of its leaf's largest entry, on meshes
(1,1), (2,1), (1,2) and (2,2), for a dst-balanced partition (equal edge
counts per node shard) and an unbalanced one; at (1,1) also the JAX
``make_sharded_loss``'s.
"""

import dataclasses
import functools

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.compat import make_mesh
from repro.configs import base as jbase
from repro.configs import graphsage_reddit as jsage
from repro.data import graph_data as JD
from repro.models import gnn as JG
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step

from repro_torch.configs import GNN_SHAPES, get_arch
from repro_torch.configs import graphsage_reddit as tsage
from repro_torch.data import graph_data as TD
from repro_torch.launch.forcedevices import run_ranks
from repro_torch.launch.gnn_ranks import rank_checks
from repro_torch.models import gnn as TG
from repro_torch.models import weights as TW
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import flatten_with_paths

TOL = 1e-5
RANK_TIMEOUT_S = 120.0


def _close(got, want, tol=TOL, what="", atol=0.0):
    """|got - want| <= tol * largest |want| + atol."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale + atol, \
        f"{what}: err {err} > {tol} x {scale} + {atol}"


def _tcfg(jcfg):
    return TG.SAGEConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _jax_model(cfg_key, seed=0):
    jcfg = _jcfg(cfg_key)
    params, _ = JG.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, params, jax.tree.map(np.asarray, params)


def _jcfg(cfg_key):
    if cfg_key == "smoke":
        return jsage._smoke()
    return jsage._config(cfg_key)


def _graph(cfg_key, jcfg, seed=0):
    """The graph a config runs on: ``molecule`` at its real shape, a
    small power-law graph otherwise; labels, and a mask with every third
    node out."""
    if cfg_key == "molecule":
        d = GNN_SHAPES["molecule"].dims
        g = TD.gen_batched_molecules(d["batch_graphs"], d["nodes_per_graph"],
                                     d["edges_per_graph"], jcfg.d_feat,
                                     jcfg.n_classes, seed=seed)
    else:
        g = TD.gen_powerlaw_graph(120, 5.0, jcfg.d_feat, jcfg.n_classes,
                                  seed=seed)
    mask = np.ones(g.x.shape[0], bool)
    mask[::3] = False
    return g, mask


def _sampled(g, jcfg, n_seeds=16, seed=0):
    s = TD.NeighborSampler(g.edge_src, g.edge_dst, g.x.shape[0], seed=seed)
    seeds = np.arange(n_seeds)
    feats, masks = s.sample_batch(seeds, tuple(jcfg.fanouts), g.x)
    feats = tuple(np.ascontiguousarray(f) for f in feats)
    masks = tuple(np.ascontiguousarray(m) for m in masks)
    return feats, masks, g.labels[seeds]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# configs, data, weights
# ---------------------------------------------------------------------------

def test_gnn_shapes_config_and_registry_equal_the_jax_package():
    assert {k: dataclasses.asdict(v) for k, v in GNN_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.GNN_SHAPES.items()}
    spec = get_arch("graphsage-reddit")
    assert spec is tsage.SPEC
    for f in ("arch_id", "family", "source", "shape_ids", "rules_override",
              "notes"):
        assert getattr(spec, f) == getattr(jsage.SPEC, f), f
    for shape in (None,) + tuple(GNN_SHAPES):
        assert dataclasses.asdict(spec.config_fn(shape)) == \
            dataclasses.asdict(jsage.SPEC.config_fn(shape)), shape
    assert spec.config_fn("minibatch_lg").fanouts == (15, 10)
    assert dataclasses.asdict(spec.smoke_config_fn()) == \
        dataclasses.asdict(jsage.SPEC.smoke_config_fn())
    # the edge counts the chip run's generators give
    for shape in ("full_graph_sm", "minibatch_lg", "ogb_products"):
        d = GNN_SHAPES[shape].dims
        n = d.get("n_nodes", d["raw_nodes"])
        e = d.get("n_edges", d["raw_edges"])
        assert int(n * (e / n)) == e, shape


@pytest.mark.parametrize("name", ["float32", "bfloat16", "float64",
                                  "float16", "zeros"])
def test_sage_param_dtype_takes_the_config_dtypes_only(name):
    """fp32, bf16 (the hillclimb variant) and float64 (a check of the
    sharded loss) map to their torch dtypes, as ``jnp.dtype`` does; any
    other name raises a ValueError naming the config."""
    cfg = TG.SAGEConfig("c", dtype=name)
    if name in ("float32", "bfloat16", "float64"):
        assert cfg.param_dtype == getattr(torch, name)
        assert str(cfg.param_dtype) == f"torch.{jnp.dtype(name)}"
    else:
        with pytest.raises(ValueError, match="SAGEConfig 'c'"):
            cfg.param_dtype


def _same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


@pytest.mark.parametrize("args", [(200, 5.0, 8, 4, 0), (80, 4.0, 24, 5, 3),
                                  (2816, 10752 / 2816, 16, 7, 1)])
def test_powerlaw_graph_byte_identical(args):
    want = JD.gen_powerlaw_graph(*args[:4], seed=args[4])
    got = TD.gen_powerlaw_graph(*args[:4], seed=args[4])
    for f in ("x", "edge_src", "edge_dst", "labels"):
        _same(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("args", [(4, 10, 16, 8, 3, 0),
                                  (128, 30, 64, 32, 16, 2)])
def test_batched_molecules_byte_identical(args):
    want = JD.gen_batched_molecules(*args[:5], seed=args[5])
    got = TD.gen_batched_molecules(*args[:5], seed=args[5])
    for f in ("x", "edge_src", "edge_dst", "labels"):
        _same(getattr(got, f), getattr(want, f), f)


def test_neighbor_sampler_byte_identical():
    """Both samplers on the same graph and seed: the CSR arrays, then a
    sequence of hops and batches (the rng advances alike), and the
    isolated-node fallback (self loops, mask 0)."""
    g = JD.gen_powerlaw_graph(200, 5.0, 8, 4, seed=0)
    js = JD.NeighborSampler(g.edge_src, g.edge_dst, 200, seed=0)
    ts = TD.NeighborSampler(g.edge_src, g.edge_dst, 200, seed=0)
    _same(ts.nbr, js.nbr, "nbr")
    _same(ts.offsets, js.offsets, "offsets")
    seeds = np.arange(32)
    for fan in (5, 1, 12):
        for a, b in zip(ts.sample_hop(seeds, fan), js.sample_hop(seeds, fan),
                        strict=True):
            _same(a, b, f"hop {fan}")
    for _ in range(2):
        (tf, tm), (jf, jm) = (ts.sample_batch(seeds, (5, 3), g.x),
                              js.sample_batch(seeds, (5, 3), g.x))
        for a, b in zip(tf + tm, jf + jm, strict=True):
            _same(a, b, "batch")
    src, dst = np.zeros(10, np.int32), np.ones(10, np.int32)
    a = TD.NeighborSampler(src, dst, 200, seed=0).sample_hop(
        np.array([199, 1]), 4)
    b = JD.NeighborSampler(src, dst, 200, seed=0).sample_hop(
        np.array([199, 1]), 4)
    for x, y in zip(a, b, strict=True):
        _same(x, y, "isolated")
    assert not a[1][0].any() and (a[0][0] == 199).all()


def test_weights_round_trip_and_seeded_init_follow_the_jax_tree():
    jcfg, _, tree = _jax_model("smoke")
    model = TW.gnn_from_numpy(tree, device="cpu")
    want = flatten_with_paths(tree)
    got = flatten_with_paths(TW.gnn_to_numpy(model))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b), p
    assert [p for p, _, _ in TW.gnn_leaves(model)] == [p for p, _ in want]
    mine, logical = TG.init_params(_tcfg(jcfg), seed=3, device="cpu",
                                   trainable=True)
    assert logical == JG.init_params(jax.random.PRNGKey(0), jcfg)[1]
    assert all(p.requires_grad for p in mine.parameters())
    assert [(p, a.shape, a.dtype) for p, a in
            flatten_with_paths(TW.gnn_to_numpy(mine))] == \
        [(p, a.shape, a.dtype) for p, a in want]
    again, _ = TG.init_params(_tcfg(jcfg), seed=3, device="cpu")
    for a, b in zip(mine.parameters(), again.parameters(), strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# forward passes, losses, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_key", ["smoke", "molecule", "full_graph_sm"])
def test_forward_full_matches_jax(cfg_key):
    """The smoke config, ``molecule`` at its real shape, and the
    ``full_graph_sm`` widths (1433 features) on a small graph."""
    jcfg, params, tree = _jax_model(cfg_key, seed=1)
    g, _ = _graph(cfg_key, jcfg, seed=1)
    model = TW.gnn_from_numpy(tree, device="cpu")
    want = JG.forward_full(params, jcfg, *(jnp.asarray(a) for a in
                                           (g.x, g.edge_src, g.edge_dst)))
    got = TG.forward_full(model, _tcfg(jcfg), _t(g.x), _t(g.edge_src),
                          _t(g.edge_dst).long())
    _close(got, want, what="logits")
    assert np.array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


@pytest.mark.parametrize("cfg_key", ["smoke", "minibatch_lg"])
def test_forward_sampled_matches_jax(cfg_key):
    jcfg, params, tree = _jax_model(cfg_key, seed=1)
    g, _ = _graph(cfg_key, jcfg, seed=2)
    feats, masks, _ = _sampled(g, jcfg, seed=2)
    model = TW.gnn_from_numpy(tree, device="cpu")
    want = JG.forward_sampled(params, jcfg, tuple(map(jnp.asarray, feats)),
                              tuple(map(jnp.asarray, masks)))
    got = TG.forward_sampled(model, _tcfg(jcfg), tuple(map(_t, feats)),
                             tuple(map(_t, masks)))
    _close(got, want, what="logits")
    no_mask = TG.forward_sampled(model, _tcfg(jcfg), tuple(map(_t, feats)))
    _close(no_mask, JG.forward_sampled(params, jcfg,
                                       tuple(map(jnp.asarray, feats))),
           what="logits, no masks")


def _losses(kind, jcfg, g, mask):
    """(JAX loss of params, port loss of a model) on one batch."""
    if kind == "full":
        arrs = (g.x, g.edge_src, g.edge_dst, g.labels, mask)
        return (lambda p: JG.loss_full(p, jcfg, *map(jnp.asarray, arrs)),
                lambda m: TG.loss_full(m, _tcfg(jcfg), *map(_t, arrs)))
    feats, masks, labels = _sampled(g, jcfg, seed=4)
    return (lambda p: JG.loss_sampled(p, jcfg, tuple(map(jnp.asarray, feats)),
                                      tuple(map(jnp.asarray, masks)),
                                      jnp.asarray(labels)),
            lambda m: TG.loss_sampled(m, _tcfg(jcfg), tuple(map(_t, feats)),
                                      tuple(map(_t, masks)), _t(labels)))


@pytest.mark.parametrize("kind,cfg_key", [("full", "smoke"),
                                          ("full", "molecule"),
                                          ("sampled", "smoke")])
def test_loss_and_grads_match_jax(kind, cfg_key):
    jcfg, params, tree = _jax_model(cfg_key, seed=2)
    g, mask = _graph(cfg_key, jcfg, seed=3)
    jloss, tloss = _losses(kind, jcfg, g, mask)
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    model = TW.gnn_from_numpy(tree, device="cpu", trainable=True)
    loss, m = tloss(model)
    _close(loss, float(jl), what="loss")
    assert float(m["acc"]) == float(jm["acc"])
    leaves = TW.gnn_leaves(model)
    grads = torch.autograd.grad(loss, [ps[0] for _, ps, _ in leaves])
    jflat = dict(flatten_with_paths(jax.tree.map(np.asarray, jg)))
    assert [p for p, _, _ in leaves] == list(jflat)
    for (path, _, _), gr in zip(leaves, grads, strict=True):
        _close(gr, jflat[path], what=path)


@pytest.mark.parametrize("kind", ["full", "sampled"])
def test_adamw_train_step_matches_jax(kind):
    """Two steps of ``make_train_step`` with AdamW (lr 3e-4, the JAX cell's
    optimizer) against the JAX ``make_train_step``."""
    jcfg, params, tree = _jax_model("smoke", seed=3)
    cfg = topt.OptConfig(lr=3e-4, warmup_steps=0, decay_steps=10)
    ocfg = jopt.OptConfig(**dataclasses.asdict(cfg))
    model = TW.gnn_from_numpy(tree, device="cpu", trainable=True)
    jp, jo = params, jopt.opt_init(params, ocfg)
    step = make_train_step(lambda fn: fn(model),
                           topt.opt_init(TW.gnn_leaves(model), cfg))
    for i in range(2):
        g, mask = _graph("smoke", jcfg, seed=10 + i)
        jloss, tloss = _losses(kind, jcfg, g, mask)
        jstep = jmake_train_step(lambda p, _b, f=jloss: f(p), ocfg)
        jp, jo, jm = jstep(jp, jo, {})
        m = step(tloss)
        _close(m["loss"], float(jm["loss"]), what=f"loss {i}")
        _close(m["grad_norm"], float(jm["grad_norm"]), what=f"norm {i}")
        assert float(m["acc"]) == float(jm["acc"])
    jflat = dict(flatten_with_paths(jax.tree.map(np.asarray, jp)))
    for path, ps, _ in TW.gnn_leaves(model):
        _close(ps[0], jflat[path], what=path, atol=2 * 1e-2 * cfg.lr)


# ---------------------------------------------------------------------------
# the locality-partitioned loss over (data, model) ranks
# ---------------------------------------------------------------------------

N_SHARDED, F_RAW, F_PAD = 64, 22, 24


@functools.lru_cache(maxsize=None)
def _sharded_case():
    """The graph (64 nodes, 22 features zero-padded to 24), its mask, a
    dst-balanced and an unbalanced edge list, the JAX model at d_feat 24
    and loss_full's loss and gradients for each edge list."""
    jcfg = dataclasses.replace(jsage._smoke(), d_feat=F_PAD)
    g = TD.gen_powerlaw_graph(N_SHARDED, 6.0, F_RAW, jcfg.n_classes, seed=5)
    x = np.zeros((N_SHARDED, F_PAD), np.float32)
    x[:, :F_RAW] = g.x
    mask = np.ones(N_SHARDED, bool)
    mask[::5] = False
    low = g.edge_dst < N_SHARDED // 2
    n_even = min(low.sum(), (~low).sum())
    keep = np.zeros_like(low)
    keep[np.flatnonzero(low)[:n_even]] = True
    keep[np.flatnonzero(~low)[:n_even]] = True
    # unbalanced: three quarters of the edges' dst moved into the low half
    dst_skew = g.edge_dst.copy()
    move = np.arange(len(dst_skew)) % 4 != 0
    dst_skew[move] %= N_SHARDED // 2
    edges = {"balanced": (g.edge_src[keep], g.edge_dst[keep]),
             "unbalanced": (g.edge_src, dst_skew)}
    params, _ = JG.init_params(jax.random.PRNGKey(7), jcfg)
    want = {}
    for name, (src, dst) in edges.items():
        (jl, _), jg = jax.value_and_grad(lambda p, s=src, d=dst: JG.loss_full(
            p, jcfg, jnp.asarray(x), jnp.asarray(s), jnp.asarray(d),
            jnp.asarray(g.labels), jnp.asarray(mask)), has_aux=True)(params)
        want[name] = (float(jl), dict(flatten_with_paths(
            jax.tree.map(np.asarray, jg))))
    graphs = {name: (x, src, dst, g.labels, mask)
              for name, (src, dst) in edges.items()}
    return jcfg, params, graphs, want


def test_sharded_partitions_are_what_they_say():
    _, _, graphs, _ = _sharded_case()
    counts = {name: np.bincount(gr[2] // (N_SHARDED // 2), minlength=2)
              for name, gr in graphs.items()}
    assert counts["balanced"][0] == counts["balanced"][1] > 0
    assert counts["unbalanced"][0] > 2 * counts["unbalanced"][1]


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_sharded_loss_gives_loss_full_on_every_rank(shape):
    jcfg, params, graphs, want = _sharded_case()
    tree = jax.tree.map(np.asarray, params)
    jobs = list(graphs.items())
    per_rank = [out["sharded"] for out in run_ranks(
        rank_checks, shape[0] * shape[1],
        ([(shape, _tcfg(jcfg), tree, gr, F_PAD) for _, gr in jobs],),
        timeout_s=RANK_TIMEOUT_S)]
    for r, results in enumerate(per_rank):
        for (name, _), (loss, grads) in zip(jobs, results, strict=True):
            wl, wg = want[name]
            assert abs(loss - wl) <= TOL * abs(wl), (shape, r, name, loss, wl)
            assert sorted(grads) == sorted(wg)
            for path, gr in grads.items():
                _close(gr, wg[path], what=f"{shape} rank {r} {name} {path}")
    if shape == (1, 1):
        mesh = make_mesh((1, 1), ("data", "model"))
        jfn = JG.make_sharded_loss(mesh, jcfg, N_SHARDED, F_PAD)
        for (name, gr), (loss, grads) in zip(jobs, per_rank[0],
                                             strict=True):
            x, src, dst, labels, mask = map(jnp.asarray, gr)
            jl, jg = jax.jit(jax.value_and_grad(lambda p: jfn(
                p, x, src, dst, labels, mask)))(params)
            _close(np.float32(loss), float(jl), what=f"JAX sharded {name}")
            for path, g in flatten_with_paths(jax.tree.map(np.asarray, jg)):
                _close(grads[path], g, what=f"JAX sharded {name} {path}")


def test_shard_graph_cuts_rows_columns_and_dst_local_edges():
    _, _, graphs, _ = _sharded_case()
    x, src, dst, labels, mask = graphs["unbalanced"]
    xs, s, d, lab, m = TG.shard_graph(x, src, dst, labels, mask, 1, 1, 2, 2,
                                      F_PAD)
    half = N_SHARDED // 2
    assert np.array_equal(xs, x[half:, F_PAD // 2:])
    sel = dst >= half
    assert np.array_equal(s, src[sel]) and np.array_equal(d, dst[sel] - half)
    assert np.array_equal(lab, labels[half:]) and np.array_equal(m,
                                                                 mask[half:])
    xt = TG.shard_graph(*map(_t, (x, src, dst, labels, mask)), 0, 0, 2, 2,
                        F_PAD + 2)[0]
    assert xt.shape == (half, F_PAD // 2 + 1)
    with pytest.raises(ValueError):
        TG.shard_graph(x, src, dst, labels, mask, 0, 0, 3, 1, F_PAD)


def test_sharded_probe_reports_every_mesh_and_the_kink():
    """``launch.gnn_ranks.probe`` at ``full_graph_sm`` on the CPU: a row
    for each mesh of ``PROBE_MESHES``, float64 within 1e-5 (read ~1e-15),
    and the layer-1 pre-activation nearest 0 with its node and unit."""
    from repro_torch.launch.gnn_ranks import PROBE_MESHES, probe
    rows = probe([(0, 0)], device="cpu", dtypes=("float64",))
    meshes = sorted(tuple(r["mesh"]) for r in rows if "mesh" in r)
    assert meshes == sorted(s for ss in PROBE_MESHES.values() for s in ss)
    for r in rows[:-1]:
        assert r["dtype"] == "float64" and r["grad_rel_err"] <= TOL, r
        assert r["loss_rel_err"] <= TOL, r
    kink = rows[-1]
    assert 0 <= kink["node"] < 2816 and 0 <= kink["unit"] < 128
    assert abs(kink["layer1_nearest_zero"]) < 1e-3
