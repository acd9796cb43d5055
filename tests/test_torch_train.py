"""The port's training substrate held against the JAX package on the CPU:
the synthetic LM stream, the schedule and clipping, AdamW and Adafactor
on identical numpy gradients, microbatching, checkpoints (both packages
read each other's), and the two-tower loss with its EmbeddingBag
gradient.  fp32 throughout.

Tolerances: optimizer updates within 1e-6 (both sides run the same fp32
formulas; XLA and torch may fuse a multiply-add where the other rounds
twice); the two-tower loss within 1e-5 and its gradients within 1e-5 of
each tensor's largest entry (matmuls summed in other orders)."""

import dataclasses
import os

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp
import ml_dtypes

from repro.configs import two_tower_retrieval as jtt
from repro.data import lm_data as jlm
from repro.models import recsys as JR
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step

from repro_torch.data import lm_data as tlm
from repro_torch.data import recsys_data as tdata
from repro_torch.kernels import ops
from repro_torch.kernels import segment_embed as tse
from repro_torch.models import recsys as TR
from repro_torch.models import weights as TW
from repro_torch.train import checkpoint as tck
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_eval_step, make_train_step
from repro_torch.tree import flatten_with_paths

OPT_TOL = 1e-6


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: err {err} > {tol} x {scale}"


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,vocab,batch,seq", [
    (0, 0, 512, 4, 16), (0, 7, 512, 4, 16), (3, 123, 8192, 2, 33),
    (11, 5, 151936, 1, 8)])
def test_synthetic_lm_batches_bit_equal(seed, step, vocab, batch, seq):
    j = jlm.SyntheticLM(jlm.LMDataConfig(vocab, batch, seq, seed=seed))
    t = tlm.SyntheticLM(tlm.LMDataConfig(vocab, batch, seq, seed=seed))
    for a, b in zip(j.batch(step), t.batch(step), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# schedule, norm, clipping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    topt.OptConfig(lr=3e-3, warmup_steps=0, decay_steps=3),
    topt.OptConfig(lr=1.0, warmup_steps=10, decay_steps=100,
                   min_lr_frac=0.1),
    topt.OptConfig(lr=3e-4, warmup_steps=50, decay_steps=500)])
def test_lr_schedule_matches_jax(cfg):
    jcfg = jopt.OptConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 2, 3, 5, 9, 10, 11, 50, 99, 100, 101, 250, 600):
        want = float(jopt.lr_at(jcfg, jnp.int32(step)))
        got = topt.lr_at(cfg, step)
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-30), step


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_global_norm_and_clip_match_jax(max_norm):
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(4, 8)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32) * 3,
            "c": rng.normal(size=(2, 3, 5)).astype(np.float32)}
    want_clip, want_norm = jopt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, tree), max_norm)
    grads = [torch.from_numpy(v.copy()) for v in tree.values()]
    _close(topt.global_norm(grads), float(jopt.global_norm(tree)), OPT_TOL)
    norm = topt.clip_by_global_norm(grads, max_norm)
    _close(norm, float(want_norm), OPT_TOL, "norm")
    for k, g in zip(tree, grads, strict=True):
        _close(g, want_clip[k], OPT_TOL, k)


# ---------------------------------------------------------------------------
# AdamW / Adafactor on identical gradients
# ---------------------------------------------------------------------------

def _opt_problem(seed):
    """Leaves: 1-D and 2-D (and 3-D) unstacked, and two stacked leaves
    (1-D and 2-D layers) whose JAX form has a leading layer axis."""
    rng = np.random.default_rng(seed)
    shapes = {"a1": (16,), "b2": (8, 12), "c3": (3, 4, 5),
              "stack/norm": (3, 10), "stack/w": (3, 6, 7)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 10 ** rng.uniform(
        -3, 1) for k, s in shapes.items()} for _ in range(3)]
    return params, grads


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *ps, last = k.split("/")
        for p in ps:
            node = node.setdefault(p, {})
        node[last] = v
    return out


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_updates_match_jax(kind):
    params, grads = _opt_problem(1)
    cfg = topt.OptConfig(kind=kind, lr=3e-2, warmup_steps=2, decay_steps=10,
                         grad_clip=5.0)
    jcfg = jopt.OptConfig(**dataclasses.asdict(cfg))
    jp = _nest({k: jnp.asarray(v) for k, v in params.items()})
    jstate = jopt.opt_init(jp, jcfg)

    parts = {k: ([torch.tensor(v[i]) for i in range(v.shape[0])]
                 if k.startswith("stack") else [torch.tensor(v)])
             for k, v in params.items()}
    leaves = [(k, parts[k], k.startswith("stack")) for k in sorted(parts)]
    opt = topt.opt_init(leaves, cfg)
    upd = jax.jit(lambda p, g, s: jopt.opt_update(p, g, s, jcfg))
    for g in grads:
        jp, jstate, jm = upd(jp, _nest({k: jnp.asarray(v)
                                        for k, v in g.items()}), jstate)
        tg = [torch.tensor(g[k][i] if stacked else g[k])
              for k, ps, stacked in leaves for i in range(len(ps))]
        m = opt.step(grads=tg)
        _close(m["grad_norm"], float(jm["grad_norm"]), OPT_TOL, "norm")
        assert abs(m["lr"] - float(jm["lr"])) <= OPT_TOL * float(jm["lr"])
        jflat = dict(flatten_with_paths(jax.tree.map(np.asarray, jp)))
        for k, ps, stacked in leaves:
            got = torch.stack(ps) if stacked else ps[0]
            _close(got, jflat[k], OPT_TOL, f"param {k}")
        jstate_flat = dict(flatten_with_paths(
            jax.tree.map(np.asarray, jstate)))
        tstate_flat = dict(flatten_with_paths(opt.state_tree()))
        assert sorted(jstate_flat) == sorted(tstate_flat)
        for k, v in jstate_flat.items():
            _close(tstate_flat[k], v, OPT_TOL, f"state {k}")


def test_optimizer_state_tree_round_trips():
    params, grads = _opt_problem(2)
    cfg = topt.OptConfig(kind="adafactor", lr=1e-2)

    def fresh():
        return topt.opt_init([(k, [torch.tensor(v)], False)
                              for k, v in sorted(params.items())], cfg)

    opt = fresh()
    opt.step(grads=[torch.tensor(grads[0][k]) for k in sorted(params)])
    tree = {k: np.asarray(v).copy()
            for k, v in flatten_with_paths(opt.state_tree())}
    other = fresh()
    other.load_state_tree(opt.state_tree())
    assert other.step_count == 1
    for k, v in flatten_with_paths(other.state_tree()):
        assert np.array_equal(np.asarray(v), tree[k]), k


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_reads_dot_grad_as_torch_optimizers_do(kind):
    """``loss.backward(); opt.step()`` (each part's ``.grad``) updates as
    ``opt.step(grads=...)`` does; a part without a gradient counts as
    zeros, as JAX gives them."""
    params, grads = _opt_problem(3)
    cfg = topt.OptConfig(kind=kind, lr=1e-2, warmup_steps=0)
    runs = []
    for explicit in (True, False):
        ps = {k: torch.tensor(v, requires_grad=True)
              for k, v in sorted(params.items())}
        opt = topt.opt_init([(k, [p], False) for k, p in ps.items()], cfg)
        g = {k: torch.tensor(v) for k, v in grads[0].items()}
        g["a1"] = torch.zeros_like(g["a1"])          # "a1" gets no grad
        if explicit:
            opt.step(grads=[g[k] for k in ps])
        else:
            sum((p * g[k]).sum() for k, p in ps.items()
                if k != "a1").backward()
            opt.step()
        runs.append({k: p.detach().clone() for k, p in ps.items()})
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


def _quadratic(seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(8, 8)).astype(np.float32) / 4 + np.eye(8, dtype=
                                                               np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    return A, b


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_converges_on_quadratic(kind):
    A, b = map(torch.from_numpy, _quadratic())
    w = torch.zeros(8, requires_grad=True)
    cfg = topt.OptConfig(kind=kind, lr=0.05, warmup_steps=5,
                         decay_steps=400, weight_decay=0.0, grad_clip=100.0)
    opt = topt.opt_init([("w", [w], False)], cfg)

    def loss_fn(batch):
        r = A @ w - b + 0 * batch["x"].sum()
        return (r ** 2).sum(), {"r": (r ** 2).sum()}

    step = make_train_step(loss_fn, opt)
    losses = [float(step({"x": torch.zeros((4, 1))})["loss"])
              for _ in range(300)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.05


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_microbatching_matches_full_batch(kind):
    """n_mb gradient accumulation == one big batch (a mean loss), as
    ``tests/test_train.py::test_microbatching_matches_full_batch_grads``
    holds the JAX step; and the JAX step itself agrees."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(16, 4)).astype(np.float32)
    y = rng.normal(size=(16,)).astype(np.float32)
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    cfg = topt.OptConfig(kind=kind, lr=1e-2, weight_decay=0.0)
    jcfg = jopt.OptConfig(**dataclasses.asdict(cfg))

    def jloss(p, batch):
        pred = (batch["x"] @ p["w"]).sum(-1)
        return ((pred - batch["y"]) ** 2).mean(), {}

    jp = {"w": jnp.asarray(w0)}
    jbatch = {"x": jnp.asarray(X), "y": jnp.asarray(y)}
    jw = jax.jit(jmake_train_step(jloss, jcfg, 1))(
        jp, jopt.opt_init(jp, jcfg), jbatch)[0]["w"]

    out = {}
    for n_mb in (1, 4):
        w = torch.tensor(w0, requires_grad=True)
        opt = topt.opt_init([("w", [w], False)], cfg)

        def loss_fn(batch):
            pred = (batch["x"] @ w).sum(-1)
            return ((pred - batch["y"]) ** 2).mean(), {"n": batch["x"][0, 0]}

        m = make_train_step(loss_fn, opt, n_mb)(
            {"x": torch.from_numpy(X), "y": torch.from_numpy(y)})
        out[n_mb] = w.detach().numpy().copy()
        # metrics are the last microbatch's
        assert float(m["n"]) == X[16 - 16 // n_mb, 0]
    np.testing.assert_allclose(out[1], out[4], rtol=1e-5)
    _close(out[1], np.asarray(jw), 1e-6, "vs JAX")


def test_microbatching_rejects_uneven_split_and_eval_step_runs():
    w = torch.ones(2, requires_grad=True)
    opt = topt.opt_init([("w", [w], False)], topt.OptConfig())

    def loss_fn(batch):
        return (batch["x"] @ w).sum(), {}

    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(loss_fn, opt, 4)({"x": torch.ones(6, 2)})
    m = make_eval_step(loss_fn)({"x": torch.ones(3, 2)})
    assert float(m["loss"]) == 6.0 and not m["loss"].requires_grad


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                       "layers": [{"b": rng.normal(size=(5,)).astype(
                           ml_dtypes.bfloat16)} for _ in range(2)]},
            "opt": {"step": np.asarray(7, np.int32),
                    "count": rng.integers(0, 100, (6,)).astype(np.int32)}}


def _equal_bits(t, a) -> bool:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return t.dtype == torch.bfloat16 and np.array_equal(
            t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))
    return t.numpy().dtype == a.dtype and np.array_equal(t.numpy(), a)


def test_checkpoint_round_trip_rotation_and_latest(tmp_path):
    d = str(tmp_path / "ck")
    tree = _ckpt_tree()
    state = {"params": {"w": torch.from_numpy(tree["params"]["w"]),
                        "layers": tree["params"]["layers"]},
             "opt": tree["opt"]}
    for step in (10, 20, 30, 40):
        tck.save_checkpoint(d, step, state, extra={"mesh": [1, 1]}, keep=2)
    assert sorted(os.listdir(d)) == ["step-00000030", "step-00000040"]
    assert tck.latest_step(d) == 40 and tck.latest_step(str(tmp_path)) \
        is None
    got, step, extra = tck.restore_checkpoint(d, state)
    assert step == 40 and extra == {"mesh": [1, 1]}
    for (p, a), (q, t) in zip(flatten_with_paths(tree),
                              flatten_with_paths(got), strict=True):
        assert p == q and _equal_bits(t, a), p
    got30, step30, _ = tck.restore_checkpoint(d, state, step=30)
    assert step30 == 30 and _equal_bits(got30["params"]["w"],
                                        tree["params"]["w"])
    with pytest.raises(KeyError, match="missing leaf"):
        tck.restore_checkpoint(d, {"nope": np.zeros(1)})
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(tmp_path / "none"), state)


def test_async_checkpointer_writes_and_surfaces_errors(tmp_path):
    d = str(tmp_path / "ck")
    w = torch.arange(6, dtype=torch.float32)
    ck = tck.AsyncCheckpointer(d, keep=3)
    ck.save(1, {"w": w})
    w.add_(100)                   # the save copied the leaf first
    ck.save(2, {"w": w})
    ck.wait()
    assert not [n for n in os.listdir(d) if n.startswith("tmp-")]
    got, _, _ = tck.restore_checkpoint(d, {"w": w}, step=1)
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32))
    (tmp_path / "file").write_text("x")
    bad = tck.AsyncCheckpointer(str(tmp_path / "file"))
    bad.save(3, {"w": w})
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                    # the error is raised once


def test_checkpoint_written_by_jax_is_read_by_the_port(tmp_path):
    d = str(tmp_path / "jax")
    tree = _ckpt_tree(1)
    jck.save_checkpoint(d, 5, jax.tree.map(jnp.asarray, tree),
                        extra={"mesh": [1, 1]})
    got, step, extra = tck.restore_checkpoint(d, tree)
    assert step == 5 and extra == {"mesh": [1, 1]}
    for (p, a), (_, t) in zip(flatten_with_paths(tree),
                              flatten_with_paths(got), strict=True):
        assert _equal_bits(t, a), p


def test_checkpoint_written_by_the_port_is_read_by_jax(tmp_path):
    d = str(tmp_path / "port")
    tree = _ckpt_tree(2)
    state = {"params": {"w": torch.from_numpy(tree["params"]["w"]),
                        "layers": [{"b": torch.from_numpy(
                            l["b"].view(np.int16)).view(torch.bfloat16)}
                            for l in tree["params"]["layers"]]},
             "opt": {k: torch.from_numpy(v) for k, v in
                     tree["opt"].items()}}
    tck.save_checkpoint(d, 9, state)
    got, step, _ = jck.restore_checkpoint(d, jax.tree.map(jnp.asarray, tree))
    assert step == 9
    for (p, a), (_, b) in zip(flatten_with_paths(tree),
                              flatten_with_paths(got), strict=True):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert a.tobytes() == b.tobytes(), p


# ---------------------------------------------------------------------------
# two-tower loss and the EmbeddingBag gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_grad_matches_jax_vjp(combiner):
    rng = np.random.default_rng(3)
    V, D, B, L = 40, 6, 9, 7
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    mask = rng.random((B, L)) < 0.6
    mask[2] = False                            # an all-masked bag
    ids[~mask] = rng.integers(-5, V + 5, int((~mask).sum()))  # any value
    g = rng.normal(size=(B, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: JR.embedding_bag(
        {"table": t}, jnp.asarray(np.clip(ids, 0, V - 1)),
        jnp.asarray(mask), combiner), jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    for m in (torch.from_numpy(mask), torch.from_numpy(mask.astype(
            np.int32))):
        got = tse.embedding_bag_grad(torch.from_numpy(g),
                                     torch.from_numpy(ids), m, V, combiner)
        _close(got, want, 1e-6, combiner)
    # and the plain path's autograd gives the same
    t = torch.tensor(table, requires_grad=True)
    ops.embedding_bag(t, torch.from_numpy(ids), torch.from_numpy(mask),
                      combiner=combiner).backward(torch.from_numpy(g))
    _close(t.grad, want, 1e-6, "autograd of the plain version")


def _tt_models(seed=0):
    cfg = jtt._SMOKE
    params, _ = JR.twotower_init(jax.random.PRNGKey(seed), cfg)
    tcfg = TR.TwoTowerConfig(**dataclasses.asdict(cfg))
    model = TW.recsys_from_numpy(jax.tree.map(np.asarray, params),
                                 device="cpu", trainable=True)
    return cfg, params, tcfg, model


def _tt_batch(cfg, seed, batch):
    """``twotower_batch``: Zipf histories and positives, with the logQ of
    each positive under its Zipf popularity."""
    return tdata.twotower_batch(seed, batch, cfg.n_users, cfg.n_items,
                                cfg.n_user_hist)


@pytest.mark.parametrize("seed,batch", [(1, 33)])
def test_twotower_loss_and_grads_match_jax(seed, batch):
    cfg, params, tcfg, model = _tt_models(seed)
    b = _tt_batch(cfg, seed, batch)
    keys = ("user_id", "hist_ids", "hist_mask", "pos_item", "item_logq")

    def jloss(p):
        return JR.twotower_loss(p, cfg, *(jnp.asarray(b[k]) for k in keys))

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    loss, m = TR.twotower_loss(model, tcfg,
                               *(torch.from_numpy(b[k]) for k in keys))
    _close(loss, float(jl), 1e-5, "loss")
    _close(m["ce"], float(jm["ce"]), 1e-5, "ce")
    assert float(m["in_batch_acc"]) == pytest.approx(float(
        jm["in_batch_acc"]))
    leaves = TW.recsys_leaves(model)
    grads = torch.autograd.grad(loss, [ps[0] for _, ps, _ in leaves])
    jflat = dict(flatten_with_paths(jax.tree.map(np.asarray, jg)))
    assert sorted(jflat) == sorted(p for p, _, _ in leaves)
    for (path, _, _), g in zip(leaves, grads, strict=True):
        _close(g, jflat[path], 1e-5, path)


def test_twotower_to_numpy_round_trip_and_leaf_order():
    cfg, params, tcfg, model = _tt_models(2)
    tree = TW.recsys_to_numpy(model)
    want = jax.tree.map(np.asarray, params)
    assert [p for p, _ in flatten_with_paths(tree)] == \
        [p for p, _ in flatten_with_paths(want)] == \
        [p for p, _, _ in TW.recsys_leaves(model)]
    for (p, a), (_, b) in zip(flatten_with_paths(tree),
                              flatten_with_paths(want), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b), p
    assert all(p.requires_grad for p in model.parameters())
