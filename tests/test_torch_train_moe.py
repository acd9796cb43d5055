"""The port's trainer on the MoE, MLA and sliding-window stacks held
against the JAX package on the CPU, at the mixtral-8x22b and
deepseek-v2-236b smoke configs (fp32): the trainer's leaves (the JAX
leaf order, the router fp32), AdamW and Adafactor on those leaves
(Adafactor factoring a stacked ``(L, E, d, f)`` expert leaf over its last
two axes), ``train_lm`` against the JAX trainer over 10 steps,
checkpoints of both trainers restored by the other package, ``main``
and the parameter counts behind a step's flops.  The loss and every
gradient of these stacks are held in
``tests/test_torch_train_lm.py::test_loss_fn_and_grads_match_jax``.

Tolerances: optimizer updates within 1e-6 of the largest entry (the same
fp32 formulas; XLA and torch may fuse a multiply-add where the other
rounds twice); the optimizer's moments within 4e-6: they are linear
(``mu``) and quadratic (``nu``, ``vr``, ``vc``) in the clipped gradient,
whose scale each package takes from an fp32 global norm summed in its
own order (at deepseek-v2-smoke's 490k entries the two norms read 4.2e-7
and 1.9e-7 off the exact one, so ``nu`` moves by about 1e-6, while the
update, a ratio of the moments, does not); ``train_lm``'s logged losses
and final metrics within 1e-4 relative (ten steps of fp32 matmuls summed
in other orders)."""

import dataclasses
import functools
import os
import shutil

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import deepseek_v2_236b as jds
from repro.configs import get_arch as jget_arch
from repro.configs import mixtral_8x22b as jmx
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt

from repro_torch.configs import get_arch
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from repro_torch.models import weights as TW
from repro_torch.train import checkpoint as tck
from repro_torch.train import optimizer as topt
from repro_torch.tree import flatten_with_paths

OPT_TOL = 1e-6
STATE_TOL = 4e-6
RUN_TOL = 1e-4
ARCHS = {"mixtral": jmx._SMOKE, "deepseek": jds._SMOKE}
ARCH_IDS = {"mixtral": "mixtral-8x22b", "deepseek": "deepseek-v2-236b"}
LM_ARCHS = ("qwen1.5-0.5b", "granite-3-8b", "command-r-plus-104b",
            "mixtral-8x22b", "deepseek-v2-236b")


def _tcfg(jcfg, **over):
    return TT.LMConfig(**{**dataclasses.asdict(jcfg), **over})


def _close(got, want, tol, what=""):
    got = got.detach().to(torch.float32).numpy() \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, f"{what}: err {err} > {tol} x {scale}"


@functools.lru_cache(maxsize=None)
def _jax_params(jcfg, seed=0):
    """The JAX ``init_params`` tree (read only: shared between tests) and
    its numpy view."""
    params = jax.jit(lambda: JT.init_params(jax.random.PRNGKey(seed),
                                            jcfg)[0])()
    return params, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# leaves and parameter counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lm_leaves_follow_the_jax_leaf_paths(arch):
    """The trainer's leaves are the JAX tree's, in ``flatten_with_paths``
    order (``dense_layers``, ``embed``, ``final_norm``, ``lm_head``,
    ``moe_layers``), each stacked leaf with the JAX leaf's shape."""
    _, tree = _jax_params(ARCHS[arch])
    model = TW.lm_from_numpy(_tcfg(ARCHS[arch]), tree, device="cpu",
                             trainable=True)
    want = flatten_with_paths(tree)
    leaves = TW.lm_leaves(model)
    assert [p for p, _, _ in leaves] == [p for p, _ in want]
    for (path, parts, stacked), (_, a) in zip(leaves, want, strict=True):
        shape = ((len(parts),) if stacked else ()) + tuple(parts[0].shape)
        assert shape == a.shape, path
        assert stacked == path.startswith(("dense_layers/", "moe_layers/"))
    assert any(p.startswith("moe_layers/mlp/w_gate") for p, _, _ in leaves)


def test_router_stays_fp32_in_a_bf16_model():
    """In a bf16 model the router is fp32 (JAX ``moe_init`` casts it),
    in its leaf, its gradient and the optimizer state, before and after
    a train step; every other matrix stays bf16."""
    jcfg = dataclasses.replace(jmx._SMOKE, dtype="bfloat16")
    _, tree = _jax_params(jcfg, seed=4)
    assert tree["moe_layers"]["mlp"]["router"].dtype == np.float32
    cfg = _tcfg(jcfg)
    model = TW.lm_from_numpy(cfg, tree, device="cpu", trainable=True)
    leaves = TW.lm_leaves(model)
    dtypes = {path: parts[0].dtype for path, parts, _ in leaves}
    assert dtypes.pop("moe_layers/mlp/router") == torch.float32
    assert set(dtypes.values()) == {torch.bfloat16}
    opt = topt.opt_init(leaves, topt.OptConfig(kind="adafactor"))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 40))
    loss, _ = TT.loss_fn(model, cfg, torch.from_numpy(toks),
                         torch.from_numpy(np.roll(toks, -1, 1)))
    parts = [p for _, ps, _ in leaves for p in ps]
    grads = torch.autograd.grad(loss, parts)
    assert {g.dtype for p, g in zip(parts, grads, strict=True)
            if p.dtype == torch.float32} == {torch.float32}
    opt.step(grads=list(grads))
    for name, tree_ in opt.state_tree()["v"]["moe_layers"]["mlp"].items():
        for k, v in tree_.items():
            assert v.dtype == torch.float32, (name, k)
    assert model.layers[0].mlp.router.dtype == torch.float32
    assert model.layers[0].mlp.w_up.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("name", ["_FULL", "_SMOKE"])
def test_param_counts_equal_the_jax_package(arch, name):
    """``param_count`` is the size of the JAX ``init_params`` tree and
    ``active_param_count`` the JAX formula (top_k + shared experts of
    each MoE layer).  At the ``_FULL`` configs the JAX methods multiply
    shapes in int32 (``jnp.prod(jnp.array(shape))``) and wrap past 2^31
    elements a leaf, so there the tree's size is summed in int64 and the
    JAX formula applied to it; at ``_SMOKE`` the JAX methods themselves
    are compared.  The port's seeded smoke model holds that many."""
    spec = jget_arch(arch)
    jcfg = spec.config_fn(None) if name == "_FULL" \
        else spec.smoke_config_fn()
    tcfg = get_arch(arch).config_fn(None) if name == "_FULL" \
        else get_arch(arch).smoke_config_fn()
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                   jcfg)[0])
    total = sum(int(np.prod(x.shape, dtype=np.int64))
                for x in jax.tree.leaves(shapes))
    assert tcfg.param_count() == total
    inactive = 0
    if jcfg.moe:
        inactive = ((jcfg.n_layers - jcfg.first_k_dense)
                    * (jcfg.n_experts - jcfg.top_k)
                    * 3 * jcfg.d_model * (jcfg.moe_d_ff or jcfg.d_ff))
    assert tcfg.active_param_count() == total - inactive
    if name == "_SMOKE":
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()
        model = TT.init_params(tcfg, seed=0, device="cpu")
        assert sum(p.numel() for p in model.parameters()) == total


# ---------------------------------------------------------------------------
# AdamW / Adafactor on the MoE and MLA leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_optimizer_updates_on_moe_leaves_match_jax(arch, kind):
    """Two updates on identical seeded gradients, clipped (their norm is
    about 40 times ``grad_clip``): every parameter within 1e-6 and every
    state leaf within 4e-6 of the JAX ``opt_update``'s; Adafactor's
    moments of a stacked expert leaf ``(L, E, d, f)`` are ``vr (L, E,
    d)`` and ``vc (L, E, f)``, as JAX factors them."""
    jcfg = ARCHS[arch]
    jp, tree = _jax_params(jcfg)
    cfg = topt.OptConfig(kind=kind, lr=3e-2, warmup_steps=1, decay_steps=10,
                         grad_clip=5.0)
    ocfg = jopt.OptConfig(**dataclasses.asdict(cfg))
    jstate = jopt.opt_init(jp, ocfg)
    model = TW.lm_from_numpy(_tcfg(jcfg), tree, device="cpu",
                             trainable=True)
    leaves = TW.lm_leaves(model)
    opt = topt.opt_init(leaves, cfg)
    rng = np.random.default_rng(2)
    upd = jax.jit(lambda p, g, s: jopt.opt_update(p, g, s, ocfg))
    for _ in range(2):
        g = {path: (rng.normal(size=a.shape) * 10 ** rng.uniform(-3, 0)
                    ).astype(np.float32)
             for path, a in flatten_with_paths(tree)}
        jg = jax.tree.unflatten(jax.tree.structure(jp), [
            jnp.asarray(g[p]) for p, _ in flatten_with_paths(tree)])
        jp, jstate, jm = upd(jp, jg, jstate)
        # copies: the port clips its gradients in place
        m = opt.step(grads=[torch.tensor(g[path][i] if stacked
                                         else g[path])
                            for path, ps, stacked in leaves
                            for i in range(len(ps))])
        _close(m["grad_norm"], float(jm["grad_norm"]), OPT_TOL, "norm")
        jflat = dict(flatten_with_paths(jax.tree.map(np.asarray, jp)))
        for path, ps, stacked in leaves:
            got = torch.stack(ps) if stacked else ps[0]
            _close(got, jflat[path], OPT_TOL, f"param {path}")
        jstate_flat = dict(flatten_with_paths(jax.tree.map(np.asarray,
                                                           jstate)))
        tstate_flat = dict(flatten_with_paths(opt.state_tree()))
        assert sorted(jstate_flat) == sorted(tstate_flat)
        for k, v in jstate_flat.items():
            _close(tstate_flat[k], v, STATE_TOL, f"state {k}")
    if kind == "adafactor":
        L, E, d, f = tree["moe_layers"]["mlp"]["w_gate"].shape
        v = opt.state_tree()["v"]["moe_layers"]["mlp"]["w_gate"]
        assert tuple(v["vr"].shape) == (L, E, d)
        assert tuple(v["vc"].shape) == (L, E, f)


# ---------------------------------------------------------------------------
# train_lm against the JAX trainer; checkpoints across the packages
# ---------------------------------------------------------------------------

STEPS, BATCH, SEQ = 10, 2, 48          # 48: past mixtral-smoke's window


@pytest.fixture(scope="module", params=sorted(ARCHS))
def jax_moe_run(request, tmp_path_factory):
    """One JAX ``train_lm`` run per smoke config: 10 steps, a log line a
    step, a checkpoint every 5 steps (kept: steps 5 and 10)."""
    arch = request.param
    d = str(tmp_path_factory.mktemp(f"jax_{arch}"))
    logs = []
    out = jtrain.train_lm(ARCHS[arch], steps=STEPS, batch=BATCH,
                          seq_len=SEQ, lr=3e-3, seed=0, log_every=1,
                          log_fn=logs.append, ckpt_dir=d, ckpt_every=5)
    return arch, out, logs, d


def _close_runs(out, jout):
    assert [s for s, _ in out["history"]] == [s for s, _ in jout["history"]]
    for (s, a), (_, b) in zip(out["history"], jout["history"], strict=True):
        assert abs(a - b) <= RUN_TOL * abs(b), (s, a, b)
    assert out["final"].keys() == jout["final"].keys()
    for k, v in jout["final"].items():
        assert abs(out["final"][k] - v) <= RUN_TOL * max(abs(v), 1e-30), k


def test_train_lm_matches_the_jax_trainer_on_moe_stacks(jax_moe_run,
                                                        tmp_path):
    """From the JAX trainer's initial weights the port's ``train_lm``
    logs the same losses over 10 steps (aux loss, lr, grad norm in the
    final metrics too), and the JAX package restores the checkpoint the
    port wrote: the same tree, the same parameters and optimizer state."""
    arch, jout, _, _ = jax_moe_run
    jcfg = ARCHS[arch]
    jp, tree = _jax_params(jcfg)
    d = str(tmp_path / "port")
    out = ttrain.train_lm(_tcfg(jcfg), steps=STEPS, batch=BATCH,
                          seq_len=SEQ, lr=3e-3, seed=0, log_every=1,
                          log_fn=lambda *_: 0, device="cpu", params=tree,
                          ckpt_dir=d, ckpt_every=5)
    _close_runs(out, jout)
    assert out["final"]["aux"] > 0
    jo = jopt.opt_init(jp, jopt.OptConfig())
    state, step, extra = jck.restore_checkpoint(d, {"params": jp,
                                                    "opt": jo})
    assert step == STEPS and extra == {"mesh": [1, 1]}
    assert jax.tree.structure(state) == jax.tree.structure(
        {"params": jp, "opt": jo})
    assert int(state["opt"]["step"]) == STEPS
    mine, _, _ = tck.restore_checkpoint(d, state)
    for (p, a), (_, b) in zip(flatten_with_paths(state),
                              flatten_with_paths(mine), strict=True):
        assert np.array_equal(np.asarray(a), b.numpy()), p


def test_port_resumes_a_jax_moe_checkpoint(jax_moe_run, tmp_path):
    """The port restores the JAX trainer's step-5 checkpoint (MoE and MLA
    trees, AdamW state) and replays steps 6-10 within 1e-4."""
    arch, jout, _, jdir = jax_moe_run
    d = str(tmp_path / "from_jax")
    shutil.copytree(jdir, d)
    shutil.rmtree(os.path.join(d, f"step-{STEPS:08d}"))
    logs = []
    out = ttrain.train_lm(_tcfg(ARCHS[arch]), steps=STEPS, batch=BATCH,
                          seq_len=SEQ, lr=3e-3, seed=0, log_every=1,
                          log_fn=logs.append, device="cpu", ckpt_dir=d,
                          resume=True)
    assert logs[0].startswith("[resume] restored step 5")
    _close_runs(out, {"history": jout["history"][5:],
                      "final": jout["final"]})


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_main_runs_the_moe_smoke_configs(arch, capsys):
    ttrain.main(["--arch", ARCH_IDS[arch], "--smoke", "--device", "cpu",
                 "--steps", "2", "--batch", "2", "--seq-len", "40"])
    out = capsys.readouterr().out
    assert "step     2 loss=" in out and "final: {" in out
    assert "'aux': " in out
