"""The port's SASRec, DIN and xDeepFM and the screened two-tower retrieval
held against the JAX package on the CPU, at the ``_SMOKE`` configs
(fp32): configs and data batches equal, weights from the JAX ``*_init``
carried across as numpy, inputs from the ported batch functions.

Tolerances: logits and scores within 1e-5 of the largest entry compared,
and every gradient of each loss within 1e-5 of its tensor's largest
entry (``jax.value_and_grad``), that scale floored at 1e-3 of the
model's largest gradient entry: XLA and torch sum the matmuls, einsums
and softmaxes in other orders, and DIN's attention MLP has an output
bias whose gradient is exactly zero (a masked softmax does not move when
every weight shifts alike), so both packages return rounding noise
there (~1e-11).  Two AdamW steps through ``make_train_step``: losses and
gradient norms within 1e-5, every parameter within 1e-5 of its tensor's
largest entry plus 1e-2 of the learning rate a step (Adam moves an entry
by about lr whatever its gradient's size, so an entry whose gradient is
near ``eps`` (1e-8) turns a gradient difference of ~1e-9, far inside
the gradient tolerance, into an update difference of up to ~1e-2 lr:
read 6.6e-3 lr at sasrec-smoke).  Batches and the ``max`` combiner are
equal bit for bit; top-k ids exactly."""

import dataclasses
import functools

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import din as jdin
from repro.configs import sasrec as jsas
from repro.configs import two_tower_retrieval as jtt
from repro.configs import xdeepfm as jxd
from repro.data import recsys_data as jdata
from repro.models import recsys as JR
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step

from repro_torch.configs import din as tdin
from repro_torch.configs import get_arch
from repro_torch.configs import sasrec as tsas
from repro_torch.configs import xdeepfm as txd
from repro_torch.data import recsys_data as tdata
from repro_torch.models import recsys as TR
from repro_torch.models import weights as TW
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import flatten_with_paths

TOL = 1e-5
MODELS = {  # name: (JAX config module, port config module, port config)
    "sasrec": (jsas, tsas, TR.SASRecConfig),
    "din": (jdin, tdin, TR.DINConfig),
    "xdeepfm": (jxd, txd, TR.XDeepFMConfig),
}


def _close(got, want, tol=TOL, what="", floor=1e-30, atol=0.0):
    """|got - want| <= tol * max(largest |want|, floor) + atol."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale + atol, \
        f"{what}: err {err} > {tol} x {scale} + {atol}"


@functools.lru_cache(maxsize=None)
def _jax_model(name, seed=0):
    jmod, _, _ = MODELS[name]
    init = {"sasrec": JR.sasrec_init, "din": JR.din_init,
            "xdeepfm": JR.xdeepfm_init}[name]
    params = jax.jit(lambda: init(jax.random.PRNGKey(seed),
                                  jmod._SMOKE)[0])()
    return jmod._SMOKE, params, jax.tree.map(np.asarray, params)


def _models(name, seed=0, trainable=False):
    jcfg, params, tree = _jax_model(name, seed)
    tcfg = MODELS[name][2](**dataclasses.asdict(jcfg))
    return jcfg, params, tcfg, TW.recsys_from_numpy(tree, device="cpu",
                                                    trainable=trainable)


def _batch(name, cfg, seed, batch):
    """The ported batch function's numpy batch, with ids 0 (padding) at
    the front of a few SASRec and DIN histories."""
    if name == "sasrec":
        b = tdata.sasrec_batch(seed, batch, cfg.seq_len, cfg.n_items,
                               cfg.n_negatives)
        b["seq_ids"][0, :7] = 0
        b["pos_ids"][0, :6] = 0
        b["seq_ids"][1, :cfg.seq_len - 1] = 0
    elif name == "din":
        b = tdata.din_batch(seed, batch, cfg.seq_len, cfg.n_items,
                            cfg.n_context, cfg.n_context_fields)
        b["hist_ids"][0, :5] = 0
    else:
        b = tdata.xdeepfm_batch(seed, batch, cfg.n_fields,
                                cfg.vocab_per_field)
    return b


LOSS_KEYS = {"sasrec": ("seq_ids", "pos_ids", "neg_ids"),
             "din": ("hist_ids", "target_id", "ctx_ids", "labels"),
             "xdeepfm": ("field_ids", "labels")}


def _losses(name):
    return ({"sasrec": JR.sasrec_loss, "din": JR.din_loss,
             "xdeepfm": JR.xdeepfm_loss}[name],
            {"sasrec": TR.sasrec_loss, "din": TR.din_loss,
             "xdeepfm": TR.xdeepfm_loss}[name])


# ---------------------------------------------------------------------------
# configs, data, weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_configs_equal_the_jax_package(name):
    jmod, tmod, _ = MODELS[name]
    for cfg in ("_FULL", "_SMOKE"):
        assert dataclasses.asdict(getattr(jmod, cfg)) \
            == dataclasses.asdict(getattr(tmod, cfg)), cfg
    spec = get_arch(jmod.SPEC.arch_id)
    assert spec is tmod.SPEC
    for f in ("arch_id", "family", "source", "shape_ids", "rules_override",
              "notes"):
        assert getattr(spec, f) == getattr(jmod.SPEC, f), f
    assert spec.config_fn(None) is tmod._FULL
    assert spec.smoke_config_fn() is tmod._SMOKE


@pytest.mark.parametrize("fn,args", [
    ("sasrec_batch", (0, 8, 20, 1000, 5)),
    ("sasrec_batch", (7, 512, 50, 1_000_000, 1)),
    ("din_batch", (1, 8, 20, 2000, 100, 4)),
    ("din_batch", (3, 512, 100, 1_000_000, 100_000, 4)),
    ("xdeepfm_batch", (2, 8, 8, 200)),
    ("xdeepfm_batch", (5, 512, 39, 100_000))])
def test_recsys_batches_byte_identical(fn, args):
    want = getattr(jdata, fn)(*args)
    got = getattr(tdata, fn)(*args)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_weights_round_trip_and_seeded_init_follow_the_jax_tree(name):
    """recsys_from_numpy then recsys_to_numpy gives the JAX tree back
    bit for bit; the leaves are its paths in the JAX leaf order; the
    port's own seeded model has the tree's paths, shapes and dtypes."""
    jcfg, _, tree = _jax_model(name)
    model = TW.recsys_from_numpy(tree, device="cpu")
    want = flatten_with_paths(tree)
    got = flatten_with_paths(TW.recsys_to_numpy(model))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b), p
    assert [p for p, _, _ in TW.recsys_leaves(model)] == \
        [p for p, _ in want]
    assert not any(p.requires_grad for p in model.parameters())
    init = {"sasrec": TR.sasrec_init, "din": TR.din_init,
            "xdeepfm": TR.xdeepfm_init}[name]
    tcfg = MODELS[name][2](**dataclasses.asdict(jcfg))
    mine = init(tcfg, seed=3, device="cpu", trainable=True)
    assert all(p.requires_grad for p in mine.parameters())
    shapes = [(p, a.shape, a.dtype) for p, a in
              flatten_with_paths(TW.recsys_to_numpy(mine))]
    assert shapes == [(p, a.shape, a.dtype) for p, a in want]
    again = init(tcfg, seed=3, device="cpu")
    for a, b in zip(mine.parameters(), again.parameters(), strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_sasrec_encode_and_score_match_jax():
    jcfg, params, tcfg, model = _models("sasrec", seed=1)
    b = _batch("sasrec", jcfg, 1, 6)
    seq = b["seq_ids"]
    cand = np.random.default_rng(1).integers(
        1, jcfg.n_items, (6, 30)).astype(np.int32)
    _close(TR.sasrec_encode(model, tcfg, torch.from_numpy(seq)),
           JR.sasrec_encode(params, jcfg, jnp.asarray(seq)), what="encode")
    _close(TR.sasrec_score(model, tcfg, torch.from_numpy(seq),
                           torch.from_numpy(cand)),
           JR.sasrec_score(params, jcfg, jnp.asarray(seq),
                           jnp.asarray(cand)), what="candidates")
    _close(TR.sasrec_score(model, tcfg, torch.from_numpy(seq)),
           JR.sasrec_score(params, jcfg, jnp.asarray(seq)), what="catalog")


def test_din_forward_and_candidate_scores_match_jax(monkeypatch):
    """din_forward, and din_score_candidates for one user in blocks of 64
    (the last one short) equal to one block of every candidate and to
    the JAX function."""
    jcfg, params, tcfg, model = _models("din", seed=1)
    b = _batch("din", jcfg, 1, 7)
    keys = ("hist_ids", "target_id", "ctx_ids")
    _close(TR.din_forward(model, tcfg, *(torch.from_numpy(b[k])
                                         for k in keys)),
           JR.din_forward(params, jcfg, *(jnp.asarray(b[k]) for k in keys)),
           what="forward")
    hist, ctx = b["hist_ids"][:1], b["ctx_ids"][:1]
    cand = np.random.default_rng(2).permutation(
        np.arange(1, jcfg.n_items))[:300].astype(np.int32)
    want = JR.din_score_candidates(params, jcfg, jnp.asarray(hist),
                                   jnp.asarray(ctx), jnp.asarray(cand))
    th, tc, tk = map(torch.from_numpy, (hist, ctx, cand))
    one = TR.din_score_candidates(model, tcfg, th, tc, tk)
    monkeypatch.setattr(TR, "DIN_SCORE_BLOCK", 64)
    blocked = TR.din_score_candidates(model, tcfg, th, tc, tk)
    _close(one, want, what="candidates")
    assert torch.equal(blocked, one)


def test_xdeepfm_forward_matches_jax():
    jcfg, params, tcfg, model = _models("xdeepfm", seed=1)
    ids = _batch("xdeepfm", jcfg, 1, 9)["field_ids"]
    _close(TR.xdeepfm_forward(model, tcfg, torch.from_numpy(ids)),
           JR.xdeepfm_forward(params, jcfg, jnp.asarray(ids)))


# ---------------------------------------------------------------------------
# losses, gradients, a train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_and_grads_match_jax(name):
    jcfg, params, tcfg, model = _models(name, seed=2, trainable=True)
    b = _batch(name, jcfg, 2, 12)
    jloss_fn, tloss_fn = _losses(name)
    keys = LOSS_KEYS[name]
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, jcfg, *(jnp.asarray(b[k]) for k in keys)),
        has_aux=True))(params)
    loss, m = tloss_fn(model, tcfg, *(torch.from_numpy(b[k]) for k in keys))
    _close(loss, float(jl), what="loss")
    _close(m["ce"], float(jm["ce"]), what="ce")
    leaves = TW.recsys_leaves(model)
    grads = torch.autograd.grad(loss, [ps[0] for _, ps, _ in leaves])
    jflat = dict(flatten_with_paths(jax.tree.map(np.asarray, jg)))
    assert [p for p, _, _ in leaves] == list(jflat)
    floor = 1e-3 * max(float(np.abs(g).max()) for g in jflat.values())
    for (path, _, _), g in zip(leaves, grads, strict=True):
        _close(g, jflat[path], what=path, floor=floor)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_adamw_train_step_matches_jax(name):
    """Two steps of ``make_train_step(*_loss)`` with AdamW against the JAX
    ``make_train_step``: losses and gradient norms within 1e-5,
    parameters within 1e-5 of each tensor's largest entry plus 1e-2 lr a
    step."""
    jcfg, params, tcfg, model = _models(name, seed=3, trainable=True)
    cfg = topt.OptConfig(lr=1e-3, warmup_steps=0, decay_steps=10)
    ocfg = jopt.OptConfig(**dataclasses.asdict(cfg))
    jloss_fn, tloss_fn = _losses(name)
    keys = LOSS_KEYS[name]
    jstep = jax.jit(jmake_train_step(
        lambda p, bt: jloss_fn(p, jcfg, *(bt[k] for k in keys)), ocfg))
    step = make_train_step(lambda bt: tloss_fn(
        model, tcfg, *(bt[k] for k in keys)), topt.opt_init(
            TW.recsys_leaves(model), cfg))
    jp, jo = params, jopt.opt_init(params, ocfg)
    for i in range(2):
        b = _batch(name, jcfg, 10 + i, 16)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(b[k]) for k in keys})
        m = step({k: torch.from_numpy(b[k]) for k in keys})
        _close(m["loss"], float(jm["loss"]), what=f"loss {i}")
        _close(m["grad_norm"], float(jm["grad_norm"]), what=f"norm {i}")
    jflat = dict(flatten_with_paths(jax.tree.map(np.asarray, jp)))
    for path, ps, _ in TW.recsys_leaves(model):
        _close(ps[0], jflat[path], what=path, atol=2 * 1e-2 * cfg.lr)


# ---------------------------------------------------------------------------
# the screened two-tower retrieval
# ---------------------------------------------------------------------------

def test_topk_ordered_breaks_ties_as_jax():
    """Equal values by lower index first, best first, -0.0 below 0.0
    (XLA's total order), as ``jax.lax.top_k``."""
    rng = np.random.default_rng(5)
    x = rng.integers(-4, 5, (3, 200)).astype(np.float32) / 4
    x[0, ::7] = -0.0
    x[1, :] = 1.5
    for k in (1, 13, 200):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = TR._topk_ordered(torch.from_numpy(x), k)
        assert np.array_equal(ti.numpy(), np.asarray(ji)), k
        assert np.array_equal(tv.numpy(), np.asarray(jv)), k


def _tt(seed):
    cfg = jtt._SMOKE
    params, _ = JR.twotower_init(jax.random.PRNGKey(seed), cfg)
    tcfg = TR.TwoTowerConfig(**dataclasses.asdict(cfg))
    model = TW.recsys_from_numpy(jax.tree.map(np.asarray, params),
                                 device="cpu")
    return cfg, params, tcfg, model


@pytest.mark.parametrize("seed,n_queries,topk,shortlist", [
    (0, 1, 10, 64), (1, 1, 25, 128), (2, 3, 10, 64)])
def test_retrieval_scores_screened_matches_jax(seed, n_queries, topk,
                                               shortlist):
    """Top-k ids equal to the JAX function's and its scores within 1e-5
    (B > 1: the first query's shortlist and ids, every query's scores).
    The shortlist holds the exact path's top-k here, so the ids also
    equal ``retrieval_scores``'.  If a bf16 near-tie at the shortlist's
    cutoff split the two packages' screens, the ids would be held
    against the exact path alone, and the test says which it did."""
    cfg, params, tcfg, model = _tt(seed)
    b = tdata.twotower_batch(seed, n_queries, cfg.n_users, cfg.n_items,
                             cfg.n_user_hist)
    keys = ("user_id", "hist_ids", "hist_mask")
    cand = np.random.default_rng(seed).permutation(cfg.n_items).astype(
        np.int32)
    jv, ji = JR.retrieval_scores_screened(
        params, cfg, *(jnp.asarray(b[k]) for k in keys), jnp.asarray(cand),
        topk=topk, shortlist=shortlist)
    targs = [torch.from_numpy(b[k]) for k in keys] + [torch.from_numpy(cand)]
    tv, ti = TR.retrieval_scores_screened(model, tcfg, *targs, topk=topk,
                                          shortlist=shortlist)
    assert tuple(ti.shape) == (1, topk) and tuple(tv.shape) == \
        (n_queries, topk)
    _, exact_ids = TR.retrieval_scores(model, tcfg, *targs, topk=topk)
    if np.array_equal(ti.numpy(), np.asarray(ji)):
        _close(tv, jv, what="screened scores")
    else:            # a near-tie at the cutoff: say so, hold the exact path
        print(f"screen split at the cutoff (seed {seed}): ids held "
              "against the exact path")
    assert torch.equal(ti[0], exact_ids[0])
