"""The port's MoE, MLA and sliding-window serving path held against the
JAX package on the CPU, at the mixtral and deepseek-v2 smoke configs
(fp32).

JAX draws the weights; they pass to the port as numpy arrays (a layer's
tree through the port's module constructors, a model's through
``models.weights.lm_from_numpy``).  Inputs come from numpy seeds.  Every
comparison is within 1e-5 of the largest entry compared: XLA and torch
sum the matmuls and softmaxes in different orders, and the port's
prefill attends through the flash kernel's plain version (a dense
softmax) where JAX runs the chunked online softmax.
"""

import dataclasses
import functools

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import deepseek_v2_236b as jds
from repro.configs import mixtral_8x22b as jmx
from repro.models import layers as JL
from repro.models import transformer as JT

from repro_torch.configs import deepseek_v2_236b as tds
from repro_torch.configs import get_arch
from repro_torch.configs import mixtral_8x22b as tmx
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.weights import lm_from_numpy, lm_leaves, lm_to_numpy
from repro_torch.tree import flatten_with_paths

REL = 1e-5
ARCHS = {"mixtral": jmx._SMOKE, "deepseek": jds._SMOKE}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _close(got, want, rel=REL) -> None:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= rel * scale, (err, scale)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _tcfg(jcfg):
    return TT.LMConfig(**dataclasses.asdict(jcfg))


def _models(jcfg, seed=0):
    params, _ = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = _tcfg(jcfg)
    model = lm_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                          device="cpu")
    return params, tcfg, model


@functools.lru_cache(maxsize=None)
def _jax_serve(arch):
    """JAX's prefill and decode_step for ``arch``, jitted once (as
    ``repro.launch.serve`` runs them)."""
    jcfg = ARCHS[arch]
    prefill = jax.jit(lambda p, t, max_len: JT.prefill(p, jcfg, t, max_len),
                      static_argnums=2)
    step = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    return prefill, step


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", ["_FULL", "_SMOKE"])
def test_configs_equal_the_jax_package(name):
    for jmod, tmod in ((jmx, tmx), (jds, tds)):
        j, t = getattr(jmod, name), getattr(tmod, name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t), jmod.__name__
        spec = get_arch(jmod.SPEC.arch_id)
        for f in ("arch_id", "family", "source", "shape_ids", "notes",
                  "rules_override"):
            assert getattr(spec, f) == getattr(jmod.SPEC, f), f
    assert TT.LMConfig(**dataclasses.asdict(jds._FULL)).mla_dims \
        == TL.MLADims(**dataclasses.asdict(jds._FULL.mla_dims))
    assert TT.LMConfig(**dataclasses.asdict(jmx._FULL)).moe_dims \
        == TL.MoEDims(**dataclasses.asdict(jmx._FULL.moe_dims))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_pair(jcfg, seed, bias_to_expert0=False):
    dims = jcfg.moe_dims
    p, _ = JL.moe_init(jax.random.PRNGKey(seed), dims, jnp.float32)
    if bias_to_expert0:
        p = dict(p, router=p["router"].at[:, 0].set(0.5))
    shared = None
    if "shared" in p:
        shared = TL.SwiGLU(*(_t(p["shared"][k])
                             for k in ("w_gate", "w_up", "w_down")))
    tp = TL.MoE(_t(p["router"]), _t(p["w_gate"]), _t(p["w_up"]),
                _t(p["w_down"]), shared)
    return p, tp, TL.MoEDims(**dataclasses.asdict(dims))


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("B,S,biased", [(2, 48, False), (1, 97, False),
                                        (2, 97, True)])
def test_moe_apply_matches_jax(arch, B, S, biased):
    """y and the aux loss; the router's expert ids equal.  (1, 97) and (2,
    97) have T not divisible by 32 (one group of 97, two of 97); the
    biased router sends every token's first copy to expert 0, past its
    capacity of 64, so the stable sort decides which copies drop."""
    jcfg = ARCHS[arch]
    p, tp, dims = _moe_pair(jcfg, seed=S + B, bias_to_expert0=biased)
    x = np.random.default_rng(S).normal(size=(B, S, jcfg.d_model)).astype(
        np.float32) + (1.0 if biased else 0.0)
    y, aux = JL.moe_apply(p, jnp.asarray(x), jcfg.moe_dims,
                          compute_dtype=jnp.float32)
    ty, taux = TL.moe_apply(tp, _t(x), dims, compute_dtype=torch.float32)
    _close(ty, y)
    _close(taux, aux)

    G = TL._pick_groups(dims.dispatch_groups, B * S)
    logits = jnp.asarray(x).reshape(G, -1, jcfg.d_model) @ p["router"]
    _, jids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), dims.top_k)
    _, _, tids = TL.moe_route(tp, _t(x).reshape(G, -1, jcfg.d_model),
                              dims.top_k)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    if biased:
        C = TL.moe_capacity(dims, B * S // G)
        assert (tids[..., 0] == 0).all() and B * S // G > C


def test_moe_dispatch_drops_the_copies_past_capacity():
    """At the biased router every group overflows expert 0; the output
    differs from an undropped dispatch (capacity factor 8), so the drop
    is real, and matches JAX's at both."""
    jcfg = ARCHS["mixtral"]
    p, tp, dims = _moe_pair(jcfg, seed=3, bias_to_expert0=True)
    x = np.random.default_rng(3).normal(size=(2, 97, jcfg.d_model)).astype(
        np.float32) + 1.0
    ys = []
    for cf in (jcfg.capacity_factor, 8.0):
        jd = dataclasses.replace(jcfg.moe_dims, capacity_factor=cf)
        td = dataclasses.replace(dims, capacity_factor=cf)
        y, _ = JL.moe_apply(p, jnp.asarray(x), jd, compute_dtype=jnp.float32)
        ty, _ = TL.moe_apply(tp, _t(x), td, compute_dtype=torch.float32)
        _close(ty, y)
        ys.append(ty)
    assert float((ys[0] - ys[1]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_lora", [48, 0])
def test_mla_apply_and_decode_match_jax(q_lora):
    jcfg = dataclasses.replace(ARCHS["deepseek"], q_lora=q_lora)
    dims = jcfg.mla_dims
    tdims = TL.MLADims(**dataclasses.asdict(dims))
    p, _ = JL.mla_init(jax.random.PRNGKey(q_lora), dims, jnp.float32)
    tp = TL.MLA({k: _t(v) for k, v in p.items()})
    B, S, steps = 2, 37, 4
    rng = np.random.default_rng(q_lora)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    y, (c_kv, k_rope) = JL.mla_apply(p, jnp.asarray(x), dims,
                                     positions=jnp.asarray(pos),
                                     return_kv=True,
                                     compute_dtype=jnp.float32, attn_chunk=64)
    for attention in ("chunked", "flash"):
        ty, (tc, tk) = TL.mla_apply(tp, _t(x), tdims, positions=_t(pos),
                                    return_kv=True, attn_chunk=64,
                                    compute_dtype=torch.float32,
                                    attention=attention)
        _close(ty, y)
        _close(tc, c_kv)
        _close(tk, k_rope)
    assert tk.shape == (B, S, dims.d_rope)

    # 4 absorbed decode steps over a cache with room for them
    cap = S + steps
    jcache = {"c_kv": jnp.pad(c_kv, ((0, 0), (0, steps), (0, 0))),
              "k_rope": jnp.pad(k_rope, ((0, 0), (0, steps), (0, 0))),
              "len": jnp.full((B,), S, jnp.int32)}
    tcache = {k: _t(v) for k, v in jcache.items()}
    for step in range(steps):
        xs = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        y, jcache = JL.mla_decode(p, jnp.asarray(xs), jcache, dims,
                                  compute_dtype=jnp.float32)
        ty, tcache = TL.mla_decode(tp, _t(xs), tcache, tdims,
                                   compute_dtype=torch.float32)
        _close(ty, y)
        for k in ("c_kv", "k_rope"):
            _close(tcache[k], jcache[k])
        assert np.array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))
    assert tcache["c_kv"].shape == (B, cap, dims.kv_lora)


# ---------------------------------------------------------------------------
# sliding windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [1, 7, 32, 64, 500])
@pytest.mark.parametrize("S,chunk", [(64, 16), (50, 1024)])
def test_windowed_attention_matches_jax_chunked(window, S, chunk):
    """chunked_attention(window=) and the flash kernel's plain version
    against the JAX package's chunked_attention(window=), GQA 6/2."""
    rng = np.random.default_rng(window * 31 + S)
    q = rng.normal(size=(2, S, 6, 16)).astype(np.float32)
    k = rng.normal(size=(2, S, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, S, 2, 12)).astype(np.float32)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                chunk=chunk)
    got = TL.chunked_attention(_t(q), _t(k), _t(v), causal=True,
                               window=window, chunk=chunk)
    _close(got, want)
    _close(tref.flash_attention_ref(_t(q), _t(k), _t(v), window=window),
           want)


def test_plain_flash_rejects_what_a_window_cannot_take():
    q = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError, match="causal"):
        tref.flash_attention_ref(q, q, q, causal=False, window=3)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        tref.flash_attention_ref(q, q[:, :4], q[:, :4], window=3)
    with pytest.raises(ValueError, match=">= 0"):
        tref.flash_attention_ref(q, q, q, window=-1)


def test_plain_flash_in_row_blocks_equals_one_block(monkeypatch):
    rng = np.random.default_rng(4)
    q, k, v = (_t(rng.normal(size=(2, 70, 4, 8)).astype(np.float32))
               for _ in range(3))
    whole = tref.flash_attention_ref(q, k, v, window=9)
    monkeypatch.setattr(tref, "_SCORE_BLOCK", 2 * 4 * 70 * 6)   # 6 rows
    assert torch.equal(tref.flash_attention_ref(q, k, v, window=9), whole)


def test_gqa_decode_ring_wraps_like_jax():
    """A ring of 8 slots from len 5 over 10 steps: slots 5, 6, 7, 0, 1..."""
    jcfg = ARCHS["mixtral"]
    p, _ = JL.gqa_init(jax.random.PRNGKey(0), jcfg.d_model, jcfg.n_heads,
                       jcfg.n_kv_heads, jcfg.head_dim, dtype=jnp.float32)
    tp = TL.GQA(*(_t(p[k]) for k in ("wq", "wk", "wv", "wo")))
    rng = np.random.default_rng(0)
    B, W = 2, 8
    shape = (B, W, jcfg.n_kv_heads, jcfg.head_dim)
    jcache = {"k": jnp.asarray(rng.normal(size=shape).astype(np.float32)),
              "v": jnp.asarray(rng.normal(size=shape).astype(np.float32)),
              "len": jnp.asarray([5, 7], jnp.int32)}
    tcache = {k: _t(v) for k, v in jcache.items()}
    for _ in range(10):
        x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        y, jcache = JL.gqa_decode(p, jnp.asarray(x), jcache, window=W,
                                  compute_dtype=jnp.float32)
        ty, tcache = TL.gqa_decode(tp, _t(x), tcache, window=W,
                                   compute_dtype=torch.float32)
        _close(ty, y)
        _close(tcache["k"], jcache["k"])
        _close(tcache["v"], jcache["v"])
    assert tcache["len"].tolist() == [15, 17]


# ---------------------------------------------------------------------------
# the model: prefill caches, decode across the wrap, forward, loss
# ---------------------------------------------------------------------------

# mixtral-smoke's window is 32: S < w, S = w, S > w with (S - w) % w = 13,
# S > 2w; deepseek-v2-smoke (MLA) at a short and a longer prompt.
PREFILL_CASES = [("mixtral", 20), ("mixtral", 32), ("mixtral", 45),
                 ("mixtral", 77), ("deepseek", 20), ("deepseek", 45)]


@pytest.mark.parametrize("arch,S", PREFILL_CASES)
def test_prefill_and_decode_match_jax(arch, S):
    """Prefill's logits and every cache entry, then 14 decode steps (the
    mixtral ring wraps from every start: S + 14 > 32), logits at each and
    the caches after them."""
    jcfg = ARCHS[arch]
    jprefill, jstep = _jax_serve(arch)
    params, tcfg, model = _models(jcfg, seed=S)
    B, steps = 2, 14
    toks = _tokens(jcfg, B, S, seed=S)
    jl, jc = jprefill(params, jnp.asarray(toks), S + steps)
    with torch.inference_mode():
        tl, tc = TT.prefill(model, tcfg, _t(toks), max_len=S + steps)
    assert set(tc) == set(jc)
    _close(tl, jl)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        if k == "len":
            assert np.array_equal(tc[k].numpy(), np.asarray(jc[k]))
        else:
            _close(tc[k], jc[k])
    if jcfg.sliding_window:
        assert tc["k"].shape[2] == jcfg.sliding_window
    rng = np.random.default_rng(S + 1)
    for _ in range(steps):
        tok = rng.integers(0, jcfg.vocab_size, (B,)).astype(np.int32)
        jl, jc = jstep(params, jnp.asarray(tok), jc)
        with torch.inference_mode():
            tl, tc = TT.decode_step(model, tcfg, _t(tok), tc)
        _close(tl, jl)
    for k in jc:
        _close(tc[k], jc[k])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_cache_matches_jax(arch):
    jcfg = ARCHS[arch]
    for max_len in (10, 32, 100):
        jc = JT.init_cache(jcfg, 3, max_len)
        tc = TT.init_cache(_tcfg(jcfg), 3, max_len, device="cpu")
        assert {k: tuple(v.shape) for k, v in tc.items()} \
            == {k: v.shape for k, v in jc.items()}
        assert tc["len"].dtype == torch.int32


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_and_loss_match_jax(arch):
    """forward's logits and summed MoE aux loss, and loss_fn's value and
    metrics (its gradients wait for the training slice)."""
    jcfg = ARCHS[arch]
    params, tcfg, model = _models(jcfg, seed=7)
    toks = _tokens(jcfg, 2, 40, seed=7)
    labels = np.concatenate([toks[:, 1:], -np.ones((2, 1), np.int32)], 1)
    jlog, jaux = JT.forward(params, jcfg, jnp.asarray(toks))
    jloss, jm = JT.loss_fn(params, jcfg, jnp.asarray(toks),
                           jnp.asarray(labels))
    with torch.no_grad():
        tlog, taux = TT.forward(model, tcfg, _t(toks))
        tloss, tm = TT.loss_fn(model, tcfg, _t(toks), _t(labels))
    _close(tlog, jlog)
    _close(taux, jaux)
    assert float(taux) > 0
    _close(tloss, jloss)
    for k in ("ce", "aux", "ppl"):
        _close(tm[k], jm[k])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_weights_round_trip(arch):
    """lm_from_numpy then lm_to_numpy gives the JAX tree back, leaf for
    leaf (MoE and MLA keys, the dense_layers/moe_layers split); the
    trainer's leaves list the JAX tree's leaf paths in its order."""
    jcfg = ARCHS[arch]
    params, _ = JT.init_params(jax.random.PRNGKey(2), jcfg)
    tree = jax.tree.map(np.asarray, params)
    model = lm_from_numpy(_tcfg(jcfg), tree, device="cpu")
    back = lm_to_numpy(model)
    want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype and np.array_equal(got[path], a), \
            path
    assert [p for p, _, _ in lm_leaves(model)] == \
        [p for p, _ in flatten_with_paths(tree)]
    with pytest.raises(ValueError, match="moe_layers"):
        lm_from_numpy(_tcfg(jcfg), {k: v for k, v in tree.items()
                                    if k != "moe_layers"}, device="cpu")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_builds_the_jax_stack(arch):
    """The port's own seeded model has the JAX tree's paths, shapes and
    dtypes (dense layers first, then MoE layers)."""
    jcfg = ARCHS[arch]
    params, _ = JT.init_params(jax.random.PRNGKey(0), jcfg)
    want = {jax.tree_util.keystr(p): (a.shape, str(a.dtype)) for p, a in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    model = TT.init_params(_tcfg(jcfg), seed=0, device="cpu")
    got = {jax.tree_util.keystr(p): (a.shape, str(a.dtype)) for p, a in
           jax.tree_util.tree_flatten_with_path(lm_to_numpy(model))[0]}
    assert got == want
