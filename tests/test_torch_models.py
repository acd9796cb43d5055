"""The port's dense LM held against the JAX package on the CPU.

JAX draws the weights (``repro.models.transformer.init_params``); they
pass to the port as numpy arrays through ``models.weights.lm_from_numpy``.
Token ids come from numpy seeds.  At the smoke config (fp32) the two
sides agree within 1e-4: XLA and torch sum the matmuls and the softmax
in different orders, and prefill attention is the plain flash version
(dense softmax) on the port's side against the chunked online softmax
on JAX's.
"""

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import qwen1_5_0_5b as jqwen
from repro.configs import two_tower_retrieval as jtt
from repro.models import layers as JL
from repro.models import transformer as JT

from repro_torch.configs import get_arch
from repro_torch.configs import qwen1_5_0_5b as tqwen
from repro_torch.configs import two_tower_retrieval as ttt
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.weights import lm_from_numpy

TOL = 1e-4


def _jax_model(cfg, seed=0):
    params, _ = JT.init_params(jax.random.PRNGKey(seed), cfg)
    return params, jax.tree.map(np.asarray, params)


def _tcfg(jcfg):
    """The port's LMConfig with the same field values."""
    return TT.LMConfig(**dataclasses.asdict(jcfg))


def _err(a, b) -> float:
    a = a.to(torch.float32).numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)
    b = b.to(torch.float32).numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("name", ["_FULL", "_SMOKE"])
def test_configs_equal_the_jax_package(name):
    for jmod, tmod in ((jqwen, tqwen), (jtt, ttt)):
        j, t = getattr(jmod, name), getattr(tmod, name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t), jmod.__name__
    jspec, tspec = jqwen.SPEC, get_arch("qwen1.5-0.5b")
    for f in ("arch_id", "family", "source", "shape_ids", "notes"):
        assert getattr(jspec, f) == getattr(tspec, f), f
    assert tqwen._FULL.padded_vocab == jqwen._FULL.padded_vocab
    assert tqwen._FULL.head_dim == jqwen._FULL.head_dim


def test_get_arch_names_roadmap_for_unported_archs():
    assert get_arch("two-tower-retrieval").family == "recsys"
    assert get_arch("mixtral-8x22b").family == "lm"
    assert get_arch("graphsage-reddit").family == "gnn"
    with pytest.raises(KeyError, match="ROADMAP"):
        get_arch("fim-eclat")


@pytest.mark.parametrize("flag", [dict(moe=True, n_experts=4, top_k=2),
                                  dict(mla=True, kv_lora=16),
                                  dict(sliding_window=8)])
def test_moe_mla_and_sliding_window_raise_not_implemented(flag):
    """MoE, MLA and sliding windows serve (their models and caches build)
    and train: the trainer raises NotImplementedError for none of them
    (their gradients are held against JAX in test_torch_train_lm.py)."""
    from repro_torch.launch.train import train_lm

    cfg = dataclasses.replace(tqwen._SMOKE, **flag)
    TT.init_params(cfg, device="cpu")
    cache = TT.init_cache(cfg, 1, 16, device="cpu")
    assert ("c_kv" in cache) == bool(cfg.mla)
    out = train_lm(cfg, steps=1, batch=1, seq_len=8, device="cpu",
                   log_fn=lambda *_: 0)
    assert np.isfinite(out["final"]["loss"])
    assert (out["final"]["aux"] > 0) == bool(cfg.moe)


def test_seeded_init_shapes_follow_the_jax_tree():
    cfg = tqwen._SMOKE
    model = TT.init_params(cfg, seed=1, device="cpu")
    _, tree = _jax_model(jqwen._SMOKE)
    st = tree["dense_layers"]
    assert tuple(model.embed.table.shape) == tree["embed"]["table"].shape
    assert len(model.layers) == cfg.n_layers
    for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
        got = getattr(model.layers[0].attn, name)
        assert tuple(got.shape) == st["attn"][name].shape[1:], name
        assert not got.requires_grad
    again = TT.init_params(cfg, seed=1, device="cpu")
    assert torch.equal(model.layers[1].mlp.w_up, again.layers[1].mlp.w_up)
    assert model.lm_head is None            # tied embeddings


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    assert _err(got, want) < TOL
    scale = rng.normal(size=(16,)).astype(np.float32)
    got = TL.rmsnorm(TL.RMSNorm(torch.from_numpy(scale)),
                     torch.from_numpy(x), 1e-6)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("bias", [False, True])
def test_dense_matches_jax(bias):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 7, 24)).astype(np.float32)
    w = rng.normal(size=(24, 40)).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32)
    jp = {"kernel": jnp.asarray(w)}
    tp = TL.Dense(torch.from_numpy(w), torch.from_numpy(b) if bias else None)
    if bias:
        jp["bias"] = jnp.asarray(b)
    want = JL.dense(jp, jnp.asarray(x), compute_dtype=jnp.float32)
    got = TL.dense(tp, torch.from_numpy(x), compute_dtype=torch.float32)
    assert _err(got, want) < TOL
    g = torch.Generator().manual_seed(0)
    p = TL.dense_init(24, 40, generator=g, bias=bias, dtype=torch.float32)
    assert tuple(p.kernel.shape) == (24, 40) and (p.bias is None) != bias


def test_gqa_apply_matches_jax():
    cfg = jqwen._SMOKE
    params, tree = _jax_model(cfg)
    model = lm_from_numpy(_tcfg(cfg), tree, device="cpu")
    rng = np.random.default_rng(1)
    B, S = 2, 40
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    p0 = jax.tree.map(lambda a: a[0], params["dense_layers"]["attn"])
    jy, (jk, jv) = JL.gqa_apply(p0, jnp.asarray(x), positions=jnp.asarray(pos),
                                rope_theta=cfg.rope_theta,
                                attn_chunk=cfg.attn_chunk,
                                compute_dtype=jnp.float32, return_kv=True)
    ty, (tk, tv) = TL.gqa_apply(model.layers[0].attn, torch.from_numpy(x),
                                positions=torch.from_numpy(pos),
                                rope_theta=cfg.rope_theta,
                                compute_dtype=torch.float32, return_kv=True)
    assert _err(ty, jy) < TOL
    assert _err(tk, jk) < TOL and _err(tv, jv) < TOL


@pytest.mark.parametrize("S,max_len", [(40, 44), (64, None)])
def test_prefill_and_decode_steps_match_jax(S, max_len):
    cfg = jqwen._SMOKE
    params, tree = _jax_model(cfg)
    tcfg = _tcfg(cfg)
    model = lm_from_numpy(tcfg, tree, device="cpu")
    rng = np.random.default_rng(2)
    B = 3
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jlog, jcache = JT.prefill(params, cfg, jnp.asarray(tokens),
                              max_len=max_len)
    tlog, tcache = TT.prefill(model, tcfg, torch.from_numpy(tokens),
                              max_len=max_len)
    assert tuple(tlog.shape) == (B, cfg.padded_vocab)
    assert tlog.dtype == torch.float32
    assert _err(tlog, jlog) < TOL
    for key in ("k", "v"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        assert _err(tcache[key], jcache[key]) < TOL
    assert np.array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))
    # Decode past the cache capacity too (slot min(pos, S - 1)).
    cap = tcache["k"].shape[2]
    for step in range(cap - S + 2):
        tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        jlog, jcache = JT.decode_step(params, cfg, jnp.asarray(tok), jcache)
        tlog, tcache = TT.decode_step(model, tcfg, torch.from_numpy(tok),
                                      tcache)
        assert _err(tlog, jlog) < TOL, step
        for key in ("k", "v"):
            assert _err(tcache[key], jcache[key]) < TOL, (step, key)
        assert np.array_equal(tcache["len"].numpy(),
                              np.asarray(jcache["len"]))


def test_decode_step_updates_the_cache_in_place():
    cfg = tqwen._SMOKE
    model = TT.init_params(cfg, device="cpu")
    tokens = torch.zeros((2, 5), dtype=torch.int32)
    _, cache = TT.prefill(model, cfg, tokens, max_len=8)
    k = cache["k"]
    before = k[:, :, 5].clone()
    _, new = TT.decode_step(model, cfg, torch.zeros(2, dtype=torch.int32),
                            cache)
    assert new["k"] is k and not torch.equal(k[:, :, 5], before)
    assert new["len"].tolist() == [6, 6]


def test_bf16_prefill_matches_jax():
    """bf16 keeps 8 significant bits, and XLA and torch round q/k/v, the
    attention output and the MLP's hidden activations to bf16 at other
    points (XLA may fuse the casts away), so the two sides' last-token
    logits (|logit| < ~1 here) differ by a few bf16 ulps: the bound is
    3e-2, the bf16 tolerance of ``tests/test_kernels.py``."""
    cfg = dataclasses.replace(jqwen._SMOKE, dtype="bfloat16")
    params, tree = _jax_model(cfg)
    tcfg = _tcfg(cfg)
    model = lm_from_numpy(tcfg, tree, device="cpu")
    assert model.embed.table.dtype == torch.bfloat16
    assert torch.equal(model.embed.table.view(torch.int16),
                       torch.from_numpy(np.array(tree["embed"]["table"]).view(
                           np.int16)))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    jlog, jcache = JT.prefill(params, cfg, jnp.asarray(tokens))
    tlog, tcache = TT.prefill(model, tcfg, torch.from_numpy(tokens))
    assert tcache["k"].dtype == torch.bfloat16
    assert _err(tlog, jlog) < 3e-2
