"""The port's two-tower retrieval path held against the JAX package on
the CPU: weights from ``repro.models.recsys.twotower_init`` carried
across as numpy, inputs from ``twotower_batch`` (whose port must be byte
identical).  fp32 throughout; the towers' matmuls sum in other orders on
the two sides, so embeddings and scores agree within 1e-5 and the top-k
ids exactly."""

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import two_tower_retrieval as jtt
from repro.data import recsys_data as jdata
from repro.models import recsys as JR

from repro_torch.data import recsys_data as tdata
from repro_torch.kernels import segment_embed as tse
from repro_torch.models import recsys as TR
from repro_torch.models.weights import recsys_from_numpy

TOL = 1e-5


def _models(seed=0):
    cfg = jtt._SMOKE
    params, _ = JR.twotower_init(jax.random.PRNGKey(seed), cfg)
    tcfg = TR.TwoTowerConfig(**dataclasses.asdict(cfg))
    model = recsys_from_numpy(jax.tree.map(np.asarray, params),
                              device="cpu")
    return cfg, params, tcfg, model


def _batch(cfg, seed, batch):
    b = tdata.twotower_batch(seed, batch, cfg.n_users, cfg.n_items,
                             cfg.n_user_hist)
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


def _err(a, b) -> float:
    return float(np.abs(a.numpy() - np.asarray(b)).max())


@pytest.mark.parametrize("seed,batch,n_users,n_items,hist", [
    (0, 8, 1000, 500, 10), (7, 512, 5_000_000, 2_000_000, 50),
    (3, 1, 5_000_000, 2_000_000, 50)])
def test_twotower_batch_byte_identical(seed, batch, n_users, n_items, hist):
    want = jdata.twotower_batch(seed, batch, n_users, n_items, hist)
    got = tdata.twotower_batch(seed, batch, n_users, n_items, hist)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_matches_jax_model_function(combiner):
    cfg, params, _, model = _models()
    b, tb = _batch(cfg, 1, 6)
    want = JR.embedding_bag(params["item_emb"], jnp.asarray(b["hist_ids"]),
                            jnp.asarray(b["hist_mask"]), combiner)
    got = TR.embedding_bag(model.item_emb, tb["hist_ids"], tb["hist_mask"],
                           combiner)
    assert _err(got, want) < TOL
    want = JR.embedding_bag(params["item_emb"], jnp.asarray(b["hist_ids"]),
                            None, combiner)
    got = TR.embedding_bag(model.item_emb, tb["hist_ids"], None, combiner)
    assert _err(got, want) < TOL


def test_max_combiner_waits_for_a_later_slice():
    """The ``max`` combiner, once left for a later slice, is ported (plain
    PyTorch, as JAX computes it in jnp): equal to the JAX model function
    with a mask (an all-masked bag gives ``finfo.min``) and without."""
    cfg, params, _, model = _models()
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.n_items, (6, 9)).astype(np.int32)
    mask = rng.random((6, 9)) < 0.5
    mask[3] = False
    for m in (mask, None):
        want = JR.embedding_bag(params["item_emb"], jnp.asarray(ids),
                                None if m is None else jnp.asarray(m),
                                "max")
        got = TR.embedding_bag(model.item_emb, torch.from_numpy(ids),
                               None if m is None else torch.from_numpy(m),
                               "max")
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_user_and_item_embed_match_jax():
    cfg, params, tcfg, model = _models()
    b, tb = _batch(cfg, 2, 16)
    want = JR.user_embed(params, cfg, jnp.asarray(b["user_id"]),
                         jnp.asarray(b["hist_ids"]),
                         jnp.asarray(b["hist_mask"]))
    before = tse.embedding_bag.launches
    got = TR.user_embed(model, tcfg, tb["user_id"], tb["hist_ids"],
                        tb["hist_mask"])
    assert tse.embedding_bag.launches == before     # CPU: plain version
    assert got.shape == (16, cfg.tower_mlp[-1])
    assert _err(got, want) < TOL
    items = np.arange(0, cfg.n_items, 7, dtype=np.int32)
    want = JR.item_embed(params, cfg, jnp.asarray(items))
    got = TR.item_embed(model, tcfg, torch.from_numpy(items))
    assert _err(got, want) < TOL
    assert np.allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("seed,n_queries,topk", [(3, 1, 100), (4, 3, 17)])
def test_retrieval_scores_match_jax(seed, n_queries, topk):
    cfg, params, tcfg, model = _models(seed)
    b, tb = _batch(cfg, seed, n_queries)
    cand = np.random.default_rng(seed).permutation(cfg.n_items).astype(
        np.int32)
    jv, ji = JR.retrieval_scores(params, cfg, jnp.asarray(b["user_id"]),
                                 jnp.asarray(b["hist_ids"]),
                                 jnp.asarray(b["hist_mask"]),
                                 jnp.asarray(cand), topk=topk)
    tv, ti = TR.retrieval_scores(model, tcfg, tb["user_id"], tb["hist_ids"],
                                 tb["hist_mask"], torch.from_numpy(cand),
                                 topk=topk)
    assert tuple(ti.shape) == (n_queries, topk)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert _err(tv, jv) < TOL


def test_seeded_twotower_init_shapes():
    tcfg = TR.TwoTowerConfig(**dataclasses.asdict(jtt._SMOKE))
    model = TR.twotower_init(tcfg, seed=5, device="cpu")
    assert tuple(model.user_emb.table.shape) == (1000, 32)
    assert [tuple(lp.w.shape) for lp in model.user_tower] == [(64, 64),
                                                              (64, 32)]
    assert [tuple(lp.w.shape) for lp in model.item_tower] == [(32, 64),
                                                              (64, 32)]
    again = TR.twotower_init(tcfg, seed=5, device="cpu")
    assert torch.equal(model.item_tower[1].w, again.item_tower[1].w)
