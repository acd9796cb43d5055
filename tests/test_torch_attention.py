"""The port's plain flash attention and EmbeddingBag held against the JAX
package on the CPU.

Inputs are made with numpy from a seed and fed to both
``repro.kernels`` (the jnp refs, and the Pallas kernels in interpret
mode) and ``repro_torch.kernels.ops``, which takes the plain PyTorch
versions of its Hopper kernels for CPU tensors.  Tolerances are those of
``tests/test_kernels.py``: 2e-5 for fp32 attention and 3e-2 for bf16
(the two sides round bf16 at other places and sum in other orders),
1e-5 for EmbeddingBag.
"""

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ref import embedding_bag_ref, flash_attention_ref
from repro.kernels.segment_embed import embedding_bag as pallas_bag

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_embed as tse

SWEEP = [
    (2, 128, 128, 4, 2, 32, 32, True, "float32", 2e-5),
    (1, 256, 256, 8, 8, 64, 64, True, "float32", 2e-5),
    (2, 128, 256, 4, 1, 32, 16, False, "float32", 2e-5),
    (1, 128, 128, 4, 4, 128, 128, True, "float32", 2e-5),
    (1, 128, 128, 4, 2, 32, 32, True, "bfloat16", 3e-2),
]

RAGGED = [
    (1, 1, 1, 2, 1, 16, 16, True, "float32", 2e-5),
    (2, 65, 65, 4, 2, 32, 32, True, "float32", 2e-5),
    (1, 200, 200, 4, 4, 64, 64, True, "float32", 2e-5),
    (1, 70, 130, 4, 2, 32, 24, False, "float32", 2e-5),
    (1, 130, 70, 2, 2, 16, 16, True, "float32", 2e-5),
    (1, 65, 65, 4, 2, 32, 32, True, "bfloat16", 3e-2),
]


def _qkv(rng, B, Sq, Skv, H, KH, D, Dv):
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, Dv)).astype(np.float32))


def _torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,Dv,causal,dtype,tol", SWEEP)
def test_plain_flash_matches_ref_and_pallas_on_sweep(B, Sq, Skv, H, KH, D,
                                                      Dv, causal, dtype,
                                                      tol):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, B, Sq, Skv, H, KH, D, Dv)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    want = flash_attention_ref(jq, jk, jv, causal=causal)
    pallas = pallas_flash(jq, jk, jv, causal=causal, q_block=64, kv_block=64)
    got = tops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                               _torch(v, dtype), causal=causal)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (B, Sq, H, Dv)
    for other in (want, pallas):
        err = float(np.abs(_np32(got) - _np32(other)).max())
        assert err < tol, err


@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,Dv,causal,dtype,tol", RAGGED)
def test_plain_flash_takes_ragged_lengths(B, Sq, Skv, H, KH, D, Dv, causal,
                                          dtype, tol):
    """Any Sq and Skv: the Pallas kernel needs Sq % q_block == 0, so the
    ragged cases are held against the jnp ref only."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, B, Sq, Skv, H, KH, D, Dv)
    want = flash_attention_ref(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                               causal=causal)
    got = tops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                               _torch(v, dtype), causal=causal)
    err = float(np.abs(_np32(got) - _np32(want)).max())
    assert err < tol, err


# bf16 cases of the tensor-core kernel's card tests (tests/test_torch_cuda.py),
# with the serve head shape (H 16, D 64) at S 256: B, Sq, Skv, H, KH, D, Dv,
# causal.
BF16_EDGES = [
    (2, 128, 128, 4, 2, 16, 16, True),
    (1, 256, 256, 8, 8, 64, 64, True),
    (1, 128, 128, 4, 4, 128, 128, True),
    (1, 70, 130, 4, 2, 32, 24, True),
    (2, 128, 256, 4, 1, 32, 32, True),
    (2, 128, 256, 4, 2, 64, 64, False),
    (1, 70, 130, 4, 2, 32, 32, True),
    (1, 130, 70, 2, 2, 16, 16, True),
    (1, 1, 1, 2, 1, 16, 16, True),
    (2, 65, 65, 4, 2, 32, 32, True),
    (1, 256, 256, 16, 16, 64, 64, True),
    (1, 300, 300, 4, 2, 6, 10, True),
]


def _tensor_core_rounding(q, k, v, causal, block=128):
    """The bf16 tensor-core kernel's arithmetic in plain torch: bf16 q, k,
    v unscaled; S = q k^T in fp32; the scale applied to S as c = scale *
    log2(e) with p = 2^(s c - m) over 128-key tiles (online max and sum in
    fp32); P rounded to bf16 before P V; fp32 accumulation; the output
    divided by max(l, 1e-30) and rounded to bf16."""
    B, Sq, H, D = q.shape
    _, Skv, KH, Dv = v.shape
    c = torch.tensor(D ** -0.5, dtype=torch.float32) * 1.4426950408889634
    qf = q.float().reshape(B, Sq, KH, H // KH, D)
    kf, vf = k.float(), v.float()
    m = torch.full((B, Sq, KH, H // KH), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Sq, KH, H // KH, Dv))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, block):
        keys = torch.arange(k0, min(k0 + block, Skv))[None, :]
        s = torch.einsum("bqkgd,bskd->bqkgs", qf, kf[:, k0:k0 + block])
        if causal:
            s = s.masked_fill((keys > rows)[None, :, None, None, :],
                              float("-inf"))
        m_new = torch.maximum(m, s.amax(-1) * c)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgs,bskv->bqkgv", p.to(torch.bfloat16).float(),
            vf[:, k0:k0 + block])
        m = m_new
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.reshape(B, Sq, H, Dv).to(torch.bfloat16)


@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,Dv,causal", BF16_EDGES)
def test_tensor_core_rounding_meets_the_bf16_tolerance(B, Sq, Skv, H, KH, D,
                                                       Dv, causal):
    """The rounding the bf16 kernel adopts (P in bf16, the scale on S)
    stays within 3e-2 of the JAX package's reference by construction."""
    rng = np.random.default_rng(Sq * 7 + Skv + D)
    q, k, v = _qkv(rng, B, Sq, Skv, H, KH, D, Dv)
    jq, jk, jv = (jnp.asarray(a, "bfloat16") for a in (q, k, v))
    want = flash_attention_ref(jq, jk, jv, causal=causal)
    got = _tensor_core_rounding(*(_torch(a, "bfloat16") for a in (q, k, v)),
                                causal)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, Sq, H, Dv)
    err = float(np.abs(_np32(got) - _np32(want)).max())
    assert err < 3e-2, err


def test_plain_flash_softmax_scale_and_masked_rows_finite():
    """An explicit ``softmax_scale`` is honoured, and with Sq > Skv under
    the top-left causal mask every row still sees key 0 (no NaN)."""
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, 1, 9, 4, 2, 2, 8, 8)
    got = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               softmax_scale=0.3)
    want = flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                               softmax_scale=0.3)
    assert np.isfinite(got.numpy()).all()
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 2e-5


@pytest.mark.parametrize("V,D,B,L,comb", [
    (100, 16, 8, 5, "mean"), (64, 32, 16, 9, "sum"),
    (257, 8, 4, 3, "mean"), (1000, 64, 8, 20, "mean"),
])
def test_plain_embedding_bag_matches_ref_and_pallas(V, D, B, L, comb):
    rng = np.random.default_rng(4)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    mask = rng.random((B, L)) < 0.8
    want = embedding_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                             jnp.asarray(mask), combiner=comb)
    pallas = pallas_bag(jnp.asarray(table), jnp.asarray(ids),
                        jnp.asarray(mask), combiner=comb, bag_block=4)
    for m in (torch.from_numpy(mask),
              torch.from_numpy(mask.astype(np.int32))):
        got = tops.embedding_bag(torch.from_numpy(table),
                                 torch.from_numpy(ids), m, combiner=comb)
        for other in (want, pallas):
            assert float(np.abs(got.numpy() - np.asarray(other)).max()) \
                < 1e-5


def test_plain_embedding_bag_all_masked_bag_is_zero():
    table = torch.ones((8, 4))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    mask = torch.tensor([[False] * 3, [True] * 3])
    out = tops.embedding_bag(table, ids, mask, combiner="mean")
    assert torch.equal(out[0], torch.zeros(4))
    assert torch.equal(out[1], torch.ones(4))
    want = embedding_bag_ref(jnp.ones((8, 4)), jnp.zeros((2, 3), jnp.int32),
                             jnp.asarray(mask.numpy()), combiner="mean")
    assert np.array_equal(out.numpy(), np.asarray(want))


def test_plain_embedding_bag_ignores_masked_ids_out_of_range():
    """A masked slot's id is never used: out-of-range ids there change
    nothing (the kernel never reads the row)."""
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 50, (6, 7)).astype(np.int32))
    mask = torch.from_numpy(rng.random((6, 7)) < 0.5)
    bad = ids.clone()
    bad[~mask] = 10 ** 6
    for comb in ("sum", "mean"):
        assert torch.equal(tref.embedding_bag_ref(table, ids, mask,
                                                  combiner=comb),
                           tref.embedding_bag_ref(table, bad, mask,
                                                  combiner=comb))


def test_ops_route_cpu_tensors_to_plain_and_wrappers_need_cuda():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="backend"):
        tops.flash_attention(q, q, q, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)
    table = torch.zeros((4, 8))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tse.embedding_bag(table, ids, ids)
    with pytest.raises(ValueError, match="combiner"):
        tops.embedding_bag(table, ids, ids, combiner="max")
    before = (tfa.flash_attention.launches, tse.embedding_bag.launches)
    tops.flash_attention(q, q, q)
    tops.embedding_bag(table, ids, ids)
    assert (tfa.flash_attention.launches,
            tse.embedding_bag.launches) == before
