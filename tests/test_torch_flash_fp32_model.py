"""A CPU model of the Hopper fp32 flash-attention kernel
(``flash_attn_kernel`` in ``src/repro_torch/csrc/flash_attention_fp32.cu``),
held against the JAX package's attention.

The CUDA kernel runs only on the card; this file checks its design here.
The model does what the kernel's warps do, fragment by fragment: a CTA of
8 warps of 16 query rows, Q staged once and scaled by ``scale * log2 e``,
K/V tiles of 64 keys (32 at D > 128) zero-padded to the kernel's row
strides,
each ``mma.sync m16n8k8`` TF32 product built from the PTX fragment
layout (lane ``(g, t) = (lane // 4, lane % 4)``), the operands split as
``hi + lo`` (hi rounded to 11 significant bits by an integer add and
mask, the tensor core reading the top 11 bits of lo), three products a
step, small ones first (S summed over d in 16-column chunks, each
chunk's partial sum added in fp32), the permuted sums over d and over
keys (P taken from the S accumulator as it lies), V's permuted columns
written back in order, the online softmax in log2 units with its -1e30
mask and its exponent against 0, a warp skipping tiles none of its rows
can see.  Each MMA's sum is rounded to fp32 to nearest here; the tensor
core rounds its own way, which the card tests
(``tests/test_torch_cuda.py``) hold.  Lane-parallel steps are numpy
operations over the (batch, head, warp) items and 32 lanes.

Tolerance 2e-5, the fp32 one of ``tests/test_kernels.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models import layers as JL

torch = pytest.importorskip("torch")
from repro_torch.kernels import ref as tref  # noqa: E402

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
# Fragment coordinates of m16n8k8 TF32 (PTX ISA): A (16 x 8, row), B (8 x
# 8, col), C/D (16 x 8), per lane and register.
A_ROW, A_COL = np.stack([G, G + 8, G, G + 8], 1), np.stack([T, T, T + 4, T + 4], 1)
B_ROW, B_COL = np.stack([T, T + 4], 1), np.stack([G, G], 1)
C_ROW = np.stack([G, G, G + 8, G + 8], 1)
C_COL = np.stack([2 * T, 2 * T + 1, 2 * T, 2 * T + 1], 1)
NEG = np.float32(-1e30)
F32 = np.float32
MASK = np.uint32(0xFFFFE000)


def _split(x):
    """hi = x rounded to TF32 (ties away from zero), lo = x - hi."""
    x = np.asarray(x, F32)
    hi = ((x.view(np.uint32) + np.uint32(0x1000)) & MASK).view(F32)
    return hi, (x - hi).astype(F32)


def _tf32(x):
    """What the tensor core reads of an fp32 register: its top 19 bits."""
    return (np.asarray(x, F32).view(np.uint32) & MASK).view(F32)


def _mma(d, a, b):
    """d += a b for each item: d (n, 32, 4), a (n, 32, 4), b (n, 32, 2)."""
    n = d.shape[0]
    A = np.zeros((n, 16, 8))
    B = np.zeros((n, 8, 8))
    C = np.zeros((n, 16, 8))
    A[:, A_ROW, A_COL] = _tf32(a)
    B[:, B_ROW, B_COL] = _tf32(b)
    C[:, C_ROW, C_COL] = d
    return (A @ B + C).astype(F32)[:, C_ROW, C_COL]


def _mma3(d, a, b, passes):
    """3xTF32 (small products first), or one TF32 product of the rounded
    operands (``passes=1``)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    if passes == 1:
        return _mma(d, ah, bh)
    return _mma(_mma(_mma(d, al, bh), ah, bl), ah, bh)


def _chunk(a, y, passes):
    """A 16-column chunk's partial sum of S for one n-tile, from zero: A
    fragments ``a`` of its two k-steps, K values ``y`` (n, 32, 4).  The
    small products of both steps first, then the large ones."""
    (h0, l0), (h1, l1) = _split(a[0]), _split(a[1])
    (g0, k0), (g1, k1) = _split(y[..., :2]), _split(y[..., 2:])
    pairs = ((l0, g0), (h0, k0), (l1, g1), (h1, k1), (h0, g0), (h1, g1))
    d = np.zeros(y.shape[:2] + (4,), F32)
    for x, z in pairs[4:] if passes == 1 else pairs:
        d = _mma(d, x, z)
    return d


def kernel_model(q, k, v, *, causal=True, window=0, scale=None, passes=3):
    """The fp32 kernel's output for numpy q (B, Sq, H, D), k (B, Skv, KH,
    D), v (B, Skv, KH, Dv)."""
    B, Sq, H, D = q.shape
    _, Skv, KH, Dv = v.shape
    scale = D ** -0.5 if scale is None else scale
    W = 8
    BQ = 16 * W
    KV = 64 if D <= 128 else 32                    # keys a K/V tile
    DK = 64 if D <= 64 else 128 if D <= 128 else 192
    DV = 64 if Dv <= 64 else 128
    dp = -(-D // 16) * 16                          # chunks not all zero
    ldq, ldv = DK + 16, DV + 4
    # Items: (b, h, warp), flattened; each has 32 lanes.
    N = B * H * W
    b_i, h_i, w_i = (a.ravel() for a in np.meshgrid(
        np.arange(B), np.arange(H), np.arange(W), indexing="ij"))
    bh_i = b_i * H + h_i
    kv_i = b_i * KH + h_i // (H // KH)
    c = F32(scale) * F32(1.4426950408889634)
    out = np.zeros((B, Sq, H, Dv), F32)
    e4 = np.arange(4)
    for q0 in range(0, Sq, BQ):
        n_q = min(BQ, Sq - q0)
        Qs = np.zeros((B, H, BQ, ldq), F32)
        Qs[:, :, :n_q, :D] = q[:, q0:q0 + n_q].transpose(0, 2, 1, 3)
        Qs = (Qs * c).reshape(B * H, BQ, ldq)
        kv_end = min(Skv, q0 + BQ) if causal else Skv
        kv_begin = max(0, q0 - window + 1) // KV * KV if window else 0
        n_tiles = -(-(kv_end - kv_begin) // KV)
        acc = np.zeros((N, DV // 8, 32, 4), F32)
        m = np.full((N, 2, 32), NEG, F32)
        l = np.zeros((N, 2, 32), F32)
        r0 = q0 + 16 * w_i
        row_g = 16 * w_i[:, None] + G[None]                  # (N, 32)
        for it in range(n_tiles):
            k0 = kv_begin + it * KV
            n_k = min(KV, Skv - k0)
            Ks = np.zeros((B, KH, KV, ldq), F32)
            Vs = np.zeros((B, KH, KV, ldv), F32)
            Ks[:, :, :n_k, :D] = k[:, k0:k0 + n_k].transpose(0, 2, 1, 3)
            Vs[:, :, :n_k, :Dv] = v[:, k0:k0 + n_k].transpose(0, 2, 1, 3)
            Ks = Ks.reshape(B * KH, KV, ldq)
            Vs = Vs.reshape(B * KH, KV, ldv)
            seen = (r0 < Sq) & ~(causal & (k0 > r0 + 15))
            if window:
                seen &= ~(r0 - (k0 + KV - 1) >= window)
            # S = Q K^T over 16-column chunks: lane (g, t) reads columns
            # 4t .. 4t + 3 of rows g, g + 8 and of key g of each n-tile.
            s = np.zeros((N, KV // 8, 32, 4), F32)
            for cc in range(0, dp, 16):
                cols = cc + 4 * T[:, None] + e4[None]           # (32, 4)
                xa = Qs[bh_i[:, None, None], row_g[:, :, None], cols[None]]
                xb = Qs[bh_i[:, None, None], row_g[:, :, None] + 8,
                        cols[None]]
                a = [np.stack([xa[..., 2 * st], xb[..., 2 * st],
                               xa[..., 2 * st + 1], xb[..., 2 * st + 1]], -1)
                     for st in range(2)]
                for n in range(KV // 8):
                    y = Ks[kv_i[:, None, None], (8 * n + G)[None, :, None],
                           cols[None]]
                    s[:, n] += _chunk(a, y, passes)
            key = (k0 + 8 * np.arange(KV // 8)[:, None, None]
                   + 2 * T[None, :, None] + (e4 % 2)[None, None])
            row = (r0[:, None, None, None] + G[None, None, :, None]
                   + 8 * (e4 // 2)[None, None, None])
            masked = np.broadcast_to(key >= Skv, row.shape[:1] + key.shape)
            if causal:
                masked = masked | (key[None] > row)
            if window:
                masked = masked | (row - key[None] >= window)
            need = np.full(N, k0 + KV > Skv)
            if causal:
                need |= k0 + KV - 1 > r0
            if window:
                need |= r0 + 15 - k0 >= window
            s = np.where(masked & need[:, None, None, None], NEG, s)
            # Online softmax: rows g (registers 0, 1) and g + 8 (2, 3).
            mt = np.stack([s[..., :2].max(axis=(1, 3)),
                           s[..., 2:].max(axis=(1, 3))], 1)   # (N, 2, 32)
            mt = np.repeat(mt.reshape(N, 2, 8, 4).max(-1), 4, axis=-1)
            m_new = np.maximum(m, mt)
            m_use = np.where(m_new > NEG, m_new, F32(0))
            corr = np.exp2(m - m_new).astype(F32)
            p = np.exp2(s - m_use[:, [0, 0, 1, 1]].transpose(0, 2, 1)[:, None]
                        ).astype(F32)
            assert (p[s <= NEG] == 0).all()
            l_new = l * corr + np.stack([p[..., :2].sum(axis=(1, 3)),
                                         p[..., 2:].sum(axis=(1, 3))], 1)
            a_new = acc * corr[:, [0, 0, 1, 1]].transpose(0, 2, 1)[:, None]
            # O += P V: k-step n reads V rows 8n + 2t and 8n + 2t + 1;
            # n-tile 4ch + i reads column 32ch + 4g + i.
            for n in range(KV // 8):
                pa = np.stack([p[:, n, :, 0], p[:, n, :, 2], p[:, n, :, 1],
                               p[:, n, :, 3]], -1)
                rows = (8 * n + 2 * T)[None, :, None]
                for ch in range(DV // 32):
                    vc = (32 * ch + 4 * G[:, None] + e4[None])[None]
                    v0 = Vs[kv_i[:, None, None], rows, vc]
                    v1 = Vs[kv_i[:, None, None], rows + 1, vc]
                    for i in range(4):
                        a_new[:, 4 * ch + i] = _mma3(
                            a_new[:, 4 * ch + i], pa,
                            np.stack([v0[..., i], v1[..., i]], -1), passes)
            m = np.where(seen[:, None, None], m_new, m)
            l = np.where(seen[:, None, None], l_new, l)
            acc = np.where(seen[:, None, None, None], a_new, acc)
        # Epilogue: row sums over a row's 4 lanes; column 32ch + 8t + 4half
        # + i is register 2r + half of n-tile 4ch + i.
        l4 = l.reshape(N, 2, 8, 4)
        l_row = ((l4[..., 0] + l4[..., 1]) + (l4[..., 2] + l4[..., 3]))
        inv = (F32(1) / np.maximum(l_row, F32(1e-30))).astype(F32)
        for r in range(2):
            rows = r0[:, None] + G[None] + 8 * r                # (N, 32)
            for ch in range(DV // 32):
                for half in range(2):
                    for i in range(4):
                        col = 32 * ch + 8 * T + 4 * half + i       # (32,)
                        val = acc[:, 4 * ch + i, :, 2 * r + half] * \
                            inv[:, r, G]
                        ok = (rows < Sq) & (col[None] < Dv)
                        n_ok, lane_ok = np.nonzero(ok)
                        out[b_i[n_ok], rows[n_ok, lane_ok], h_i[n_ok],
                            col[lane_ok]] = val[n_ok, lane_ok]
    return out


def _qkv(seed, B, Sq, Skv, H, KH, D, Dv):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(F32),
            rng.normal(size=(B, Skv, KH, D)).astype(F32),
            rng.normal(size=(B, Skv, KH, Dv)).astype(F32))


def _jax(q, k, v, causal, window, scale):
    """The JAX package's attention: ``flash_attention_ref``, or
    ``chunked_attention(window=)`` for a sliding window."""
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if window:
        return np.asarray(JL.chunked_attention(
            jq, jk, jv, causal=True, window=window, chunk=k.shape[1],
            softmax_scale=scale))
    return np.asarray(jax_flash_ref(jq, jk, jv, causal=causal,
                                    softmax_scale=scale))


# B, Sq, Skv, H, KH, D, Dv, causal, window: the fp32 sweep of
# tests/test_kernels.py and chip_smoke.py (ragged lengths, Sq != Skv both
# ways, GQA), non-causal with Skv >> Sq, both key tiles (64 keys; 32 at
# D > 128), MLA's D 192 / Dv 128 and the padded widths the card
# sweep has (D 6, 130, 136, 190; Dv 10, 24, 72, 100), and windows at and
# around the 64-key tile (a row whose first loaded tile it cannot see).
CASES = [
    (2, 128, 128, 4, 2, 32, 32, True, 0),
    (1, 256, 256, 8, 8, 64, 64, True, 0),
    (2, 128, 256, 4, 1, 32, 16, False, 0),
    (1, 128, 128, 4, 4, 128, 128, True, 0),
    (1, 1, 1, 2, 1, 16, 16, True, 0),
    (2, 65, 65, 4, 2, 32, 32, True, 0),
    (1, 200, 200, 4, 4, 64, 64, True, 0),
    (1, 70, 130, 4, 2, 32, 24, False, 0),
    (1, 130, 70, 2, 2, 16, 16, True, 0),
    (1, 33, 700, 4, 2, 64, 64, False, 0),
    (1, 20, 300, 2, 1, 192, 128, False, 0),
    (1, 150, 150, 2, 2, 192, 128, True, 0),
    (1, 100, 100, 2, 1, 136, 128, True, 0),
    (1, 90, 90, 2, 2, 130, 100, True, 0),
    (1, 150, 150, 4, 2, 6, 10, True, 37),
    (1, 140, 140, 4, 2, 190, 72, True, 64),
    (1, 300, 300, 4, 2, 64, 64, True, 1),
    (1, 300, 300, 4, 2, 64, 64, True, 63),
    (1, 300, 300, 4, 2, 64, 64, True, 64),
    (1, 300, 300, 4, 2, 64, 64, True, 65),
    (1, 333, 333, 4, 2, 128, 128, True, 129),
    (1, 200, 200, 2, 1, 192, 128, True, 33),
    (1, 40, 500, 4, 2, 128, 96, False, 0),
]


@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,Dv,causal,window", CASES)
def test_kernel_model_matches_the_jax_package(B, Sq, Skv, H, KH, D, Dv,
                                              causal, window):
    q, k, v = _qkv(Sq * 31 + Skv + D, B, Sq, Skv, H, KH, D, Dv)
    got = kernel_model(q, k, v, causal=causal, window=window)
    want = _jax(q, k, v, causal, window, None)
    plain = tref.flash_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window).numpy()
    assert got.shape == want.shape == (B, Sq, H, Dv)
    for other in (want, plain):
        err = float(np.abs(got - other).max())
        assert err < 2e-5, err


@pytest.mark.parametrize("scale", [0.3, -0.3, 0.0])
@pytest.mark.parametrize("window", [0, 100])
def test_kernel_model_takes_any_softmax_scale(scale, window):
    """Scale and log2 e are folded into Q: exact for a negative scale and
    for 0 (uniform weights), with a window's -1e30 mask too."""
    q, k, v = _qkv(11, 1, 200, 200, 4, 4, 64, 64)
    got = kernel_model(q, k, v, window=window, scale=scale)
    want = _jax(q, k, v, True, window, scale)
    assert float(np.abs(got - want).max()) < 2e-5


def test_one_tf32_pass_misses_the_tolerance_and_three_hold_it():
    """At softmax_scale 1 (scores of std ~8) one TF32 product of the
    rounded operands misses 2e-5; the 3xTF32 split holds it."""
    q, k, v = _qkv(7, 1, 192, 192, 4, 2, 64, 64)
    want = _jax(q, k, v, True, 0, 1.0)
    err3 = float(np.abs(kernel_model(q, k, v, scale=1.0) - want).max())
    err1 = float(np.abs(kernel_model(q, k, v, scale=1.0, passes=1)
                        - want).max())
    assert err3 < 2e-5, err3
    assert err1 > 2e-5, err1
