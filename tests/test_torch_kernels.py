"""The port's kernel layer held bit for bit against the JAX package.

Inputs are made with numpy from a seed and fed to both the jnp refs /
``repro.kernels.ops`` and ``repro_torch.kernels.ops`` on the CPU, where
the port takes the plain PyTorch versions of its Hopper kernels.  The
words are drawn over the full uint32 range, so bit 31 is set in about
half of them (int32 ``>>`` is arithmetic in the port's layout).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.bitmap import popcount32_np as j_popcount32_np
from repro.core.bitmap import suffix_popcounts_np as j_suffix_np
from repro.kernels import ops as jops
from repro.kernels.compact import compact_gather as pallas_compact_gather
from repro.kernels.ref import (bitmap_count_ref, bitmap_intersect_es_ref,
                               bitmap_intersect_full_ref, compact_gather_ref,
                               screen_and_intersect_ref, screen_pairs_ref)

from repro_torch.core import bitmap as tbitmap
from repro_torch.kernels import bitmap_intersect as tbi
from repro_torch.kernels import compact as tcompact
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _random_bitmaps(rng, n, n_blocks, bw, density=0.25):
    u = rng.integers(0, 2 ** 32, (n, n_blocks, bw),
                     dtype=np.uint64).astype(np.uint32)
    m = rng.integers(0, 2 ** 32, (n, n_blocks, bw),
                     dtype=np.uint64).astype(np.uint32)
    if density < 0.5:
        u &= m
    return u


def _t(a: np.ndarray) -> torch.Tensor:
    """Host uint32/int32 array -> the port's int32 tensor (same bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _eq(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.int32 and b.dtype == np.uint32:
        a = a.view(np.uint32)
    return a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# popcount / suffix tables
# ---------------------------------------------------------------------------

def test_popcount_and_suffix_match_reference_with_bit31_words():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2 ** 32, (5, 7, 16), dtype=np.uint64).astype(
        np.uint32)
    x[0, 0, :4] = [0x80000000, 0xFFFFFFFF, 0x80000001, 0x7FFFFFFF]
    pc = tbitmap.popcount32(_t(x)).numpy()
    assert pc.dtype == np.int32
    assert np.array_equal(pc, j_popcount32_np(x))
    assert np.array_equal(pc[0, 0, :4], [1, 32, 2, 31])
    suf = tbitmap.suffix_popcounts(_t(x))
    assert suf.dtype == torch.int32
    assert np.array_equal(suf.numpy(), j_suffix_np(x))
    assert np.array_equal(tbitmap.suffix_popcounts_np(x), j_suffix_np(x))


# ---------------------------------------------------------------------------
# blocked ES scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["and", "andnot"])
@pytest.mark.parametrize("n_blocks,bw", [(1, 128), (3, 128), (5, 8), (9, 1)])
def test_bitmap_kernel_matches_ref(mode, n_blocks, bw):
    rng = np.random.default_rng(42)
    n_pairs = 7
    U = _random_bitmaps(rng, n_pairs, n_blocks, bw)
    V = _random_bitmaps(rng, n_pairs, n_blocks, bw)
    su, sv = j_suffix_np(U), j_suffix_np(V)
    rho = j_popcount32_np(U).reshape(n_pairs, -1).sum(1).astype(np.int32)
    n_trans = n_blocks * bw * 32
    for minsup in (-3, 0, 1, n_trans // 64, n_trans // 8, n_trans):
        r = bitmap_intersect_es_ref(U, V, su, sv, rho, jnp.int32(minsup),
                                    mode=mode)
        p = tops.bitmap_intersect_es(_t(U), _t(V), _t(su), _t(sv), _t(rho),
                                     minsup, mode=mode)
        for name, a, b in zip(("Z", "cnt", "blocks", "alive"), p, r,
                              strict=True):
            assert _eq(a.numpy(), np.asarray(b)), (mode, minsup, name)


def test_bitmap_kernel_es_aborts_and_freezes():
    """Dead pairs stop processing blocks, freeze counts and read back zero
    past the abort (the paper's semantics quantised to blocks)."""
    rng = np.random.default_rng(0)
    U = _random_bitmaps(rng, 16, 6, 8, density=0.2)
    V = _random_bitmaps(rng, 16, 6, 8, density=0.2)
    su, sv = j_suffix_np(U), j_suffix_np(V)
    minsup = 6 * 8 * 32 // 4
    Z, cnt, blocks, alive = tops.bitmap_intersect_es(
        _t(U), _t(V), _t(su), _t(sv), torch.zeros(16, dtype=torch.int32),
        minsup, mode="and")
    blocks, Z = blocks.numpy(), _u32(Z)
    assert (blocks < 6).any() and not alive.numpy()[blocks < 6].any()
    full = j_popcount32_np(U & V).sum(-1)
    for i in range(16):
        assert not Z[i, blocks[i]:].any()
        assert cnt[i] == full[i, :blocks[i]].sum()


@pytest.mark.parametrize("mode", ["and", "andnot"])
def test_full_intersect_count_and_screen_match_refs(mode):
    rng = np.random.default_rng(7)
    U = _random_bitmaps(rng, 5, 3, 8, density=0.3)
    V = _random_bitmaps(rng, 5, 3, 8, density=0.3)
    Z, cnt = tops.bitmap_intersect_full(_t(U), _t(V), mode=mode)
    rZ, rcnt = bitmap_intersect_full_ref(U, V, mode=mode)
    assert _eq(Z.numpy(), np.asarray(rZ)) and _eq(cnt.numpy(),
                                                   np.asarray(rcnt))
    if mode == "and":
        assert _eq(tops.bitmap_count(_t(U), _t(V)).numpy(),
                   np.asarray(bitmap_count_ref(U, V)))
    su, sv = j_suffix_np(U), j_suffix_np(V)
    rho = su[:, 0].astype(np.int32)
    bound, ok = tops.screen_pairs(_t(U[:, 0]), _t(V[:, 0]), _t(su[:, 1]),
                                  _t(sv[:, 1]), _t(rho), 40, mode=mode)
    rb, rok = screen_pairs_ref(U[:, 0], V[:, 0], su[:, 1], sv[:, 1], rho,
                               jnp.int32(40), mode=mode)
    assert _eq(bound.numpy(), np.asarray(rb))
    assert _eq(ok.numpy(), np.asarray(rok))


# ---------------------------------------------------------------------------
# fused dispatch: gather + scan + survivor-only scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("es", [False, True])
@pytest.mark.parametrize("mode", ["and", "andnot"])
@pytest.mark.parametrize("n_blocks,bw", [(1, 128), (3, 128), (5, 8)])
def test_fused_screen_and_intersect_matches_ref(es, mode, n_blocks, bw):
    """Child rows and suffix tables land at ``slots`` only for survivors;
    dead pairs' slots, slots >= capacity and untouched rows stay as they
    were — equal to the jnp ref and to the JAX ops dispatch."""
    rng = np.random.default_rng(11)
    cap, n_pairs = 32, 9
    store0 = _random_bitmaps(rng, cap, n_blocks, bw)
    suffix0 = j_suffix_np(store0)
    ua = rng.integers(0, 12, n_pairs).astype(np.int32)
    vb = rng.integers(0, 12, n_pairs).astype(np.int32)
    slots = np.arange(12, 12 + n_pairs, dtype=np.int32)
    slots[-1] = cap + 3          # pad slot: must be skipped
    rho = suffix0[ua, 0].astype(np.int32)
    n_trans = n_blocks * bw * 32
    for minsup in (0, 1, n_trans // 64, n_trans // 8):
        rows_r, suf_r, cnt_r, blocks_r, alive_r = screen_and_intersect_ref(
            store0, suffix0, ua, vb, slots, rho, jnp.int32(minsup),
            mode=mode, early_stop=es)
        rows, suffix = _t(store0), _t(suffix0)
        out = tops.screen_and_intersect(rows, suffix, ua, vb, slots, rho,
                                        minsup, mode=mode, early_stop=es)
        assert out[0] is rows and out[1] is suffix     # updated in place
        key = (es, mode, minsup)
        for a, b in zip(out[2:], (cnt_r, blocks_r, alive_r), strict=True):
            assert _eq(a.numpy(), np.asarray(b)), key
        assert _eq(rows.numpy(), np.asarray(rows_r)), key
        assert _eq(suffix.numpy(), np.asarray(suf_r)), key
        support = (out[2].numpy() if mode == "and"
                   else rho - out[2].numpy())
        keep = out[4].numpy() & (support >= minsup)
        for i in np.flatnonzero(~keep[:-1]):
            assert np.array_equal(_u32(rows)[slots[i]], store0[slots[i]])
        # and the JAX ops dispatch (jnp backend) agrees too
        jr = jops.screen_and_intersect(
            jnp.asarray(store0), jnp.asarray(suffix0), ua, vb, slots, rho,
            jnp.int32(minsup), mode=mode, early_stop=es, backend="jnp")
        assert _eq(rows.numpy(), np.asarray(jr[0])), key


# ---------------------------------------------------------------------------
# compaction gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("new_cap", [4, 16, 48])
def test_compact_rows_matches_ref(new_cap):
    """Live destinations carry their source bit for bit; perm < 0 and
    perm >= capacity destinations come up zeroed, on rows, suffix tables
    and (cap, 3) codes alike."""
    rng = np.random.default_rng(5)
    cap = 32
    rows = rng.integers(0, 2 ** 32, (cap, 3, 8), dtype=np.uint64
                        ).astype(np.uint32)
    suffix = j_suffix_np(rows)
    codes = rng.integers(-1000, 1000, (cap, 3)).astype(np.int32)
    perm = rng.permutation(cap)[:new_cap].astype(np.int32)
    perm = np.resize(perm, new_cap)
    perm[::3] = -1
    perm[1::5] = cap + 2                 # out of range: zero-filled
    gr, gs = tops.compact_rows(_t(rows), _t(suffix), perm)
    assert _eq(gr.numpy(), np.asarray(compact_gather_ref(
        jnp.asarray(rows), perm)))
    assert _eq(gs.numpy(), np.asarray(compact_gather_ref(
        jnp.asarray(suffix), perm)))
    gc = tref.compact_gather_ref(_t(codes), _t(perm))
    assert _eq(gc.numpy(), np.asarray(compact_gather_ref(
        jnp.asarray(codes), perm)))
    for i, src in enumerate(perm):
        want = rows[src] if 0 <= src < cap else 0
        assert np.array_equal(_u32(gr)[i], np.broadcast_to(want,
                                                            rows[0].shape))


def test_compact_out_of_range_follows_ref_not_pallas_clip():
    """Known divergence, pinned: the Pallas compact_gather clips perm >=
    capacity to capacity - 1 and copies that row; the jnp ref — and the
    port, kernel and plain version alike — zero-fill it."""
    rng = np.random.default_rng(9)
    cap = 8
    slab = rng.integers(1, 1000, (cap, 4)).astype(np.int32)
    perm = np.array([0, cap, cap + 5, -1], np.int32)
    pallas = np.asarray(pallas_compact_gather(jnp.asarray(slab),
                                              jnp.asarray(perm),
                                              interpret=True))
    assert np.array_equal(pallas[1], slab[cap - 1])
    port = tref.compact_gather_ref(_t(slab), _t(perm)).numpy()
    assert np.array_equal(port[0], slab[0])
    assert not port[1:].any()
    assert _eq(port, np.asarray(compact_gather_ref(jnp.asarray(slab),
                                                   perm)))


# ---------------------------------------------------------------------------
# dispatch rules
# ---------------------------------------------------------------------------

def test_ops_backend_argument():
    U = torch.zeros((2, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown backend"):
        tops.bitmap_count(U, U, backend="jnp")
    assert tops.bitmap_count(U, U, backend="plain").tolist() == [0, 0]


def test_kernel_wrappers_reject_cpu_tensors():
    """The kernel wrappers launch only on CUDA tensors and raise on
    anything else — before any build is attempted."""
    U = torch.zeros((2, 1, 4), dtype=torch.int32)
    s = torch.zeros((2, 2), dtype=torch.int32)
    r = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tbi.bitmap_intersect_es(U, U, s, s, r, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tbi.screen_and_intersect(U, s, r, r, r, r, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tcompact.compact_gather(s, r)
    assert tbi.bitmap_intersect_es.launches == 0
    assert tcompact.compact_gather.launches == 0


def test_upload_columns_cpu_roundtrip():
    cols = [np.arange(5, dtype=np.int32), np.full(5, -7, np.int32)]
    host, (a, b) = tops.upload_columns(torch.device("cpu"), cols)
    assert host.shape == (2, 5)
    assert a.tolist() == list(range(5)) and b.tolist() == [-7] * 5
