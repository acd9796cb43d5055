"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a host without a CUDA device every test here skips
(the ``cuda_device`` fixture decides at run time).  Imports neither JAX
nor the JAX package, so it runs on the card's machine as it is:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.core.bitmap import suffix_popcounts
from repro_torch.core.eclat import mine_bitmap
from repro_torch.core.prepost import mine_prepost_device
from repro_torch.data.transactions import (gen_dense_tabular,
                                           gen_powerlaw_baskets)
from repro_torch.kernels import _build, ops
from repro_torch.kernels.bitmap_diff import bitmap_diff_es
from repro_torch.kernels.bitmap_intersect import bitmap_intersect_es
from repro_torch.kernels.compact import compact_gather
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.nlist_merge import nlist_merge, zmerge_scatter
from repro_torch.kernels.segment_embed import embedding_bag

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rows(rng, n, nb, bw, dev):
    u = rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64)
    u &= rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64)
    return torch.from_numpy(u.astype(np.uint32).view(np.int32)).to(dev)


@pytest.mark.parametrize("mode", ["and", "andnot"])
@pytest.mark.parametrize("nb,bw", [(9, 1), (7, 8), (3, 128), (5, 3), (4, 256),
                                   (11, 6)])
def test_scan_kernel_matches_plain(cuda_device, mode, nb, bw):
    rng = np.random.default_rng(0)
    U, V = _rows(rng, 17, nb, bw, cuda_device), _rows(rng, 17, nb, bw,
                                                      cuda_device)
    su, sv = suffix_popcounts(U), suffix_popcounts(V)
    rho = su[:, 0].contiguous()
    before = bitmap_intersect_es.launches
    for minsup in (-1, 0, 1, nb * bw * 4, nb * bw * 8):
        got = ops.bitmap_intersect_es(U, V, su, sv, rho, minsup, mode=mode)
        want = ops.bitmap_intersect_es(U, V, su, sv, rho, minsup, mode=mode,
                                       backend="plain")
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), (mode, minsup)
    assert bitmap_intersect_es.launches == before + 5


@pytest.mark.parametrize("es", [True, False])
def test_fused_kernel_matches_plain(cuda_device, es):
    rng = np.random.default_rng(1)
    slab = _rows(rng, 40, 5, 8, cuda_device)
    suf = suffix_popcounts(slab)
    ua = np.arange(0, 10, dtype=np.int32)
    vb = np.arange(5, 15, dtype=np.int32)
    slots = np.arange(20, 30, dtype=np.int32)
    slots[-1] = 40                                  # pad slot: skipped
    rho = np.zeros(10, np.int32)
    for minsup in (1, 200, 400):
        rk, sk, rp, sp = slab.clone(), suf.clone(), slab.clone(), suf.clone()
        got = ops.screen_and_intersect(rk, sk, ua, vb, slots, rho, minsup,
                                       early_stop=es)
        want = ops.screen_and_intersect(rp, sp, ua, vb, slots, rho, minsup,
                                        early_stop=es, backend="plain")
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), minsup


def test_compact_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(2)
    perm = torch.tensor([3, -1, 0, 40, 7, 39, -5], dtype=torch.int32,
                        device=cuda_device)
    for slab in (_rows(rng, 40, 3, 8, cuda_device),
                 _rows(rng, 40, 1, 3, cuda_device)[:, 0].contiguous(),
                 suffix_popcounts(_rows(rng, 40, 6, 128, cuda_device))):
        before = compact_gather.launches
        got = compact_gather(slab, perm)
        assert compact_gather.launches == before + 1
        assert torch.equal(got, ops.compact_rows(slab, slab, perm,
                                                 backend="plain")[0])


def test_miner_on_card_equals_cpu(cuda_device):
    db = gen_powerlaw_baskets(n_trans=300, n_items=200, avg_trans_len=6,
                              seed=0)
    out_c, st_c = mine_bitmap(db, 3, block_words=8, device=cuda_device)
    out_p, st_p = mine_bitmap(db, 3, block_words=8, device="cpu")
    assert out_c == out_p and len(out_c) == 1687
    times = {"runtime_s", "assemble_s", "resolve_s"}
    assert ({k: v for k, v in st_c.as_dict().items() if k not in times}
            == {k: v for k, v in st_p.as_dict().items() if k not in times})


def test_purity_guard_raises_on_a_host_sync(cuda_device):
    """On CUDA the guard has teeth: a readback outside host_sync raises,
    one inside it does not, and the previous mode comes back."""
    from repro_torch.core.guards import device_purity_guard, host_sync

    x = torch.ones(4, device=cuda_device)
    before = torch.cuda.get_sync_debug_mode()
    with device_purity_guard():
        with pytest.raises(RuntimeError):
            x.sum().item()
        with host_sync("test readback"):
            assert x.sum().item() == 4.0
    assert torch.cuda.get_sync_debug_mode() == before


@pytest.mark.parametrize("nb,bw", [(9, 1), (7, 8), (3, 128), (84, 128),
                                   (5, 3), (4, 256), (11, 6)])
def test_diff_kernel_matches_plain(cuda_device, nb, bw):
    rng = np.random.default_rng(3)
    U, V = _rows(rng, 17, nb, bw, cuda_device), _rows(rng, 17, nb, bw,
                                                      cuda_device)
    U[::3, nb // 2] = 0                              # zero-mass U blocks
    su = suffix_popcounts(U)
    rho = su[:, 0].contiguous()
    before = bitmap_diff_es.launches
    for minsup in (-1, 0, 1, nb * bw * 4, nb * bw * 8):
        got = ops.bitmap_diff_es(U, V, su, rho, minsup)
        want = ops.bitmap_diff_es(U, V, su, rho, minsup, backend="plain")
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), minsup
    assert bitmap_diff_es.launches == before + 5


@pytest.mark.parametrize("es", [True, False])
def test_fused_diff_kernel_matches_plain(cuda_device, es):
    rng = np.random.default_rng(4)
    slab = _rows(rng, 40, 5, 8, cuda_device)
    slab[:8, 2] = 0
    suf = suffix_popcounts(slab)
    ua = np.arange(0, 10, dtype=np.int32)
    vb = np.arange(5, 15, dtype=np.int32)
    slots = np.arange(20, 30, dtype=np.int32)
    slots[-1] = 40                                  # skipped
    rho = suf[torch.from_numpy(ua).long().to(cuda_device), 0].cpu().numpy()
    for minsup in (1, 100, 200):
        rk, sk, rp, sp = slab.clone(), suf.clone(), slab.clone(), suf.clone()
        got = ops.screen_and_diff(rk, sk, ua, vb, slots, rho, minsup,
                                  early_stop=es)
        want = ops.screen_and_diff(rp, sp, ua, vb, slots, rho, minsup,
                                   early_stop=es, backend="plain")
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), minsup


# (P, nb, bw, warps a pair): pairs spread over several warps while the
# launch holds fewer than 64 warps an SM and the row gives each warp 512
# words; 8500 pairs take a warp each; bw 3, 6 and 1 take the scalar path.
LAYOUTS = [(6, 64, 128, 8), (6, 16, 128, 4), (6, 4, 256, 2),
           (2300, 16, 128, 4), (8500, 4, 256, 1), (2300, 6, 8, 1),
           (7, 5, 3, 1), (9, 11, 6, 1), (5, 300, 1, 1)]


@pytest.mark.parametrize("P,nb,bw,warps", LAYOUTS)
def test_scan_layouts_match_plain(cuda_device, P, nb, bw, warps):
    """Both layouts and both load widths, with random (inconsistent)
    suffix tables and a misaligned copy of the operands (4-byte loads)."""
    rng = np.random.default_rng(10)
    U, V = _rows(rng, P, nb, bw, cuda_device), _rows(rng, P, nb, bw,
                                                     cuda_device)
    su = torch.from_numpy(rng.integers(-50, nb * bw * 4, (P, nb + 1))
                          .astype(np.int32)).to(cuda_device)
    sv = torch.from_numpy(rng.integers(-50, nb * bw * 4, (P, nb + 1))
                          .astype(np.int32)).to(cuda_device)
    rho = torch.from_numpy(rng.integers(0, nb * bw * 16, P)
                           .astype(np.int32)).to(cuda_device)
    flat = torch.zeros(2 * U.numel() + 2, dtype=torch.int32,
                       device=cuda_device)
    Um = flat[1:1 + U.numel()].view(U.shape)
    Vm = flat[1 + U.numel():1 + 2 * U.numel()].view(U.shape)
    Um.copy_(U)
    Vm.copy_(V)
    assert _build.load().repro_scan_warps(P, nb, bw) == warps
    for mode in ("and", "andnot"):
        for minsup in (-4, 0, 1, nb * bw * 2, nb * bw * 6, nb * bw * 12):
            want = ops.bitmap_intersect_es(U, V, su, sv, rho, minsup,
                                           mode=mode, backend="plain")
            for a, b in ((U, V), (Um, Vm)):
                got = ops.bitmap_intersect_es(a, b, su, sv, rho, minsup,
                                              mode=mode)
                for g, w in zip(got, want, strict=True):
                    assert torch.equal(g, w), (mode, minsup)
    U[:, nb // 2] = 0                                # zero-mass U blocks
    su = suffix_popcounts(U)
    for minsup in (-4, 0, 1, nb * bw * 2, nb * bw * 6, nb * bw * 12):
        want = ops.bitmap_diff_es(U, V, su, rho, minsup, backend="plain")
        got = ops.bitmap_diff_es(U, V, su, rho, minsup)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), ("diff", minsup)


@pytest.mark.parametrize("P,nb,bw,warps", LAYOUTS)
def test_fused_layouts_match_plain(cuda_device, P, nb, bw, warps):
    """The fused dispatches in both layouts: survivors written, slots -1
    and cap skipped, non-survivor slots untouched."""
    rng = np.random.default_rng(11)
    n_rows = 16
    cap = n_rows + P
    slab = _rows(rng, cap, nb, bw, cuda_device)
    slab[:4, nb // 2] = 0
    suf = suffix_popcounts(slab)
    ua = rng.integers(0, n_rows, P).astype(np.int32)
    vb = rng.integers(0, n_rows, P).astype(np.int32)
    slots = np.arange(n_rows, n_rows + P, dtype=np.int32)
    slots[-1] = cap
    slots[-2] = -1
    rho = suf[torch.from_numpy(ua).long().to(cuda_device), 0].cpu().numpy()
    nt = nb * bw * 32
    for es in (True, False):
        for minsup in (0, 1, nt // 32, nt // 8, nt // 5):
            for fn, kw in ((ops.screen_and_intersect, {"mode": "and"}),
                           (ops.screen_and_intersect, {"mode": "andnot"}),
                           (ops.screen_and_diff, {})):
                rk, sk = slab.clone(), suf.clone()
                rp, sp = slab.clone(), suf.clone()
                got = fn(rk, sk, ua, vb, slots, rho, minsup, early_stop=es,
                         **kw)
                want = fn(rp, sp, ua, vb, slots, rho, minsup, early_stop=es,
                          backend="plain", **kw)
                for g, w in zip(got, want, strict=True):
                    assert torch.equal(g, w), (fn.__name__, kw, es, minsup)


def _pool(rng, cap, extents, dev):
    codes = np.stack([rng.integers(0, 1000, cap), rng.integers(0, 1000, cap),
                      rng.integers(1, 20, cap)], axis=1).astype(np.int32)
    for off, ln in extents:
        seg = codes[off:off + ln]
        codes[off:off + ln] = seg[np.argsort(seg[:, 0], kind="stable")]
    return torch.from_numpy(codes).to(dev)


@pytest.mark.parametrize("es", [True, False])
def test_nlist_kernels_match_plain(cuda_device, es):
    rng = np.random.default_rng(5)
    cap, P, lu, lv = 4096, 300, 32, 128
    u_off = rng.integers(0, 1024, P).astype(np.int32)
    v_off = rng.integers(1024, 2048 - lv, P).astype(np.int32)
    u_len = rng.integers(0, lu + 1, P).astype(np.int32)
    v_len = rng.integers(0, lv + 1, P).astype(np.int32)
    codes = _pool(rng, cap, list(zip(u_off, u_len)) + list(zip(v_off, v_len)),
                  cuda_device)
    rho = rng.integers(0, 200, P).astype(np.int32)
    m0, s0 = nlist_merge.launches, zmerge_scatter.launches
    for minsup in (0, 1, 20, 150):
        got = ops.nlist_presize(codes, u_off, u_len, v_off, v_len, rho,
                                minsup, lu=lu, lv=lv, early_stop=es)
        want = ops.nlist_presize(codes, u_off, u_len, v_off, v_len, rho,
                                 minsup, lu=lu, lv=lv, early_stop=es,
                                 backend="plain")
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), minsup
        out_off = (2048 + lu * np.arange(P)).astype(np.int32)
        out_off[::7] = cap + 1                       # skipped
        ck, cp = codes.clone(), codes.clone()
        a = ops.nlist_scatter(ck, got[0], u_off, u_len, v_off, v_len,
                              out_off, lu=lu, lv=lv)
        b = ops.nlist_scatter(cp, want[0], u_off, u_len, v_off, v_len,
                              out_off, lu=lu, lv=lv, backend="plain")
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        ck, cp = codes.clone(), codes.clone()
        a = ops.nlist_extend(ck, u_off, u_len, v_off, v_len, out_off, rho,
                             minsup, lu=lu, lv=lv, early_stop=es)
        b = ops.nlist_extend(cp, u_off, u_len, v_off, v_len, out_off, rho,
                             minsup, lu=lu, lv=lv, early_stop=es,
                             backend="plain")
        for g, w in zip(a, b, strict=True):
            assert torch.equal(g, w), minsup
    assert nlist_merge.launches == m0 + 8
    assert zmerge_scatter.launches == s0 + 8


def _nlist_pairs_pool(rng, pairs, dev):
    """The (U, V) code lists of ``pairs`` as extents of one slab with
    room for the children after them: (codes, cols, bump)."""
    cols, ext, bump = [[], [], [], []], [], 0
    for u, v in pairs:
        for arr, c in ((u, 0), (v, 2)):
            ext.append((bump, arr))
            cols[c].append(bump)
            cols[c + 1].append(len(arr))
            bump += len(arr)
    cap = bump + sum(cols[1]) + 64
    codes = rng.integers(0, 1000, (cap, 3)).astype(np.int32)
    for off, arr in ext:
        codes[off:off + len(arr)] = arr
    return (torch.from_numpy(codes).to(dev),
            [np.asarray(c, np.int32) for c in cols], bump)


def _nlist_case(dev, pairs, rho, plans, *, lu=None, out_off_fn=None):
    """Presize, scatter and extend on the card equal their plain versions
    for each (early_stop, minsup) of ``plans``; returns the last
    presize."""
    rng = np.random.default_rng(9)
    codes, cols, bump = _nlist_pairs_pool(rng, pairs, dev)
    cap = int(codes.shape[0])
    lu = lu or max(8, 1 << int(np.ceil(np.log2(max(int(cols[1].max()), 1)))))
    lv = max(8, 1 << int(np.ceil(np.log2(max(int(cols[3].max()), 1)))))
    rho = np.asarray(rho, np.int32)
    for es, minsup in plans:
        got = ops.nlist_presize(codes, *cols, rho, minsup, lu=lu, lv=lv,
                                early_stop=es)
        want = ops.nlist_presize(codes, *cols, rho, minsup, lu=lu, lv=lv,
                                 early_stop=es, backend="plain")
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), (es, minsup)
        out_off = (bump + np.concatenate([[0], np.cumsum(cols[1])[:-1]])
                   ).astype(np.int32)
        if out_off_fn is not None:
            out_off = out_off_fn(out_off, cap)
        ck, cp = codes.clone(), codes.clone()
        a = ops.nlist_scatter(ck, got[0], *cols, out_off, lu=lu, lv=lv)
        b = ops.nlist_scatter(cp, want[0], *cols, out_off, lu=lu, lv=lv,
                              backend="plain")
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        ck, cp = codes.clone(), codes.clone()
        a = ops.nlist_extend(ck, *cols, out_off, rho, minsup, lu=lu, lv=lv,
                             early_stop=es)
        b = ops.nlist_extend(cp, *cols, out_off, rho, minsup, lu=lu, lv=lv,
                             early_stop=es, backend="plain")
        for g, w in zip(a, b, strict=True):
            assert torch.equal(g, w), (es, minsup)
    return got


def _sorted_nlist(rng, n, span=300):
    pre = np.sort(rng.choice(span, n, replace=False))
    return np.stack([pre, rng.integers(0, span, n),
                     rng.integers(1, 20, n)], 1).astype(np.int32)


NL_EDGES = [0, 1, 31, 32, 33, 63, 64, 65]


@pytest.mark.parametrize("es", [True, False])
def test_nlist_kernels_at_window_edges(cuda_device, es):
    """Every pair of window-edge lengths (0, 1, 31-33, 63-65)."""
    rng = np.random.default_rng(12)
    pairs = [(_sorted_nlist(rng, n), _sorted_nlist(rng, m))
             for n in NL_EDGES for m in NL_EDGES]
    rho = [int(v[:, 2].sum()) for _, v in pairs]
    _nlist_case(cuda_device, pairs, rho, [(es, 1), (es, 80), (es, 400)])


def test_nlist_kernels_abort_on_the_first_step(cuda_device):
    """rho < minsup: the walk aborts on step 1, a j-step, an i-step
    without a match, or a match."""
    j_first = (np.array([[50, 10 ** 6, 2]], np.int32),
               _sorted_nlist(np.random.default_rng(1), 40, 40))
    i_first = (np.array([[0, 1, 2], [60, 5, 3]], np.int32),
               np.array([[10, 50, 4], [20, 3, 1]], np.int32))
    match_first = (np.array([[11, 5, 2]], np.int32),
                   np.array([[10, 50, 4]], np.int32))
    got = _nlist_case(cuda_device, [j_first, i_first, match_first],
                      [5, 5, 5], [(False, 100), (True, 100)])
    assert got[3].tolist() == [1, 1, 1] and not got[5].any().item()


@pytest.mark.parametrize("row", [0, 31, 32, 40])
def test_nlist_kernels_abort_on_an_i_step(cuda_device, row):
    """Every U code matches V's one code; U code ``row``'s negative
    frequency makes the guard fail on its own i-step."""
    k = np.arange(48)
    u = np.stack([10 + k, 1000 - k, np.ones(48)], 1).astype(np.int32)
    u[row, 2] = -(row + 100)
    v = np.array([[5, 10 ** 6, 7]], np.int32)
    got = _nlist_case(cuda_device, [(u, v)], [7], [(False, 7), (True, 7)])
    assert got[3].tolist() == [row + 1] and got[4].tolist() == [0]
    assert not got[5].any().item()


def test_nlist_scatter_with_negative_out_off(cuda_device):
    """Destinations below 0 are skipped one by one, like those past the
    slab; the pairs still report their child lengths."""
    rng = np.random.default_rng(13)
    pairs = [(_sorted_nlist(rng, 40), _sorted_nlist(rng, 20))
             for _ in range(6)]

    def shift(out_off, cap):
        out = out_off.copy()
        out[0], out[1], out[2] = -5, -1000, cap - 3    # straddle both ends
        return out
    _nlist_case(cuda_device, pairs, [0] * 6, [(False, 0), (True, 0)],
                out_off_fn=shift)


def test_nlist_kernels_with_lu_above_every_length(cuda_device):
    """A match table wider than every U (lu 1000, not a multiple of 4):
    the rest of each row is the sentinel, rows are not 16-byte aligned."""
    rng = np.random.default_rng(14)
    pairs = [(_sorted_nlist(rng, n), _sorted_nlist(rng, 50))
             for n in (0, 1, 33, 70)]
    rho = [int(v[:, 2].sum()) for _, v in pairs]
    for lu in (1000, 1024):
        _nlist_case(cuda_device, pairs, rho, [(True, 20), (False, 1)], lu=lu)


def test_nlist_kernels_on_a_32769_code_walk(cuda_device):
    """One U of 32,769 codes, each a descendant of V's one code: the walk
    goes through all of U, in one group, through a 65,536-wide table."""
    n = 32769
    k = np.arange(n)
    u = np.stack([10 + k, 10 ** 8 - k, 1 + k % 5], 1).astype(np.int32)
    v = np.array([[5, 10 ** 9, 3]], np.int32)
    got = _nlist_case(cuda_device, [(u, v)], [3], [(True, 1)], lu=65536)
    assert got[3].tolist() == [n] and got[1].tolist() == [1]


@pytest.mark.parametrize("scheme", ["declat", "adaptive", "prepost"])
def test_slice2_engines_on_card_equal_cpu(cuda_device, scheme):
    db = gen_dense_tabular(n_trans=500, n_cols=9, vals_per_col=4, seed=0)
    if scheme == "prepost":
        run = lambda dev: mine_prepost_device(db, 175, device=dev)  # noqa
    else:
        kw = (dict(block_words=1, diff_density=0.3, diff_hysteresis=0.05)
              if scheme == "adaptive" else dict(block_words=8))
        run = lambda dev: mine_bitmap(db, 175, scheme, device=dev,  # noqa
                                      **kw)
    out_c, st_c = run(cuda_device)
    out_p, st_p = run("cpu")
    assert out_c == out_p and len(out_c) == 321
    times = {"runtime_s", "assemble_s", "resolve_s"}
    assert ({k: v for k, v in st_c.as_dict().items() if k not in times}
            == {k: v for k, v in st_p.as_dict().items() if k not in times})


# ---------------------------------------------------------------------------
# flash attention and EmbeddingBag (the serving paths)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,Dv,causal,dtype,tol", [
    (2, 128, 128, 4, 2, 32, 32, True, torch.float32, 2e-5),
    (1, 256, 256, 8, 8, 64, 64, True, torch.float32, 2e-5),
    (2, 128, 256, 4, 1, 32, 16, False, torch.float32, 2e-5),
    (1, 128, 128, 4, 4, 128, 128, True, torch.float32, 2e-5),
    (1, 128, 128, 4, 2, 32, 32, True, torch.bfloat16, 3e-2),
    (1, 1, 1, 2, 1, 16, 16, True, torch.float32, 2e-5),
    (2, 65, 65, 4, 2, 32, 32, True, torch.float32, 2e-5),
    (1, 200, 200, 4, 4, 64, 64, True, torch.bfloat16, 3e-2),
    (1, 70, 130, 4, 2, 32, 24, False, torch.float32, 2e-5),
    (1, 130, 70, 2, 2, 16, 16, True, torch.float32, 2e-5),
    # bf16 runs on the tensor-core kernel: its own edges
    (2, 128, 128, 4, 2, 16, 16, True, torch.bfloat16, 3e-2),
    (1, 256, 256, 8, 8, 64, 64, True, torch.bfloat16, 3e-2),
    (1, 128, 128, 4, 4, 128, 128, True, torch.bfloat16, 3e-2),
    (1, 70, 130, 4, 2, 32, 24, True, torch.bfloat16, 3e-2),
    (2, 128, 256, 4, 1, 32, 32, True, torch.bfloat16, 3e-2),
    (2, 128, 256, 4, 2, 64, 64, False, torch.bfloat16, 3e-2),
    (1, 70, 130, 4, 2, 32, 32, True, torch.bfloat16, 3e-2),
    (1, 130, 70, 2, 2, 16, 16, True, torch.bfloat16, 3e-2),
    (1, 1, 1, 2, 1, 16, 16, True, torch.bfloat16, 3e-2),
    (2, 65, 65, 4, 2, 32, 32, True, torch.bfloat16, 3e-2),
    (1, 1024, 1024, 16, 16, 64, 64, True, torch.bfloat16, 3e-2),
    (1, 300, 300, 4, 2, 6, 10, True, torch.bfloat16, 3e-2),  # plain-load fill
])
def test_flash_kernel_matches_plain(cuda_device, B, Sq, Skv, H, KH, D, Dv,
                                    causal, dtype, tol):
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in fp32
    g = torch.Generator(device=cuda_device).manual_seed(Sq * 131 + Skv)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
               for shape in ((B, Sq, H, D), (B, Skv, KH, D),
                             (B, Skv, KH, Dv)))
    before = flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention(q, k, v, causal=causal, backend="plain")
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err < tol, err


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_kernel_takes_any_softmax_scale(cuda_device, dtype, tol):
    """A positive scale is folded into the exponent (bf16); zero and
    negative scales take the kernel's multiply-first branch."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v = (torch.randn((1, 200, 4, 64), generator=g,
                           device=cuda_device).to(dtype) for _ in range(3))
    for scale in (0.3, -0.3, 0.0):
        got = ops.flash_attention(q, k, v, softmax_scale=scale)
        want = ops.flash_attention(q, k, v, softmax_scale=scale,
                                   backend="plain")
        err = (got.float() - want.float()).abs().max().item()
        assert err < tol, (scale, err)


def _sass_by_function(lib) -> dict:
    """``cuobjdump -sass`` of the kernels' library, split by function."""
    import shutil
    import subprocess
    from pathlib import Path

    tool = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).with_name("cuobjdump"))
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}


def test_bf16_flash_kernel_runs_on_the_tensor_cores(cuda_device):
    """The bf16 kernel's SASS holds warpgroup MMAs (HGMMA); the fp32
    kernel's holds no tensor-core MMA at all."""
    _build.load()
    funcs = _sass_by_function(_build.library_path())
    bf16 = {k: v for k, v in funcs.items() if "flash_wgmma_kernel" in k}
    fp32 = {k: v for k, v in funcs.items() if "flash_attn_kernel" in k}
    assert bf16 and fp32, sorted(funcs)
    for name, sass in bf16.items():
        assert "HGMMA" in sass, name
    for name, sass in fp32.items():
        assert "HGMMA" not in sass and "HMMA" not in sass, name


# B, S, H, KH, D, Dv, window: ragged lengths, windows at and around the
# 128-key tile (a row whose first loaded tile it cannot see), past S, and
# GQA 48/8 at mixtral's head width; then MLA's 192/128 heads (one kv head
# per query head), a partial third panel (D 136) and the plain-load fill
# (D 130, 190).
FLASH_WINDOW_CASES = [
    (2, 1000, 8, 2, 64, 64, 1), (1, 1000, 8, 2, 64, 64, 100),
    (1, 1000, 8, 2, 64, 64, 127), (1, 1000, 8, 2, 64, 64, 128),
    (1, 1000, 8, 2, 64, 64, 129), (1, 777, 4, 4, 32, 24, 1000),
    (1, 5000, 48, 8, 128, 128, 4096), (1, 1100, 48, 8, 128, 128, 300),
    (1, 300, 4, 2, 6, 10, 37),
]
FLASH_D192_CASES = [
    (2, 300, 4, 4, 192, 128, 0), (1, 1000, 8, 8, 192, 128, 0),
    (1, 129, 2, 2, 192, 64, 0), (1, 1000, 8, 8, 192, 128, 200),
    (1, 260, 2, 1, 136, 128, 0), (1, 200, 2, 2, 130, 100, 0),
    (1, 333, 4, 2, 190, 72, 64),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,S,H,KH,D,Dv,window",
                         FLASH_WINDOW_CASES + FLASH_D192_CASES)
def test_flash_kernel_window_and_wide_heads_match_plain(
        cuda_device, B, S, H, KH, D, Dv, window, dtype, tol):
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in fp32
    g = torch.Generator(device=cuda_device).manual_seed(S * 7 + window)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
               for shape in ((B, S, H, D), (B, S, KH, D), (B, S, KH, Dv)))
    before = flash_attention.launches
    got = ops.flash_attention(q, k, v, window=window)
    want = ops.flash_attention(q, k, v, window=window, backend="plain")
    assert flash_attention.launches == before + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err < tol, err


def test_flash_kernel_window_with_a_negative_scale(cuda_device):
    """The multiply-first branch masks with -1e30: a row whose first tile
    it cannot see still adds exactly 0 from it."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        q, k, v = (torch.randn((1, 512, 4, 64), generator=g,
                               device=cuda_device).to(dtype)
                   for _ in range(3))
        for w in (1, 128, 200):
            got = ops.flash_attention(q, k, v, window=w, softmax_scale=-0.2)
            want = ops.flash_attention(q, k, v, window=w, softmax_scale=-0.2,
                                       backend="plain")
            err = (got.float() - want.float()).abs().max().item()
            assert err < tol, (dtype, w, err)


def test_flash_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 4, 2, 8), device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(torch.zeros((1, 4, 2, 200), device=cuda_device),
                        *(torch.zeros((1, 4, 2, 200), device=cuda_device),) * 2)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, torch.zeros((1, 4, 2, 192), device=cuda_device))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, q, q, causal=False, window=2)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        flash_attention(torch.zeros((1, 5, 2, 8), device=cuda_device), q, q,
                        window=2)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="group"):
        flash_attention(torch.zeros((1, 4, 3, 8), device=cuda_device), q, q)


def _bag_inputs(rng, V, D, B, L, dev, p_valid=0.8):
    table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, V, (B, L)).astype(np.int32))
    mask = torch.from_numpy(rng.random((B, L)) < p_valid)
    return table.to(dev), ids.to(dev), mask.to(dev)


@pytest.mark.parametrize("V,D,B,L,comb", [
    (100, 16, 8, 5, "mean"), (64, 32, 16, 9, "sum"),
    (257, 8, 4, 3, "mean"), (1000, 64, 8, 20, "mean"),
    (300, 6, 33, 7, "sum"), (5000, 256, 70, 50, "mean")])
def test_bag_kernel_matches_plain(cuda_device, V, D, B, L, comb):
    rng = np.random.default_rng(V)
    table, ids, mask = _bag_inputs(rng, V, D, B, L, cuda_device)
    mask[0] = False                                  # an all-masked bag
    for m in (mask, mask.to(torch.int32)):
        before = embedding_bag.launches
        got = ops.embedding_bag(table, ids, m, combiner=comb)
        want = ops.embedding_bag(table, ids, m, combiner=comb,
                                 backend="plain")
        assert embedding_bag.launches == before + 1
        assert (got - want).abs().max().item() < 1e-5
        assert torch.equal(got, want)
        assert torch.equal(got[0], torch.zeros_like(got[0]))
    # A table that is not 16-byte aligned takes the scalar path.
    flat = torch.zeros(V * D + 1, device=cuda_device)
    off = flat[1:].view(V, D)
    off.copy_(table)
    got = ops.embedding_bag(off, ids, mask, combiner=comb)
    want = ops.embedding_bag(off, ids, mask, combiner=comb, backend="plain")
    assert (got - want).abs().max().item() < 1e-5


@pytest.mark.parametrize("V,D,B,L,comb", [
    (5000, 256, 40, 100, "mean"),   # past the 64 slots a warp holds at once
    (700, 12, 40, 100, "sum"),      # ... on the scalar path
    (3000, 64, 5000, 30, "mean"),   # the large-batch design
])
def test_bag_kernel_is_bit_equal(cuda_device, V, D, B, L, comb):
    """Slots are added in order, so the sums equal the plain version's bit
    for bit, here with a bag whose only valid slot is the last."""
    rng = np.random.default_rng(B + L)
    table, ids, mask = _bag_inputs(rng, V, D, B, L, cuda_device)
    mask[1] = False
    mask[1, -1] = True
    for m in (mask, mask.to(torch.int32)):
        got = ops.embedding_bag(table, ids, m, combiner=comb)
        want = ops.embedding_bag(table, ids, m, combiner=comb,
                                 backend="plain")
        assert torch.equal(got, want)
        assert torch.equal(got[1], table[ids[1, -1].long()])


def test_bag_kernel_row_offsets_are_64_bit(cuda_device):
    """Rows past 2^31 / D: at D = 256 an int32 ``id * D`` wraps beyond
    8,388,608 rows.  The table (8.6 GB) is left uninitialised except the
    rows the bags name."""
    D, V = 256, 2 ** 23 + 64
    table = torch.empty((V, D), device=cuda_device)
    rng = np.random.default_rng(9)
    ids_np = rng.integers(V - 64, V, (16, 5)).astype(np.int32)
    ids_np[:, 0] = rng.integers(0, 64, 16)
    ids = torch.from_numpy(ids_np).to(cuda_device)
    rows = torch.unique(ids.long())
    table[rows] = torch.randn((rows.numel(), D), device=cuda_device)
    mask = torch.ones((16, 5), dtype=torch.bool, device=cuda_device)
    got = ops.embedding_bag(table, ids, mask, combiner="sum")
    want = ops.embedding_bag(table, ids, mask, combiner="sum",
                             backend="plain")
    assert torch.equal(got, want)


def test_serving_paths_launch_their_kernels(cuda_device):
    """Prefill launches flash attention once per layer and decode not at
    all; the user tower launches the bag kernel; both agree with the
    plain paths."""
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys_data import twotower_batch
    from repro_torch.launch.serve import serve_greedy
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as T

    cfg = get_arch("qwen1.5-0.5b").smoke_config_fn()
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32)
    model = T.init_params(cfg, seed=0, device=cuda_device)
    before = flash_attention.launches
    got = serve_greedy(cfg, prompts, 5, model=model, device=cuda_device)
    assert flash_attention.launches == before + cfg.n_layers
    want = serve_greedy(cfg, prompts, 5, model=model, device=cuda_device,
                        backend="plain")
    assert np.array_equal(got, want)

    tcfg = get_arch("two-tower-retrieval").smoke_config_fn()
    tt = R.twotower_init(tcfg, seed=0, device=cuda_device)
    b = twotower_batch(0, 4, tcfg.n_users, tcfg.n_items, tcfg.n_user_hist)
    args = [torch.from_numpy(b[k]).to(cuda_device)
            for k in ("user_id", "hist_ids", "hist_mask")]
    cand = torch.arange(tcfg.n_items, dtype=torch.int32, device=cuda_device)
    before = embedding_bag.launches
    vk, ik = R.retrieval_scores(tt, tcfg, *args, cand, topk=10)
    assert embedding_bag.launches == before + 1
    vp, ip = R.retrieval_scores(tt, tcfg, *args, cand, topk=10,
                                backend="plain")
    assert torch.equal(ik, ip) and (vk - vp).abs().max().item() <= 1e-5


@pytest.mark.parametrize("arch,S", [("mixtral-8x22b", 40),
                                    ("mixtral-8x22b", 77),
                                    ("deepseek-v2-236b", 50)])
def test_moe_serving_on_card_launches_and_matches_plain(cuda_device, arch,
                                                        S):
    """The MoE/MLA/sliding-window serving path on the card: prefill
    launches flash attention once a layer (windowed past the smoke
    window of 32; 24-wide MLA heads), and the decode loop (ring wrap, MoE
    dispatch, latent cache) runs under the device-purity guard, so the
    dispatch never waits for the card; tokens equal the plain path's."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_greedy
    from repro_torch.models import transformer as T

    cfg = get_arch(arch).smoke_config_fn()
    prompts = np.random.default_rng(S).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    model = T.init_params(cfg, seed=1, device=cuda_device)
    before = flash_attention.launches
    got = serve_greedy(cfg, prompts, 40, model=model, device=cuda_device)
    assert flash_attention.launches == before + cfg.n_layers
    want = serve_greedy(cfg, prompts, 40, model=model, device=cuda_device,
                        backend="plain")
    assert np.array_equal(got, want)


def test_sharded_dispatch_on_card_matches_plain(cuda_device):
    """The sharded dispatch (``ops.ShardedScreen``) in a gloo world of two
    ranks sharing the card, against the plain sharded dispatch: the scan
    kernel with per-pair thresholds, then the survivors' second launch."""
    import torch_dist_ranks
    torch_dist_ranks.check_dispatch((2, 1), str(cuda_device), 300.0)


@pytest.mark.parametrize("comb", ["sum", "mean"])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32])
def test_bag_autograd_rule_launches_and_matches_plain(cuda_device, comb,
                                                      mask_dtype):
    """Under autograd the forward launches the kernel (bit-equal to the
    plain version) and the table's gradient equals the plain path's
    autograd gradient; an all-masked bag adds nothing.  Both gradients
    accumulate with atomics, so they agree to rounding, not bit for
    bit."""
    rng = np.random.default_rng(21)
    table, ids, mask = _bag_inputs(rng, 3000, 64, 300, 20, cuda_device)
    mask[0] = False                                  # an all-masked bag
    mask = mask.to(mask_dtype)
    g = torch.randn((300, 64), device=cuda_device)
    grads = {}
    for backend in ("auto", "plain"):
        t = table.clone().requires_grad_()
        before = embedding_bag.launches
        out = ops.embedding_bag(t, ids, mask, combiner=comb,
                                backend=backend)
        assert embedding_bag.launches == before + (backend == "auto")
        out.backward(g)
        grads[backend] = (out.detach(), t.grad)
    assert torch.equal(grads["auto"][0], grads["plain"][0])
    err = (grads["auto"][1] - grads["plain"][1]).abs().max().item()
    assert err <= 1e-6 * grads["plain"][1].abs().max().item()
    touched = torch.zeros(3000, dtype=torch.bool, device=cuda_device)
    touched[ids[mask.bool()].long()] = True
    assert torch.equal(grads["auto"][1][~touched],
                       torch.zeros_like(grads["auto"][1][~touched]))


def test_twotower_train_step_launches_the_bag_kernel(cuda_device):
    """``make_train_step(twotower_loss)`` on the card: one bag launch a
    step, the loss finite and falling over a few steps."""
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys_data import twotower_batch
    from repro_torch.models import recsys as R
    from repro_torch.models.weights import recsys_leaves
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.train_step import make_train_step

    cfg = get_arch("two-tower-retrieval").smoke_config_fn()
    model = R.twotower_init(cfg, seed=0, device=cuda_device, trainable=True)
    opt = opt_init(recsys_leaves(model), OptConfig(lr=1e-2,
                                                     warmup_steps=0))
    b = twotower_batch(0, 64, cfg.n_users, cfg.n_items, cfg.n_user_hist)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in b.items()}
    keys = ("user_id", "hist_ids", "hist_mask", "pos_item", "item_logq")
    step = make_train_step(lambda bt: R.twotower_loss(
        model, cfg, *(bt[k] for k in keys)), opt)
    losses = []
    for _ in range(5):
        before = embedding_bag.launches
        losses.append(float(step(batch)["loss"]))
        assert embedding_bag.launches == before + 1
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_train_lm_step_on_card_matches_cpu(cuda_device):
    """Two ``train_lm`` steps at the qwen smoke config on the card (the
    loop under the purity guard: a host sync raises) and on the CPU, from
    the same weights and batches, TF32 off: losses, grad norms and every
    final metric within 1e-4 relative."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train_lm
    from repro_torch.models import transformer as T
    from repro_torch.models.weights import lm_to_numpy

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_arch("qwen1.5-0.5b").smoke_config_fn()
    params = lm_to_numpy(T.init_params(cfg, seed=3, device="cpu"))
    out = {}
    for dev in ("cpu", cuda_device):
        logs = []
        out[str(dev)] = (train_lm(cfg, steps=2, batch=4, seq_len=64,
                                  log_every=1, log_fn=logs.append,
                                  device=dev, params=params), logs)
    (cpu, _), (card, _) = out["cpu"], out[str(cuda_device)]
    for (s1, a), (s2, b) in zip(card["history"], cpu["history"],
                                strict=True):
        assert s1 == s2 and abs(a - b) <= 1e-4 * abs(b)
    for k, v in cpu["final"].items():
        assert abs(card["final"][k] - v) <= 1e-4 * max(abs(v), 1e-30), k


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-236b"])
def test_moe_train_lm_step_on_card_matches_cpu(cuda_device, arch):
    """Two ``train_lm`` steps at the MoE smoke configs on the card (the
    loop under the purity guard: the dispatch's sort, ``searchsorted``
    and ``index_add_`` and their backward never wait for the card) and
    on the CPU, from the same weights and batches, TF32 off: losses and
    every final metric (aux loss, grad norm) within 1e-4 relative.  The
    MoE combine and the embedding gradient add with atomics on the card,
    so the two agree to rounding, not bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train_lm
    from repro_torch.models import transformer as T
    from repro_torch.models.weights import lm_to_numpy

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_arch(arch).smoke_config_fn()
    params = lm_to_numpy(T.init_params(cfg, seed=5, device="cpu"))
    out = {}
    for dev in ("cpu", cuda_device):
        out[str(dev)] = train_lm(cfg, steps=2, batch=2, seq_len=48,
                                 log_every=1, log_fn=lambda *_: 0,
                                 device=dev, params=params)
    cpu, card = out["cpu"], out[str(cuda_device)]
    for (s1, a), (s2, b) in zip(card["history"], cpu["history"],
                                strict=True):
        assert s1 == s2 and abs(a - b) <= 1e-4 * abs(b)
    assert cpu["final"]["aux"] > 0
    for k, v in cpu["final"].items():
        assert abs(card["final"][k] - v) <= 1e-4 * max(abs(v), 1e-30), k


@pytest.mark.parametrize("name", ["sasrec", "din", "xdeepfm"])
def test_recsys_models_on_card_match_cpu(cuda_device, name):
    """SASRec, DIN and xDeepFM at their smoke configs: the loss and every
    gradient on the card within 1e-5 of the CPU's (of each tensor's
    largest entry, floored at 1e-3 of the model's largest: DIN's
    attention output bias has an exactly zero gradient, rounding noise
    on both), and no kernel of the port launched."""
    from repro_torch.configs import get_arch
    from repro_torch.data import recsys_data as D
    from repro_torch.models import recsys as R
    from repro_torch.models import weights as W

    cfg = get_arch(name).smoke_config_fn()
    init = {"sasrec": R.sasrec_init, "din": R.din_init,
            "xdeepfm": R.xdeepfm_init}[name]
    loss_fn = {"sasrec": R.sasrec_loss, "din": R.din_loss,
               "xdeepfm": R.xdeepfm_loss}[name]
    b = {"sasrec": lambda: D.sasrec_batch(1, 64, cfg.seq_len, cfg.n_items,
                                          cfg.n_negatives),
         "din": lambda: D.din_batch(1, 64, cfg.seq_len, cfg.n_items,
                                    cfg.n_context, cfg.n_context_fields),
         "xdeepfm": lambda: D.xdeepfm_batch(1, 64, cfg.n_fields,
                                            cfg.vocab_per_field)}[name]()
    tree = W.recsys_to_numpy(init(cfg, seed=2, device="cpu"))
    got = {}
    before = (embedding_bag.launches, flash_attention.launches)
    for dev in ("cpu", cuda_device):
        model = W.recsys_from_numpy(tree, dev, trainable=True)
        leaves = W.recsys_leaves(model)
        loss, _ = loss_fn(model, cfg, *(torch.from_numpy(v).to(dev)
                                        for v in b.values()))
        grads = torch.autograd.grad(loss, [ps[0] for _, ps, _ in leaves])
        got[str(dev)] = [loss.detach().cpu()] + [g.cpu() for g in grads]
    assert (embedding_bag.launches, flash_attention.launches) == before
    cpu, card = got["cpu"], got[str(cuda_device)]
    floor = 1e-3 * max(g.abs().max().item() for g in cpu[1:])
    for a, b_ in zip(card, cpu, strict=True):
        scale = max(b_.abs().max().item(), floor)
        assert (a - b_).abs().max().item() <= 1e-5 * scale


def test_screened_retrieval_on_card_matches_the_exact_path(cuda_device):
    """``retrieval_scores_screened`` on the card (the bf16 screen on the
    tensor cores, the fp32 rescoring, the bag kernel once): with a
    shortlist that holds the exact top-k, the ids equal
    ``retrieval_scores``' and the scores are within 1e-5."""
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys_data import twotower_batch
    from repro_torch.models import recsys as R

    cfg = get_arch("two-tower-retrieval").smoke_config_fn()
    tt = R.twotower_init(cfg, seed=4, device=cuda_device)
    b = twotower_batch(4, 1, cfg.n_users, cfg.n_items, cfg.n_user_hist)
    args = [torch.from_numpy(b[k]).to(cuda_device)
            for k in ("user_id", "hist_ids", "hist_mask")]
    cand = torch.randperm(cfg.n_items, generator=torch.Generator()
                          .manual_seed(4)).to(torch.int32).to(cuda_device)
    before = embedding_bag.launches
    vs, ids = R.retrieval_scores_screened(tt, cfg, *args, cand, topk=10,
                                          shortlist=128)
    assert embedding_bag.launches == before + 1
    ve, ie = R.retrieval_scores(tt, cfg, *args, cand, topk=10)
    assert torch.equal(ids, ie)
    assert (vs - ve).abs().max().item() <= 1e-5


def _gnn_case(name):
    """(config, loss function, batch on a device) of a small GNN cell."""
    from repro_torch.configs import get_arch
    from repro_torch.data import graph_data as GD
    from repro_torch.models import gnn as G

    spec = get_arch("graphsage-reddit")
    if name == "sampled":
        cfg = spec.smoke_config_fn()
        g = GD.gen_powerlaw_graph(500, 8.0, cfg.d_feat, cfg.n_classes,
                                  seed=5)
        feats, masks = GD.NeighborSampler(g.edge_src, g.edge_dst, 500,
                                          seed=5).sample_batch(
            np.arange(64), tuple(cfg.fanouts), g.x)

        def batch(dev):
            return (tuple(torch.from_numpy(np.ascontiguousarray(f)).to(dev)
                          for f in feats),
                    tuple(torch.from_numpy(np.ascontiguousarray(m)).to(dev)
                          for m in masks),
                    torch.from_numpy(g.labels[:64]).to(dev))
        return cfg, G.loss_sampled, batch
    cfg = spec.config_fn(name)
    if name == "molecule":
        g = GD.gen_batched_molecules(128, 30, 64, cfg.d_feat, cfg.n_classes,
                                     seed=5)
    else:
        g = GD.gen_powerlaw_graph(2816, 10752 / 2816, cfg.d_feat,
                                  cfg.n_classes, seed=5)
    mask = np.arange(g.x.shape[0]) % 3 != 0

    def batch(dev):
        return tuple(torch.from_numpy(a).to(dev) for a in
                     (g.x, g.edge_src, g.edge_dst, g.labels, mask))
    return cfg, G.loss_full, batch


@pytest.mark.parametrize("name", ["full_graph_sm", "molecule", "sampled"])
def test_gnn_on_card_matches_cpu(cuda_device, name):
    """GraphSAGE's loss and every gradient on the card within 1e-4 of the
    CPU's (of the leaf's largest entry), the segment sums' atomics under
    deterministic algorithms; no kernel of the port launched."""
    from repro_torch.models import gnn as G
    from repro_torch.models import weights as W

    cfg, loss_fn, batch = _gnn_case(name)
    model, _ = G.init_params(cfg, seed=2, device="cpu")
    tree = W.gnn_to_numpy(model)
    got = {}
    before = (embedding_bag.launches, flash_attention.launches)
    for dev in ("cpu", cuda_device):
        model = W.gnn_from_numpy(tree, dev, trainable=True)
        leaves = W.gnn_leaves(model)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            loss, _ = loss_fn(model, cfg, *batch(dev))
            grads = torch.autograd.grad(loss, [ps[0] for _, ps, _ in
                                               leaves])
        finally:
            torch.use_deterministic_algorithms(False)
        got[str(dev)] = [loss.detach().cpu()] + [g.cpu() for g in grads]
    assert (embedding_bag.launches, flash_attention.launches) == before
    for a, b in zip(got[str(cuda_device)], got["cpu"], strict=True):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def test_gnn_sharded_loss_on_card_gives_loss_full(cuda_device):
    """``make_sharded_loss`` in a gloo world of two ranks sharing the card,
    meshes (2,1) and (1,2): every rank's loss and gradients within 1e-5
    of ``loss_full``'s on the card (of each leaf's largest entry), both
    sides' segment sums under deterministic algorithms, in float64 (the
    fp32 weights cast).  In fp32 at these seeds node 807's layer-1
    pre-activation of unit 42 is 6.26e-7, within the two paths' rounding
    of the ReLU's kink: it falls on the other side of 0 and moves
    ``layers/0/w_neigh``'s gradient in that unit by 9.95e-4 of its
    largest entry on every mesh (``python -m
    repro_torch.launch.gnn_ranks --cases 5:3``); chip_smoke.py phase 15
    holds the fp32 program on these meshes at its own seed."""
    import dataclasses

    from repro_torch.launch.forcedevices import run_ranks
    from repro_torch.launch.gnn_ranks import rank_checks
    from repro_torch.models import gnn as G
    from repro_torch.models import weights as W
    from repro_torch.tree import tree_map

    cfg, _, batch = _gnn_case("full_graph_sm")
    f_pad = cfg.d_feat + 1
    cfg = dataclasses.replace(cfg, d_feat=f_pad)
    tree = W.gnn_to_numpy(G.init_params(cfg, seed=3, device=cuda_device)[0])
    tree = tree_map(lambda a: a.astype(np.float64), tree)
    cfg = dataclasses.replace(cfg, dtype="float64")
    x, src, dst, labels, mask = (t.numpy() for t in batch("cpu"))
    xp = np.zeros((x.shape[0], f_pad), np.float64)
    xp[:, :x.shape[1]] = x
    graph = (xp, src, dst, labels, mask)
    model = W.gnn_from_numpy(tree, cuda_device, trainable=True)
    leaves = W.gnn_leaves(model)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss, _ = G.loss_full(model, cfg, *(
            torch.from_numpy(a).to(cuda_device) for a in graph))
        want = dict(zip([p for p, _, _ in leaves], torch.autograd.grad(
            loss, [ps[0] for _, ps, _ in leaves]), strict=True))
    finally:
        torch.use_deterministic_algorithms(False)
    jobs = [(shape, cfg, tree, graph, f_pad) for shape in ((2, 1), (1, 2))]
    res = run_ranks(rank_checks, 2, (jobs, None, str(cuda_device)),
                    timeout_s=300.0, threads=0)
    for out in res:
        for (shape, *_), (got_loss, grads) in zip(jobs, out["sharded"],
                                                  strict=True):
            assert abs(got_loss - loss.item()) <= 1e-5 * abs(loss.item())
            for k, w in want.items():
                w = w.cpu()
                err = (torch.from_numpy(grads[k]) - w).abs().max().item()
                assert err <= 1e-5 * w.abs().max().item(), (shape, k, err)


def test_int8_compression_on_card(cuda_device):
    """``quantize_int8`` on the card bit-equal to the CPU's; the compressed
    sum and the cross-pod mean in a gloo world of two ranks sharing the
    card (a (pod 2, data 1, model 1) mesh) equal to the sums of the CPU's
    payloads."""
    from repro_torch.distributed.compression import quantize_int8
    from repro_torch.launch.forcedevices import run_ranks
    from repro_torch.launch.gnn_ranks import rank_checks

    rng = np.random.default_rng(8)
    x = (rng.normal(size=(512, 300)) * 3).astype(np.float32)
    qc, sc = quantize_int8(torch.from_numpy(x))
    qd, sd = quantize_int8(torch.from_numpy(x).to(cuda_device))
    assert torch.equal(qd.cpu(), qc)
    assert torch.equal(sd.cpu().view(torch.int32), sc.view(torch.int32))
    xs = [{"w": (rng.normal(size=(32, 16)) * (r + 1)).astype(np.float32)}
          for r in range(2)]
    res = [out["comp"] for out in run_ranks(
        rank_checks, 2, ((), ((2, 1, 1), ("pod", "data", "model"), xs),
                         str(cuda_device)), timeout_s=300.0, threads=0)]
    qs = [quantize_int8(torch.from_numpy(t["w"])) for t in xs]
    want = (qs[0][0].to(torch.int32) + qs[1][0].to(torch.int32)).to(
        torch.float32) * ((qs[0][1] + qs[1][1]) / 2.0)
    for psum, cross in res:
        assert torch.equal(torch.from_numpy(psum["w"]), want)
        assert torch.equal(torch.from_numpy(cross["w"]), want / 2.0)
