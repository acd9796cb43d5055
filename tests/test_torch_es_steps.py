"""A CPU model of the Hopper ES-scan kernels' algorithm
(``src/repro_torch/csrc/es_scan.cuh``), held against the JAX package's
``_blocked_es_scan`` / ``_blocked_diff_scan`` and
``screen_and_intersect_ref`` / ``screen_and_diff_ref``.

The CUDA kernels run only on the card; this file checks their design
here.  The model works as the kernel does: a pair's row is walked in
steps of 512 words per warp, split over ``warps`` consecutive warp
portions; element j of a lane is vector ``e0 + 32 j + lane`` (``vw`` words,
inside one block); per-element popcounts are scanned over (j, lane) with
two 16-bit counts packed in one shuffle (Hillis-Steele rounds, as
``__shfl_up_sync`` does them); each block that ends in the step gets its
bound, and a min over the failing elements' positions (``__reduce_min_sync``)
gives the first failing block.  With several warps a pair, each warp
posts its portion's popcount, its positive-mass block ends and its least
bound offset, and every warp finds the first failing portion from those.
A diff block whose U mass ``su[k] - su[k+1]`` is <= 0 is not loaded.
Survivors walk the steps again and write the child row and its suffix
table from the same scan.  Lane-parallel steps are numpy operations over
(j, lane); integer work: every comparison is exact.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from repro.kernels import ref as jref

STEP_WORDS = 512
NO_FAIL = 2 ** 32 - 1
LANES = np.arange(32)


def _rows(rng, n, nb, bw, density=1):
    u = rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64)
    for _ in range(density):
        u &= rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64)
    return u.astype(np.uint32)


def _suffix(rows):
    pc = np.bitwise_count(rows).sum(-1).astype(np.int64)      # (P, nb)
    suf = np.zeros((rows.shape[0], rows.shape[1] + 1), np.int64)
    suf[:, :-1] = np.cumsum(pc[:, ::-1], axis=1)[:, ::-1]
    return suf.astype(np.int32)


def _warp_scan16(x):
    """Inclusive scan over 32 lanes of packed 16-bit pairs, in the rounds
    of ``__shfl_up_sync`` (uint32 wrap, as the kernel's int adds)."""
    x = x.astype(np.uint32)
    off = 1
    while off < 32:
        y = np.concatenate([np.zeros(off, np.uint32), x[:-off]])
        x = x + y
        off <<= 1
    return x


class Step:
    """One warp's portion of a step (``load_step``)."""

    def __init__(self, u, v, su, sv, e0, *, bvec, vw, row_vecs, diff,
                 bound, andnot, touched):
        L = 16 // vw
        self.L = L
        # Block and remainder carried from lane to element as the kernel
        # does: 32 vectors = q32 blocks + r32 vectors.
        e = e0 + LANES
        k, r = e // bvec, e % bvec
        q32, r32 = 32 // bvec, 32 % bvec
        self.z = np.zeros((L, 32, vw), np.uint32)
        self.blk = np.zeros((L, 32), np.int64)
        self.aux = np.zeros((L, 32), np.int64)
        self.live = np.zeros((L, 32), bool)
        self.ends = np.zeros((L, 32), bool)
        flip = np.uint32(0xFFFFFFFF) if andnot else np.uint32(0)
        for j in range(L):
            inn = e < row_vecs
            end = inn & (r == bvec - 1)
            load = inn.copy()
            self.blk[j] = k
            if diff:
                kk = np.where(inn, k, 0)
                self.aux[j] = np.where(inn, su[kk].astype(np.int64)
                                       - su[kk + 1], 0)
                load = inn & (self.aux[j] > 0)
            elif bound and not andnot:
                kk = np.where(end, k, 0)
                self.aux[j] = np.where(end, np.minimum(su[kk + 1],
                                                       sv[kk + 1]), 0)
            ee = np.where(load, e, 0)
            uu = np.where(load[:, None], u[ee], 0).astype(np.uint32)
            vv = np.where(load[:, None], v[ee], 0).astype(np.uint32)
            touched.update(int(x) for x in e[load])
            self.z[j] = uu & (vv ^ flip)
            self.live[j], self.ends[j] = inn, end
            e = e + 32
            k, r = k + q32, r + r32
            wrap = r >= bvec
            r = np.where(wrap, r - bvec, r)
            k = np.where(wrap, k + 1, k)
        c = np.bitwise_count(self.z).sum(-1).astype(np.uint32)   # (L, 32)
        self.incl = np.zeros((L, 32), np.int64)
        run = 0
        for j in range(0, L, 2):
            x = _warp_scan16(c[j] | (c[j + 1] << 16))
            t = int(x[31])
            self.incl[j] = run + (x & 0xFFFF)
            run += t & 0xFFFF
            self.incl[j + 1] = run + (x >> 16)
            run += t >> 16
        self.total = run
        self.pos = 32 * np.arange(L)[:, None] + LANES[None, :]

    def bound(self, andnot, base):
        return base - self.incl if andnot else base + self.incl + self.aux

    def first_fail(self, andnot, base, thr):
        """(key, count through it, its block), or (NO_FAIL, 0, 0)."""
        fail = self.ends & (self.bound(andnot, base) < thr)
        if not fail.any():
            return NO_FAIL, 0, 0
        key = int(self.pos[fail].min())
        j, lane = divmod(key, 32)
        return key, int(self.incl[j, lane]), int(self.blk[j, lane])

    def massive(self, lim):
        return int((self.ends & (self.aux > 0) & (self.pos <= lim)).sum())


def model_pair(u, v, su, sv, rho, thr, *, nb, bw, andnot, diff, warps, vw,
               want_z=True):
    """One pair through ``es_scan_kernel``: ``(Z row or None, cnt, blocks,
    alive, words touched)``; ``u``/``v`` are (row_words // vw, vw)."""
    bvec = bw // vw
    row_vecs = nb * bw // vw
    step_vecs = warps * STEP_WORDS // vw
    n_steps = -(-row_vecs // step_vecs)
    z = np.zeros((row_vecs, vw), np.uint32) if want_z else None
    touched = set()
    carry = done = 0
    for s in range(n_steps):
        sts = [Step(u, v, su, sv, s * step_vecs + w * (STEP_WORDS // vw),
                    bvec=bvec, vw=vw, row_vecs=row_vecs, diff=diff,
                    bound=True, andnot=andnot, touched=touched)
               for w in range(warps)]
        # the posted summaries, then the first failing portion
        fw, acc, macc, offs, mbefore = -1, 0, 0, [], []
        for w, st in enumerate(sts):
            offs.append(acc)
            mbefore.append(macc)
            g = st.bound(andnot, 0)[st.ends]
            base = rho - carry - acc if andnot else carry + acc
            if fw < 0 and g.size and base + int(g.min()) < thr:
                fw = w
            if fw < 0:
                macc += st.massive(NO_FAIL)
            acc += st.total
        if fw < 0:
            carry += acc
            done += macc
            if want_z:
                for w, st in enumerate(sts):
                    e = s * step_vecs + w * (STEP_WORDS // vw) + st.pos
                    z[e[st.live]] = st.z[st.live]
            continue
        st = sts[fw]
        base = rho - carry - offs[fw] if andnot else carry + offs[fw]
        key, pf, kf = st.first_fail(andnot, base, thr)
        assert key != NO_FAIL          # the summary and the search agree
        cnt = carry + offs[fw] + pf
        blocks = done + mbefore[fw] + st.massive(key) if diff else kf + 1
        if want_z:
            for w, st in enumerate(sts[:fw + 1]):
                e = s * step_vecs + w * (STEP_WORDS // vw) + st.pos
                keep = st.live & (st.pos <= (key if w == fw else NO_FAIL))
                z[e[keep]] = st.z[keep]
        return z, cnt, blocks, False, touched
    return z, carry, done if diff else nb, True, touched


def model_child(u, v, su, sv, total, *, nb, bw, diff, andnot, warps, vw):
    """The survivor epilogue: the child row and its suffix table."""
    bvec = bw // vw
    row_vecs = nb * bw // vw
    step_vecs = warps * STEP_WORDS // vw
    out = np.zeros((row_vecs, vw), np.uint32)
    osuf = np.full(nb + 1, -7, np.int64)
    osuf[0] = total
    before = 0
    for s in range(-(-row_vecs // step_vecs)):
        off = 0
        for w in range(warps):
            e0 = s * step_vecs + w * (STEP_WORDS // vw)
            st = Step(u, v, su, sv, e0, bvec=bvec, vw=vw, row_vecs=row_vecs,
                      diff=diff, bound=False, andnot=andnot, touched=set())
            e = e0 + st.pos
            out[e[st.live]] = st.z[st.live]
            osuf[st.blk[st.ends] + 1] = total - (before + off
                                                  + st.incl[st.ends])
            off += st.total
        before += off
    return out.reshape(nb, bw), osuf.astype(np.int32)


def model_scan(U, V, su, sv, rho, thr, *, mode="and", diff=False, warps=1,
               vw=1):
    """The standalone entry over (P, nb, bw) operands."""
    P, nb, bw = U.shape
    Z = np.zeros_like(U)
    cnt = np.zeros(P, np.int64)
    blocks = np.zeros(P, np.int64)
    alive = np.zeros(P, bool)
    for p in range(P):
        z, cnt[p], blocks[p], alive[p], _ = model_pair(
            U[p].reshape(-1, vw), V[p].reshape(-1, vw), su[p],
            None if diff else sv[p], int(rho[p]), thr, nb=nb, bw=bw,
            andnot=diff or mode == "andnot", diff=diff, warps=warps, vw=vw)
        Z[p] = z.reshape(nb, bw)
    return Z, cnt, blocks, alive


def model_fused(rows, suffix, ua, vb, slots, rho, minsup, es_minsup, *,
                mode="and", diff=False, warps=1, vw=1):
    """The fused dispatch, updating ``rows``/``suffix`` in place."""
    cap, nb, bw = rows.shape
    andnot = diff or mode == "andnot"
    src_rows, src_suf = rows.copy(), suffix.copy()
    out = []
    for p in range(len(ua)):
        u = src_rows[ua[p]].reshape(-1, vw)
        v = src_rows[vb[p]].reshape(-1, vw)
        _, cnt, blocks, alive, _ = model_pair(
            u, v, src_suf[ua[p]], src_suf[vb[p]], int(rho[p]), es_minsup,
            nb=nb, bw=bw, andnot=andnot, diff=diff, warps=warps, vw=vw,
            want_z=False)
        out.append((cnt, blocks, alive))
        support = int(rho[p]) - cnt if andnot else cnt
        if alive and support >= minsup and 0 <= slots[p] < cap:
            rows[slots[p]], suffix[slots[p]] = model_child(
                u, v, src_suf[ua[p]], src_suf[vb[p]], cnt, nb=nb, bw=bw,
                diff=diff, andnot=andnot, warps=warps, vw=vw)
    cnt, blocks, alive = (np.array(x) for x in zip(*out))
    return cnt, blocks, alive


_es_scan = jax.jit(jref._blocked_es_scan, static_argnames=("mode",))
_diff_scan = jax.jit(jref._blocked_diff_scan)


def _jax_scan(U, V, su, sv, rho, thr, *, mode="and", diff=False):
    P = U.shape[0]
    thr = jnp.full((P,), thr, jnp.int32)
    if diff:
        out = _diff_scan(jnp.asarray(U), jnp.asarray(V), jnp.asarray(su),
                         jnp.asarray(rho), thr)
    else:
        out = _es_scan(jnp.asarray(U), jnp.asarray(V), jnp.asarray(su),
                       jnp.asarray(sv), jnp.asarray(rho), thr, mode=mode)
    return tuple(np.asarray(x) for x in out)


def _check(got, want, what):
    for g, w, name in zip(got, want, ("Z", "cnt", "blocks", "alive"),
                          strict=True):
        assert np.array_equal(np.asarray(g).astype(np.int64),
                              np.asarray(w).astype(np.int64)), (name, what)


def _layouts(bw):
    """(warps, vw) pairs the kernel can take at this block width."""
    vws = (1, 4) if bw % 4 == 0 else (1,)
    return [(w, vw) for w in (1, 2, 4, 8) for vw in vws]


# bw and nb: nb x bw never a multiple of the 512-word step.
SHAPES = [(1, 700), (3, 200), (8, 70), (128, 9), (256, 5)]


@pytest.mark.parametrize("bw,nb", SHAPES)
@pytest.mark.parametrize("mode", ["and", "andnot"])
def test_model_scan_matches_jax(bw, nb, mode):
    rng = np.random.default_rng(bw * 7 + nb)
    P = 4
    U, V = _rows(rng, P, nb, bw), _rows(rng, P, nb, bw)
    su, sv = _suffix(U), _suffix(V)
    rho = su[:, 0].copy()
    nt = nb * bw * 32
    for thr in (-(2 ** 31), -4, 0, 1, nt // 16, nt // 8, nt // 5):
        want = _jax_scan(U, V, su, sv, rho, thr, mode=mode)
        for warps, vw in _layouts(bw):
            _check(model_scan(U, V, su, sv, rho, thr, mode=mode,
                              warps=warps, vw=vw), want,
                   (thr, warps, vw))


@pytest.mark.parametrize("bw,nb", SHAPES)
def test_model_scan_with_random_suffix_tables(bw, nb):
    """Inconsistent suffix tables: the bound is not monotone, and the
    first failing block must still be found."""
    rng = np.random.default_rng(bw + 3 * nb)
    P = 4
    U, V = _rows(rng, P, nb, bw), _rows(rng, P, nb, bw)
    nt = nb * bw * 32
    su = rng.integers(-100, nt // 4, (P, nb + 1)).astype(np.int32)
    sv = rng.integers(-100, nt // 4, (P, nb + 1)).astype(np.int32)
    rho = rng.integers(0, nt // 2, P).astype(np.int32)
    for mode in ("and", "andnot"):
        for thr in (-4, 0, nt // 64, nt // 16, nt // 8):
            want = _jax_scan(U, V, su, sv, rho, thr, mode=mode)
            for warps, vw in _layouts(bw):
                _check(model_scan(U, V, su, sv, rho, thr, mode=mode,
                                  warps=warps, vw=vw), want,
                       (mode, thr, warps, vw))


@pytest.mark.parametrize("bw,nb", SHAPES)
def test_model_diff_matches_jax(bw, nb):
    """Zero-mass U blocks (a zero prefix too, and a run across a step
    edge) are neither loaded nor counted."""
    rng = np.random.default_rng(bw * 5 + nb)
    P = 4
    U, V = _rows(rng, P, nb, bw), _rows(rng, P, nb, bw)
    per_step = max(1, STEP_WORDS // bw)
    U[0, :nb // 3] = 0
    U[1, max(0, per_step - 2):per_step + 2] = 0
    U[2, ::2] = 0
    su = _suffix(U)
    rho = su[:, 0].copy()
    nt = nb * bw * 32
    for thr in (-(2 ** 31), -4, 0, 1, nt // 16, nt // 8, nt // 5):
        want = _jax_scan(U, V, su, None, rho, thr, diff=True)
        for warps, vw in _layouts(bw):
            got = model_scan(U, V, su, None, rho, thr, diff=True,
                             warps=warps, vw=vw)
            _check(got, want, (thr, warps, vw))


def _abort_case(bw, nb, k, *, diff=False):
    """One pair whose andnot bound rho - count first fails at block k
    (thr 1, rho = the count through block k, block k nonempty)."""
    rng = np.random.default_rng(k + bw)
    U, V = _rows(rng, 1, nb, bw), _rows(rng, 1, nb, bw)
    U[0, k, 0] |= np.uint32(1)
    V[0, k, 0] &= ~np.uint32(1)
    if diff and k + 1 < nb:
        U[0, k + 1:k + 3] = 0          # zero-mass blocks right after it
    z = U & ~V
    pc = np.bitwise_count(z).sum(-1)[0].astype(np.int64)
    rho = np.array([int(pc[:k + 1].sum())], np.int32)
    return U, V, _suffix(U), rho


@pytest.mark.parametrize("diff", [False, True])
@pytest.mark.parametrize("bw,nb", [(1, 1100), (8, 140), (128, 20)])
def test_model_abort_points(bw, nb, diff):
    """An abort at block 0, at a step's (and a warp portion's) last
    block, and on a step boundary, for every layout."""
    for warps, vw in _layouts(bw):
        per_step = max(1, warps * STEP_WORDS // bw)
        per_warp = max(1, STEP_WORDS // bw)
        for k in sorted({0, per_warp - 1, per_warp, per_step - 1, per_step,
                         nb - 1}):
            if k >= nb:
                continue
            U, V, su, rho = _abort_case(bw, nb, k, diff=diff)
            want = _jax_scan(U, V, su, su, rho, 1, mode="andnot", diff=diff)
            got = model_scan(U, V, su, su, rho, 1, mode="andnot", diff=diff,
                             warps=warps, vw=vw)
            _check(got, want, (k, warps, vw))
            assert not got[3][0] and got[1][0] == rho[0]
            if not diff:
                assert got[2][0] == k + 1


def test_model_reads_at_most_one_step_past_the_abort():
    """The words a pair loads end with the abort's step."""
    bw, nb, k = 8, 140, 70
    U, V, su, rho = _abort_case(bw, nb, k)
    for warps, vw in _layouts(bw):
        *_, touched = model_pair(U[0].reshape(-1, vw), V[0].reshape(-1, vw),
                                 su[0], su[0], int(rho[0]), 1, nb=nb, bw=bw,
                                 andnot=True, diff=False, warps=warps, vw=vw)
        step = warps * STEP_WORDS
        last = max(touched) * vw + vw - 1
        assert last < ((k * bw) // step + 1) * step
        assert last >= (k + 1) * bw - 1


def _slab_case(rng, bw, nb, n_rows=6, P=7):
    cap = n_rows + P
    rows = _rows(rng, cap, nb, bw)
    rows[:2, nb // 2] = 0
    suffix = _suffix(rows)
    ua = rng.integers(0, n_rows, P).astype(np.int32)
    vb = rng.integers(0, n_rows, P).astype(np.int32)
    slots = np.arange(n_rows, n_rows + P, dtype=np.int32)
    slots[-1] = cap                     # pad slot
    slots[-2] = -1                      # negative slot
    return rows, suffix, ua, vb, slots, cap


@pytest.mark.parametrize("bw,nb", SHAPES)
@pytest.mark.parametrize("kind", ["and", "andnot", "diff"])
def test_model_fused_matches_jax(bw, nb, kind):
    """The fused dispatch: counters, survivors' child rows and suffix
    tables (built by the epilogue's scan), slots -1 and cap skipped,
    non-survivor slots untouched.  JAX wraps a negative scatter index,
    so it is handed ``cap`` where the port's slot is -1: both skip."""
    rng = np.random.default_rng(bw * 11 + nb)
    rows0, suf0, ua, vb, slots, cap = _slab_case(rng, bw, nb)
    rho = suf0[ua, 0].copy()
    jslots = np.where(slots < 0, cap, slots).astype(np.int32)
    nt = nb * bw * 32
    diff = kind == "diff"
    mode = "andnot" if diff else kind
    for es in (True, False):
        for minsup in (0, 1, nt // 16, nt // 8, nt // 5):
            if diff:
                want = jref.screen_and_diff_ref(
                    jnp.asarray(rows0), jnp.asarray(suf0), ua, vb, jslots,
                    rho, jnp.int32(minsup), early_stop=es)
            else:
                want = jref.screen_and_intersect_ref(
                    jnp.asarray(rows0), jnp.asarray(suf0), ua, vb, jslots,
                    rho, jnp.int32(minsup), mode=mode, early_stop=es)
            want = [np.asarray(x) for x in want]
            for warps, vw in _layouts(bw):
                rows, suf = rows0.copy(), suf0.copy()
                cnt, blocks, alive = model_fused(
                    rows, suf, ua, vb, slots, rho, minsup,
                    minsup if es else 0, mode=mode, diff=diff, warps=warps,
                    vw=vw)
                what = (es, minsup, warps, vw)
                assert np.array_equal(rows, want[0]), what
                assert np.array_equal(suf, want[1]), what
                assert np.array_equal(cnt, want[2]), what
                assert np.array_equal(blocks, want[3]), what
                assert np.array_equal(alive, want[4]), what
