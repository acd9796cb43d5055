"""A CPU model of the Hopper N-list kernels' algorithm
(``src/repro_torch/csrc/nlist_merge.cu``), held against the JAX package's
``nlist_presize_ref`` / ``nlist_scatter_ref``.

The CUDA kernels run only on the card; this file checks their design
here.  The merge model works as a warp does: windows of 32 U and 32 V
codes, the path traced a U row at a time with one ballot (the columns
where the walk leaves the row) and one bit scan (``__ffs``), and with
early stopping the first failing step found from a prefix sum of the V
window's frequencies (each lane's skip) and a ballot of the lanes'
guards, redone when z_mass moves.  The scatter model reads each
match-table row 128 entries at a time, 4 to a lane, with a warp max-scan
carried across chunks, a sum scan of the U mass and a segmented scan of
the previous group start's mass.  Lane-parallel steps are numpy vector
operations over 32 lanes.  Integer work: every comparison is exact.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from repro.kernels import ref as jref

from repro_torch.core import oracle as toracle

from test_torch_engine import _smoke

W = 32
SENT = np.iinfo(np.int32).max
FULL = 0xFFFFFFFF


def _w(x):
    """int32 wrap-around of a Python int or int64 array."""
    return ((np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32) - 2 ** 31


def _guard(z, rho, skip, minsup):
    """z_mass + (rho - skip) >= minsup in int32 wrap-around (vectorised)."""
    return _w(np.asarray(z, np.int64) + _w(rho - np.asarray(skip, np.int64))
              ) >= minsup


# ---------------------------------------------------------------------------
# the merge (nl_merge_kernel): one pair
# ---------------------------------------------------------------------------

def _window(codes, off, base):
    cap = codes.shape[0]
    return codes[np.clip(off + base + np.arange(W), 0, cap - 1)].astype(
        np.int64)


def _first_adv(adv, c):
    """Per lane: the first column >= c set in adv, 32 for none."""
    out = np.full(W, 32, np.int64)
    for lane in range(W):
        m = int(adv[lane]) & ((FULL << int(c[lane])) & FULL) if c[lane] < 32 \
            else 0
        if m:
            out[lane] = (m & -m).bit_length() - 1
    return out


def _masks(X, Y, ncols):
    """Per U row (lane): adv and desc over the V window's columns."""
    d = (X[:, None, 0] > Y[None, :, 0]) & (X[:, None, 1] < Y[None, :, 1])
    a = (d | (X[:, None, 0] <= Y[None, :, 0])) & (np.arange(W) < ncols)
    d &= np.arange(W) < ncols
    bit = np.int64(1) << np.arange(W)
    return (a * bit).sum(1), (d * bit).sum(1)


def model_merge_pair(codes, uo, nu, vo, nv, rho, minsup, lu, es):
    """One warp's pair: ``(out_slot row, child_len, support, comparisons,
    checks, alive)``."""
    row = np.full(lu, SENT, np.int64)
    z = cmps = checks = groups = 0
    last_j = -1
    alive = True
    lanes = np.arange(W)
    if nu > 0 and nv > 0:
        ib = jb = r0 = c0 = 0
        X, Y = _window(codes, uo, 0), _window(codes, vo, 0)
        nrows, ncols = min(W, nu), min(W, nv)
        s_in = _w(np.cumsum(Y[:, 2]))          # skip after lane's j-step
        s_ex = _w(s_in - Y[:, 2])
        adv, desc = _masks(X, Y, ncols)
        slot = np.full(W, SENT, np.int64)
        written = 0
        while True:
            # 1. the path: Jacobi rounds of e_r = first_adv(e_{r-1})
            live = (lanes >= r0) & (lanes < nrows)
            e = np.where(live, _first_adv(adv, np.full(W, c0)),
                         np.where(lanes < r0, 0, 32))
            while True:
                prev = np.concatenate([[e[0]], e[:-1]])   # shfl_up
                prev[r0] = c0
                e2 = np.where(live, _first_adv(adv, prev), e)
                if not (e2 != e).any():
                    break
                e = e2
            exits = live & (e == 32)
            right = bool(exits.any())
            r_end = int(np.argmax(exits)) if right else nrows
            istep = (lanes >= r0) & (lanes < r_end)
            c_end = ncols if right else int(e[r_end - 1])
            # 2. matches, z_mass, groups
            hit = istep & ((desc >> (e & 31)) & 1).astype(bool)
            dz = np.where(hit, X[:, 2], 0)
            z_after = _w(z + np.cumsum(dz))
            z_before = _w(z_after - dz)
            # a hit starts a group where its column differs from the
            # previous hit's (the last earlier hit lane's, else last_j)
            before = np.empty(W, np.int64)
            cur = last_j
            for lane in range(W):
                before[lane] = cur
                if hit[lane]:
                    cur = jb + int(e[lane])
            starts = hit & (jb + e != before)
            g_after = groups + np.cumsum(starts)
            # 3. early stopping
            if es and not hit.any():
                # z_mass holds: only j-steps move the guard, and the walk's
                # first step if it is an i-step (then the guard reads rho)
                run = (lanes >= c0) & (lanes < c_end)
                fj = run & ~_guard(z, rho, s_in, minsup)
                keys = []
                if fj.any():
                    k = int(np.argmax(fj))
                    i_before = int((istep & (e <= k)).sum())
                    keys.append((i_before + (k - c0)) * 64 + (k - c0 + 1))
                if cmps == 0 and r_end > 0 and e[0] == 0 and \
                        not _guard(0, rho, 0, minsup):
                    keys.append(0)
            elif es:
                exit_row = right & (lanes == r_end)
                run_end = np.where(exit_row, ncols, e)
                has_run = (istep | exit_row) & (run_end > prev)
                own_row = np.zeros(W, np.int64)
                own_z = np.zeros(W, np.int64)
                own_row[prev[has_run]] = lanes[has_run]
                own_z[prev[has_run]] = z_before[has_run]
                run_starts = sum(1 << int(s) for s in prev[has_run])
                keys = []
                for k in range(c0, c_end):        # each column lane
                    m = run_starts & ((1 << (k + 1)) - 1)
                    s = m.bit_length() - 1
                    if not _guard(own_z[s], rho, s_in[k], minsup):
                        keys.append(((own_row[s] - r0) + (k - c0)) * 64
                                    + (k - c0 + 1))
                skip_at = s_ex[e & 31]
                fi = istep & ~_guard(z_after, rho, skip_at, minsup)
                ki = ((lanes - r0) + (e - c0)) * 64 + (e - c0)
                keys += list(ki[fi])
            if es:
                if keys:
                    key = int(min(keys))
                    idx = key >> 6
                    cmps += idx + 1
                    checks += key & 63
                    alive = False
                    kept = istep & ((lanes - r0) + (e - c0) <= idx)
                    n_kept = int(kept.sum())
                    if n_kept:
                        groups = int(g_after[r0 + n_kept - 1])
                    slot[kept & hit] = jb + e[kept & hit]
                    break
            cmps += (r_end - r0) + (c_end - c0)
            checks += c_end - c0
            slot[hit] = jb + e[hit]
            if hit.any():
                z = int(z_after[-1])
                groups += int(starts.sum())
                last_j = cur
            # 4. slide
            if right:
                if jb + ncols >= nv:
                    break
                skip0 = int(s_in[31])
                jb += W
                Y = _window(codes, vo, jb)
                ncols = min(W, nv - jb)
                s_in = _w(skip0 + np.cumsum(Y[:, 2]))
                s_ex = _w(s_in - Y[:, 2])
                adv, desc = _masks(X, Y, ncols)
                r0, c0 = r_end, 0
            else:
                row[ib:ib + min(W, lu - ib)] = slot[:min(W, lu - ib)]
                written = ib + W
                if ib + nrows >= nu:
                    break
                ib += W
                X = _window(codes, uo, ib)
                nrows = min(W, nu - ib)
                adv, desc = _masks(X, Y, ncols)
                slot[:] = SENT
                r0, c0 = 0, c_end
        if written <= ib:
            row[ib:ib + min(W, lu - ib)] = slot[:min(W, lu - ib)]
    return row, groups, (z if alive else 0), cmps, checks, alive


def model_presize(codes, u_off, u_len, v_off, v_len, rho, minsup, *, lu,
                  early_stop):
    outs = [model_merge_pair(codes, int(u_off[p]), int(u_len[p]),
                             int(v_off[p]), int(v_len[p]), int(rho[p]),
                             int(minsup), lu, early_stop)
            for p in range(len(u_off))]
    return (np.stack([o[0] for o in outs]).reshape(len(outs), lu),
            *(np.array([o[k] for o in outs]) for k in range(1, 6)))


# ---------------------------------------------------------------------------
# the scatter (zmerge_scatter_kernel): one pair
# ---------------------------------------------------------------------------

def _excl_last(val, has, carry):
    """Segmented scan: the right-most earlier lane's value where it has
    one, else ``carry``."""
    out = np.empty_like(val)
    cur = carry
    for k in range(W):
        out[k] = cur
        if has[k]:
            cur = val[k]
    return out


def model_scatter_pair(codes, srow, uo, nu, vo, nv, base):
    """Writes pair's children into ``codes`` (in place); returns
    child_len."""
    cap, lu = codes.shape[0], srow.shape[0]
    writes = base < cap and base + lu > 0
    running, groups, mass, start_mass = -1, 0, 0, 0

    def code(idx):
        return codes[min(max(idx, 0), cap - 1)]

    def dest_ok(g):
        return 0 <= base + g < cap

    for k0 in range(0, lu, 128):
        idx = k0 + np.arange(128)
        s = np.where(idx < lu, srow[np.minimum(idx, lu - 1)], SENT)
        s = s.reshape(W, 4).astype(np.int64)
        valid = s != SENT
        if not valid.any():                            # one vote
            continue
        lmax = np.where(valid, s, -1).max(1)
        incl = np.maximum.accumulate(lmax)             # warp max-scan
        before = np.maximum(running, np.concatenate([[-1], incl[:-1]]))
        start = np.zeros((W, 4), bool)
        for t in range(4):
            start[:, t] = valid[:, t] & (s[:, t] != before)
            before = np.where(valid[:, t], np.maximum(before, s[:, t]),
                              before)
        n_start = start.sum(1)
        if writes:
            i = idx.reshape(W, 4)
            f = np.zeros((W, 4), np.int64)
            for lane, t in zip(*np.nonzero(valid & (i < nu)), strict=True):
                f[lane, t] = code(uo + int(i[lane, t]))[2]
            lmass = _w(f.sum(1))
            m_lane = _w(mass + np.concatenate([[0], np.cumsum(lmass)[:-1]]))
            g_lane = groups + np.concatenate([[0], np.cumsum(n_start)[:-1]])
            last = np.zeros(W, np.int64)
            for lane in range(W):
                mm = m_lane[lane]
                for t in range(4):
                    if start[lane, t]:
                        last[lane] = mm
                    mm = _w(mm + f[lane, t])
            prev_l = _excl_last(last, n_start > 0, start_mass)
            for lane in range(W):
                m, g, prev = m_lane[lane], g_lane[lane], prev_l[lane]
                for t in range(4):
                    if start[lane, t]:
                        if g > 0 and dest_ok(g - 1):
                            codes[base + g - 1, 2] = _w(m - prev)
                        if dest_ok(g):
                            rep = int(s[lane, t])
                            y = code(vo + rep)
                            codes[base + g, 0] = y[0] if rep < nv else SENT
                            codes[base + g, 1] = y[1] if rep < nv else 0
                        prev = m
                        g += 1
                    m = _w(m + f[lane, t])
            if (n_start > 0).any():
                start_mass = last[np.flatnonzero(n_start > 0)[-1]]
            mass = int(_w(mass + lmass.sum()))
        groups += int(n_start.sum())
        running = max(running, int(incl[-1]))
    if writes and groups > 0 and dest_ok(groups - 1):
        codes[base + groups - 1, 2] = _w(mass - start_mass)
    return groups


def model_scatter(codes, out_slot, u_off, u_len, v_off, v_len, out_off):
    codes = codes.copy()
    cl = [model_scatter_pair(codes, np.asarray(out_slot[p]), int(u_off[p]),
                             int(u_len[p]), int(v_off[p]), int(v_len[p]),
                             int(out_off[p]))
          for p in range(len(u_off))]
    return codes, np.array(cl, np.int64)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _random_nlist(rng, n, span=20000, fmin=1, fmax=20):
    """``n`` codes with distinct ascending pre and random post."""
    pre = np.sort(rng.choice(span, n, replace=False))
    return np.stack([pre, rng.integers(0, span, n),
                     rng.integers(fmin, fmax, n)], 1).astype(np.int32)


def _layout(rng, pairs):
    """(U, V) code lists of ``pairs`` as extents of one slab, with room
    after them for the children; returns (codes, u_off, u_len, v_off,
    v_len, room_at)."""
    cols, ext, bump = [[], [], [], []], [], 0
    for u, v in pairs:
        for arr, c in ((u, 0), (v, 2)):
            ext.append((bump, arr))
            cols[c].append(bump)
            cols[c + 1].append(len(arr))
            bump += len(arr)
    cap = bump + sum(cols[1]) + 8
    codes = rng.integers(0, 1000, (cap, 3)).astype(np.int32)
    for off, arr in ext:
        codes[off:off + len(arr)] = arr
    return (codes, *(np.asarray(c, np.int32) for c in cols), bump)


def _width(n):
    return max(8, 1 << int(np.ceil(np.log2(max(n, 1)))))


def _check(rng, pairs, rho, plans, *, out_slot_fn=None):
    """The merge model equals ``nlist_presize_ref`` and the scatter model
    ``nlist_scatter_ref`` for each (early_stop, minsup) of ``plans``."""
    codes, u_off, u_len, v_off, v_len, bump = _layout(rng, pairs)
    lu, lv = _width(int(u_len.max())), _width(int(v_len.max()))
    rho = np.asarray(rho, np.int32)
    for es, minsup in plans:
        r = jref.nlist_presize_ref(jnp.asarray(codes), u_off, u_len, v_off,
                                   v_len, rho, jnp.int32(minsup), lu=lu,
                                   lv=lv, early_stop=es)
        m = model_presize(codes, u_off, u_len, v_off, v_len, rho, minsup,
                          lu=lu, early_stop=es)
        for name, a, b in zip(("out_slot", "child_len", "support", "cmps",
                               "checks", "alive"), m, r, strict=True):
            assert np.array_equal(np.asarray(a, np.int64),
                                  np.asarray(b, np.int64)), (es, minsup, name)
        out_slot = np.asarray(r[0])
        if out_slot_fn is not None:
            out_slot = out_slot_fn(out_slot, u_len)
        child_len = np.asarray(jref._nl_group_starts(jnp.asarray(out_slot))[2])
        out_off = np.full(len(pairs), codes.shape[0], np.int32)
        nxt = bump
        for p in range(len(pairs)):
            if int(r[2][p]) >= minsup or out_slot_fn is not None:
                out_off[p] = nxt
                nxt += int(child_len[p])
        rc, rl = jref.nlist_scatter_ref(jnp.asarray(codes), out_slot, u_off,
                                        u_len, v_off, v_len, out_off, lu=lu,
                                        lv=lv)
        mc, ml = model_scatter(codes, out_slot, u_off, u_len, v_off, v_len,
                               out_off)
        assert np.array_equal(ml, np.asarray(rl)), (es, minsup, "child_len")
        assert np.array_equal(mc, np.asarray(rc)), (es, minsup, "codes")
    return m


def _rho(pairs):
    return [int(v[:, 2].sum()) for _, v in pairs]


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

EDGES = [0, 1, 31, 32, 33, 63, 64, 65]


@pytest.mark.parametrize("es", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_model_on_random_pre_sorted_lists(seed, es):
    """Pre ascending, post random: not a PPC-tree's lists."""
    rng = np.random.default_rng(seed)
    pairs = [(_random_nlist(rng, int(rng.integers(0, 90))),
              _random_nlist(rng, int(rng.integers(0, 90))))
             for _ in range(24)]
    _check(rng, pairs, _rho(pairs), [(es, 0), (es, 30), (es, 400)])


@pytest.mark.parametrize("es", [True, False])
@pytest.mark.parametrize("n_u", EDGES)
def test_model_at_window_edge_lengths(n_u, es):
    """U of each window-edge length against V of every such length."""
    rng = np.random.default_rng(100 + n_u)
    pairs = [(_random_nlist(rng, n_u, span=300),
              _random_nlist(rng, n_v, span=300)) for n_v in EDGES]
    _check(rng, pairs, _rho(pairs), [(es, 1), (es, 60)])


@pytest.mark.parametrize("regime", ["powerlaw", "dense", "longpat"])
def test_model_on_ppc_tree_nlists(regime):
    """Tree-consistent N-lists of the smoke regimes, in engine order."""
    db, minsup = _smoke()[regime]
    tree = toracle.PPCTree(db, minsup)
    order = list(reversed(tree.order_desc))
    lists = [np.asarray(tree.nlists[it], np.int32).reshape(-1, 3)
             for it in order]
    ia, ib = np.triu_indices(len(order), 1)
    sel = np.random.default_rng(7).permutation(ia.size)[:150]
    pairs = [(lists[a], lists[b]) for a, b in zip(ia[sel], ib[sel],
                                                 strict=True)]
    rho = [tree.item_support[order[b]] for b in ib[sel]]
    _check(np.random.default_rng(8), pairs, rho,
           [(True, minsup), (False, minsup)])


@pytest.mark.parametrize("es", [True, False])
def test_model_when_rho_is_below_minsup(es):
    """rho < minsup: with ES the walk aborts on its first step, whether
    that is a j-step or an i-step."""
    rng = np.random.default_rng(3)
    j_first = (np.array([[50, 1, 2]], np.int32), _random_nlist(rng, 40, 40))
    i_first = (np.array([[0, 1, 2], [60, 5, 3]], np.int32),
               np.array([[10, 50, 4], [20, 3, 1]], np.int32))
    match_first = (np.array([[11, 5, 2]], np.int32),
                   np.array([[10, 50, 4]], np.int32))
    pairs = [j_first, i_first, match_first]
    m = _check(rng, pairs, [5, 5, 5], [(es, 100)])
    if es:
        assert list(m[3]) == [1, 1, 1] and not m[5].any()


@pytest.mark.parametrize("pos", range(W + 2))
def test_model_abort_at_each_window_position(pos):
    """All j-steps (U's pre above every V code), V freq 1, rho = nv: the
    guard fails first after j-step pos + 1, for every column of the
    first window and past it."""
    rng = np.random.default_rng(pos)
    nv = 70
    v = _random_nlist(rng, nv, span=1000)
    v[:, 2] = 1
    u = np.array([[5000, 10 ** 6, 3], [5001, 10 ** 6, 4]], np.int32)
    pairs = [(u, v), (u, v[:40])]
    m = _check(rng, pairs, [nv, 40], [(True, nv - pos)])
    assert m[3][0] == pos + 1 and m[4][0] == pos + 1 and not m[5][0]


@pytest.mark.parametrize("row", [0, 5, 31, 32, 40])
def test_model_abort_on_an_i_step(row):
    """Every U code is a descendant of V's one code; U code ``row`` has a
    negative frequency that makes the guard fail on its i-step."""
    n = 48
    k = np.arange(n)
    u = np.stack([10 + k, 1000 - k, np.ones(n)], 1).astype(np.int32)
    u[row, 2] = -(row + 100)
    v = np.array([[5, 10 ** 6, 7]], np.int32)
    m = _check(np.random.default_rng(row), [(u, v)], [7],
               [(False, 7), (True, 7)])
    assert not m[5][0] and m[3][0] == row + 1 and m[4][0] == 0


@pytest.mark.parametrize("es", [True, False])
def test_model_with_zero_and_negative_frequencies(es):
    rng = np.random.default_rng(11)
    pairs = [(_random_nlist(rng, int(rng.integers(0, 80)), span=400,
                            fmin=-6, fmax=7),
              _random_nlist(rng, int(rng.integers(0, 80)), span=400,
                            fmin=-6, fmax=7)) for _ in range(24)]
    rho = rng.integers(-20, 60, len(pairs))
    _check(rng, pairs, rho, [(es, -5), (es, 0), (es, 12)])


def test_model_scatter_with_slots_past_u_len():
    """Non-sentinel slots past u_len (and a repeated slot below the
    running max): each still opens or joins a group, with U mass 0."""
    rng = np.random.default_rng(21)
    pairs = [(_random_nlist(rng, int(rng.integers(1, 70)), span=300),
              _random_nlist(rng, int(rng.integers(1, 70)), span=300))
             for _ in range(12)]

    def extend(out_slot, u_len):
        out = out_slot.copy()
        for p, n in enumerate(u_len):
            tail = np.arange(int(n), out.shape[1])
            pick = tail[rng.random(tail.size) < 0.3]
            out[p, pick] = rng.integers(0, 8, pick.size)
        return out
    _check(rng, pairs, _rho(pairs), [(True, 1), (False, 1)],
           out_slot_fn=extend)


@pytest.mark.parametrize("es", [True, False])
def test_model_groups_span_chunks(es):
    """Two Z-merge groups of 140 and 160 matches: the first crosses the
    scatter's 128-entry chunk edge, the second the 256 one, so the
    running maximum and the group's mass carry across chunks."""
    n = 300
    k = np.arange(n)
    post = np.where(k < 140, 1000 - k, 2 * 10 ** 6)
    u = np.stack([10 + k, post, 1 + k % 4], 1).astype(np.int32)
    v = np.array([[5, 10 ** 6, 3], [12, 3 * 10 ** 6, 5]], np.int32)
    m = _check(np.random.default_rng(5), [(u, v)], [8], [(es, 1)])
    assert m[1][0] == 2 and m[3][0] == n + 1
