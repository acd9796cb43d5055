"""Plain PyTorch versions of the port's kernels (port of the matching
functions of ``repro.kernels.ref``): the ES scan, the dEclat difference,
the N-list merge / Z-merge scatter, the compaction gather, flash
attention and EmbeddingBag.

Each function here defines what its Hopper kernel under ``csrc/``
computes: bit for bit for the integer kernels and EmbeddingBag, within
a float tolerance for attention (the kernel sums in another order).
They run on any device: ``kernels.ops`` takes them for CPU tensors (the
tests and the CPU entry points), and ``chip_smoke.py`` runs them on the
card to hold the kernels against.

Bitmaps are int32 tensors holding uint32 bits (see ``core.bitmap``).
Unlike the jnp refs, the fused dispatches update the row store (and the
N-list scatters the code pool) **in place** and return the same tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.bitmap import (NL_SENTINEL, popcount32,
                                     suffix_popcounts)

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Blocked early-stopping bitmap intersection (Eclat "and" / dEclat "andnot")
# ---------------------------------------------------------------------------
#
# Semantics (``repro.kernels.ref``, shared with csrc/bitmap_intersect.cu):
#   * blocks are processed in order; a pair is "alive" until its ES bound
#     drops below the threshold;
#   * block k's output/count/work are produced iff the pair is alive at the
#     START of block k;
#   * counts freeze at death;
#   * mode "and":    Z = U & V,  bound_k = count_k + min(sufU[k+1], sufV[k+1])
#   * mode "andnot": Z = U & ~V, bound_k = rho_parent - count_k
#   * minsup <= 0 disables early stopping.


def _check_mode(mode: str) -> None:
    if mode not in ("and", "andnot"):
        raise ValueError(f"bad mode {mode!r}")


def _blocked_es_scan(U: Tensor, V: Tensor, suffix_u: Tensor,
                     suffix_v: Tensor, rho_parent: Tensor, thr: Tensor, *,
                     mode: str) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Blocked-ES scan with a per-pair threshold vector ``thr``, in closed
    form: per-block popcounts, their running sum, then the first block
    whose bound fails.  A pair processes block ``k`` iff no earlier block
    failed; it dies at (and including) its first failing block.  Returns
    ``(Z, counts, blocks_done, alive)`` with Z zero past the abort."""
    _check_mode(mode)
    Zf = U & (V if mode == "and" else ~V)
    pc = popcount32(Zf).sum(dim=-1)                    # (P, nb) int64
    cum = pc.cumsum(dim=1)                             # count after block k
    if mode == "and":
        bound = cum + torch.minimum(suffix_u[:, 1:], suffix_v[:, 1:])
    else:
        bound = rho_parent.to(torch.int64)[:, None] - cum
    fail = bound < thr.to(torch.int64)[:, None]        # (P, nb)
    fails_before = fail.to(torch.int32).cumsum(dim=1) - fail.to(torch.int32)
    processed = fails_before == 0                      # alive at block start
    blocks = processed.sum(dim=1).to(torch.int32)
    cnt = (pc * processed).sum(dim=1).to(torch.int32)
    alive = ~fail.any(dim=1)
    Z = Zf * processed[:, :, None].to(Zf.dtype)
    return Z, cnt, blocks, alive


def bitmap_intersect_es_ref(U: Tensor, V: Tensor, suffix_u: Tensor,
                            suffix_v: Tensor, rho_parent: Tensor, minsup,
                            *, mode: str = "and",
                            ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``U``/``V`` int32 (P, nb, bw), suffix tables int32 (P, nb+1),
    ``rho_parent`` int32 (P,), scalar ``minsup``.  Returns ``(Z, counts,
    blocks_done, alive)``."""
    thr = torch.full((U.shape[0],), int(minsup), dtype=torch.int32,
                     device=U.device)
    return _blocked_es_scan(U, V, suffix_u, suffix_v, rho_parent, thr,
                            mode=mode)


# ---------------------------------------------------------------------------
# Blocked diffset difference with zero-block skipping (dEclat)
# ---------------------------------------------------------------------------
#
# Z, counts and aliveness are those of ``_blocked_es_scan(mode="andnot")``
# bit for bit; only the work counter differs: ``blocks_done`` charges only
# the visited blocks whose U mass ``su[k] - su[k+1]`` is positive (Z = U &
# ~V is zero wherever U is, so such a block cannot change the count).


def _blocked_diff_scan(U: Tensor, V: Tensor, suffix_u: Tensor,
                       rho_parent: Tensor, thr: Tensor,
                       ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Blocked dEclat difference scan on the bound ``rho - count`` with a
    per-pair threshold ``thr`` (port of ``repro.kernels.ref.
    _blocked_diff_scan``).  Aliveness is a prefix property, so the
    visited blocks are ``range(visited)`` of the andnot scan, and the
    work counter keeps the nonzero-mass ones.  Returns ``(Z, counts,
    blocks_done, alive)``."""
    Z, cnt, visited, alive = _blocked_es_scan(
        U, V, suffix_u, suffix_u, rho_parent, thr, mode="andnot")
    nb = U.shape[1]
    mass = suffix_u[:, :-1] - suffix_u[:, 1:]
    k = torch.arange(nb, device=U.device)
    blocks = ((k[None, :] < visited[:, None]) & (mass > 0)).sum(dim=1)
    return Z, cnt, blocks.to(torch.int32), alive


def bitmap_diff_es_ref(U: Tensor, V: Tensor, suffix_u: Tensor,
                       rho_parent: Tensor, minsup,
                       ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Blocked dEclat difference ``Z = U & ~V`` with zero-block skipping
    (``repro.kernels.ref.bitmap_diff_es_ref``).  ``minsup <= 0`` disables
    early stopping.  Returns ``(Z, counts, blocks_done, alive)``."""
    thr = torch.full((U.shape[0],), int(minsup), dtype=torch.int32,
                     device=U.device)
    return _blocked_diff_scan(U, V, suffix_u, rho_parent, thr)


def _survivor_mask(cnt: Tensor, alive: Tensor, rho_parent: Tensor, minsup,
                   *, mode: str) -> Tensor:
    """The scatter gate: a child is materialised iff its exact support
    clears minsup AND its pair finished the scan alive (in diff mode a
    dead pair's frozen count overestimates ``rho - cnt``, so aliveness is
    load-bearing)."""
    support = cnt if mode == "and" else rho_parent.to(torch.int32) - cnt
    return alive & (support >= int(minsup))


def _scatter_children(rows: Tensor, suffix: Tensor, Z: Tensor,
                      keep: Tensor, slots: Tensor) -> None:
    """Write the kept children and their suffix tables at ``slots``, in
    place; slots outside ``[0, capacity)`` are skipped (the explicit mask
    stands in for JAX's ``mode="drop"``)."""
    cap = rows.shape[0]
    keep = keep & (slots >= 0) & (slots < cap)
    dst = slots[keep].to(torch.int64)
    rows[dst] = Z[keep]
    suffix[dst] = suffix_popcounts(Z[keep])


def screen_and_intersect_ref(rows: Tensor, suffix: Tensor, ua: Tensor,
                             vb: Tensor, slots: Tensor, rho_parent: Tensor,
                             minsup, *, mode: str = "and",
                             early_stop: bool = True,
                             ) -> Tuple[Tensor, Tensor, Tensor, Tensor,
                                        Tensor]:
    """Fused screen + blocked ES intersection over a row store, scatter
    included (``repro.kernels.ref.screen_and_intersect_ref``).

    Operands are gathered by row index; the child row and its suffix
    table are written at ``slots[i]`` only for survivors
    (:func:`_survivor_mask`) whose slot lies in ``[0, capacity)`` — the
    explicit mask stands in for JAX's ``mode="drop"``.  Non-survivor and
    pad slots are left untouched.  ``rows``/``suffix`` are updated in
    place and returned with ``(counts, blocks_done, alive)``."""
    U = rows.index_select(0, ua)
    V = rows.index_select(0, vb)
    su = suffix.index_select(0, ua)
    sv = suffix.index_select(0, vb)
    es_minsup = int(minsup) if early_stop else 0
    Z, cnt, blocks, alive = bitmap_intersect_es_ref(
        U, V, su, sv, rho_parent, es_minsup, mode=mode)
    _scatter_children(rows, suffix, Z,
                      _survivor_mask(cnt, alive, rho_parent, minsup,
                                     mode=mode), slots)
    return rows, suffix, cnt, blocks, alive


def screen_and_diff_ref(rows: Tensor, suffix: Tensor, ua: Tensor,
                        vb: Tensor, slots: Tensor, rho_parent: Tensor,
                        minsup, *, early_stop: bool = True,
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Fused screen + blocked dEclat difference over a row store, scatter
    included (``repro.kernels.ref.screen_and_diff_ref``): the diffset
    sibling of :func:`screen_and_intersect_ref`, gated on ``rho - count``
    with the skip-aware work counter.  Fed tidset operands it writes the
    level-2 diffset ``T(a) & ~T(b)``.  Updates ``rows``/``suffix`` in place
    and returns them with ``(counts, blocks_done, alive)``."""
    U = rows.index_select(0, ua)
    V = rows.index_select(0, vb)
    su = suffix.index_select(0, ua)
    es_minsup = int(minsup) if early_stop else 0
    Z, cnt, blocks, alive = bitmap_diff_es_ref(U, V, su, rho_parent,
                                               es_minsup)
    _scatter_children(rows, suffix, Z,
                      _survivor_mask(cnt, alive, rho_parent, minsup,
                                     mode="andnot"), slots)
    return rows, suffix, cnt, blocks, alive


_INT32_MIN = -(2 ** 31)


def _sharded_slice(rows: Tensor, suffix: Tensor, ua: Tensor, vb: Tensor,
                   rho: Tensor, minsup: int, n_real: int, *, n_shards: int,
                   mode: str, early_stop: bool):
    """One cls shard's pair slice over every virtual block shard: the
    per-pair math of the sharded dispatch up to, not including, the
    scatter.  Returns ``(Z, child_suffix, bound, count, blocks, alive)``."""
    _, nb, bw = rows.shape
    nbl = nb // n_shards
    n = ua.shape[0]
    S = n_shards
    U = rows.index_select(0, ua).reshape(n * S, nbl, bw)
    V = rows.index_select(0, vb).reshape(n * S, nbl, bw)
    su = suffix.index_select(0, ua).reshape(n * S, nbl + 1)
    sv = suffix.index_select(0, vb).reshape(n * S, nbl + 1)
    rho_s = rho.to(torch.int32).repeat_interleave(S)
    if not early_stop:
        thr = torch.full((n * S,), _INT32_MIN, dtype=torch.int32,
                         device=rows.device)
    elif mode == "and":
        m = torch.minimum(su[:, 0], sv[:, 0]).reshape(n, S).to(torch.int64)
        slack = m.sum(dim=1, keepdim=True) - m      # every OTHER shard's
        thr = (int(minsup) - slack).reshape(-1).to(torch.int32)
    else:
        thr = torch.full((n * S,), int(minsup), dtype=torch.int32,
                         device=rows.device)
    if mode == "and":
        Z, cnt, blocks, alive = _blocked_es_scan(U, V, su, sv, rho_s, thr,
                                                 mode="and")
        # The block axis is padded to the shard count at the tail; a
        # shard's scan count is clamped to its real blocks.
        real_local = (n_real - torch.arange(S, device=rows.device) * nbl
                      ).clamp(0, nbl)
        blocks = torch.minimum(blocks.reshape(n, S), real_local[None, :])
    else:
        # The skip-aware counter of the diff scan: nonzero-mass U blocks
        # visited (pad blocks have no mass).
        Z, cnt, blocks, alive = _blocked_diff_scan(U, V, su, rho_s, thr)
        blocks = blocks.reshape(n, S)
    zpc = popcount32(Z).sum(dim=-1).reshape(n, S, nbl)
    c0 = zpc[:, :, 0].to(torch.int64)
    if mode == "and":
        bound = (c0 + torch.minimum(su[:, 1], sv[:, 1]).reshape(n, S)
                 ).sum(dim=1)
    else:
        bound = rho.to(torch.int64) - c0.sum(dim=1)
    child_suffix = suffix_popcounts(Z).reshape(n, S * (nbl + 1))
    return (Z.reshape(n, nb, bw), child_suffix, bound.to(torch.int32),
            cnt.reshape(n, S).sum(dim=1).to(torch.int32),
            blocks.sum(dim=1).to(torch.int32),
            alive.reshape(n, S).all(dim=1))


def screen_and_intersect_sharded_ref(
        rows: Tensor, suffix: Tensor, ua: Tensor, vb: Tensor, slots: Tensor,
        rho_parent: Tensor, minsup, n_real_blocks=None, *, n_shards: int,
        n_cls: int = 1, mode: str = "and", early_stop: bool = True,
        ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The sharded fused dispatch in one process, with ``n_shards``
    virtual block shards and ``n_cls`` virtual pair slices (port of
    ``repro.kernels.ref.screen_and_intersect_sharded_ref``): the yardstick
    of ``ops.make_screen_and_intersect_sharded``.

    ``rows`` int32 (cap, nb, bw) holds every shard's blocks, ``nb`` a
    multiple of ``n_shards`` with the pad at the tail; ``suffix`` int32
    (cap, n_shards * (nb // n_shards + 1)) holds each shard's local
    suffix table in turn (``DeviceRowStore``'s sharded layout).  Per pair:

    * ``thr`` per shard: ``minsup - slack`` in mode "and" with ES, where
      slack is ``sum over the OTHER shards of min(sufU[0], sufV[0])``;
      minsup in mode "andnot"; INT32_MIN (never kills) with ES off;
    * each shard's blocked scan against its threshold (mode "andnot"
      counts the nonzero-mass U blocks visited, as the diff scan does);
    * ``count``/``blocks`` summed over shards (mode "and" clamps each
      shard's count of blocks to its real ones, ``n_real_blocks``), alive
      iff every shard finished alive, ``bound`` the two-level screen:
      ``sum_s (c0_s + min(sufU_s[1], sufV_s[1]))`` or ``rho - sum_s
      c0_s`` with ``c0_s`` the popcount of the shard's block 0;
    * survivors (global count and alive, ``_survivor_mask``) write their
      child rows and local suffix tables at ``slots``; other slots and
      slots outside ``[0, cap)`` stay untouched.

    The chunk is cut into ``n_cls`` contiguous slices evaluated apart, so
    every output is that of ``n_cls=1``.  Updates ``rows``/``suffix`` in
    place and returns them with ``(bound, count, blocks, alive)``."""
    _check_mode(mode)
    n = ua.shape[0]
    nb = rows.shape[1]
    if n_cls < 1 or n % n_cls:
        raise ValueError(f"pair chunk of {n} does not divide n_cls={n_cls}")
    if nb % n_shards or suffix.shape[1] != n_shards * (nb // n_shards + 1):
        raise ValueError(f"rows {tuple(rows.shape)} / suffix "
                         f"{tuple(suffix.shape)} are not {n_shards} shards")
    n_real = nb if n_real_blocks is None else int(n_real_blocks)
    k = n // n_cls
    parts = [_sharded_slice(rows, suffix, ua[c * k:(c + 1) * k],
                            vb[c * k:(c + 1) * k],
                            rho_parent[c * k:(c + 1) * k], minsup, n_real,
                            n_shards=n_shards, mode=mode,
                            early_stop=early_stop)
             for c in range(n_cls)]
    Z, child_suffix, bound, count, blocks, alive = (
        torch.cat([p[i] for p in parts]) for i in range(6))
    keep = _survivor_mask(count, alive, rho_parent, minsup, mode=mode)
    cap = rows.shape[0]
    keep = keep & (slots >= 0) & (slots < cap)
    dst = slots[keep].to(torch.int64)
    rows[dst] = Z[keep]
    suffix[dst] = child_suffix[keep]
    return rows, suffix, bound, count, blocks, alive


def bitmap_count_ref(U: Tensor, V: Tensor) -> Tensor:
    """Plain AND + popcount support counting (no ES); int32 (P,)."""
    return popcount32(U & V).reshape(U.shape[0], -1).sum(dim=-1).to(
        torch.int32)


def bitmap_intersect_full_ref(U: Tensor, V: Tensor, *, mode: str = "and",
                              ) -> Tuple[Tensor, Tensor]:
    """One AND/ANDNOT + popcount pass, no block scan: ``(Z, counts)``."""
    _check_mode(mode)
    Z = U & (V if mode == "and" else ~V)
    cnt = popcount32(Z).reshape(U.shape[0], -1).sum(dim=-1).to(torch.int32)
    return Z, cnt


def screen_pairs_ref(first_u: Tensor, first_v: Tensor, suffix1_u: Tensor,
                     suffix1_v: Tensor, rho_parent: Tensor, minsup, *,
                     mode: str = "and") -> Tuple[Tensor, Tensor]:
    """One-block refinement of the support bound.

    mode "and":    bound = |U0 & V0|  + min(sufU[1], sufV[1])
    mode "andnot": bound = rho_parent - |U0 & ~V0|
    Returns ``(bound int32, alive bool)``."""
    if mode == "and":
        c0 = popcount32(first_u & first_v).sum(dim=-1)
        bound = c0 + torch.minimum(suffix1_u, suffix1_v)
    elif mode == "andnot":
        c0 = popcount32(first_u & ~first_v).sum(dim=-1)
        bound = rho_parent.to(torch.int64) - c0
    else:
        raise ValueError(f"bad mode {mode!r}")
    bound = bound.to(torch.int32)
    return bound, bound >= int(minsup)


# ---------------------------------------------------------------------------
# N-list intersection (PrePost+)
# ---------------------------------------------------------------------------
#
# PP-codes are (pre, post, freq) int32 triples; padded batches carry
# pre = NL_SENTINEL past each row's length.  The merge is the two-pointer
# walk of ``repro.kernels.ref._nl_merge_vmapped`` with the corrected ES
# guard ``z_mass + (rho_V - skip) < minsup``.


def _nl_merge(u_pre: Tensor, u_post: Tensor, u_freq: Tensor, v_pre: Tensor,
              v_post: Tensor, v_freq: Tensor, u_len: Tensor, v_len: Tensor,
              rho_v: Tensor, minsup, *, early_stop: bool,
              ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Batched two-pointer N-list merge (port of ``_nl_merge_vmapped``).

    Every pair takes one step of its walk per loop iteration, masked once
    its own loop condition fails, so each pair's comparisons, checks and
    abort point are exactly the sequential merge's.  Returns ``(out_slot,
    support, comparisons, checks, alive)``: ``out_slot[p, i]`` is the V
    index U code ``i`` matched (else ``NL_SENTINEL``); an aborted pair
    reports support 0."""
    P, Lu = u_pre.shape
    Lv = v_pre.shape[1]
    dev = u_pre.device
    i32 = torch.int32
    nu, nv, rho = u_len.to(i32), v_len.to(i32), rho_v.to(i32)
    minsup = int(minsup)
    i = torch.zeros(P, dtype=i32, device=dev)
    j, z_mass, skip, cmps, checks = (torch.zeros_like(i) for _ in range(5))
    alive = torch.ones(P, dtype=torch.bool, device=dev)
    # Column Lu of the match table takes the writes of non-matching steps.
    out_slot = torch.full((P, Lu + 1), NL_SENTINEL, dtype=i32, device=dev)
    U3 = torch.stack([u_pre, u_post, u_freq], dim=-1).to(i32)
    V3 = torch.stack([v_pre, v_post, v_freq], dim=-1).to(i32)
    rows = torch.arange(P, device=dev)
    dump = torch.full((P,), Lu, dtype=torch.int64, device=dev)
    n_steps = int((nu + nv).max()) if P and Lu and Lv else 0
    for step in range(n_steps):
        act = (i < nu) & (j < nv) & alive
        if step % 256 == 0 and not bool(act.any()):
            break
        ic = i.clamp(0, Lu - 1).long()
        x, y = U3[rows, ic], V3[rows, j.clamp(0, Lv - 1).long()]
        is_desc = (x[:, 0] > y[:, 0]) & (x[:, 1] < y[:, 1])
        adv = is_desc | (x[:, 0] <= y[:, 0])
        match = act & is_desc
        out_slot[rows, torch.where(match, ic, dump)] = j
        cmps += act
        z_mass += torch.where(match, x[:, 2], 0)
        skipped = act & ~adv
        skip += torch.where(skipped, y[:, 2], 0)
        checks += skipped
        if early_stop:
            alive &= ~(act & (z_mass + (rho - skip) < minsup))
        i += act & adv
        j += skipped
    support = torch.where(alive, z_mass, 0)
    return out_slot[:, :Lu].contiguous(), support, cmps, checks, alive


def nlist_intersect_ref(u_pre: Tensor, u_post: Tensor, u_freq: Tensor,
                        v_pre: Tensor, v_post: Tensor, v_freq: Tensor,
                        u_len: Tensor, v_len: Tensor, rho_v: Tensor, minsup,
                        *, early_stop: bool = True,
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Padded-batch N-list merge (``repro.kernels.ref.nlist_intersect_ref``):
    ``(out_slot, support, comparisons, checks, alive)``."""
    return _nl_merge(u_pre, u_post, u_freq, v_pre, v_post, v_freq, u_len,
                     v_len, rho_v, minsup, early_stop=early_stop)


def _nl_gather(codes: Tensor, off: Tensor, length: Tensor, width: int,
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Padded ``(pre, post, freq)`` rows ``(P, width)`` gathered from the
    pool slab ``codes (cap, 3)`` by extent offset; pre is the sentinel
    (post, freq 0) past each row's length."""
    cap = codes.shape[0]
    k = torch.arange(width, device=codes.device)
    idx = (off.to(torch.int64)[:, None] + k[None, :]).clamp(0, cap - 1)
    mask = k[None, :] < length[:, None]
    g = codes[idx]
    return (torch.where(mask, g[..., 0], NL_SENTINEL),
            torch.where(mask, g[..., 1], 0),
            torch.where(mask, g[..., 2], 0))


def _nl_group_starts(out_slot: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Z-merge groups (Alg. 3 line 31): matched slots are non-decreasing,
    so a group starts where the slot exceeds the running maximum of the
    earlier matched slots.  Returns ``(valid, start, child_len)``."""
    P = out_slot.shape[0]
    valid = out_slot != NL_SENTINEL
    js = torch.where(valid, out_slot, -1)
    running = torch.cummax(js, dim=1).values
    prev = torch.cat([torch.full((P, 1), -1, dtype=js.dtype,
                                 device=js.device), running[:, :-1]], dim=1)
    start = valid & (out_slot != prev)
    return valid, start, start.sum(dim=1).to(torch.int32)


def _nl_zmerge_scatter(codes: Tensor, out_slot: Tensor, u_freq: Tensor,
                       v_pre: Tensor, v_post: Tensor, out_off: Tensor,
                       ) -> Tuple[Tensor, Tensor]:
    """Z-merge + child scatter into the pool, in place: group ``g`` of
    pair ``p`` (U frequencies summed, the representative V code's pre and
    post) is written at ``out_off[p] + g``; destinations outside ``[0,
    capacity)`` are skipped (JAX's ``mode="drop"``).  Returns ``(codes,
    child_len)``."""
    P, Lu = out_slot.shape
    cap = codes.shape[0]
    valid, start, child_len = _nl_group_starts(out_slot)
    gid = start.to(torch.int64).cumsum(dim=1) - 1
    dump = torch.full_like(gid, Lu)                    # dropped column
    zfreq = torch.zeros((P, Lu + 1), dtype=torch.int32, device=codes.device)
    zfreq.scatter_add_(1, torch.where(valid, gid, dump),
                       torch.where(valid, u_freq.to(torch.int32), 0))
    rep = torch.zeros((P, Lu + 1), dtype=torch.int64, device=codes.device)
    rep.scatter_(1, torch.where(start, gid, dump),
                 torch.where(start, out_slot.to(torch.int64), 0))
    rep = rep[:, :Lu]
    child = torch.stack([v_pre.gather(1, rep), v_post.gather(1, rep),
                         zfreq[:, :Lu]], dim=-1).to(torch.int32)
    k = torch.arange(Lu, device=codes.device)
    dest = out_off.to(torch.int64)[:, None] + k[None, :]
    keep = (k[None, :] < child_len[:, None]) & (dest >= 0) & (dest < cap)
    codes[dest[keep]] = child[keep]
    return codes, child_len


def nlist_presize_ref(codes: Tensor, u_off: Tensor, u_len: Tensor,
                      v_off: Tensor, v_len: Tensor, rho_v: Tensor, minsup,
                      *, lu: int, lv: int, early_stop: bool = True,
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                                 Tensor]:
    """Merge-only pre-pass (``repro.kernels.ref.nlist_presize_ref``):
    gather both operands from the pool, merge, count the Z-merge groups.
    Returns ``(out_slot, child_len, support, comparisons, checks,
    alive)``."""
    u_pre, u_post, u_freq = _nl_gather(codes, u_off, u_len, lu)
    v_pre, v_post, v_freq = _nl_gather(codes, v_off, v_len, lv)
    out_slot, support, cmps, checks, alive = _nl_merge(
        u_pre, u_post, u_freq, v_pre, v_post, v_freq, u_len, v_len, rho_v,
        minsup, early_stop=early_stop)
    _, _, child_len = _nl_group_starts(out_slot)
    return out_slot, child_len, support, cmps, checks, alive


def nlist_scatter_ref(codes: Tensor, out_slot: Tensor, u_off: Tensor,
                      u_len: Tensor, v_off: Tensor, v_len: Tensor,
                      out_off: Tensor, *, lu: int, lv: int,
                      ) -> Tuple[Tensor, Tensor]:
    """Scatter pass (``repro.kernels.ref.nlist_scatter_ref``): Z-merge the
    pre-pass match table into the pool at ``out_off``, in place.
    Returns ``(codes, child_len)``."""
    _, _, u_freq = _nl_gather(codes, u_off, u_len, lu)
    v_pre, v_post, _ = _nl_gather(codes, v_off, v_len, lv)
    return _nl_zmerge_scatter(codes, out_slot, u_freq, v_pre, v_post,
                              out_off)


def nlist_extend_ref(codes: Tensor, u_off: Tensor, u_len: Tensor,
                     v_off: Tensor, v_len: Tensor, out_off: Tensor,
                     rho_v: Tensor, minsup, *, lu: int, lv: int,
                     early_stop: bool = True,
                     ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                                Tensor]:
    """One-dispatch PrePost+ extension (``repro.kernels.ref.
    nlist_extend_ref``): merge, then Z-merge + scatter for pairs whose
    support clears minsup.  In place; returns ``(codes, child_len,
    support, comparisons, checks, alive)``."""
    u_pre, u_post, u_freq = _nl_gather(codes, u_off, u_len, lu)
    v_pre, v_post, v_freq = _nl_gather(codes, v_off, v_len, lv)
    out_slot, support, cmps, checks, alive = _nl_merge(
        u_pre, u_post, u_freq, v_pre, v_post, v_freq, u_len, v_len, rho_v,
        minsup, early_stop=early_stop)
    cap = codes.shape[0]
    out_off = torch.where(support >= int(minsup), out_off.to(torch.int32),
                          cap)
    codes, child_len = _nl_zmerge_scatter(codes, out_slot, u_freq, v_pre,
                                          v_post, out_off)
    return codes, child_len, support, cmps, checks, alive


def compact_gather_ref(slab: Tensor, perm: Tensor) -> Tensor:
    """``out[i] = slab[perm[i]]`` for ``0 <= perm[i] < capacity``, zeros
    elsewhere (``perm < 0`` marks free slots; ``perm >= capacity`` also
    comes up zeroed, as in the jnp ref).  Any leading-axis slab."""
    cap = slab.shape[0]
    g = slab.index_select(0, perm.clamp(0, cap - 1))
    ok = (perm >= 0) & (perm < cap)
    ok = ok.reshape((perm.shape[0],) + (1,) * (slab.dim() - 1))
    return g * ok.to(slab.dtype)


# ---------------------------------------------------------------------------
# flash attention + embedding bag (``repro.kernels.ref``: 553, 571)
# ---------------------------------------------------------------------------

def check_window(Sq: int, Skv: int, causal: bool, window: int) -> None:
    """A sliding window needs the causal mask and ``Sq <= Skv``, so that
    every query row sees at least its own key."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("a sliding window needs causal=True")
    if window and Sq > Skv:
        raise ValueError(f"a sliding window needs Sq <= Skv (every query "
                         f"row sees a key), got Sq={Sq}, Skv={Skv}")


# Scores the plain attention holds at once (fp32): 2^28 is 1 GiB.
_SCORE_BLOCK = 1 << 28


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True, window: int = 0,
                        softmax_scale=None) -> Tensor:
    """Dense attention with an fp32 softmax, GQA by folding query heads
    into ``(KH, G)`` groups: q ``(B, Sq, H, D)``, k ``(B, Skv, KH, D)``,
    v ``(B, Skv, KH, Dv)`` -> ``(B, Sq, H, Dv)`` in q's type.  Any ``Sq``
    and ``Skv``; the causal mask is top-left aligned (query ``i`` sees
    keys ``<= i``), ``window`` > 0 also masks keys ``<= i - window`` (the
    JAX package's ``chunked_attention(window=...)``), and masked scores
    are ``-1e30``.  Query rows go in blocks of at most 2^28 scores, each
    row's softmax whole."""
    B, Sq, H, D = q.shape
    _, Skv, KH, Dv = v.shape
    check_window(Sq, Skv, causal, window)
    G = H // KH
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    ar_k = torch.arange(Skv, device=q.device)
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    rows = max(1, _SCORE_BLOCK // max(B * H * Skv, 1))
    for i0 in range(0, Sq, rows):
        i1 = min(Sq, i0 + rows)
        qg = q[:, i0:i1].reshape(B, i1 - i0, KH, G, D).to(torch.float32)
        s = torch.einsum("bqkgd,bskd->bqkgs", qg, kf) * scale
        if causal:
            ar_q = torch.arange(i0, i1, device=q.device)
            masked = ar_q[:, None] < ar_k[None, :]
            if window:
                masked |= (ar_q[:, None] - ar_k[None, :]) >= window
            s.masked_fill_(masked[None, :, None, None, :], -1e30)
        a = torch.softmax(s, dim=-1)
        del s
        o = torch.einsum("bqkgs,bskv->bqkgv", a, vf)
        out[:, i0:i1] = o.reshape(B, i1 - i0, H, Dv).to(q.dtype)
    return out


def embedding_bag_ref(table: Tensor, ids: Tensor, mask: Tensor, *,
                      combiner: str = "mean") -> Tensor:
    """Masked sum (or mean over ``max(count, 1)``) of the rows ``ids``
    names, per bag: table ``(V, D)``, ids and mask ``(B, L)`` -> ``(B,
    D)``.  The slots are added in order, one at a time, which is the
    order the Hopper kernel adds them in; a masked slot adds zero (its id
    is clamped into the table, so it may hold any value)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    B, L = ids.shape
    V, D = table.shape
    m = mask.to(torch.float32)
    safe = ids.to(torch.int64).clamp(0, max(V - 1, 0))
    acc = torch.zeros((B, D), dtype=torch.float32, device=table.device)
    for j in range(L):
        acc = acc + table[safe[:, j]].to(torch.float32) * m[:, j, None]
    if combiner == "mean":
        acc = acc / m.sum(dim=-1, keepdim=True).clamp_min(1.0)
    return acc.to(table.dtype)
