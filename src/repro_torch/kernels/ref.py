"""Plain PyTorch versions of the main path's kernels (port of the
matching functions of ``repro.kernels.ref``).

Each function here defines, bit for bit, what its Hopper kernel under
``csrc/`` computes.  They run on any device: ``kernels.ops`` takes them
for CPU tensors (the tests and the CPU entry points), and
``chip_smoke.py`` runs them on the card to hold the kernels against.

Bitmaps are int32 tensors holding uint32 bits (see ``core.bitmap``).
Unlike the jnp refs, the fused dispatch updates the row store **in
place** and returns the same tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.bitmap import popcount32, suffix_popcounts

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


def _survivor_mask(cnt: Tensor, alive: Tensor, rho_parent: Tensor, minsup,
                   *, mode: str) -> Tensor:
    """The scatter gate: a child is materialised iff its exact support
    clears minsup AND its pair finished the scan alive."""
    support = cnt if mode == "and" else rho_parent.to(torch.int32) - cnt
    return alive & (support >= int(minsup))


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
    cap = rows.shape[0]
    keep = (_survivor_mask(cnt, alive, rho_parent, minsup, mode=mode)
            & (slots >= 0) & (slots < cap))
    dst = slots[keep].to(torch.int64)
    rows[dst] = Z[keep]
    suffix[dst] = suffix_popcounts(Z[keep])
    return rows, suffix, cnt, blocks, alive


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


def compact_gather_ref(slab: Tensor, perm: Tensor) -> Tensor:
    """``out[i] = slab[perm[i]]`` for ``0 <= perm[i] < capacity``, zeros
    elsewhere (``perm < 0`` marks free slots; ``perm >= capacity`` also
    comes up zeroed, as in the jnp ref).  Any leading-axis slab."""
    cap = slab.shape[0]
    g = slab.index_select(0, perm.clamp(0, cap - 1))
    ok = (perm >= 0) & (perm < cap)
    ok = ok.reshape((perm.shape[0],) + (1,) * (slab.dim() - 1))
    return g * ok.to(slab.dtype)
