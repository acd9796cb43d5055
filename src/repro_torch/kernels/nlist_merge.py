"""Wrappers of the Hopper N-list kernels (``csrc/nlist_merge.cu``).

* :func:`nlist_merge` — counterpart of ``repro.kernels.nlist_merge.
  nlist_merge`` (the Pallas TPU kernel) fused with the operand gather and
  the Z-merge group count of ``repro.kernels.ops._nlist_presize_impl``:
  a warp per pair traces the sequential two-pointer walk through
  32-code windows of both operand N-lists, read straight from the pool
  slab, and returns the match table, exact child lengths, supports,
  comparison and check counts and aliveness.
* :func:`zmerge_scatter` — counterpart of ``repro.kernels.ref.
  _nl_zmerge_scatter`` (jnp in the JAX package, no Pallas kernel): a
  warp per pair reads its match-table row coalesced, Z-merges it and
  writes the child N-list into the pool at ``out_off``, in place.

CUDA int32 tensors only; the plain versions for CPU tensors live in
``kernels.ref`` and are chosen by ``kernels.ops``.  Each launch adds one
to its function's ``launches``; launches are on
``torch.cuda.current_stream()`` and never synchronise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .bitmap_intersect import _check

Tensor = torch.Tensor


def _check_pool(codes: Tensor, cols, n_pairs: int) -> None:
    _check(codes, "codes")
    if codes.dim() != 2 or codes.shape[1] != 3:
        raise ValueError(f"codes must be (capacity, 3), got "
                         f"{tuple(codes.shape)}")
    for name, t in cols.items():
        _check(t, name, (n_pairs,))


def nlist_merge(codes: Tensor, u_off: Tensor, u_len: Tensor, v_off: Tensor,
                v_len: Tensor, rho_v: Tensor, minsup: int, *, lu: int,
                early_stop: bool = True,
                ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Two-pointer ES merge of each pair's U and V extents of the pool
    slab ``codes`` (capacity, 3).  ``lu`` is the width of the match table
    and must be at least every ``u_len``.  Returns ``(out_slot (P, lu),
    child_len, support, comparisons, checks, alive)``."""
    P = int(u_off.shape[0])
    _check_pool(codes, dict(u_off=u_off, u_len=u_len, v_off=v_off,
                            v_len=v_len, rho_v=rho_v), P)
    if lu < 1:
        raise ValueError(f"lu must be >= 1, got {lu}")
    dev = codes.device
    out_slot = torch.empty((P, lu), dtype=torch.int32, device=dev)
    child_len, support, cmps, checks = (
        torch.empty(P, dtype=torch.int32, device=dev) for _ in range(4))
    alive = torch.empty(P, dtype=torch.bool, device=dev)
    if P:
        err = _build.load().repro_nlist_merge(
            codes.data_ptr(), int(codes.shape[0]), u_off.data_ptr(),
            u_len.data_ptr(), v_off.data_ptr(), v_len.data_ptr(),
            rho_v.data_ptr(), P, int(lu), int(minsup), int(bool(early_stop)),
            out_slot.data_ptr(), child_len.data_ptr(), support.data_ptr(),
            cmps.data_ptr(), checks.data_ptr(), alive.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "nlist_merge")
        nlist_merge.launches += 1
    return out_slot, child_len, support, cmps, checks, alive


nlist_merge.launches = 0


def zmerge_scatter(codes: Tensor, out_slot: Tensor, u_off: Tensor,
                   u_len: Tensor, v_off: Tensor, v_len: Tensor,
                   out_off: Tensor) -> Tensor:
    """Z-merge ``out_slot`` (P, lu) and write each pair's child N-list at
    ``out_off`` into ``codes`` **in place**; destinations outside ``[0,
    capacity)`` are skipped.  Returns ``child_len``."""
    P = int(u_off.shape[0])
    _check_pool(codes, dict(u_off=u_off, u_len=u_len, v_off=v_off,
                            v_len=v_len, out_off=out_off), P)
    _check(out_slot, "out_slot")
    if out_slot.dim() != 2 or out_slot.shape[0] != P:
        raise ValueError(f"out_slot must be ({P}, lu), got "
                         f"{tuple(out_slot.shape)}")
    dev = codes.device
    child_len = torch.empty(P, dtype=torch.int32, device=dev)
    if P:
        err = _build.load().repro_zmerge_scatter(
            codes.data_ptr(), int(codes.shape[0]), out_slot.data_ptr(),
            int(out_slot.shape[1]), u_off.data_ptr(), u_len.data_ptr(),
            v_off.data_ptr(), v_len.data_ptr(), out_off.data_ptr(), P,
            child_len.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "zmerge_scatter")
        zmerge_scatter.launches += 1
    return child_len


zmerge_scatter.launches = 0
