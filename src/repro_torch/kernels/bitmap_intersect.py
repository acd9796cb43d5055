"""Wrappers of the Hopper ES-scan kernel (``csrc/bitmap_intersect.cu``).

Counterpart of ``repro.kernels.bitmap_intersect.bitmap_intersect_es``
(the Pallas TPU kernel) and of the gather/scatter that
``repro.kernels.ops._screen_and_intersect_impl`` fuses around it.  One
CUDA kernel serves both entries here:

* :func:`screen_and_intersect` — the mining hot path: operands are read
  straight from the row-store slab by index and survivors' child rows and
  suffix tables are written into it (in place), all in one launch;
* :func:`bitmap_intersect_es` — the standalone scan over materialised
  operand batches, returning Z.

Both take CUDA int32 tensors only and raise on anything else: the plain
versions for CPU tensors live in ``kernels.ref`` and are chosen by
``kernels.ops``.  Each launch adds one to ``bitmap_intersect_es.launches``
(the kernel's single launch counter); launches are on
``torch.cuda.current_stream()`` and never synchronise.

The abort threshold is one scalar for every pair, or a per-pair int32
vector ``thr`` (the sharded dispatch's ``minsup - slack``); any int32 is
exact, and one at or below 0 never kills an "and" pair.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

Tensor = torch.Tensor


def _check(t: Tensor, name: str, shape=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _launch(U, V, su, sv, ua, vb, rho, *, es_minsup: int, mode: str,
            Z, cnt, blocks, alive, child_rows, child_suffix, slots,
            gate_minsup: int, thr=None) -> None:
    if mode not in ("and", "andnot"):
        raise ValueError(f"bad mode {mode!r}")
    n_pairs = int(rho.shape[0])
    if n_pairs == 0:
        return
    _, nb, bw = U.shape
    cap = int(child_rows.shape[0]) if child_rows is not None else 0
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.load()
    err = lib.repro_es_scan(
        ptr(U), ptr(V), ptr(su), ptr(sv), ptr(ua), ptr(vb), ptr(rho),
        n_pairs, int(nb), int(bw), int(es_minsup), ptr(thr),
        int(mode == "andnot"),
        ptr(Z), ptr(cnt), ptr(blocks), ptr(alive), ptr(child_rows),
        ptr(child_suffix), ptr(slots), cap, int(gate_minsup),
        torch.cuda.current_stream(U.device).cuda_stream)
    _build.check(err, "bitmap_intersect_es")
    bitmap_intersect_es.launches += 1


def _outputs(n_pairs: int, device) -> Tuple[Tensor, Tensor, Tensor]:
    return (torch.empty(n_pairs, dtype=torch.int32, device=device),
            torch.empty(n_pairs, dtype=torch.int32, device=device),
            torch.empty(n_pairs, dtype=torch.bool, device=device))


def bitmap_intersect_es(U: Tensor, V: Tensor, suffix_u: Tensor,
                        suffix_v: Tensor, rho_parent: Tensor, minsup: int,
                        *, mode: str = "and", write_z: bool = True,
                        thr: "Tensor | None" = None,
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Standalone blocked ES scan over ``U``/``V`` int32 (P, nb, bw), with
    the threshold ``minsup`` for every pair or, where given, ``thr``
    int32 (P,) per pair.  Returns ``(Z, counts, blocks_done, alive)``;
    with ``write_z=False`` no Z is written and ``None`` is returned in its
    place (support counting)."""
    P, nb, bw = U.shape
    _check(U, "U")
    _check(V, "V", (P, nb, bw))
    _check(suffix_u, "suffix_u", (P, nb + 1))
    _check(suffix_v, "suffix_v", (P, nb + 1))
    _check(rho_parent, "rho_parent", (P,))
    if thr is not None:
        _check(thr, "thr", (P,))
    Z = torch.empty_like(U) if write_z else None
    cnt, blocks, alive = _outputs(P, U.device)
    _launch(U, V, suffix_u, suffix_v, None, None, rho_parent,
            es_minsup=minsup, mode=mode, Z=Z, cnt=cnt, blocks=blocks,
            alive=alive, child_rows=None, child_suffix=None, slots=None,
            gate_minsup=0, thr=thr)
    return Z, cnt, blocks, alive


bitmap_intersect_es.launches = 0


def screen_and_intersect(rows: Tensor, suffix: Tensor, ua: Tensor,
                         vb: Tensor, slots: Tensor, rho_parent: Tensor,
                         minsup: int, es_minsup: int, *, mode: str = "and",
                         thr: "Tensor | None" = None,
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused gather + blocked ES scan + survivor-only scatter over the row
    store.  ``rows`` int32 (cap, nb, bw) and ``suffix`` int32 (cap, nb+1)
    are updated **in place**; a child is written at ``slots[i]`` iff pair
    ``i`` finished alive, its support clears ``minsup`` and ``0 <=
    slots[i] < cap``.  ``es_minsup`` is the scan's abort threshold (0 = ES
    off), or ``thr`` int32 (P,) per pair where given.  Returns ``(counts,
    blocks_done, alive)``."""
    cap, nb, bw = rows.shape
    P = int(ua.shape[0])
    _check(rows, "rows")
    _check(suffix, "suffix", (cap, nb + 1))
    for t, name in ((ua, "ua"), (vb, "vb"), (slots, "slots"),
                    (rho_parent, "rho_parent")):
        _check(t, name, (P,))
    if thr is not None:
        _check(thr, "thr", (P,))
    cnt, blocks, alive = _outputs(P, rows.device)
    _launch(rows, rows, suffix, suffix, ua, vb, rho_parent,
            es_minsup=es_minsup, mode=mode, Z=None, cnt=cnt, blocks=blocks,
            alive=alive, child_rows=rows, child_suffix=suffix, slots=slots,
            gate_minsup=minsup, thr=thr)
    return cnt, blocks, alive
