"""Wrappers of the Hopper dEclat difference kernel (``csrc/bitmap_diff.cu``).

Counterpart of ``repro.kernels.bitmap_diff.bitmap_diff_es`` (the Pallas
TPU kernel) and of the gather/scatter that
``repro.kernels.ops._screen_and_diff_impl`` fuses around it.  One CUDA
kernel serves both entries here:

* :func:`screen_and_diff` — the diffset hot path: operands and the U
  suffix table are read straight from the row-store slab by index, and
  survivors' child rows and suffix tables are written into it (in
  place), all in one launch;
* :func:`bitmap_diff_es` — the standalone scan over materialised operand
  batches, returning Z.

``suffix_u`` must be the suffix table of ``U`` (as it always is on the
mining path): the kernel reads and counts only blocks whose U mass is
positive.  CUDA int32 tensors only; the plain versions for CPU tensors
live in ``kernels.ref`` and are chosen by ``kernels.ops``.  Each launch
adds one to ``bitmap_diff_es.launches``; launches are on
``torch.cuda.current_stream()`` and never synchronise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .bitmap_intersect import _check, _outputs

Tensor = torch.Tensor


def _launch(U, V, su, ua, vb, rho, *, es_minsup: int, Z, cnt, blocks,
            alive, child_rows, child_suffix, slots, gate_minsup: int,
            thr=None) -> None:
    n_pairs = int(rho.shape[0])
    if n_pairs == 0:
        return
    _, nb, bw = U.shape
    cap = int(child_rows.shape[0]) if child_rows is not None else 0
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _build.load().repro_diff_scan(
        ptr(U), ptr(V), ptr(su), ptr(ua), ptr(vb), ptr(rho), n_pairs,
        int(nb), int(bw), int(es_minsup), ptr(thr), ptr(Z), ptr(cnt),
        ptr(blocks),
        ptr(alive), ptr(child_rows), ptr(child_suffix), ptr(slots), cap,
        int(gate_minsup), torch.cuda.current_stream(U.device).cuda_stream)
    _build.check(err, "bitmap_diff_es")
    bitmap_diff_es.launches += 1


def bitmap_diff_es(U: Tensor, V: Tensor, suffix_u: Tensor,
                   rho_parent: Tensor, minsup: int, *,
                   thr: "Tensor | None" = None,
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Standalone blocked difference ``Z = U & ~V`` over ``U``/``V`` int32
    (P, nb, bw) on the bound ``rho - count``, against ``minsup`` or, where
    given, ``thr`` int32 (P,) per pair.  Returns ``(Z, counts,
    blocks_done, alive)``."""
    P, nb, bw = U.shape
    _check(U, "U")
    _check(V, "V", (P, nb, bw))
    _check(suffix_u, "suffix_u", (P, nb + 1))
    _check(rho_parent, "rho_parent", (P,))
    if thr is not None:
        _check(thr, "thr", (P,))
    Z = torch.empty_like(U)
    cnt, blocks, alive = _outputs(P, U.device)
    _launch(U, V, suffix_u, None, None, rho_parent, es_minsup=minsup, Z=Z,
            cnt=cnt, blocks=blocks, alive=alive, child_rows=None,
            child_suffix=None, slots=None, gate_minsup=0, thr=thr)
    return Z, cnt, blocks, alive


bitmap_diff_es.launches = 0


def screen_and_diff(rows: Tensor, suffix: Tensor, ua: Tensor, vb: Tensor,
                    slots: Tensor, rho_parent: Tensor, minsup: int,
                    es_minsup: int, *, thr: "Tensor | None" = None,
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused gather + blocked difference + survivor-only scatter over the
    row store.  ``rows`` int32 (cap, nb, bw) and ``suffix`` int32 (cap,
    nb+1) are updated **in place**; a child is written at ``slots[i]``
    iff pair ``i`` finished alive, ``rho - count`` clears ``minsup`` and
    ``0 <= slots[i] < cap``.  ``es_minsup`` is the abort threshold (0 =
    ES off), or ``thr`` int32 (P,) per pair where given.  Returns
    ``(counts, blocks_done, alive)``."""
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
    _launch(rows, rows, suffix, ua, vb, rho_parent, es_minsup=es_minsup,
            Z=None, cnt=cnt, blocks=blocks, alive=alive, child_rows=rows,
            child_suffix=suffix, slots=slots, gate_minsup=minsup, thr=thr)
    return cnt, blocks, alive
