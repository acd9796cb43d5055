"""Public wrappers of the main path's kernels (port of the matching
functions of ``repro.kernels.ops``).

Selection goes by the device of the tensors given:

* CPU tensors take the plain PyTorch versions in ``kernels.ref`` (the
  tests and ``device="cpu"`` runs);
* CUDA tensors launch the Hopper kernels (``kernels.bitmap_intersect``,
  ``kernels.compact``), or raise — nothing falls back.

``backend`` is kept for API parity with the JAX package: ``"auto"`` (the
default, the rule above) or ``"plain"``, which forces the plain version
on CUDA tensors so ``chip_smoke.py`` can hold a kernel against it.  The
mining path never passes ``"plain"``.

``screen_and_intersect`` is the mining hot path: one launch per pair
chunk against the device-resident row store, which it updates **in
place** (the JAX version donates and returns new buffers; the port
returns the same tensors).  Index columns may be given as host numpy
arrays: :func:`upload_columns` moves them in one copy, from pinned
memory without blocking on CUDA.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import bitmap_intersect as _bi
from . import compact as _compact
from . import ref as _ref

Tensor = torch.Tensor

_INT32_MIN = -(2 ** 31)


def _use_kernel(t: Tensor, backend: str) -> bool:
    """True -> launch the CUDA kernel; False -> plain version."""
    if backend not in ("auto", "plain"):
        raise ValueError(f"unknown backend {backend!r}")
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return backend == "auto"


def upload_columns(device: torch.device, cols: Sequence[np.ndarray],
                   ) -> Tuple[Tensor, List[Tensor]]:
    """Stack equal-length host int32 columns into one ``(k, n)`` tensor on
    ``device`` with a single copy.  For CUDA the host side is a fresh
    pinned buffer and the copy does not block (no host sync).  Returns
    ``(host_buffer, per-column device views)``; callers that launch work
    on the views keep ``host_buffer`` alive until that work retires."""
    device = torch.device(device)
    n = int(len(cols[0])) if cols else 0
    host = torch.empty((len(cols), n), dtype=torch.int32,
                       pin_memory=device.type == "cuda")
    hn = host.numpy()
    for i, c in enumerate(cols):
        hn[i] = c
    dev = host.to(device, non_blocking=True)
    return host, [dev[i] for i in range(len(cols))]


def _as_i32(x, device: torch.device) -> Tensor:
    if isinstance(x, Tensor):
        if x.device != device or x.dtype != torch.int32:
            raise ValueError(f"expected an int32 tensor on {device}, got "
                             f"{x.dtype} on {x.device}")
        return x.contiguous()
    return upload_columns(device, [np.asarray(x, np.int32).reshape(-1)])[1][0]


def bitmap_intersect_es(U: Tensor, V: Tensor, suffix_u: Tensor,
                        suffix_v: Tensor, rho_parent: Tensor, minsup: int,
                        *, mode: str = "and", backend: str = "auto",
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Blocked early-stopping intersection (``ref.bitmap_intersect_es_ref``
    semantics).  Returns ``(Z, counts, blocks_done, alive)``."""
    if _use_kernel(U, backend):
        return _bi.bitmap_intersect_es(U, V, suffix_u, suffix_v, rho_parent,
                                       int(minsup), mode=mode)
    return _ref.bitmap_intersect_es_ref(U, V, suffix_u, suffix_v,
                                        rho_parent, minsup, mode=mode)


def screen_and_intersect(rows: Tensor, suffix: Tensor, ua, vb, slots,
                         rho_parent, minsup: int, *, mode: str = "and",
                         early_stop: bool = True, backend: str = "auto",
                         ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Fused screen + blocked ES intersection over a device row store
    (``ref.screen_and_intersect_ref`` semantics, bit for bit).

    One launch per pair chunk: operands are read from ``rows``/``suffix``
    by index, and a child row plus its suffix table is written at
    ``slots[i]`` only for survivors — pairs that finished alive with
    support >= ``minsup`` — whose slot lies in ``[0, capacity)``.
    ``early_stop=False`` disables the in-scan abort, not the gate.
    ``rows``/``suffix`` are updated in place and returned with
    ``(counts, blocks_done, alive)``."""
    dev = rows.device
    ua, vb, slots, rho = (_as_i32(x, dev) for x in (ua, vb, slots,
                                                     rho_parent))
    minsup = int(minsup)
    if _use_kernel(rows, backend):
        cnt, blocks, alive = _bi.screen_and_intersect(
            rows, suffix, ua, vb, slots, rho, minsup,
            minsup if early_stop else 0, mode=mode)
        return rows, suffix, cnt, blocks, alive
    return _ref.screen_and_intersect_ref(rows, suffix, ua, vb, slots, rho,
                                         minsup, mode=mode,
                                         early_stop=early_stop)


def compact_rows(rows: Tensor, suffix: Tensor, perm, *,
                 backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """Row-store compaction: gather live rows + suffix tables to the
    front of a fresh slab (``ref.compact_gather_ref`` on each).  ``perm
    int32 (new_capacity,)`` maps destination to source slots; entries
    outside ``[0, capacity)`` come up zeroed."""
    perm = _as_i32(perm, rows.device)
    if _use_kernel(rows, backend):
        return (_compact.compact_gather(rows, perm),
                _compact.compact_gather(suffix, perm))
    return (_ref.compact_gather_ref(rows, perm),
            _ref.compact_gather_ref(suffix, perm))


def _zero_scan_inputs(U: Tensor) -> Tuple[Tensor, Tensor]:
    P, nb, _ = U.shape
    return (torch.zeros((P, nb + 1), dtype=torch.int32, device=U.device),
            torch.zeros(P, dtype=torch.int32, device=U.device))


def bitmap_intersect_full(U: Tensor, V: Tensor, *, mode: str = "and",
                          backend: str = "auto") -> Tuple[Tensor, Tensor]:
    """Full intersection ``(Z, counts)`` without block metrics
    (``ref.bitmap_intersect_full_ref``).  On CUDA: the ES kernel with a
    threshold no bound can miss, so every block is scanned."""
    if _use_kernel(U, backend):
        zeros, rho = _zero_scan_inputs(U)
        Z, cnt, _, _ = _bi.bitmap_intersect_es(U, V, zeros, zeros, rho,
                                               _INT32_MIN, mode=mode)
        return Z, cnt
    return _ref.bitmap_intersect_full_ref(U, V, mode=mode)


def bitmap_count(U: Tensor, V: Tensor, *, backend: str = "auto") -> Tensor:
    """Support counting without ES and without materialising Z
    (``ref.bitmap_count_ref``).  On CUDA: the ES kernel, no Z output."""
    if _use_kernel(U, backend):
        zeros, rho = _zero_scan_inputs(U)
        _, cnt, _, _ = _bi.bitmap_intersect_es(U, V, zeros, zeros, rho, 0,
                                               mode="and", write_z=False)
        return cnt
    return _ref.bitmap_count_ref(U, V)


def screen_pairs(first_u: Tensor, first_v: Tensor, suffix1_u: Tensor,
                 suffix1_v: Tensor, rho_parent: Tensor, minsup: int, *,
                 mode: str = "and", backend: str = "auto",
                 ) -> Tuple[Tensor, Tensor]:
    """One-block screening bound (``ref.screen_pairs_ref``).  On CUDA: the
    ES kernel over the single block, then the bound from its count."""
    if _use_kernel(first_u, backend):
        P = first_u.shape[0]
        zero = torch.zeros((P, 1), dtype=torch.int32, device=first_u.device)
        su = torch.cat([zero, suffix1_u.to(torch.int32)[:, None]], dim=1)
        sv = torch.cat([zero, suffix1_v.to(torch.int32)[:, None]], dim=1)
        _, c0, _, _ = _bi.bitmap_intersect_es(
            first_u[:, None, :].contiguous(), first_v[:, None, :].contiguous(),
            su, sv, rho_parent.to(torch.int32).contiguous(), _INT32_MIN,
            mode=mode, write_z=False)
        if mode == "and":
            bound = c0 + torch.minimum(su[:, 1], sv[:, 1])
        else:
            bound = rho_parent.to(torch.int32) - c0
        return bound, bound >= int(minsup)
    return _ref.screen_pairs_ref(first_u, first_v, suffix1_u, suffix1_v,
                                 rho_parent, minsup, mode=mode)
