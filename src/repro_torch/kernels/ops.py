"""Public wrappers of the port's kernels (port of the matching functions
of ``repro.kernels.ops``).

Selection goes by the device of the tensors given:

* CPU tensors take the plain PyTorch versions in ``kernels.ref`` (the
  tests and ``device="cpu"`` runs);
* CUDA tensors launch the Hopper kernels (``kernels.bitmap_intersect``,
  ``kernels.bitmap_diff``, ``kernels.nlist_merge``, ``kernels.compact``,
  ``kernels.suffix_table``, ``kernels.flash_attention``,
  ``kernels.segment_embed``), or raise —
  nothing falls back.

``backend`` is kept for API parity with the JAX package: ``"auto"`` (the
default, the rule above) or ``"plain"``, which forces the plain version
on CUDA tensors so ``chip_smoke.py`` can hold a kernel against it.  The
mining path never passes ``"plain"``.

``screen_and_intersect`` / ``screen_and_diff`` are the bitmap hot paths:
one launch per pair chunk against the device-resident row store, which
they update **in place** (the JAX versions donate and return new
buffers; the port returns the same tensors).
:func:`make_screen_and_intersect_sharded` is their count-distribution
form over a ``(block, cls)`` mesh of processes, each holding a block
shard of the store.  ``nlist_presize`` +
``nlist_scatter`` are the PrePost+ hot path over the N-list pool, the
scatter again in place.  Index columns may be given as host numpy
arrays: :func:`upload_columns` moves them in one copy, from pinned
memory without blocking on CUDA.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor

from . import bitmap_diff as _bd
from . import bitmap_intersect as _bi
from . import compact as _compact
from . import flash_attention as _fa
from . import nlist_merge as _nl
from . import ref as _ref
from . import segment_embed as _se
from . import suffix_table as _st
from repro_torch.core.bitmap import popcount32, suffix_popcounts
from repro_torch.core.guards import host_sync

Tensor = torch.Tensor

_INT32_MIN = -(2 ** 31)
_INT32_MAX = 2 ** 31 - 1


_CARD_PATH = threading.local()


@contextlib.contextmanager
def card_path():
    """Inside, FAKE tensors take the kernels' route whatever their device:
    the custom ops' shape functions and FLOP formulas stand in for the
    kernels.  The dry-run traces the card's path this way on a fake
    world, whose DTensor shards live on the mesh's device type, the CPU
    (``launch.cells.trace_cell``).  Real tensors are unaffected."""
    prev = getattr(_CARD_PATH, "on", False)
    _CARD_PATH.on = True
    try:
        yield
    finally:
        _CARD_PATH.on = prev


def _use_kernel(t: Tensor, backend: str) -> bool:
    """True -> launch the CUDA kernel; False -> plain version."""
    if backend not in ("auto", "plain"):
        raise ValueError(f"unknown backend {backend!r}")
    if t.device.type == "cpu":
        return (backend == "auto" and getattr(_CARD_PATH, "on", False)
                and isinstance(t, FakeTensor))
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
                        *, mode: str = "and", thr: "Tensor | None" = None,
                        backend: str = "auto",
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Blocked early-stopping intersection (``ref.bitmap_intersect_es_ref``
    semantics) against ``minsup``, or against ``thr`` int32 (P,) per pair
    where given (``ref._blocked_es_scan``).  Returns ``(Z, counts,
    blocks_done, alive)``."""
    if _use_kernel(U, backend):
        return _bi.bitmap_intersect_es(U, V, suffix_u, suffix_v, rho_parent,
                                       int(minsup), mode=mode, thr=thr)
    if thr is not None:
        return _ref._blocked_es_scan(U, V, suffix_u, suffix_v, rho_parent,
                                     thr, mode=mode)
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


def bitmap_diff_es(U: Tensor, V: Tensor, suffix_u: Tensor,
                   rho_parent: Tensor, minsup: int, *,
                   thr: "Tensor | None" = None, backend: str = "auto",
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Blocked dEclat difference with zero-block skipping
    (``ref.bitmap_diff_es_ref`` semantics) against ``minsup``, or against
    ``thr`` int32 (P,) per pair where given.  Returns ``(Z, counts,
    blocks_done, alive)``."""
    if _use_kernel(U, backend):
        return _bd.bitmap_diff_es(U, V, suffix_u, rho_parent, int(minsup),
                                  thr=thr)
    if thr is not None:
        return _ref._blocked_diff_scan(U, V, suffix_u, rho_parent, thr)
    return _ref.bitmap_diff_es_ref(U, V, suffix_u, rho_parent, minsup)


def screen_and_diff(rows: Tensor, suffix: Tensor, ua, vb, slots,
                    rho_parent, minsup: int, *, early_stop: bool = True,
                    backend: str = "auto",
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Fused screen + blocked dEclat difference over a device row store
    (``ref.screen_and_diff_ref`` semantics, bit for bit): the diffset
    sibling of :func:`screen_and_intersect`, with the same signature and
    in-place slab update.  Gated on ``rho - count``; ``blocks_done``
    charges only nonzero-mass U blocks.  Fed tidset operands it writes
    the level-2 diffset ``T(a) & ~T(b)``.  Returns ``(rows, suffix,
    counts, blocks_done, alive)``."""
    dev = rows.device
    ua, vb, slots, rho = (_as_i32(x, dev) for x in (ua, vb, slots,
                                                     rho_parent))
    minsup = int(minsup)
    if _use_kernel(rows, backend):
        cnt, blocks, alive = _bd.screen_and_diff(
            rows, suffix, ua, vb, slots, rho, minsup,
            minsup if early_stop else 0)
        return rows, suffix, cnt, blocks, alive
    return _ref.screen_and_diff_ref(rows, suffix, ua, vb, slots, rho,
                                    minsup, early_stop=early_stop)


# ---------------------------------------------------------------------------
# The sharded fused dispatch (count distribution over a (block, cls) mesh)
# ---------------------------------------------------------------------------

class _Collectives:
    """The sharded dispatch's collectives.  Under gloo with CUDA tensors
    every collective is staged through the host — the vector is copied to
    the host, reduced or gathered there and copied back — always in that
    configuration, never as a recovery from an error.  Under NCCL (CUDA)
    and gloo (CPU) the tensors go to the collective as they are."""

    def __init__(self, device: torch.device, backend: str):
        self.staged = device.type == "cuda" and backend == "gloo"

    def all_reduce(self, t: Tensor, group) -> Tensor:
        """Sum ``t`` over ``group`` in place; returns ``t``."""
        if not self.staged:
            dist.all_reduce(t, group=group)
            return t
        # host-sync: gloo reduces on the host; one vector each way
        with host_sync("gloo collective staged through the host"):
            h = t.cpu()
            dist.all_reduce(h, group=group)
            t.copy_(h)
        return t

    def all_gather(self, t: Tensor, group, n: int) -> Tensor:
        """``(n,) + t.shape``: every rank's ``t``, in group-rank order."""
        if not self.staged:
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=group)
            return torch.stack(parts)
        # host-sync: gloo gathers on the host; one vector each way
        with host_sync("gloo collective staged through the host"):
            h = t.cpu()
            parts = [torch.empty_like(h) for _ in range(n)]
            dist.all_gather(parts, h, group=group)
            return torch.stack(parts).to(t.device)


class ShardedScreen:
    """The fused gather + screen + blocked ES + survivor scatter of one
    pair chunk over a ``(block, cls)`` mesh (port of the program
    ``repro.kernels.ops.make_screen_and_intersect_sharded`` builds),
    bit for bit against ``ref.screen_and_intersect_sharded_ref`` with
    ``n_shards`` = the mesh's block size and ``n_cls`` its cls size.

    Each rank holds its block shard of the store: ``rows`` (cap, nb_local,
    bw) and its local suffix tables ``suffix`` (cap, nb_local + 1)
    (``DeviceRowStore`` sharded mode); every rank of a block shard holds
    the same slab.  A call takes the chunk's full columns (the same on
    every rank), pads them to a multiple of the cls size with ``slot =
    cap``, and works on its cls rank's contiguous slice:

    1. mode "and" with ES: all-reduce ``m = min(sufU[0], sufV[0])`` over
       the block group and set ``thr = minsup - (sum m - m)``, the mass
       every other shard could still add; mode "andnot": ``thr = minsup``;
       ES off: INT32_MIN, which never kills;
    2. the scan kernel against ``thr`` (per pair), every slot set to
       ``cap``: counts, blocks and aliveness, no child;
    3. ``c0`` (block 0's popcount of Z) and the local screen bound; mode
       "and" clamps ``blocks`` to the shard's real blocks (the pad tail
       is discounted), mode "andnot" keeps the kernel's nonzero-mass
       counter; one all-reduce of ``(count, blocks, dead, bound)`` over
       the block group;
    4. with cls > 1, one all-gather of those vectors over the cls group:
       every rank then holds the whole chunk's;
    5. the global survivor mask (``ref._survivor_mask``), and a second
       launch over the whole chunk that writes the survivors' child rows
       and local suffix tables: threshold INT32_MIN for a survivor,
       INT32_MAX (dies in its first step) for the rest, non-survivors'
       slots set to ``cap``, gate INT32_MIN (the kernel's own gate tests
       the local support, which must not decide).  Every cls replica
       recomputes the same survivors from its copy, so the replicas stay
       equal without moving Z.

    On CPU tensors the plain scans (``ref._blocked_es_scan`` /
    ``_blocked_diff_scan``) and a plain scatter take the kernel's place;
    on CUDA tensors it launches the kernel or raises.  Returns ``(rows,
    suffix, bound, count, blocks, alive)``, the per-pair vectors global
    and of the unpadded chunk's length."""

    def __init__(self, mesh, *, mode: str = "and", early_stop: bool = True):
        _ref._check_mode(mode)
        if tuple(mesh.mesh_dim_names or ()) != ("block", "cls"):
            raise ValueError(f"the mesh's dimensions must be ('block', "
                             f"'cls'), got {mesh.mesh_dim_names}")
        self.mode = mode
        self.early_stop = early_stop
        self.n_shards = mesh.size(0)
        self.n_cls = mesh.size(1)
        self.shard = mesh.get_local_rank("block")
        self.cls_rank = mesh.get_local_rank("cls")
        self.block_group = mesh.get_group("block")
        self.cls_group = mesh.get_group("cls")
        self._dist_backend = dist.get_backend(self.block_group)

    def __call__(self, rows: Tensor, suffix: Tensor, ua, vb, slots,
                 rho_parent, minsup: int, n_real_blocks: Optional[int] = None,
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
        dev = rows.device
        cap, nbl, _ = rows.shape
        kernel = _use_kernel(rows, "auto")
        coll = _Collectives(dev, self._dist_backend)
        andnot = self.mode == "andnot"
        minsup = int(minsup)
        ua, vb, slots, rho = (_as_i32(x, dev) for x in (ua, vb, slots,
                                                         rho_parent))
        n = int(ua.shape[0])
        pad = -n % self.n_cls
        if pad:                 # pad pairs read row 0 and write nothing
            zero = torch.zeros(pad, dtype=torch.int32, device=dev)
            ua, vb, rho = (torch.cat([x, zero]) for x in (ua, vb, rho))
            slots = torch.cat([slots, torch.full_like(zero, cap)])
        k = (n + pad) // self.n_cls
        lo = self.cls_rank * k
        ua_s, vb_s, rho_s = (x[lo:lo + k].contiguous()
                             for x in (ua, vb, rho))
        su = suffix.index_select(0, ua_s)
        sv = suffix.index_select(0, vb_s)

        # 1. the per-pair threshold
        thr, es_minsup = None, _INT32_MIN
        if self.early_stop and andnot:
            es_minsup = minsup
        elif self.early_stop:
            m = torch.minimum(su[:, 0], sv[:, 0])
            total = coll.all_reduce(m.clone(), self.block_group)
            thr = (minsup - (total - m)).to(torch.int32)
        # 2. the scan: counts, blocks, aliveness; no child
        cnt, blocks, alive = self._scan(rows, suffix, ua_s, vb_s, rho_s,
                                        thr, es_minsup, minsup, kernel)
        # 3. the screen bound from block 0, and the fused all-reduce
        u0 = rows.index_select(0, ua_s)[:, 0]
        v0 = rows.index_select(0, vb_s)[:, 0]
        c0 = popcount32(u0 & (~v0 if andnot else v0)).sum(dim=-1)
        if andnot:
            bound = c0
        else:
            bound = c0 + torch.minimum(su[:, 1], sv[:, 1])
            n_real = (self.n_shards * nbl if n_real_blocks is None
                      else int(n_real_blocks))
            real_local = min(max(n_real - self.shard * nbl, 0), nbl)
            blocks = blocks.clamp(max=real_local)
        vec = torch.stack([cnt, blocks, (~alive).to(torch.int32),
                           bound.to(torch.int32)])
        coll.all_reduce(vec, self.block_group)
        # 4. the whole chunk's vectors on every rank
        if self.n_cls > 1:
            vec = coll.all_gather(vec, self.cls_group, self.n_cls)
            vec = vec.permute(1, 0, 2).reshape(4, self.n_cls * k)
        count, blocks, dead, bound = vec.unbind(0)
        if andnot:
            bound = rho - bound
        alive = dead == 0
        # 5. survivors only: the second launch writes their children
        keep = (_ref._survivor_mask(count, alive, rho, minsup,
                                    mode=self.mode)
                & (slots >= 0) & (slots < cap))
        self._scatter(rows, suffix, ua, vb, slots, rho, keep, kernel)
        return (rows, suffix, bound[:n].contiguous(), count[:n].contiguous(),
                blocks[:n].contiguous(), alive[:n].contiguous())

    def _scan(self, rows, suffix, ua, vb, rho, thr, es_minsup, minsup,
              kernel) -> Tuple[Tensor, Tensor, Tensor]:
        if kernel:
            nowhere = torch.full_like(ua, rows.shape[0])
            if self.mode == "andnot":
                return _bd.screen_and_diff(rows, suffix, ua, vb, nowhere, rho,
                                           minsup, es_minsup, thr=thr)
            return _bi.screen_and_intersect(rows, suffix, ua, vb, nowhere,
                                            rho, minsup, es_minsup,
                                            mode="and", thr=thr)
        if thr is None:
            thr = torch.full_like(ua, es_minsup)
        U, V = rows.index_select(0, ua), rows.index_select(0, vb)
        su = suffix.index_select(0, ua)
        if self.mode == "andnot":
            _, cnt, blocks, alive = _ref._blocked_diff_scan(U, V, su, rho, thr)
        else:
            _, cnt, blocks, alive = _ref._blocked_es_scan(
                U, V, su, suffix.index_select(0, vb), rho, thr, mode="and")
        return cnt, blocks, alive

    def _scatter(self, rows, suffix, ua, vb, slots, rho, keep,
                 kernel) -> None:
        if kernel:
            thr = torch.where(keep, _INT32_MIN, _INT32_MAX).to(torch.int32)
            dst = torch.where(keep, slots, rows.shape[0]).to(torch.int32)
            if self.mode == "andnot":
                _bd.screen_and_diff(rows, suffix, ua, vb, dst, rho,
                                    _INT32_MIN, _INT32_MIN, thr=thr)
            else:
                _bi.screen_and_intersect(rows, suffix, ua, vb, dst, rho,
                                         _INT32_MIN, _INT32_MIN, mode="and",
                                         thr=thr)
            return
        U, V = rows[ua[keep].long()], rows[vb[keep].long()]
        Z = U & (~V if self.mode == "andnot" else V)
        dst = slots[keep].long()
        rows[dst] = Z
        suffix[dst] = suffix_popcounts(Z)


def make_screen_and_intersect_sharded(mesh, *, mode: str = "and",
                                      early_stop: bool = True,
                                      ) -> ShardedScreen:
    """The sharded fused dispatch over ``mesh`` (a ``(block, cls)``
    ``DeviceMesh``, ``launch.mesh.make_mining_mesh``); see
    :class:`ShardedScreen`."""
    return ShardedScreen(mesh, mode=mode, early_stop=early_stop)


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


def suffix_tables(rows: Tensor, suffix: Tensor, n: int, *,
                  backend: str = "auto") -> Tensor:
    """Fill ``suffix[:n]`` in place with the suffix popcount tables of
    ``rows[:n]`` (``core.bitmap.suffix_popcounts``); the row store's
    level-1 tables.  Rows past ``n`` are not touched.  Returns
    ``suffix``."""
    if _use_kernel(rows, backend):
        return _st.suffix_table(rows, suffix, n)
    suffix[:n] = suffix_popcounts(rows[:n])
    return suffix


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


def compact_codes(codes: Tensor, perm, *, backend: str = "auto") -> Tensor:
    """N-list pool compaction: the compaction gather on the ``(cap, 3)``
    code slab (``ref.compact_gather_ref``)."""
    perm = _as_i32(perm, codes.device)
    if _use_kernel(codes, backend):
        return _compact.compact_gather(codes, perm)
    return _ref.compact_gather_ref(codes, perm)


# ---------------------------------------------------------------------------
# N-list (PrePost+) dispatches
# ---------------------------------------------------------------------------

def nlist_intersect(u_pre: Tensor, u_post: Tensor, u_freq: Tensor,
                    v_pre: Tensor, v_post: Tensor, v_freq: Tensor, u_len,
                    v_len, rho_v, minsup: int, *, early_stop: bool = True,
                    backend: str = "auto",
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Padded-batch N-list merge (``ref.nlist_intersect_ref``), the
    kernel micro-bench entry: ``(out_slot, support, comparisons, checks,
    alive)``.  On CUDA the padded rows are laid out as one code slab
    (U rows, then V rows) and the merge kernel walks it."""
    dev = u_pre.device
    u_len, v_len, rho = (_as_i32(x, dev) for x in (u_len, v_len, rho_v))
    if _use_kernel(u_pre, backend):
        P, lu = u_pre.shape
        lv = v_pre.shape[1]
        codes = torch.cat([
            torch.stack([u_pre, u_post, u_freq], dim=-1).reshape(-1, 3),
            torch.stack([v_pre, v_post, v_freq], dim=-1).reshape(-1, 3),
        ]).to(torch.int32).contiguous()
        step = torch.arange(P, dtype=torch.int32, device=dev)
        out_slot, _, support, cmps, checks, alive = _nl.nlist_merge(
            codes, step * lu, u_len, P * lu + step * lv, v_len, rho,
            int(minsup), lu=lu, early_stop=early_stop)
        return out_slot, support, cmps, checks, alive
    return _ref.nlist_intersect_ref(u_pre, u_post, u_freq, v_pre, v_post,
                                    v_freq, u_len, v_len, rho, minsup,
                                    early_stop=early_stop)


def nlist_presize(codes: Tensor, u_off, u_len, v_off, v_len, rho_v,
                  minsup: int, *, lu: int, lv: int, early_stop: bool = True,
                  backend: str = "auto",
                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                             Tensor]:
    """Merge-only pre-pass of the PrePost+ extension
    (``ref.nlist_presize_ref`` semantics, bit for bit): both operands
    are read from the pool slab by extent offset and merged with the
    ``z_mass + (rho_V - skip)`` ES guard, and each pair's Z-merge group
    count is its exact child length.  ``lu`` is the match table's width
    (``lv`` only sizes the plain version's gather).  Returns
    ``(out_slot, child_len, support, comparisons, checks, alive)``."""
    dev = codes.device
    u_off, u_len, v_off, v_len, rho = (
        _as_i32(x, dev) for x in (u_off, u_len, v_off, v_len, rho_v))
    if _use_kernel(codes, backend):
        return _nl.nlist_merge(codes, u_off, u_len, v_off, v_len, rho,
                               int(minsup), lu=lu, early_stop=early_stop)
    return _ref.nlist_presize_ref(codes, u_off, u_len, v_off, v_len, rho,
                                  minsup, lu=lu, lv=lv,
                                  early_stop=early_stop)


def nlist_scatter(codes: Tensor, out_slot: Tensor, u_off, u_len, v_off,
                  v_len, out_off, *, lu: int, lv: int, backend: str = "auto",
                  ) -> Tuple[Tensor, Tensor]:
    """Scatter pass of the PrePost+ extension (``ref.nlist_scatter_ref``
    semantics): Z-merge the pre-pass match table and write the child
    N-lists into the pool at ``out_off``, **in place**; ``out_off >=
    capacity`` marks a pair to skip.  Returns ``(codes, child_len)``."""
    dev = codes.device
    u_off, u_len, v_off, v_len, out_off = (
        _as_i32(x, dev) for x in (u_off, u_len, v_off, v_len, out_off))
    if _use_kernel(codes, backend):
        child_len = _nl.zmerge_scatter(codes, out_slot, u_off, u_len, v_off,
                                       v_len, out_off)
        return codes, child_len
    return _ref.nlist_scatter_ref(codes, out_slot, u_off, u_len, v_off,
                                  v_len, out_off, lu=lu, lv=lv)


def nlist_extend(codes: Tensor, u_off, u_len, v_off, v_len, out_off, rho_v,
                 minsup: int, *, lu: int, lv: int, early_stop: bool = True,
                 backend: str = "auto",
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                            Tensor]:
    """One-call PrePost+ extension (``ref.nlist_extend_ref`` semantics):
    merge, then Z-merge + scatter of the pairs whose support clears
    minsup, in place.  On CUDA: the merge kernel, a device-side gate on
    ``out_off`` and the scatter kernel.  Returns ``(codes, child_len,
    support, comparisons, checks, alive)``."""
    dev = codes.device
    u_off, u_len, v_off, v_len, out_off, rho = (
        _as_i32(x, dev) for x in (u_off, u_len, v_off, v_len, out_off,
                                  rho_v))
    if _use_kernel(codes, backend):
        out_slot, child_len, support, cmps, checks, alive = _nl.nlist_merge(
            codes, u_off, u_len, v_off, v_len, rho, int(minsup), lu=lu,
            early_stop=early_stop)
        gated = torch.where(support >= int(minsup), out_off,
                            int(codes.shape[0])).to(torch.int32)
        _nl.zmerge_scatter(codes, out_slot, u_off, u_len, v_off, v_len,
                           gated)
        return codes, child_len, support, cmps, checks, alive
    return _ref.nlist_extend_ref(codes, u_off, u_len, v_off, v_len, out_off,
                                 rho, minsup, lu=lu, lv=lv,
                                 early_stop=early_stop)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0, softmax_scale=None,
                    backend: str = "auto") -> Tensor:
    """Fused causal GQA attention (``ref.flash_attention_ref`` semantics):
    q ``(B, Sq, H, D)``, k ``(B, Skv, KH, D)``, v ``(B, Skv, KH, Dv)`` ->
    ``(B, Sq, H, Dv)`` in q's type; ``window`` > 0 adds the sliding-window
    mask (query ``i`` sees keys ``i - window < j <= i``).  On CUDA the
    call is the custom op ``repro::flash_attention`` (the kernel; fake
    tensors take its shape function)."""
    if _use_kernel(q, backend):
        return _fa.flash_attention_op(q, k, v, causal, window,
                                      softmax_scale)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    softmax_scale=softmax_scale)


def embedding_bag(table: Tensor, ids: Tensor, mask: Tensor, *,
                  combiner: str = "mean", backend: str = "auto") -> Tensor:
    """Fused EmbeddingBag (``ref.embedding_bag_ref`` semantics): masked
    sum or mean of table rows per bag, ``(B, L)`` -> ``(B, D)``.  On CUDA
    with a table that requires grad (training) the kernel runs under
    ``segment_embed.EmbeddingBagFn``; otherwise the call is the kernel
    alone (serving); both go through the custom op ``repro::embedding_bag``
    (the kernel; fake tensors take its shape function).  The plain
    version is differentiable as it stands."""
    if _use_kernel(table, backend):
        if torch.is_grad_enabled() and table.requires_grad:
            return _se.EmbeddingBagFn.apply(table, ids, mask, combiner)
        return _se.embedding_bag_op(table, ids, mask, combiner)
    return _ref.embedding_bag_ref(table, ids, mask, combiner=combiner)
