"""Sharded mining: count distribution over the TID block axis (port of
``repro.core.distributed.DistributedMiner``).

Each process of a ``(block, cls)`` mesh (``launch.mesh.make_mining_mesh``)
holds one block shard of the row store; the candidate pairs go to every
process, and each cls replica evaluates its contiguous slice of every
chunk.  Per chunk, one sharded dispatch (``kernels.ops.ShardedScreen``):
the partial counts of every block shard are all-reduced over the block
group, so the transaction data never moves; only per-pair int32 vectors
cross processes.

The paper's early stop applies twice.  Between dispatches it is the
two-level screen: each shard refines the bound with its own block 0, and
the sum of the per-shard bounds is tighter than the centralised one.
Inside a dispatch each shard walks its blocks against ``minsup - slack``,
slack being the mass every other shard could still add, and aborts the
moment the pair is globally infrequent.  Survivors only are written.

The host DFS, drain groups, free list, compaction schedule and
representation policy are ``BitmapMiner``'s; this class swaps in the
sharded store (``_make_store``), the autotune budget per process
(``_autotune_words_per_pair``) and the dispatch (``_dispatch_launch`` /
``_dispatch_resolve``).  Every process reads the same all-reduced
vectors, so every host DFS and free list move in lockstep, and that keeps
the collectives matched.

Counters follow the JAX engine's: ``word_ops`` counts the real (unpadded)
blocks scanned on every shard; ``screened_out`` are the pairs whose
two-level bound misses minsup, ``kernel_aborts`` the pairs the screen
passed and some shard's scan killed.

``make_mining_round`` / ``make_mining_round_v2`` are the standalone round
programs of the dry-run / roofline harness (``launch.cells``): one screen
+ count over a block-sharded store, plain torch ops as the JAX rounds are
plain ``jnp``, ending in one all-reduce of two int32 vectors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

import torch.distributed as dist
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor

from repro_torch.core.bitmap import (BitmapDB, DEFAULT_BLOCK_WORDS,
                                     popcount32, suffix_popcounts)
from repro_torch.core.eclat import BitmapMiner
from repro_torch.core.guards import host_sync
from repro_torch.core.rowstore import DeviceRowStore
from repro_torch.device import DeviceLike
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# Standalone round programs (dry-run / roofline harness)
# ---------------------------------------------------------------------------

def _local_suffix(bitmaps: torch.Tensor) -> torch.Tensor:
    """Suffix popcounts over the LOCAL block shard: (rows, nb_local+1)
    int32."""
    return suffix_popcounts(bitmaps)


def _local(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a ``DTensor``; a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _round_group(mesh):
    """The process group spanning every rank of ``mesh`` (``None`` on one
    rank: no collective)."""
    if mesh.size() == 1:
        return None
    if mesh.ndim == 1:
        return mesh.get_group()
    if dist.is_initialized() and mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    return mesh._flatten().get_group()


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over every rank of the mesh (the JAX ``psum`` over all axes):
    one all-reduce, skipped on one rank."""
    if group is None:
        return x
    return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))


def _chunks(pairs: torch.Tensor, pair_chunk: int):
    n = pairs.shape[0]
    chunk = min(pair_chunk, n)
    if n % chunk:
        raise ValueError(f"{n} pairs do not split into chunks of {chunk}")
    return n, chunk


def make_mining_round(mesh, *, pair_chunk: int = 2048):
    """Fused screen+count round used by the dry-run/roofline harness.

    Pure Count Distribution (Agrawal & Shafer '96 adapted to Eclat): the
    bitmap store's BLOCK axis is sharded across EVERY mesh dimension; the
    candidate pair list is replicated; each rank computes partial
    popcounts and local suffix screen bounds on its block shard, and one
    all-reduce of two int32[n_pairs] vectors gives the global bounds and
    counts.  The transaction data never moves.

    Returns ``round(store, pairs, rho) -> (bound, count)`` over the rank's
    block shard ``store (rows, nb_local, bw)`` int32 (unsigned bits; a
    ``DTensor`` gives its local shard).  Pairs are walked in
    ``pair_chunk`` slices, as the JAX ``lax.scan`` walks them: a Python
    loop whose two gather buffers are allocated once and reused."""
    group = _round_group(mesh)

    def mining_round(store, pairs, rho):
        del rho
        store, pairs = _local(store), _local(pairs)
        n, chunk = _chunks(pairs, pair_chunk)
        dev = store.device
        bound = torch.empty(n, dtype=torch.int32, device=dev)
        count = torch.empty(n, dtype=torch.int32, device=dev)
        u = store.new_empty((chunk,) + tuple(store.shape[1:]))
        v = store.new_empty((chunk,) + tuple(store.shape[1:]))
        for c0 in range(0, n, chunk):
            p = pairs[c0:c0 + chunk].to(torch.int64)
            torch.index_select(store, 0, p[:, 0], out=u)
            torch.index_select(store, 0, p[:, 1], out=v)
            c_0 = popcount32(u[:, 0] & v[:, 0]).sum(dim=-1)
            su = _local_suffix(u)[:, 1]
            sv = _local_suffix(v)[:, 1]
            bound[c0:c0 + chunk] = c_0 + torch.minimum(su, sv)
            count[c0:c0 + chunk] = popcount32(u & v).sum(dim=(-1, -2))
        return _psum(bound, group), _psum(count, group)

    return mining_round


def make_mining_round_v2(mesh, *, pair_chunk: int = 2048):
    """Optimised mining round (the hillclimb variant).

    Two changes over ``make_mining_round``, both beyond-paper engineering
    on top of the paper's criterion:

      1. PRECOMPUTED shard-local suffix masses: the baseline recomputes
         each operand's suffix popcounts from its full gathered row (per
         pair).  The mass "popcount of blocks 1.. on shard s" is a
         per-(row, shard) invariant maintained when rows materialise, so
         the round takes it as ``suffix1 (rows, n_shards)`` (each rank
         owns its column) and the screen touches only block 0 + one
         scalar per operand.
      2. SHARED-``a`` chunking: the host batches sibling pairs of one
         class member 'a'; with ``pairs[c, :, 0]`` constant per chunk the
         u-row is gathered ONCE per chunk instead of per pair.

    Returns ``round(store, suffix1, pairs, rho) -> (bound, count)`` over
    the rank's shards (``suffix1``'s local column is ``(rows, 1)``)."""
    group = _round_group(mesh)

    def mining_round(store, suffix1, pairs, rho):
        del rho
        store, suffix1 = _local(store), _local(suffix1)
        pairs = _local(pairs)
        n, chunk = _chunks(pairs, pair_chunk)
        dev = store.device
        bound = torch.empty(n, dtype=torch.int32, device=dev)
        count = torch.empty(n, dtype=torch.int32, device=dev)
        v = store.new_empty((chunk,) + tuple(store.shape[1:]))
        for c0 in range(0, n, chunk):
            p = pairs[c0:c0 + chunk].to(torch.int64)
            a_row = p[:1, 0]                     # shared-'a' chunk
            u = store.index_select(0, a_row)     # (1, nb_local, bw)
            su = suffix1.index_select(0, a_row)[:, 0]
            torch.index_select(store, 0, p[:, 1], out=v)
            sv = suffix1.index_select(0, p[:, 1])[:, 0]
            c_0 = popcount32(u[:, 0] & v[:, 0]).sum(dim=-1)
            bound[c0:c0 + chunk] = c_0 + torch.minimum(su, sv)
            count[c0:c0 + chunk] = popcount32(u & v).sum(dim=(-1, -2))
        return _psum(bound, group), _psum(count, group)

    return mining_round


class DistributedMiner(BitmapMiner):
    """Count-distribution Eclat / dEclat / adaptive over ``mesh``, a
    ``(block, cls)`` ``DeviceMesh`` of the initialised world.

    Every process of the mesh constructs one with the same arguments and
    mines the same database; each returns the whole itemset map and the
    same counters.  ``device`` is where this process's shard lives
    (``None``: CUDA).  ``capacity`` is an initial-size hint (the slab
    grows); the other knobs are ``BitmapMiner``'s, with the JAX engine's
    defaults (``pair_chunk=4096``)."""

    def __init__(self, mesh, *, scheme: str = "eclat",
                 early_stop: bool = True, capacity: int = 4096,
                 pair_chunk: int = 4096,
                 block_words: int = DEFAULT_BLOCK_WORDS,
                 compact_occupancy: float = 0.25,
                 diff_density: "float | None" = None,
                 diff_hysteresis: float = 0.05, inflight: int = 2,
                 autotune_chunk: bool = False, device: DeviceLike = None):
        super().__init__(scheme=scheme, early_stop=early_stop,
                         block_words=block_words, pair_chunk=pair_chunk,
                         compact_occupancy=compact_occupancy,
                         diff_density=diff_density,
                         diff_hysteresis=diff_hysteresis, inflight=inflight,
                         autotune_chunk=autotune_chunk, device=device)
        self._fused = ops.make_screen_and_intersect_sharded(
            mesh, mode="and", early_stop=early_stop)
        self._fused_diff = ops.make_screen_and_intersect_sharded(
            mesh, mode="andnot", early_stop=early_stop)
        self.n_shards = self._fused.n_shards
        self.n_cls = self._fused.n_cls
        self.shard = self._fused.shard
        # Chunks are cut in multiples of the cls size so each replica's
        # slice is an equal contiguous run (core.frontier reads this).
        self.chunk_quantum = self.n_cls
        self.capacity = capacity

    def _autotune_words_per_pair(self, bdb: BitmapDB) -> int:
        # A cls replica scans 1/n_cls of each chunk: ceil, so the width
        # never overshoots the per-process budget.
        return -(-(bdb.n_blocks * self.block_words) // self.n_cls)

    def _make_store(self, bdb: BitmapDB) -> DeviceRowStore:
        return DeviceRowStore(
            bdb.bitmaps,
            capacity=max(self.capacity,
                         bdb.n_items + min(self.pair_chunk, 4096)),
            device=self.device, n_shards=self.n_shards, shard=self.shard)

    def _dispatch_launch(self, store: DeviceRowStore, ua: np.ndarray,
                         vb: np.ndarray, slots: np.ndarray, rho: np.ndarray,
                         mode: str) -> Tuple[Tuple, torch.Tensor]:
        """Upload the chunk's columns and run one sharded dispatch ("and":
        tidset intersect, "diff": diffset difference).  Returns the global
        per-pair vectors ``(bound, count, blocks, alive)``, unread, and the
        host buffer to keep alive until they are read."""
        host, cols = ops.upload_columns(store.device, [ua, vb, slots, rho])
        fused = self._fused if mode == "and" else self._fused_diff
        _, _, bound, count, blocks, alive = fused(
            store.rows, store.suffix, *cols, self._minsup, self._n_blocks)
        self._stats.device_calls += 1
        return (bound, count, blocks, alive), host

    def _dispatch_resolve(self, raw: Tuple) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking readback of one sharded dispatch + attribution: the
        screen claims the pairs its two-level bound kills; pairs it passed
        and a shard's scan killed are kernel aborts."""
        stats = self._stats
        packed = torch.stack([t.to(torch.int32) for t in raw])
        # host-sync: the group-retirement readback, once per dispatch
        with host_sync("group-retirement accounting readback"):
            packed = packed.cpu().numpy()
        bound, count, blocks = packed[0], packed[1], packed[2]
        scan_alive = packed[3].astype(bool)
        stats.word_ops += int(blocks.sum()) * self.block_words
        if not self.early_stop:
            return count, np.ones(count.size, bool)
        screen_alive = bound >= self._minsup
        stats.screened_out += int((~screen_alive).sum())
        stats.kernel_aborts += int((screen_alive & ~scan_alive).sum())
        return count, screen_alive & scan_alive
