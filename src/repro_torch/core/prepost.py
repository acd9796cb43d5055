"""Device-resident PrePost+: N-lists live in a pooled device slab (port of
``repro.core.prepost``).

The PPC-tree build is sequential host preprocessing (one pass over the
reordered transactions), shared with the oracle (``oracle.PPCTree``).
Everything after it is device-resident: every N-list the DFS can still
touch is an extent of one ``int32[capacity, 3]`` PPC-code slab
(``core.rowstore.NListPool``), and the host moves only row ids and small
int vectors.  Each sibling pair chunk is two launches:

  * pre-pass (``kernels.ops.nlist_presize``, launched in
    ``evaluate_pairs``): both operand N-lists are read from the slab by
    extent offset and merged with the ``z_mass + (rho_V - skip)`` ES
    guard; the host learns each candidate's exact child length and
    support while the match table stays on the card;
  * scatter (``kernels.ops.nlist_scatter``, launched at retirement): the
    match table is Z-merged into *tight* extents allocated for the
    surviving children only; a chunk with no survivors skips it.

The retirement readback (child_len, support, comparisons, checks, alive)
is one packed device-to-host copy inside ``host_sync``: it is
load-bearing, because extent sizes come from it.  The scatter launch
itself does not sync.  Comparison and check counts are exactly the
oracle's (same merge, same abort points).  The DFS is the shared
``core.frontier.FrontierScheduler``; each chunk launches its pairs
unpadded, with gather widths ``nl_pad_len`` of the chunk maxima.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, Hashable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bitmap import (NL_LEN_BUCKETS, NL_PAIR_CHUNK_BUCKETS,
                                     NL_REF_LEN, chunk_width_for, nl_pad_len,
                                     nl_pad_len_np)
from repro_torch.core.frontier import (Child, ClassNode, EngineAccounting,
                                       FrontierScheduler)
from repro_torch.core.guards import host_sync
from repro_torch.core.oracle import MiningStats, PPCTree
from repro_torch.core.rowstore import NListPool
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

ItemsetSupports = Dict[FrozenSet[Hashable], int]


class PendingMergeResult:
    """Lazy result handle for one N-list ``evaluate_pairs`` chunk: the
    pre-pass has been launched; the readback, the tight survivor extent
    allocation and the scatter launch run in ``resolve()`` at group
    retirement.

    Deferring the scatter past other groups' launches is sound: the
    scatter reads its operand windows from the *current* slab by offset,
    this group's operand extents stay live until its own retirement, and
    growth keeps offsets.  A compaction while the group is in flight
    moves extents but not row ids (``remap`` is a no-op), so offsets are
    resolved again at scatter time."""

    __slots__ = ("_miner", "_n", "_u_row", "_v_row", "_u_len", "_v_len",
                 "_lu", "_lv", "_raw", "_host")

    def __init__(self, miner: "DevicePrePost", n: int, u_row: np.ndarray,
                 v_row: np.ndarray, u_len: np.ndarray, v_len: np.ndarray,
                 lu: int, lv: int, raw: Tuple, host: torch.Tensor):
        self._miner = miner
        self._n = n
        self._u_row, self._v_row = u_row, v_row
        self._u_len, self._v_len = u_len, v_len
        self._lu, self._lv = lu, lv
        self._raw = raw
        self._host = host

    def remap(self, mapping) -> None:
        """Pool row ids are compaction-stable; nothing to rewrite."""

    def resolve(self) -> List[Tuple[int, int, int, Any]]:
        miner = self._miner
        pool, stats = miner._pool, miner._stats
        n = self._n
        out_slot, child_len, support, cmps, checks, alive = self._raw
        packed = torch.stack((child_len, support, cmps, checks,
                              alive.to(torch.int32)))
        # host-sync: the group-retirement readback, once per pre-pass;
        # the tight extent allocation below needs the exact lengths
        with host_sync("group-retirement accounting readback"):
            packed = packed.cpu().numpy()
        child_len, support, cmps, checks = packed[:4]
        alive = packed[4].astype(bool)
        stats.comparisons += int(cmps.sum())
        if miner.early_stop:
            # One ES bound evaluation per skipped V code: exactly the
            # oracle's es_checks; aborts count only with the guard armed.
            stats.es_checks += int(checks.sum())
            stats.es_aborts += int((~alive).sum())

        freq = support >= miner._minsup   # aborted pairs report support 0
        kept = np.nonzero(freq)[0]
        self._host = None
        if kept.size == 0:
            self._raw = None
            return []

        child_rows = pool.alloc_rows(child_len[kept])
        out_off = np.full(n, pool.capacity, np.int32)   # default: skipped
        out_off[kept] = pool.offsets(child_rows)
        # Offsets resolved at scatter time: an in-flight compaction may
        # have moved every live extent.
        # (PyTorch's pinned-memory allocator keeps the staging buffer until
        # its copy has run, so it need not outlive this call.)
        _, cols = ops.upload_columns(pool.device, [
            pool.offsets(self._u_row), self._u_len,
            pool.offsets(self._v_row), self._v_len, out_off])
        pool.codes, _ = ops.nlist_scatter(pool.codes, out_slot, *cols,
                                          lu=self._lu, lv=self._lv)
        stats.device_calls += 1
        stats.child_scatters += int(kept.size)
        stats.scatter_words += 3 * int(child_len[kept].sum())
        self._raw = None
        return [(int(b), int(row), int(support[b]), int(child_len[b]))
                for b, row in zip(kept, child_rows, strict=True)]


@dataclass
class DevicePrePostStats(MiningStats, EngineAccounting):
    """Oracle-compatible counters plus the shared device-engine
    accounting (``repro.core.prepost.DevicePrePostStats``)."""

    @property
    def pool_grows(self) -> int:
        return self.grows

    @property
    def peak_codes(self) -> int:
        return self.peak_live

    @property
    def deaths(self) -> int:
        return self.es_aborts

    def as_dict(self) -> Dict[str, float]:
        d = super().as_dict()
        d.update(pool_grows=self.pool_grows, peak_codes=self.peak_codes,
                 **self.accounting_dict())
        return d


class DevicePrePost:
    """PrePost+ over a device-resident N-list pool: a merge pre-pass and a
    survivor-only scatter per pair chunk.

    ``device``: ``None`` (the default) means CUDA, and raises when there
    is none; ``"cpu"`` runs the plain PyTorch path.  The other knobs are
    the JAX engine's: ``pair_chunk`` (clamped to the largest N-list
    bucket), ``compact_occupancy`` (0 disables), ``inflight`` and
    ``autotune_chunk`` (widen chunks of short N-lists)."""

    def __init__(self, early_stop: bool = True, pair_chunk: int = 8192,
                 compact_occupancy: float = 0.25, inflight: int = 2,
                 autotune_chunk: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.early_stop = early_stop
        self.pair_chunk = min(pair_chunk, NL_PAIR_CHUNK_BUCKETS[-1])
        self.compact_occupancy = compact_occupancy
        self.inflight = max(1, int(inflight))
        self.autotune_chunk = bool(autotune_chunk)
        self._widths: Dict[int, int] = {}

    def mine(self, db: Sequence[Sequence[Hashable]], minsup: int,
             ) -> Tuple[ItemsetSupports, DevicePrePostStats]:
        """Build the PPC-tree on the host, then :meth:`mine_tree`.
        ``runtime_s`` covers both, as in the JAX engine."""
        if minsup < 1:
            raise ValueError("minsup must be an absolute count >= 1")
        t0 = time.perf_counter()
        out, stats = self.mine_tree(PPCTree(db, minsup), minsup)
        stats.runtime_s = time.perf_counter() - t0
        return out, stats

    def mine_tree(self, tree: PPCTree, minsup: int,
                  ) -> Tuple[ItemsetSupports, DevicePrePostStats]:
        """Mine from a PPC-tree built at ``minsup`` (so its build can be
        timed apart); ``runtime_s`` is the mining alone."""
        if minsup < 1:
            raise ValueError("minsup must be an absolute count >= 1")
        stats = DevicePrePostStats()
        t0 = time.perf_counter()
        order_asc = list(reversed(tree.order_desc))
        out: ItemsetSupports = {}
        arrays: List[np.ndarray] = []
        for it in order_asc:
            out[frozenset((it,))] = tree.item_support[it]
            stats.nodes += 1
            arrays.append(np.asarray(tree.nlists[it], np.int32).reshape(-1, 3))

        pool = NListPool(capacity=max(
            64, 2 * sum(nl_pad_len(max(len(a), 1)) for a in arrays)),
            device=self.device)
        rows = pool.alloc_rows([len(a) for a in arrays])
        if len(arrays):
            pool.write_rows(rows, arrays)
        root = ClassNode(
            itemsets=[(it,) for it in order_asc],
            rows=np.asarray(rows, np.int32),
            supports=np.asarray([tree.item_support[it] for it in order_asc],
                                np.int32),
            payload=np.asarray([len(a) for a in arrays], np.int32),
            representation="nlist")

        self._minsup = minsup
        self._pool = pool
        self._out = out
        self._stats = stats
        # The widest autotuned chunk is the smallest bucket's width;
        # draining that many pairs keeps wide chunks full.
        drain_target = (self._width_for_bucket(NL_LEN_BUCKETS[0])
                        if self.autotune_chunk else None)
        sched = FrontierScheduler(self, self.pair_chunk,
                                  inflight=self.inflight,
                                  drain_target=drain_target)
        sched.run(root)
        stats.note_allocator(pool)
        stats.note_scheduler(sched)
        stats.runtime_s = time.perf_counter() - t0
        return out, stats

    # -- FrontierScheduler client protocol ----------------------------------

    def pair_columns(self, klass: ClassNode, ia: np.ndarray,
                     ib: np.ndarray) -> Dict[str, np.ndarray]:
        lens = klass.payload               # per-member exact N-list lengths
        return {"u_row": klass.rows[ia].astype(np.int32),
                "v_row": klass.rows[ib].astype(np.int32),
                "u_len": lens[ia].astype(np.int32),
                "v_len": lens[ib].astype(np.int32),
                "rho_v": klass.supports[ib].astype(np.int32)}

    def chunk_sort_key(self, cols: Dict[str, np.ndarray]) -> np.ndarray:
        """Sort drained pairs by the bucket of their longest operand, so
        one long N-list widens the match table only for its own chunk."""
        return nl_pad_len_np(np.maximum(cols["u_len"], cols["v_len"]))

    def _width_for_bucket(self, bucket: int) -> int:
        """Autotuned chunk width for one operand length bucket (floored at
        ``pair_chunk``)."""
        w = self._widths.get(bucket)
        if w is None:
            w = chunk_width_for(3 * bucket, self.pair_chunk,
                                NL_PAIR_CHUNK_BUCKETS, 3 * NL_REF_LEN)
            self._widths[bucket] = w
        return w

    def chunk_widths(self, cols: Dict[str, np.ndarray],
                     ) -> "np.ndarray | None":
        """Per-pair chunk-width cap on the sorted columns (non-increasing,
        so the greedy slicer packs each bucket at its own width)."""
        if not self.autotune_chunk:
            return None
        buckets = nl_pad_len_np(np.maximum(cols["u_len"], cols["v_len"]))
        widths = np.empty(buckets.size, np.int64)
        for b in np.unique(buckets):
            widths[buckets == b] = self._width_for_bucket(int(b))
        return widths

    def evaluate_pairs(self, cols: Dict[str, np.ndarray],
                       ) -> PendingMergeResult:
        """One pair-chunk slice -> the merge pre-pass launch (the scatter
        follows at retirement, see :class:`PendingMergeResult`).  The
        handle's ``resolve()`` yields the frequent children as ``(ki,
        row, support, length)``."""
        pool, stats = self._pool, self._stats
        u_len, v_len = cols["u_len"], cols["v_len"]
        n = int(u_len.size)
        stats.candidates += n
        lu = nl_pad_len(int(u_len.max()))
        lv = nl_pad_len(int(v_len.max()))
        host, dev_cols = ops.upload_columns(pool.device, [
            pool.offsets(cols["u_row"]), u_len, pool.offsets(cols["v_row"]),
            v_len, cols["rho_v"]])
        raw = ops.nlist_presize(pool.codes, *dev_cols, self._minsup, lu=lu,
                                lv=lv, early_stop=self.early_stop)
        stats.device_calls += 1
        return PendingMergeResult(self, n, cols["u_row"], cols["v_row"],
                                  u_len, v_len, lu, lv, raw, host)

    def make_class(self, parent: ClassNode,
                   children: List[Child]) -> ClassNode:
        del parent
        return ClassNode(
            itemsets=[c.itemset for c in children],
            rows=np.asarray([c.row for c in children], np.int32),
            supports=np.asarray([c.support for c in children], np.int32),
            payload=np.asarray([c.extra for c in children], np.int32),
            representation="nlist")

    def emit(self, itemset: Tuple[Hashable, ...], support: int) -> None:
        self._out[frozenset(itemset)] = support
        self._stats.nodes += 1

    def release(self, klass: ClassNode) -> None:
        self._pool.free_rows(klass.rows)

    def maybe_compact(self, reserve: int) -> None:
        """Drain-group boundary hook.  Row ids are compaction-stable, so
        the scheduler never remaps (returns None).  ``reserve`` is the
        drain group's pair count; the mean live extent converts it into
        a generous code estimate."""
        pool = self._pool
        avg_extent = pool.live_codes // max(pool.n_live_rows, 1)
        pool.compact_if_sparse(self.compact_occupancy,
                               reserve=reserve * max(avg_extent, 1))
        return None


def mine_prepost_device(db, minsup, early_stop: bool = True, **kw):
    """Convenience front-end mirroring
    ``repro.core.prepost.mine_prepost_device``; ``device`` defaults to
    CUDA."""
    return DevicePrePost(early_stop=early_stop, **kw).mine(db, minsup)
