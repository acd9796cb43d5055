"""Device bitmap miner: Eclat with block-level early stopping (port of
``repro.core.eclat``, scheme ``eclat``).

The equivalence-class DFS stays on the host and handles only row
*indices*; every bitmap row lives in a device-resident
``DeviceRowStore`` slab from the upload of the level-1 TID bitmaps until
its slot is free-listed.  Every sibling pair (a, b), a<b, of the drained
classes goes to the device in chunks, and each chunk is exactly **one**
launch (``kernels.ops.screen_and_intersect``):

  * gather: operand rows + suffix tables are read from the slab by index;
  * screen: block 0 of the scan — a pair whose block-0 bound misses
    minsup dies with ``blocks_done == 1``;
  * blocked ES: surviving pairs walk TID blocks and abort the moment the
    suffix bound drops below minsup;
  * scatter: child rows and their suffix tables are written into
    preallocated slots of the same slab, survivors only.

Slots are reserved one per candidate pair before the launch and the dead
ones go back to the free list when the chunk resolves; nothing was ever
written to them.  The scheduler (``core.frontier.FrontierScheduler``)
owns the traversal and compacts the slab at drain-group boundaries.

Work metric: ``word_ops`` — 32-bit word operations performed
(blocks_done x block_words per pair); ``word_ops_full`` is the full-scan
cost ``n_pairs * n_blocks * block_words``.  Every counter equals the JAX
engine's on the same input.

On CUDA the per-chunk index columns go up from pinned host buffers
without blocking, and the only host syncs are the readbacks at group
retirement (``_dispatch_resolve``), inside ``host_sync``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, Hashable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bitmap import (BITMAP_REF_ROW_WORDS, BitmapDB,
                                     DEFAULT_BLOCK_WORDS, PAIR_CHUNK_BUCKETS,
                                     chunk_width_for)
from repro_torch.core.frontier import (Child, ClassNode, EngineAccounting,
                                       FrontierScheduler)
from repro_torch.core.guards import host_sync
from repro_torch.core.rowstore import DeviceRowStore
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

ItemsetSupports = Dict[FrozenSet[Hashable], int]

# Schemes of the JAX miner that a later slice of the port brings.
_LATER_SCHEMES = {
    "declat": "ROADMAP Queue 1 item 8 (dEclat and adaptive)",
    "adaptive": "ROADMAP Queue 1 item 8 (dEclat and adaptive)",
}


@dataclass
class DeviceMiningStats(EngineAccounting):
    """Work accounting for the bitmap engine (the counters of
    ``repro.core.eclat.DeviceMiningStats``)."""

    screened_out: int = 0        # pairs killed by the one-block screen
    kernel_aborts: int = 0       # pairs killed past block 0
    word_ops: int = 0            # 32-bit word ops actually performed
    word_ops_full: int = 0       # what a non-ES engine would have performed

    @property
    def store_grows(self) -> int:
        return self.grows

    @property
    def peak_rows(self) -> int:
        return self.peak_live

    @property
    def deaths(self) -> int:
        return self.screened_out + self.kernel_aborts

    @property
    def ratio(self) -> float:
        return self.candidates / max(self.nodes, 1)

    @property
    def word_ops_saved_frac(self) -> float:
        if self.word_ops_full == 0:
            return 0.0
        return 1.0 - self.word_ops / self.word_ops_full

    def as_dict(self) -> Dict[str, float]:
        return {
            "candidates": self.candidates,
            "nodes": self.nodes,
            "ratio": round(self.ratio, 4),
            "screened_out": self.screened_out,
            "kernel_aborts": self.kernel_aborts,
            "word_ops": self.word_ops,
            "word_ops_full": self.word_ops_full,
            "word_ops_saved_frac": round(self.word_ops_saved_frac, 4),
            "store_grows": self.store_grows,
            "peak_rows": self.peak_rows,
            "runtime_s": round(self.runtime_s, 6),
            **self.accounting_dict(),
        }


class PendingPairResult:
    """Lazy result handle for one ``evaluate_pairs`` launch.

    The launch already went out; what is deferred is the blocking
    readback of count/blocks/alive plus the stats attribution and
    dead-slot frees that depend on it.  ``host`` is the pinned buffer the
    launch's index columns were uploaded from: it is held until the
    handle resolves, so it is never reused while the copy may be
    pending."""

    __slots__ = ("_miner", "_slots", "_raw", "_host")

    def __init__(self, miner: "BitmapMiner", slots: np.ndarray, raw: Tuple,
                 host: torch.Tensor):
        self._miner = miner
        self._slots = slots
        self._raw = raw
        self._host = host

    def remap(self, mapping: np.ndarray) -> None:
        self._slots = mapping[self._slots]

    def resolve(self) -> List[Tuple[int, int, int, Any]]:
        miner = self._miner
        stats, store = miner._stats, miner._store
        slots = self._slots
        cnt, alive = miner._dispatch_resolve(self._raw)
        support = cnt.astype(np.int64)
        # Exactly the launch's in-kernel scatter gate (ref._survivor_mask):
        # only these children were materialised.
        freq = np.logical_and(support >= miner._minsup, alive)
        kept_idx = np.nonzero(freq)[0]
        stats.child_scatters += int(kept_idx.size)
        stats.scatter_words += (int(kept_idx.size) * miner._n_blocks
                                * miner.block_words)
        store.free(slots[~freq])                  # dead children: recycle
        self._raw = self._host = None             # drop device/pinned refs
        return [(int(ki), int(slots[ki]), int(support[ki]), None)
                for ki in kept_idx]


class BitmapMiner:
    """Eclat over a device-resident row store with fused
    screen+intersect early stopping.

    ``device``: ``None`` (the default) means CUDA, and raises when there
    is none; ``"cpu"`` runs the plain PyTorch path.  The other knobs are
    the JAX miner's: ``pair_chunk`` (clamped to the largest bucket),
    ``compact_occupancy`` (compact the slab between drain groups when
    live rows fall below this fraction and it would at least halve; 0
    disables), ``inflight`` (drain groups in flight; 1 is the serial
    engine) and ``autotune_chunk`` (widen chunks of small rows)."""

    def __init__(self, scheme: str = "eclat", early_stop: bool = True,
                 block_words: int = DEFAULT_BLOCK_WORDS,
                 pair_chunk: int = 65536, compact_occupancy: float = 0.25,
                 inflight: int = 2, autotune_chunk: bool = False,
                 device: DeviceLike = None):
        if scheme in _LATER_SCHEMES:
            raise NotImplementedError(
                f"scheme={scheme!r} is not ported yet; it comes with "
                f"{_LATER_SCHEMES[scheme]}")
        if scheme != "eclat":
            raise ValueError(f"bad scheme {scheme!r}")
        self.device = resolve_device(device)
        self.scheme = scheme
        self.early_stop = early_stop
        self.block_words = block_words
        self.pair_chunk = min(pair_chunk, PAIR_CHUNK_BUCKETS[-1])
        self.compact_occupancy = compact_occupancy
        self.inflight = max(1, int(inflight))
        self.autotune_chunk = bool(autotune_chunk)

    # Dispatch chunks are sliced in units of this many pairs
    # (core.frontier._chunk_slices); 1 on a single device.
    chunk_quantum = 1

    def mine(self, db: Sequence[Sequence[Hashable]], minsup: int,
             ) -> Tuple[ItemsetSupports, DeviceMiningStats]:
        if minsup < 1:
            raise ValueError("minsup must be an absolute count >= 1")
        return self.mine_packed(
            BitmapDB.from_db(db, minsup, self.block_words), minsup)

    def mine_packed(self, bdb: BitmapDB, minsup: int,
                    ) -> Tuple[ItemsetSupports, DeviceMiningStats]:
        """Mine a pre-packed :class:`BitmapDB`."""
        if minsup < 1:
            raise ValueError("minsup must be an absolute count >= 1")
        stats = DeviceMiningStats()
        t0 = time.perf_counter()

        out: ItemsetSupports = {}
        for r, item in enumerate(bdb.items):
            out[frozenset((item,))] = int(bdb.supports[r])
            stats.nodes += 1

        store = DeviceRowStore(
            bdb.bitmaps, capacity=bdb.n_items + min(self.pair_chunk, 4096),
            device=self.device)
        self._minsup = minsup
        supports = bdb.supports.astype(np.int32)
        root = ClassNode(
            itemsets=[(it,) for it in bdb.items],
            rows=np.arange(bdb.n_items, dtype=np.int32),
            supports=supports)
        self._n_blocks = bdb.n_blocks
        self._store = store
        self._out = out
        self._stats = stats
        # Every pair moves the same word mass, so the autotuned chunk
        # width is one run-wide value.
        self._chunk_width = (chunk_width_for(
            bdb.n_blocks * self.block_words, self.pair_chunk,
            PAIR_CHUNK_BUCKETS, BITMAP_REF_ROW_WORDS)
            if self.autotune_chunk else None)
        sched = FrontierScheduler(self, self.pair_chunk,
                                  inflight=self.inflight,
                                  drain_target=self._chunk_width)
        sched.run(root)
        stats.note_allocator(store)
        stats.note_scheduler(sched)
        stats.runtime_s = time.perf_counter() - t0
        return out, stats

    # -- FrontierScheduler client protocol ----------------------------------

    def pair_columns(self, klass: ClassNode, ia: np.ndarray,
                     ib: np.ndarray) -> Dict[str, np.ndarray]:
        # Paper Alg. 1: Z = T(Px) & T(Py); rho is the parent support.
        return {"ua": klass.rows[ia].astype(np.int32),
                "vb": klass.rows[ib].astype(np.int32),
                "rho": klass.supports[ia].astype(np.int32)}

    def chunk_widths(self, cols: Dict[str, np.ndarray],
                     ) -> "np.ndarray | None":
        """Per-pair chunk-width cap: uniform — every pair moves
        ``n_blocks * block_words`` operand words."""
        if self._chunk_width is None:
            return None
        return np.full(cols["ua"].size, self._chunk_width, np.int64)

    def evaluate_pairs(self, cols: Dict[str, np.ndarray],
                       ) -> PendingPairResult:
        """One pair-chunk slice -> ONE fused launch.  The returned handle's
        ``resolve()`` yields the frequent children as ``(ki, slot,
        support, None)`` (``ki`` = chunk-local pair index)."""
        store, stats = self._store, self._stats
        ua, vb, rho = cols["ua"], cols["vb"], cols["rho"]
        n = int(ua.size)
        stats.candidates += n
        stats.word_ops_full += n * self._n_blocks * self.block_words
        slots = store.alloc(n)
        raw, host = self._dispatch_launch(store, ua, vb, slots, rho)
        return PendingPairResult(self, slots, raw, host)

    def make_class(self, parent: ClassNode,
                   children: List[Child]) -> ClassNode:
        return ClassNode(
            itemsets=[c.itemset for c in children],
            rows=np.asarray([c.row for c in children], np.int32),
            supports=np.asarray([c.support for c in children], np.int32))

    def emit(self, itemset: Tuple[Hashable, ...], support: int) -> None:
        self._out[frozenset(itemset)] = support
        self._stats.nodes += 1

    def release(self, klass: ClassNode) -> None:
        self._store.free(klass.rows)

    def maybe_compact(self, reserve: int) -> "np.ndarray | None":
        """Drain-group boundary hook: compact the slab when occupancy
        warrants it; returns the slot mapping (or None)."""
        return self._store.compact_if_sparse(self.compact_occupancy,
                                             reserve=reserve)

    def _dispatch_launch(self, store: DeviceRowStore, ua: np.ndarray,
                         vb: np.ndarray, slots: np.ndarray,
                         rho: np.ndarray) -> Tuple[Tuple, torch.Tensor]:
        """Upload the index columns (one non-blocking copy from a pinned
        buffer on CUDA) and launch one fused dispatch over exactly the
        chunk's pairs.  (The JAX engine pads each chunk to a
        ``PAIR_CHUNK_BUCKETS`` width to bound its jit cache, and its pad
        pairs are scanned like real ones; an eager launch needs no fixed
        shapes, so the port sends none.)  Returns the un-read device
        outputs ``(cnt, blocks, alive)`` and the host buffer to keep
        alive until they are read."""
        host, (ua_d, vb_d, slots_d, rho_d) = ops.upload_columns(
            store.device, [ua, vb, slots, rho])
        # minsup is always the real threshold (the survivor gate needs it
        # with ES off too); early_stop alone controls the in-scan abort.
        _, _, cnt, blocks, alive = ops.screen_and_intersect(
            store.rows, store.suffix, ua_d, vb_d, slots_d, rho_d,
            self._minsup, mode="and", early_stop=self.early_stop)
        self._stats.device_calls += 1
        return (cnt, blocks, alive), host

    def _dispatch_resolve(self, raw: Tuple) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking readback of one launch + work/attribution stats.
        Returns the chunk's ``(cnt, alive)``."""
        stats = self._stats
        cnt, blocks, alive = raw
        packed = torch.stack((cnt, blocks, alive.to(torch.int32)))
        # host-sync: the group-retirement readback, once per launch
        with host_sync("group-retirement accounting readback"):
            packed = packed.cpu().numpy()
        cnt, blocks, alive = packed[0], packed[1], packed[2].astype(bool)
        stats.word_ops += int(blocks.sum()) * self.block_words
        if self.early_stop:
            # A dead pair that did at most one block was killed by the
            # fused one-block screen; later deaths are kernel aborts.
            dead = ~alive
            stats.screened_out += int((dead & (blocks <= 1)).sum())
            stats.kernel_aborts += int((dead & (blocks > 1)).sum())
        return cnt, alive


def mine_bitmap(db: Sequence[Sequence[Hashable]], minsup: int,
                scheme: str = "eclat", early_stop: bool = True,
                **kw) -> Tuple[ItemsetSupports, DeviceMiningStats]:
    """Convenience front-end mirroring ``repro.core.eclat.mine_bitmap``;
    ``device`` defaults to CUDA."""
    return BitmapMiner(scheme=scheme, early_stop=early_stop, **kw).mine(
        db, minsup)
