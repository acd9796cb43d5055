"""Device-resident bitmap row store with a host-managed free list
(port of ``repro.core.rowstore.DeviceRowStore``, single device).

Every bitmap row the DFS can still touch lives in one preallocated slab
``int32[capacity, n_blocks, block_words]`` (uint32 bits, see
``core.bitmap``) with a parallel suffix-popcount slab ``int32[capacity,
n_blocks + 1]``.  The host only moves row *indices* around:

* ``alloc(k)`` hands out ``k`` free slots (growing the slab on demand);
* the fused dispatch (``kernels.ops.screen_and_intersect``) reads
  operands by index and writes survivors' children into their slots;
* ``free(ids)`` returns slots of dead candidates / expanded classes.

The fused dispatch updates the slabs **in place**.  That is safe because
every launch is ordered on one CUDA stream, and ``alloc`` never hands out
a slot that an in-flight dispatch reads as an operand (operand rows are
freed only when the drain group that reads them retires).

Growth doubles capacity to the next power of two (a device ``cat`` with
zeros).  ``compact`` gathers the live rows to the front of a smaller slab
in one dispatch per slab (``kernels.ops.compact_rows``) and returns the
old->new slot mapping, which the frontier applies to every live handle.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.bitmap import suffix_popcounts_np
from repro_torch.kernels import ops


def _round_capacity(n: int) -> int:
    cap = 64
    while cap < n:
        cap *= 2
    return cap


class DeviceRowStore:
    """Slab of bitmap rows + suffix tables resident on ``device``.

    ``rows_np`` is the host ``uint32 (n, n_blocks, block_words)`` level-1
    bitmap; its rows take slots ``0..n-1``.  The suffix table is computed
    on the host and uploaded with the rows."""

    def __init__(self, rows_np: np.ndarray, *, capacity: int = 0,
                 device: torch.device = torch.device("cpu")):
        n, nb, bw = rows_np.shape
        cap = _round_capacity(max(capacity, n, 1))
        self.device = torch.device(device)
        self.n_blocks = nb
        self.block_words = bw
        bits = np.ascontiguousarray(rows_np, dtype=np.uint32).view(np.int32)
        self.rows = torch.zeros((cap, nb, bw), dtype=torch.int32,
                                device=self.device)
        self.suffix = torch.zeros((cap, nb + 1), dtype=torch.int32,
                                  device=self.device)
        if n:
            self.rows[:n].copy_(torch.from_numpy(bits))
            self.suffix[:n].copy_(torch.from_numpy(
                suffix_popcounts_np(rows_np)))
        self._free: List[int] = list(range(cap - 1, n - 1, -1))
        self.grows = 0
        self.compactions = 0
        self.last_compaction_occupancy = 0.0
        self.peak_live = n
        self.peak_capacity = cap

    @property
    def capacity(self) -> int:
        return int(self.rows.shape[0])

    @property
    def words_per_row(self) -> int:
        """32-bit words one slab row pins on device (bitmap row + its
        suffix-table row)."""
        return self.n_blocks * self.block_words + int(self.suffix.shape[1])

    @property
    def peak_device_words(self) -> int:
        """High-water device footprint of the slab in 32-bit words
        (compaction can shrink the live slab but not this peak)."""
        return self.peak_capacity * self.words_per_row

    @property
    def n_live(self) -> int:
        return self.capacity - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.n_live / max(self.capacity, 1)

    def alloc(self, k: int) -> np.ndarray:
        """Pop ``k`` free slots (int32), growing the slab if needed."""
        if len(self._free) < k:
            self._grow(self.n_live + k)
        slots = np.asarray([self._free.pop() for _ in range(k)], np.int32)
        self.peak_live = max(self.peak_live, self.n_live)
        return slots

    def free(self, ids: Iterable[int]) -> None:
        self._free.extend(int(i) for i in ids)

    def _grow(self, need: int) -> None:
        old = self.capacity
        new = _round_capacity(max(2 * old, need))
        self.rows = torch.cat([self.rows, self.rows.new_zeros(
            (new - old, self.n_blocks, self.block_words))])
        self.suffix = torch.cat([self.suffix, self.suffix.new_zeros(
            (new - old, self.suffix.shape[1]))])
        self._free.extend(range(new - 1, old - 1, -1))
        self.grows += 1
        self.peak_capacity = max(self.peak_capacity, new)

    def compact(self, *, reserve: int = 0) -> np.ndarray:
        """Gather live rows (and suffix tables) to the front of a slab of
        ``_round_capacity(n_live + reserve)`` rows, keeping their relative
        order bit for bit.  Returns the old->new slot mapping
        ``int32[old_capacity]`` (-1 for slots that were free): callers
        MUST remap every live handle.  The mapping comes from the host
        free list; the gather itself does not block."""
        old_cap = self.capacity
        free_mask = np.zeros(old_cap, bool)
        free_mask[np.asarray(self._free, np.int64)] = True
        live = np.nonzero(~free_mask)[0].astype(np.int32)
        n_live = int(live.size)
        new_cap = _round_capacity(max(n_live + reserve, 1))

        perm = np.full(new_cap, -1, np.int32)       # dest slot -> src slot
        perm[:n_live] = live
        self.rows, self.suffix = ops.compact_rows(self.rows, self.suffix,
                                                  perm)
        self._free = list(range(new_cap - 1, n_live - 1, -1))
        self.compactions += 1
        self.last_compaction_occupancy = n_live / max(new_cap, 1)

        mapping = np.full(old_cap, -1, np.int32)
        mapping[live] = np.arange(n_live, dtype=np.int32)
        return mapping

    def compact_if_sparse(self, occupancy_threshold: float, *,
                          reserve: int = 0) -> Optional[np.ndarray]:
        """Compact when occupancy fell below ``occupancy_threshold`` AND
        the slab would shrink to at most half its size.  Returns the slot
        mapping, or ``None``."""
        if occupancy_threshold <= 0.0:
            return None
        new_cap = _round_capacity(max(self.n_live + reserve, 1))
        if (self.occupancy < occupancy_threshold
                and new_cap <= self.capacity // 2):
            return self.compact(reserve=reserve)
        return None
