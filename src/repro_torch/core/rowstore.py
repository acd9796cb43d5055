"""Device-resident allocators (port of ``repro.core.rowstore``): the
bitmap row store ``DeviceRowStore`` and the PrePost+ N-list pool
``NListPool`` (at the end of this module).

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

Sharded mode (``n_shards > 1``, the sharded miner's block shards): the
block axis is padded to a multiple of ``n_shards`` (the pad at the tail
shard), and the store holds only shard ``shard``'s blocks: ``rows``
(capacity, local_blocks, block_words) and its local suffix tables
``suffix`` (capacity, local_blocks + 1).  Every rank keeps the same host
free list and compacts with the same ``perm``, so slot ids mean the same
row on every rank; ``peak_device_words`` counts every shard's slab.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bitmap import NL_LEN_BUCKETS, nl_pad_len
from repro_torch.core.guards import host_sync
from repro_torch.core.spans import span
from repro_torch.kernels import ops


def _round_capacity(n: int) -> int:
    cap = 64
    while cap < n:
        cap *= 2
    return cap


class DeviceRowStore:
    """Slab of bitmap rows + suffix tables resident on ``device``.

    ``rows_np`` is the host ``uint32 (n, n_blocks, block_words)`` level-1
    bitmap; its rows take slots ``0..n-1``.  The rows are uploaded, then
    their suffix tables are computed on the device from the uploaded rows
    (``kernels.ops.suffix_tables``: one kernel launch on CUDA).  With
    ``n_shards > 1`` the store holds block shard ``shard`` only (module
    docstring)."""

    def __init__(self, rows_np: np.ndarray, *, capacity: int = 0,
                 device: torch.device = torch.device("cpu"),
                 n_shards: int = 1, shard: int = 0):
        n, nb_real, bw = rows_np.shape
        if not 0 <= shard < n_shards:
            raise ValueError(f"shard {shard} of {n_shards}")
        cap = _round_capacity(max(capacity, n, 1))
        self.device = torch.device(device)
        self.n_shards = n_shards
        self.shard = shard
        nb = -(-nb_real // n_shards) * n_shards
        nbl = nb // n_shards
        self.n_blocks = nb                  # every shard's, pad included
        self.local_blocks = nbl
        self.block_words = bw
        lo = shard * nbl
        with span("store.init"):
            local = np.ascontiguousarray(rows_np[:, lo:lo + nbl],
                                         dtype=np.uint32)
            if local.shape[1] < nbl:        # the tail shard's pad blocks
                local = np.concatenate([local, np.zeros(
                    (n, nbl - local.shape[1], bw), np.uint32)], axis=1)
            self.rows = torch.zeros((cap, nbl, bw), dtype=torch.int32,
                                    device=self.device)
            self.suffix = torch.zeros((cap, nbl + 1), dtype=torch.int32,
                                      device=self.device)
            if n:
                with span("store.upload"):
                    self.rows[:n].copy_(
                        torch.from_numpy(local.view(np.int32)))
                with span("store.suffix"):
                    ops.suffix_tables(self.rows, self.suffix, n)
        self._set_free(cap, n)
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
        """32-bit words one slab row pins on device over every shard
        (bitmap row + its suffix-table rows)."""
        return (self.n_blocks * self.block_words
                + self.n_shards * (self.local_blocks + 1))

    @property
    def peak_device_words(self) -> int:
        """High-water device footprint of the slab in 32-bit words, summed
        over every shard (compaction can shrink the live slab but not this
        peak)."""
        return self.peak_capacity * self.words_per_row

    @property
    def n_live(self) -> int:
        return self.capacity - self._n_free

    @property
    def occupancy(self) -> float:
        return self.n_live / max(self.capacity, 1)

    # The free list is a stack of slot ids: ``_free[:_n_free]``, top at
    # the end.  Slots go out and come back by slices, never one Python
    # call a slot; a fresh or compacted slab stacks its free slots so the
    # lowest pops first.

    def _set_free(self, cap: int, n_live: int) -> None:
        """Every slot from ``n_live`` up is free, the lowest on top."""
        self._free = np.arange(cap - 1, n_live - 1, -1, dtype=np.int32)
        self._n_free = cap - n_live

    def _push(self, ids: np.ndarray) -> None:
        top = self._n_free + ids.size
        if top > self._free.size:
            grown = np.empty(max(top, 2 * self._free.size), np.int32)
            grown[:self._n_free] = self._free[:self._n_free]
            self._free = grown
        self._free[self._n_free:top] = ids
        self._n_free = top

    def alloc(self, k: int) -> np.ndarray:
        """Pop ``k`` free slots (int32, the top of the stack first),
        growing the slab if needed."""
        if self._n_free < k:
            self._grow(self.n_live + k)
        top = self._n_free
        slots = self._free[top - k:top][::-1].copy()
        self._n_free = top - k
        self.peak_live = max(self.peak_live, self.n_live)
        return slots

    def free(self, ids: "np.ndarray | Sequence[int]") -> None:
        """Push ``ids`` back, in their order (the last is popped first)."""
        self._push(np.asarray(ids, np.int32).reshape(-1))

    def _grow(self, need: int) -> None:
        old = self.capacity
        new = _round_capacity(max(2 * old, need))
        with span("store.grow"):
            self.rows = torch.cat([self.rows, self.rows.new_zeros(
                (new - old, self.local_blocks, self.block_words))])
            self.suffix = torch.cat([self.suffix, self.suffix.new_zeros(
                (new - old, self.suffix.shape[1]))])
        self._push(np.arange(new - 1, old - 1, -1, dtype=np.int32))
        self.grows += 1
        self.peak_capacity = max(self.peak_capacity, new)

    def compact(self, *, reserve: int = 0) -> np.ndarray:
        """Gather live rows (and suffix tables) to the front of a slab of
        ``_round_capacity(n_live + reserve)`` rows, keeping their relative
        order bit for bit.  Returns the old->new slot mapping
        ``int32[old_capacity]`` (-1 for slots that were free): callers
        MUST remap every live handle.  The mapping comes from the host
        free list; the gather itself does not block."""
        with span("store.compact"):
            old_cap = self.capacity
            free_mask = np.zeros(old_cap, bool)
            free_mask[self._free[:self._n_free]] = True
            live = np.nonzero(~free_mask)[0].astype(np.int32)
            n_live = int(live.size)
            new_cap = _round_capacity(max(n_live + reserve, 1))

            perm = np.full(new_cap, -1, np.int32)     # dest slot -> src slot
            perm[:n_live] = live
            self.rows, self.suffix = ops.compact_rows(self.rows, self.suffix,
                                                      perm)
            self._set_free(new_cap, n_live)
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


def _largest_bucket_le(n: int) -> int:
    """Largest N-list bucket size <= ``n`` (``n`` >= the smallest
    bucket); every bucket is a multiple of the smallest, so splitting a
    free extent greedily with this decomposes the tail exactly."""
    best = NL_LEN_BUCKETS[0]
    for b in NL_LEN_BUCKETS:
        if b <= n:
            best = b
    b = NL_LEN_BUCKETS[-1]
    while b * 2 <= n:                 # power-of-two fallback region
        b *= 2
        best = b
    return best


class NListPool:
    """Device-resident ragged pool of PPC codes (port of
    ``repro.core.rowstore.NListPool``).

    ``codes`` is one persistent ``int32[capacity, 3]`` slab of ``(pre,
    post, freq)`` triples on ``device``.  An N-list *row* is an extent
    ``[off, off + cap_len)`` of the slab, ``cap_len`` bucketed to
    :func:`repro_torch.core.bitmap.nl_pad_len`; the host keeps the per-row
    offset/length tables plus one free list of extents per bucket, and
    never sees code contents on the hot path (``kernels.ops.
    nlist_presize`` reads operands by offset and ``ops.nlist_scatter``
    writes children by offset, in place).

    Growth doubles capacity (a device ``cat`` with zeros) and keeps live
    extents bit for bit; ``compact`` repacks live extents to the front of
    a fresh slab in one gather (``ops.compact_codes``).  Row ids are
    stable across both: callers hold row ids, never offsets.

    ``device`` has no default: the pool lives where the engine mines."""

    def __init__(self, capacity: int = 4096, *, device):
        cap = _round_capacity(max(capacity, 1))
        self.device = torch.device(device)
        self.codes = torch.zeros((cap, 3), dtype=torch.int32,
                                 device=self.device)
        self._free: Dict[int, List[int]] = {}   # bucket size -> extent offs
        self._bump = 0                          # slab high-water mark
        self.grows = 0
        self.compactions = 0
        self.last_compaction_occupancy = 0.0
        self._row_off: List[int] = []
        self._row_len: List[int] = []           # actual (exact) lengths
        self._row_cap: List[int] = []           # bucketed extent sizes
        self._free_rows: List[int] = []
        self.live_codes = 0                     # sum of live extent sizes
        self.peak_codes = 0
        self.total_alloc_codes = 0              # cumulative extent mass

    # -- state carried across from the JAX pool -----------------------------

    @classmethod
    def from_arrays(cls, codes: np.ndarray, row_off: Sequence[int],
                    row_len: Sequence[int], row_cap: Sequence[int],
                    free_rows: Sequence[int],
                    free: Mapping[int, Sequence[int]], bump: int, *,
                    device) -> "NListPool":
        """A pool holding exactly the given state: the ``codes`` slab
        (int32 ``(capacity, 3)``, a power of two), the per-row tables,
        the free row ids and the per-bucket free extent stacks (in stack
        order) and the bump pointer — e.g. a JAX pool's ``codes``,
        ``_row_off``, ``_row_len``, ``_row_cap``, ``_free_rows``,
        ``_free`` and ``_bump``.  Counters start at zero; ``live_codes``
        and ``peak_codes`` are the live extents' mass."""
        codes = np.asarray(codes)
        if codes.dtype != np.int32 or codes.ndim != 2 or codes.shape[1] != 3:
            raise ValueError(f"codes must be int32 (capacity, 3), got "
                             f"{codes.dtype} {codes.shape}")
        cap = codes.shape[0]
        if cap != _round_capacity(max(cap, 1)):
            raise ValueError(f"capacity {cap} is not a power of two >= 64")
        n_rows = len(row_off)
        if not len(row_len) == len(row_cap) == n_rows:
            raise ValueError("row_off, row_len and row_cap differ in length")
        pool = cls(cap, device=device)
        pool.codes.copy_(torch.from_numpy(np.array(codes, copy=True)))
        pool._row_off = [int(x) for x in row_off]
        pool._row_len = [int(x) for x in row_len]
        pool._row_cap = [int(x) for x in row_cap]
        pool._free_rows = [int(x) for x in free_rows]
        pool._free = {int(b): [int(x) for x in offs]
                      for b, offs in free.items()}
        pool._bump = int(bump)
        dead = set(pool._free_rows)
        pool.live_codes = sum(c for r, c in enumerate(pool._row_cap)
                              if r not in dead)
        pool.peak_codes = pool.live_codes
        return pool

    def to_arrays(self) -> Dict[str, object]:
        """The state as plain values, the keyword arguments of
        :meth:`from_arrays` (``device`` aside): ``codes`` int32 ``(capacity,
        3)``, the row tables and ``free_rows`` as int32 arrays, ``free``
        as ``{bucket: int32 array}`` and ``bump``."""
        with host_sync("pool state readback (tests, carrying state)"):
            codes = self.codes.cpu().numpy()
        i32 = lambda v: np.asarray(v, np.int32)  # noqa: E731
        return dict(codes=codes, row_off=i32(self._row_off),
                    row_len=i32(self._row_len), row_cap=i32(self._row_cap),
                    free_rows=i32(self._free_rows),
                    free={b: i32(offs) for b, offs in self._free.items()},
                    bump=self._bump)

    # -- allocation -----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return int(self.codes.shape[0])

    @property
    def n_live_rows(self) -> int:
        return len(self._row_off) - len(self._free_rows)

    @property
    def occupancy(self) -> float:
        return self.live_codes / max(self.capacity, 1)

    @property
    def peak_live(self) -> int:
        """Uniform allocator-accounting alias (``EngineAccounting``)."""
        return self.peak_codes

    def _alloc_extent(self, bucket: int) -> int:
        stack = self._free.get(bucket)
        if stack:
            return stack.pop()
        # No exact-size extent: split the smallest larger free extent —
        # the head serves the request, the tail goes back to the free
        # lists in largest-bucket-first pieces (every bucket is a
        # multiple of the smallest, so it decomposes exactly).
        bigger = sorted(b for b, s in self._free.items() if b > bucket and s)
        if bigger:
            src = bigger[0]
            off = self._free[src].pop()
            tail_off, rem = off + bucket, src - bucket
            while rem > 0:
                piece = _largest_bucket_le(rem)
                self._free.setdefault(piece, []).append(tail_off)
                tail_off += piece
                rem -= piece
            return off
        off = self._bump
        if off + bucket > self.capacity:
            self._grow(off + bucket)
        self._bump = off + bucket
        return off

    def alloc_rows(self, lengths: Sequence[int]) -> np.ndarray:
        """One row per requested length (extent = its bucket); returns
        int32 row ids.  On the mining path ``lengths`` are the pre-pass's
        exact child lengths, read back at group retirement."""
        rows = np.empty(len(lengths), np.int32)
        for k, ln in enumerate(lengths):
            ln = int(ln)
            bucket = nl_pad_len(max(ln, 1))
            off = self._alloc_extent(bucket)
            if self._free_rows:
                r = self._free_rows.pop()
                self._row_off[r] = off
                self._row_len[r] = ln
                self._row_cap[r] = bucket
            else:
                r = len(self._row_off)
                self._row_off.append(off)
                self._row_len.append(ln)
                self._row_cap.append(bucket)
            self.live_codes += bucket
            self.total_alloc_codes += bucket
            rows[k] = r
        self.peak_codes = max(self.peak_codes, self.live_codes)
        return rows

    def free_rows(self, rows: Iterable[int]) -> None:
        for r in rows:
            r = int(r)
            bucket = self._row_cap[r]
            self._free.setdefault(bucket, []).append(self._row_off[r])
            self._free_rows.append(r)
            self.live_codes -= bucket

    def set_length(self, row: int, length: int) -> None:
        self._row_len[int(row)] = int(length)

    def offsets(self, rows: Sequence[int]) -> np.ndarray:
        return np.asarray([self._row_off[int(r)] for r in rows], np.int32)

    def lengths(self, rows: Sequence[int]) -> np.ndarray:
        return np.asarray([self._row_len[int(r)] for r in rows], np.int32)

    def write_rows(self, rows: Sequence[int],
                   code_arrays: Sequence[np.ndarray]) -> None:
        """Upload row contents (pack time only: the level-1 N-lists of the
        PPC-tree build) as one copy of ``(slab index, pre, post, freq)``
        rows from pinned memory, then one device scatter."""
        idx = np.concatenate([
            np.arange(self._row_off[int(r)],
                      self._row_off[int(r)] + len(a), dtype=np.int64)
            for r, a in zip(rows, code_arrays, strict=True)])
        vals = np.concatenate([np.asarray(a, np.int32).reshape(-1, 3)
                               for a in code_arrays])
        host = torch.empty((idx.size, 4), dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")
        hn = host.numpy()
        hn[:, 0] = idx
        hn[:, 1:] = vals
        dev = host.to(self.device, non_blocking=True)
        self.codes[dev[:, 0].long()] = dev[:, 1:]

    def read_row(self, row: int) -> np.ndarray:
        """Row contents as ``int32 (len, 3)`` — tests only (the mining
        path never brings N-lists to the host)."""
        off = self._row_off[int(row)]
        ln = self._row_len[int(row)]
        with host_sync("test N-list readback"):
            return self.codes[off:off + ln].cpu().numpy()

    def _grow(self, need: int) -> None:
        old = self.capacity
        new = _round_capacity(max(2 * old, need))
        self.codes = torch.cat([self.codes,
                                self.codes.new_zeros((new - old, 3))])
        self.grows += 1

    def _tight_mass(self) -> int:
        """Bucketed mass after shrinking every live extent to the bucket of
        its actual length (what a compaction would leave)."""
        free_rows = set(self._free_rows)
        return sum(nl_pad_len(max(self._row_len[r], 1))
                   for r in range(len(self._row_off))
                   if r not in free_rows)

    def compact(self, *, reserve: int = 0) -> None:
        """Repack live extents to the front of a (usually smaller) slab in
        one gather, each shrunk to the bucket of its actual length.  Live
        codes move bit for bit and row ids stay; free lists and the bump
        pointer are rebuilt (everything past the packed region is free)."""
        free_rows = set(self._free_rows)
        live = sorted((r for r in range(len(self._row_off))
                       if r not in free_rows),
                      key=lambda r: self._row_off[r])
        idx_parts: List[np.ndarray] = []
        bump = 0
        new_off: List[Tuple[int, int, int]] = []    # (row, off, bucket)
        for r in live:
            ln = self._row_len[r]
            bucket = nl_pad_len(max(ln, 1))
            idx = np.full(bucket, -1, np.int32)
            idx[:ln] = np.arange(self._row_off[r], self._row_off[r] + ln,
                                 dtype=np.int32)
            idx_parts.append(idx)
            new_off.append((r, bump, bucket))
            bump += bucket
        new_cap = _round_capacity(max(bump + reserve, 1))
        perm = np.full(new_cap, -1, np.int32)
        if bump:
            perm[:bump] = np.concatenate(idx_parts)
        self.codes = ops.compact_codes(self.codes, perm)
        for r, off, bucket in new_off:
            self._row_off[r] = off
            self._row_cap[r] = bucket
        self._bump = bump
        self._free = {}
        self.live_codes = bump
        self.compactions += 1
        self.last_compaction_occupancy = bump / max(new_cap, 1)

    def compact_if_sparse(self, occupancy_threshold: float, *,
                          reserve: int = 0) -> bool:
        """Compact when occupancy fell below ``occupancy_threshold`` AND
        the slab would shrink to at most half its size."""
        if occupancy_threshold <= 0.0:
            return False
        if self.occupancy >= occupancy_threshold:
            return False
        new_cap = _round_capacity(max(self._tight_mass() + reserve, 1))
        if new_cap > self.capacity // 2:
            return False
        self.compact(reserve=reserve)
        return True
