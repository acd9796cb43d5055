"""Bitmap vertical format for TID-lists (port of ``repro.core.bitmap``).

Every TID-list is a packed bitmap row, so intersection is ``AND`` +
popcount and the early-stopping criterion is evaluated per *block* of
``block_words`` words against per-row suffix popcount tables.

Layout
------
Host (``BitmapDB``, packing, the state carried across from the JAX
package): ``bitmaps uint32[n_items, n_blocks, block_words]``, exactly the
reference layout — bit ``b`` of word ``w`` of block ``k`` of row ``i`` is
set iff transaction ``(k*block_words + w) * 32 + b`` contains item ``i``.

Device (``core.rowstore.DeviceRowStore``): the same bits stored as
**int32** (``np.ndarray.view(np.int32)``).  Torch's ``uint32`` lacks
``~``, ``>>``, ``-``, ``index_select`` and ``index_put_`` on the CPU, so
the slabs use int32 and treat the bits as unsigned; :func:`popcount32`
masks to 32 bits before its shifts because int32 ``>>`` is arithmetic.

``suffix int32[n_rows, n_blocks + 1]``: ``suffix[i, k]`` is the popcount
of row ``i`` from block ``k`` on; ``suffix[i, 0]`` is the support and
``suffix[i, n_blocks]`` is 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, List, Sequence

import numpy as np
import torch

WORD_BITS = 32
DEFAULT_BLOCK_WORDS = 128  # 4096 TIDs per block.

# Padding sentinel of N-list ``pre`` values and of unmatched ``out_slot``
# entries (the N-list pool, ``kernels.ref`` and ``csrc/nlist_merge.cu``).
NL_SENTINEL = np.iinfo(np.int32).max

# Bucketed N-list lengths: pool extents and gather widths are padded to
# these; past the largest, sizes go up in powers of two.
NL_LEN_BUCKETS = (8, 32, 128, 512, 2048, 8192, 32768)

# Pair-chunk width buckets, one table per dispatch family: ``pair_chunk``
# is clamped to the largest and autotuned widths (``chunk_width_for``)
# are taken from the table.
PAIR_CHUNK_BUCKETS = (64, 256, 1024, 4096, 16384, 65536, 262144)
NL_PAIR_CHUNK_BUCKETS = (64, 256, 1024, 4096, 8192, 32768)

# Reference per-pair operand sizes the ``pair_chunk`` knob is understood
# to be tuned at (see chunk_width_for): a bitmap pair of 8 blocks x 128
# words (the smoke shape), an N-list pair whose longest operand sits in
# the 128-length bucket.
BITMAP_REF_ROW_WORDS = 1024
NL_REF_LEN = 128


def chunk_width_for(words_per_pair: int, base_chunk: int,
                    bucket_table: Sequence[int], ref_words: int) -> int:
    """Largest bucket ``w`` with ``w * words_per_pair <= base_chunk *
    ref_words``, floored at ``base_chunk`` (snapped into the table):
    autotuning only widens small-operand chunks, so ``device_calls`` can
    never increase relative to the un-autotuned engine."""
    budget = max(1, int(base_chunk)) * max(1, int(ref_words))
    width = 0
    for b in bucket_table:
        if b * max(1, int(words_per_pair)) <= budget:
            width = b
    floor = min(int(base_chunk), bucket_table[-1])
    return max(width, floor)


def nl_pad_len(n: int) -> int:
    """Smallest N-list bucket >= ``n`` (power-of-two fallback past the
    largest tuned bucket)."""
    for b in NL_LEN_BUCKETS:
        if n <= b:
            return b
    b = NL_LEN_BUCKETS[-1]
    while b < n:
        b *= 2
    return b


def nl_pad_len_np(lengths: np.ndarray) -> np.ndarray:
    """Vectorized :func:`nl_pad_len` (host): the per-pair length-bucket
    key the frontier scheduler sorts N-list pairs by."""
    lengths = np.asarray(lengths, np.int64)
    buckets = np.asarray(NL_LEN_BUCKETS, np.int64)
    idx = np.searchsorted(buckets, np.maximum(lengths, 0))
    out = buckets[np.minimum(idx, len(buckets) - 1)]
    big = lengths > buckets[-1]
    if big.any():
        out = out.copy()
        out[big] = [nl_pad_len(int(v)) for v in lengths[big]]
    return out


def bucket_pad(arr: np.ndarray, n: int, bucket_sizes: Sequence[int],
               fill=0) -> np.ndarray:
    """Pad ``arr`` (first ``n`` entries valid) to the smallest bucket >= n.
    Callers drop results past ``n``.  The JAX engine pads every pair
    chunk this way to bound its jit cache; the port's eager launches take
    any width, so its miner sends chunks unpadded."""
    for b in bucket_sizes:
        if n <= b:
            if n == b:
                return arr
            pad_shape = (b - n,) + arr.shape[1:]
            return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)])
    raise ValueError(f"batch of {n} exceeds largest bucket "
                     f"{max(bucket_sizes)}")


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of 32-bit words held in an int32 (or any
    integer) tensor; returns int32.  The words are widened to int64 and
    masked to their low 32 bits first, so words with bit 31 set count
    right despite int32's arithmetic ``>>``."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24).bitwise_and_(0xFF).to(torch.int32)


def popcount32_np(x: np.ndarray) -> np.ndarray:
    """Host-side popcount of uint32 words (returns int32)."""
    x = x.astype(np.uint32)
    x = x - ((x >> 1) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
    x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> 24).astype(np.int32)


def pack_tidlists(tidlists: Sequence[Sequence[int]], n_trans: int,
                  block_words: int = DEFAULT_BLOCK_WORDS,
                  ) -> np.ndarray:
    """Pack 0-based TID lists into ``uint32[n_rows, n_blocks, block_words]``."""
    n_rows = len(tidlists)
    n_words = -(-n_trans // WORD_BITS)
    n_blocks = max(1, -(-n_words // block_words))
    flat = np.zeros((n_rows, n_blocks * block_words), dtype=np.uint32)
    for r, tids in enumerate(tidlists):
        if len(tids) == 0:
            continue
        t = np.asarray(tids, dtype=np.int64)
        if t.min() < 0 or t.max() >= n_trans:
            raise ValueError("TID out of range")
        np.bitwise_or.at(flat[r], t // WORD_BITS,
                         np.uint32(1) << (t % WORD_BITS).astype(np.uint32))
    return flat.reshape(n_rows, n_blocks, block_words)


def unpack_row(row: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_tidlists` for one row -> sorted 0-based TIDs.
    Accepts uint32 or int32 words (the device layout)."""
    flat = np.ascontiguousarray(row).reshape(-1).view(np.uint32)
    bits = np.unpackbits(flat.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.int64)


def suffix_popcounts_np(bitmaps: np.ndarray) -> np.ndarray:
    """``int32[n_rows, n_blocks+1]`` suffix popcount table (host)."""
    per_block = popcount32_np(bitmaps).sum(axis=-1)          # (rows, blocks)
    n_rows, n_blocks = per_block.shape
    out = np.zeros((n_rows, n_blocks + 1), dtype=np.int32)
    out[:, :-1] = per_block[:, ::-1].cumsum(axis=1)[:, ::-1]
    return out


def suffix_popcounts(bitmaps: torch.Tensor) -> torch.Tensor:
    """Torch version of :func:`suffix_popcounts_np` for int32 rows
    ``(n_rows, n_blocks, block_words)``; returns int32 ``(n_rows,
    n_blocks + 1)`` on the rows' device (``cumsum`` widens to int64, so
    the table is cast back)."""
    per_block = popcount32(bitmaps).sum(dim=-1)               # int64
    rev = per_block.flip(1).cumsum(dim=1).flip(1)
    zeros = torch.zeros((bitmaps.shape[0], 1), dtype=rev.dtype,
                        device=bitmaps.device)
    return torch.cat([rev, zeros], dim=1).to(torch.int32)


@dataclass
class BitmapDB:
    """A transaction database packed for device mining.

    Rows are the frequent 1-itemsets in *increasing* frequency (the
    Eclat search order from the paper §II-A).  ``bitmaps`` is host
    ``uint32``; the row store views it as int32 when it uploads it.
    """

    items: List[Hashable]                 # row -> original item
    bitmaps: np.ndarray                   # uint32 (n_items, n_blocks, bw)
    supports: np.ndarray                  # int32 (n_items,)
    n_trans: int
    minsup: int
    block_words: int

    @property
    def n_items(self) -> int:
        return len(self.items)

    @property
    def n_blocks(self) -> int:
        return self.bitmaps.shape[1]

    @classmethod
    def from_db(cls, db: Sequence[Sequence[Hashable]], minsup: int,
                block_words: int = DEFAULT_BLOCK_WORDS) -> "BitmapDB":
        from .oracle import frequent_items_ascending

        items = frequent_items_ascending(db, minsup)
        index: Dict[Hashable, int] = {it: r for r, it in enumerate(items)}
        tidlists: List[List[int]] = [[] for _ in items]
        for tid, t in enumerate(db):
            for it in set(t):
                r = index.get(it)
                if r is not None:
                    tidlists[r].append(tid)
        bitmaps = pack_tidlists(tidlists, max(len(db), 1), block_words)
        supports = np.array([len(t) for t in tidlists], dtype=np.int32)
        return cls(items=items, bitmaps=bitmaps, supports=supports,
                   n_trans=len(db), minsup=minsup, block_words=block_words)

    @classmethod
    def from_arrays(cls, items: Sequence[Hashable], bitmaps: np.ndarray,
                    supports: np.ndarray, n_trans: int, minsup: int,
                    block_words: int) -> "BitmapDB":
        """Build from plain arrays — e.g. the fields of a JAX
        ``repro.core.bitmap.BitmapDB`` — checking shapes and types."""
        bitmaps = np.asarray(bitmaps)
        if bitmaps.dtype != np.uint32 or bitmaps.ndim != 3:
            raise ValueError("bitmaps must be uint32 (n_items, n_blocks, "
                             f"block_words), got {bitmaps.dtype} "
                             f"{bitmaps.shape}")
        if bitmaps.shape[0] != len(items) or bitmaps.shape[2] != block_words:
            raise ValueError(f"bitmaps shape {bitmaps.shape} does not match "
                             f"{len(items)} items x block_words={block_words}")
        supports = np.asarray(supports, np.int32)
        if supports.shape != (len(items),):
            raise ValueError(f"supports shape {supports.shape} does not "
                             f"match {len(items)} items")
        return cls(items=list(items), bitmaps=np.ascontiguousarray(bitmaps),
                   supports=supports, n_trans=int(n_trans),
                   minsup=int(minsup), block_words=int(block_words))

    def to_arrays(self) -> Dict[str, object]:
        """The fields as plain values (``bitmaps`` uint32, ``supports``
        int32): the keyword arguments of :meth:`from_arrays` and of the
        JAX ``BitmapDB`` constructor."""
        return dict(items=list(self.items),
                    bitmaps=self.bitmaps.astype(np.uint32, copy=False),
                    supports=self.supports.astype(np.int32, copy=False),
                    n_trans=self.n_trans, minsup=self.minsup,
                    block_words=self.block_words)
