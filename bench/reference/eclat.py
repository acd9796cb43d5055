"""Plain NumPy Eclat over packed TID bitsets: the exact itemset -> support
map, and the words the paper's scheme needs to produce it.

Packing (:func:`pack`): bit ``t % 32`` of 32-bit word ``t // 32`` of an
item's row is set iff transaction ``t`` holds the item; rows are padded
to whole blocks of ``block_words`` words.  The frequent items are taken
in the scheme's order: support ascending, ties by ``repr`` of the item.

Mining (:func:`mine`): depth-first over equivalence classes; a class's
members are tidsets ``T(Px)`` and each pair ``x < y`` gives
``T(Pxy) = T(Px) & T(Py)``.  Supports are summed per block, so the
same walk also yields the needed-word count of :func:`mine`'s
``scheme`` argument:

* ``"eclat"``: a pair reads its operands word by word until the bound
  ``count + min(rest of T(Px), rest of T(Py))`` falls below minsup (the
  word at which it falls is read), or whole if it never does;
* ``"declat"``: the operands are diffsets (from level 2 on; the root
  class reads the tidsets ``T(x)``, ``T(y)``), the difference is
  ``d(Pxy) = d(Py) & ~d(Px)`` and the bound ``sup(Px) - |d(Pxy)|``; a
  word where the minuend ``U`` has no bits cannot change the count, so
  neither operand's word is counted there.

A class head's operand ``T(Px)`` (or ``d(Px)``), which its pairs
share, is counted once, at the words any of them reads; each partner
``T(Py)`` (or ``d(Py)``) at the words its own pair reads.  Each frequent
candidate writes one child row (the whole row).  The count is at word
granularity, so an implementation that checks at block granularity and
reads each pair's partner for that pair moves no less; compaction and
the upload of level-1 rows are not counted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

WORD_BITS = 32
ItemsetSupports = Dict[FrozenSet[int], int]

_LUT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def popcount(x: np.ndarray) -> np.ndarray:
    """Set bits of each unsigned word (any width), as small integers."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x)
    x = np.ascontiguousarray(x)
    b = _LUT[x.view(np.uint8)]
    return b.reshape(x.shape + (x.dtype.itemsize,)).sum(-1, dtype=np.uint8)


@dataclass
class PackedDB:
    """Frequent items of one database as bitsets, in the scheme's order."""

    labels: List[int]          # row -> item id
    rows: np.ndarray           # uint64 (n_items, n_blocks * block_words / 2)
    supports: np.ndarray       # int64 (n_items,)
    n_trans: int
    block_words: int

    @property
    def n_blocks(self) -> int:
        return self.rows.shape[1] * 2 // self.block_words

    @property
    def row_words(self) -> int:
        """32-bit words in one row."""
        return self.rows.shape[1] * 2


def pack(items: np.ndarray, mask: np.ndarray, minsup: int,
         block_words: int) -> PackedDB:
    """Bitsets of the items with support >= ``minsup``; transaction ``t``
    holds ``items[t, mask[t]]`` (a repeat counts once)."""
    if block_words % 2:
        raise ValueError("block_words must be even (rows are 64-bit)")
    n_trans = int(items.shape[0])
    tids = np.broadcast_to(np.arange(n_trans, dtype=np.int64)[:, None],
                           items.shape)[mask]
    its = items[mask].astype(np.int64)
    n_univ = int(its.max()) + 1 if its.size else 1
    pairs = np.unique(tids * n_univ + its)
    tid, item = pairs // n_univ, pairs % n_univ
    sup = np.bincount(item, minlength=n_univ)
    freq = np.flatnonzero(sup >= minsup)
    order = sorted(freq.tolist(), key=lambda i: (int(sup[i]), repr(i)))
    row_of = np.full(n_univ, -1, np.int64)
    row_of[order] = np.arange(len(order))
    r = row_of[item]
    keep = r >= 0
    r, tid = r[keep], tid[keep]
    n_blocks = max(1, -(-n_trans // (block_words * WORD_BITS)))
    rows = np.zeros((len(order), n_blocks * block_words * 4), np.uint8)
    np.bitwise_or.at(rows, (r, tid >> 3),
                     (np.uint8(1) << (tid & 7).astype(np.uint8)))
    return PackedDB(labels=order, rows=rows.view(np.uint64),
                    supports=sup[order].astype(np.int64), n_trans=n_trans,
                    block_words=block_words)


def _block_counts(x: np.ndarray, n_blocks: int) -> np.ndarray:
    """Per-block popcounts ``(k, n_blocks)`` of ``k`` uint64 rows."""
    return popcount(x).reshape(x.shape[0], n_blocks, -1).sum(
        axis=2, dtype=np.int64)


def _block_words32(row: np.ndarray, n_blocks: int) -> np.ndarray:
    """One uint64 row as ``(n_blocks, block_words)`` 32-bit words."""
    return row.view(np.uint32).reshape(n_blocks, -1)


def _first_true(a: np.ndarray) -> np.ndarray:
    """Index of the first True of each row (rows are known to have one)."""
    return np.argmax(a, axis=1)


def _before(cum: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``cum[k, b[k] - 1]``, or 0 where ``b[k] == 0``."""
    prev = cum[np.arange(cum.shape[0]), np.maximum(b - 1, 0)]
    return np.where(b > 0, prev, 0)


class _Walk:
    """One depth-first Eclat walk at one minsup."""

    def __init__(self, db: PackedDB, minsup: int, scheme: Optional[str],
                 early_stop: bool):
        if scheme not in (None, "eclat", "declat"):
            raise ValueError(f"no word count for scheme {scheme!r}")
        self.db = db
        self.minsup = int(minsup)
        self.scheme = scheme
        self.early_stop = early_stop
        self.out: ItemsetSupports = {}
        self.shared_words = 0
        self.partner_words = 0
        self.child_words = 0

    def run(self) -> None:
        db = self.db
        for lab, s in zip(db.labels, db.supports, strict=True):
            self.out[frozenset((lab,))] = int(s)
        pc = _block_counts(db.rows, db.n_blocks) if db.rows.size else None
        if len(db.labels) > 1:
            self._class((), None, db.rows, db.supports, db.labels, pc)

    def _class(self, prefix: Tuple[int, ...], tp: Optional[np.ndarray],
               rows: np.ndarray, sups: np.ndarray, labels: List[int],
               pc: np.ndarray) -> None:
        """Mine the class of prefix ``prefix``; ``tp`` is the row
        ``T(prefix)`` (None at the root) and ``pc`` the members' block
        counts."""
        m = len(labels)
        nb = self.db.n_blocks
        for i in range(m - 1):
            z = rows[i] & rows[i + 1:]
            pcz = _block_counts(z, nb)
            sup = pcz.sum(axis=1)
            freq = sup >= self.minsup
            if self.scheme is not None:
                self._count(i, rows, sups, pc, pcz, freq, tp)
            if not freq.any():
                continue
            head = prefix + (labels[i],)
            kids = [labels[i + 1 + j] for j in np.flatnonzero(freq)]
            for lab, s in zip(kids, sup[freq], strict=True):
                self.out[frozenset(head + (lab,))] = int(s)
            if len(kids) > 1:
                self._class(head, rows[i], z[freq], sup[freq], kids,
                            pcz[freq])

    def _count(self, i: int, rows: np.ndarray, sups: np.ndarray,
               pc: np.ndarray, pcz: np.ndarray, freq: np.ndarray,
               tp: Optional[np.ndarray]) -> None:
        """Add the words the pairs ``(i, j > i)`` of one class need."""
        db, minsup = self.db, self.minsup
        nb, bw, n_words = db.n_blocks, db.block_words, db.row_words
        js = np.arange(i + 1, rows.shape[0])
        self.child_words += int(freq.sum()) * n_words
        if self.scheme == "eclat":
            # Every word up to the abort counts.
            nonzero = None
            cum_a = np.cumsum(pc[i])
            cum_b = np.cumsum(pc[js], axis=1)
            cum = np.cumsum(pcz, axis=1)
            bound = cum + np.minimum(sups[i] - cum_a, sups[js, None] - cum_b)
        else:
            # The minuend U is T(x) at the root and d(Py) = T(P) & ~T(Py)
            # below it; only its nonzero words count.  d(Pxy) per block
            # is |T(Px) & ~T(Py)| either way.
            u = rows[i][None] if tp is None else tp & ~rows[js]
            nonzero = u.view(np.uint32) != 0            # (1 or pairs, words)
            cum = np.cumsum(pc[i] - pcz, axis=1)
            bound = sups[i] - cum
        fail = bound < minsup
        dies = fail.any(axis=1) if self.early_stop else np.zeros_like(freq)
        # The last word each pair reads: the whole row, or for a dying
        # pair the word of its failing block at which the bound falls.
        stop = np.full(js.size, n_words - 1)
        k = np.flatnonzero(dies)
        if k.size:
            b = _first_true(fail[k])
            a32 = _block_words32(rows[i], nb)[b]                # (k, bw)
            b32 = np.stack([_block_words32(rows[j], nb)[bb]
                            for j, bb in zip(js[k], b, strict=True)])
            if self.scheme == "eclat":
                wz = np.cumsum(popcount(a32 & b32), axis=1, dtype=np.int64)
                wa = np.cumsum(popcount(a32), axis=1, dtype=np.int64)
                wb = np.cumsum(popcount(b32), axis=1, dtype=np.int64)
                start_a = sups[i] - _before(np.broadcast_to(
                    cum_a, (k.size, nb)), b)
                start_b = sups[js[k]] - _before(cum_b[k], b)
                wbound = (_before(cum[k], b)[:, None] + wz
                          + np.minimum(start_a[:, None] - wa,
                                       start_b[:, None] - wb))
            else:
                wd = np.cumsum(popcount(a32 & ~b32), axis=1, dtype=np.int64)
                wbound = sups[i] - _before(cum[k], b)[:, None] - wd
            stop[k] = b * bw + _first_true(wbound < minsup)
        # Each partner T(Py) (or d(Py)) is read up to its own pair's
        # stop; the shared T(Px) (or d(Px)) once, where any pair reads it.
        if nonzero is None:
            self.partner_words += int((stop + 1).sum())
            self.shared_words += int(stop.max()) + 1
        else:
            need = nonzero & (np.arange(n_words)[None, :] <= stop[:, None])
            self.partner_words += int(need.sum())
            self.shared_words += int(need.any(axis=0).sum())


@dataclass
class WordCount:
    """The 32-bit words a scheme needs at one minsup."""

    shared: int        # each class head's operand, once for its pairs
    partner: int       # each pair's other operand, up to its abort
    child: int         # one child row a frequent candidate

    @property
    def total(self) -> int:
        return self.shared + self.partner + self.child


def mine(db: PackedDB, minsup: int, scheme: Optional[str] = None,
         early_stop: bool = True
         ) -> Tuple[ItemsetSupports, Optional[WordCount]]:
    """The exact itemset -> support map of ``db`` at ``minsup`` (the rows
    must be packed at a minsup no higher), and, given a ``scheme``, the
    32-bit words it needs (``early_stop=False``: every candidate reads
    its whole operands)."""
    keep = np.flatnonzero(db.supports >= minsup)
    sub = PackedDB(labels=[db.labels[r] for r in keep], rows=db.rows[keep],
                   supports=db.supports[keep], n_trans=db.n_trans,
                   block_words=db.block_words)
    walk = _Walk(sub, minsup, scheme, early_stop)
    walk.run()
    words = (WordCount(walk.shared_words, walk.partner_words,
                       walk.child_words) if scheme is not None else None)
    return walk.out, words
