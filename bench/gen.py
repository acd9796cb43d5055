"""Transaction generators of the benchmark, its own, so that a change to
the program cannot change the data the benchmark mines.

A configuration file names a generator, its parameters and the seed of
its database (``data_seed``).  A run's ``--seed`` then shuffles that
database: it permutes the transactions and relabels the items.  So every
seed mines the same sizes (the same supports, itemsets and lattice up to
ties) on other bitmaps, and the same seed always gives the same input.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

BatchStream = Iterator[Tuple[np.ndarray, np.ndarray]]


def powerlaw_stream(*, n_trans: int, n_items: int, avg_trans_len: float,
                    alpha: float, seed: int, batch: int) -> BatchStream:
    """Kosarak-family baskets: Poisson lengths of mean ``avg_trans_len``
    (at least 1, at most ``3 * mean + 8`` and ``n_items``), each basket
    that many distinct items drawn one after another with Zipf
    popularity of exponent ``alpha``, an item already in the basket
    drawn again being skipped (successive sampling without replacement).
    The mean number of distinct items a basket is the mean length."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, n_items + 1) ** alpha
    pop /= pop.sum()
    cap = max(4, int(avg_trans_len * 3) + 8)
    for lo in range(0, n_trans, batch):
        b = min(batch, n_trans - lo)
        lens = np.clip(rng.poisson(avg_trans_len, b), 1, min(cap, n_items))
        items = rng.choice(n_items, size=(b, cap), p=pop)
        first = _first_seen(items)
        short = np.flatnonzero(first.sum(axis=1) < lens)
        while short.size:
            # Rows whose draws repeat so often that they hold fewer
            # distinct items than their length: draw them again, longer.
            more = rng.choice(n_items, size=(short.size, 4 * cap), p=pop)
            f = _first_seen(more)
            k = np.argsort(~f, axis=1, kind="stable")[:, :cap]
            items[short] = np.take_along_axis(more, k, axis=1)
            first[short] = np.take_along_axis(f, k, axis=1)
            short = short[first[short].sum(axis=1) < lens[short]]
        mask = first & (np.cumsum(first, axis=1) <= lens[:, None])
        yield items, mask


def _first_seen(items: np.ndarray) -> np.ndarray:
    """True where a row's entry is its item's first occurrence."""
    order = np.argsort(items, axis=1, kind="stable")
    s = np.take_along_axis(items, order, axis=1)
    first_sorted = np.ones(s.shape, bool)
    first_sorted[:, 1:] = s[:, 1:] != s[:, :-1]
    first = np.empty_like(first_sorted)
    np.put_along_axis(first, order, first_sorted, axis=1)
    return first


STREAMS = {"powerlaw": powerlaw_stream}
# The configuration keys each generator takes.
PARAMS = {"powerlaw": ("n_trans", "n_items", "avg_trans_len", "alpha")}


class Transactions:
    """One generated database: ``items[t, :]`` where ``mask[t, :]`` holds
    the items of transaction ``t`` (distinct)."""

    def __init__(self, items: np.ndarray, mask: np.ndarray):
        self.items = items
        self.mask = mask

    @property
    def n_trans(self) -> int:
        return int(self.items.shape[0])

    def as_lists(self) -> List[List[int]]:
        """Each transaction as a list of item ids, in drawn order."""
        return [row[m].tolist() for row, m in zip(self.items, self.mask,
                                                  strict=True)]


def draw(config: dict) -> Transactions:
    """The database a configuration describes: its generator
    (``generator``) drawn from ``data_seed`` in batches of ``batch``."""
    name = config["generator"]
    params = {k: config[k] for k in PARAMS[name] if k in config}
    stream = STREAMS[name](seed=int(config["data_seed"]),
                           batch=int(config["batch"]), **params)
    items, masks = zip(*stream, strict=True)
    return Transactions(np.concatenate(items).astype(np.int32),
                        np.concatenate(masks))


def generate(config: dict, seed: int) -> Transactions:
    """A run's input: the configuration's database shuffled by ``seed``."""
    return shuffle(draw(config), seed)


def shuffle(tx: Transactions, seed: int) -> Transactions:
    """Permute the transactions and relabel the items, from ``seed``."""
    rng = np.random.default_rng(int(seed) % 2**64)
    rows = rng.permutation(tx.n_trans)
    labels = rng.permutation(int(tx.items.max()) + 1).astype(np.int32)
    return Transactions(labels[tx.items[rows]], tx.mask[rows])


def absolute_minsup(rel: float, n_trans: int) -> int:
    """A relative minsup as a count of transactions (at least 1)."""
    return max(1, int(round(rel * n_trans)))
