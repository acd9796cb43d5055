"""The benchmark's databases, drawn by its own generators
(``bench/generators/``), so that a change to the program cannot change
the data the benchmark mines.

A configuration file names a generator, its parameters and the seed of
its database (``data_seed``).  Generator ``<name>`` is
``bench/generators/<name>.py``, a module with ``PARAMS`` (the
configuration keys it takes) and ``stream(*, seed, batch, **params)``,
which yields ``(items, mask)`` batches, so a new database family is a
new file.  A run's ``--seed`` then shuffles that
database: it permutes the transactions and relabels the items.  So every
seed mines the same sizes (the same supports, itemsets and lattice up to
ties) on other bitmaps, and the same seed always gives the same input.
"""

from __future__ import annotations

from typing import List

import numpy as np

from bench import byname


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
    family = byname.load("generators", config["generator"])
    params = {k: config[k] for k in family.PARAMS if k in config}
    stream = family.stream(seed=int(config["data_seed"]),
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
