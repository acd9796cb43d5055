"""Kosarak-family baskets: Poisson lengths of mean ``avg_trans_len`` (at
least 1, at most ``3 * mean + 8`` and ``n_items``), each basket that
many distinct items drawn one after another with Zipf popularity of
exponent ``alpha``, an item already in the basket drawn again being
skipped (successive sampling without replacement).  The mean number of
distinct items a basket is the mean length."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

# The configuration keys the generator takes (``seed`` and ``batch``
# come from ``data_seed`` and ``batch``).
PARAMS = ("n_trans", "n_items", "avg_trans_len", "alpha")


def stream(*, n_trans: int, n_items: int, avg_trans_len: float,
           alpha: float, seed: int, batch: int
           ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Batches ``(items, mask)`` of at most ``batch`` baskets: a basket's
    items are ``items[t][mask[t]]``."""
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
