"""Dense tabular records: the family of accidents.dat, pumsb, connect and
chess, where each record gives one value to each of its columns.

A record has ``n_cols`` columns: the first ``n_mandatory`` in every
record, each other one present with probability ``p_optional``.  The
``n_items`` values are split over the columns as evenly as the count
allows (the first ``n_items % n_cols`` columns hold one value more), and
an item is one value of one column, so a record's items are distinct.

Columns are correlated through a latent class: each record draws one of
``n_classes`` classes, uniformly, and each of its present columns takes
its class's value with probability ``rho`` and otherwise draws a value
from the column's weights, independently of the other columns given the
class.  A column's weights are Pareto-skewed (one plus a Lomax draw of
shape ``shape`` a value, normalised) with a share ``floor`` spread
evenly over its values, so that every value has a weight of at least
``floor`` over the column's count of values; each class's value of a
column is one draw from the same weights.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

# The configuration keys the generator takes (``seed`` and ``batch``
# come from ``data_seed`` and ``batch``).
PARAMS = ("n_trans", "n_items", "n_cols", "n_mandatory", "p_optional",
          "n_classes", "rho", "shape", "floor")


def stream(*, n_trans: int, n_items: int, n_cols: int, n_mandatory: int,
           p_optional: float, n_classes: int, rho: float, shape: float,
           floor: float, seed: int, batch: int
           ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Batches ``(items, mask)`` of at most ``batch`` records, one entry a
    column: ``items[t, c]`` is column ``c``'s value as an item id and
    ``mask[t, c]`` whether the record has the column."""
    if not 0 < n_mandatory <= n_cols <= n_items:
        raise ValueError("need 0 < n_mandatory <= n_cols <= n_items")
    rng = np.random.default_rng(seed)
    n_vals = np.full(n_cols, n_items // n_cols)
    n_vals[: n_items % n_cols] += 1
    first = np.concatenate([[0], np.cumsum(n_vals)[:-1]])
    held = np.arange(n_vals.max())[None, :] < n_vals[:, None]
    skew = np.where(held, 1.0 + rng.pareto(shape, held.shape), 0.0)
    weights = ((1.0 - floor) * skew / skew.sum(axis=1, keepdims=True)
               + np.where(held, floor / n_vals[:, None], 0.0))
    cdf = np.cumsum(weights, axis=1)

    def values(u: np.ndarray) -> np.ndarray:
        """Each column's value at the uniform draws ``u[..., c]`` (a draw
        past the rounded total takes the column's last value)."""
        return np.minimum((u[..., None] >= cdf).sum(axis=-1), n_vals - 1)

    class_value = values(rng.random((n_classes, n_cols)))
    cols = np.arange(n_cols)
    for lo in range(0, n_trans, batch):
        b = min(batch, n_trans - lo)
        cls = rng.integers(n_classes, size=b)
        mask = (cols < n_mandatory) | (rng.random((b, n_cols)) < p_optional)
        tied = rng.random((b, n_cols)) < rho
        free = values(rng.random((b, n_cols)))
        val = np.where(tied, class_value[cls], free)
        yield first + val, mask
