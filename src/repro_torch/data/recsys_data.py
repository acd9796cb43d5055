"""Synthetic two-tower interaction data (port of the matching part of
``repro.data.recsys_data``): Zipfian popularity.  Pure numpy, byte
identical to the JAX package's for the same seed."""

from __future__ import annotations

from typing import Dict

import numpy as np


def _zipf(rng, n: int, size, alpha: float = 1.2) -> np.ndarray:
    # inverse-CDF Zipf over [0, n): cheap and vectorised
    u = rng.random(size)
    return np.minimum((u ** (-1.0 / (alpha - 1.0)) - 1.0).astype(np.int64),
                      n - 1) % n


def twotower_batch(rng_seed: int, batch: int, n_users: int, n_items: int,
                   hist_len: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(rng_seed)
    user = rng.integers(0, n_users, (batch,)).astype(np.int32)
    hist = _zipf(rng, n_items, (batch, hist_len)).astype(np.int32)
    hlen = rng.integers(1, hist_len + 1, (batch,))
    mask = (np.arange(hist_len)[None, :] < hlen[:, None])
    pos = _zipf(rng, n_items, (batch,)).astype(np.int32)
    # logQ correction: Zipf sampling probability of each positive
    ranks = pos.astype(np.float64) + 1
    q = ranks ** -1.2
    logq = np.log(q / q.sum() * batch).astype(np.float32)
    return {"user_id": user, "hist_ids": hist, "hist_mask": mask,
            "pos_item": pos, "item_logq": logq}
