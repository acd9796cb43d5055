"""Synthetic recsys interaction data (port of ``repro.data.recsys_data``):
Zipfian popularity, batches for SASRec, DIN, xDeepFM and the two-tower
model.  Pure numpy, byte identical to the JAX package's for the same
seed."""

from __future__ import annotations

from typing import Dict

import numpy as np


def _zipf(rng, n: int, size, alpha: float = 1.2) -> np.ndarray:
    # inverse-CDF Zipf over [0, n): cheap and vectorised
    u = rng.random(size)
    return np.minimum((u ** (-1.0 / (alpha - 1.0)) - 1.0).astype(np.int64),
                      n - 1) % n


def sasrec_batch(rng_seed: int, batch: int, seq_len: int, n_items: int,
                 n_neg: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(rng_seed)
    seq = (_zipf(rng, n_items - 1, (batch, seq_len)) + 1).astype(np.int32)
    # next-item targets: shifted sequence; negatives uniform
    pos = np.roll(seq, -1, axis=1)
    pos[:, -1] = (_zipf(rng, n_items - 1, (batch,)) + 1)
    neg = rng.integers(1, n_items, (batch, seq_len, n_neg)).astype(np.int32)
    return {"seq_ids": seq, "pos_ids": pos.astype(np.int32), "neg_ids": neg}


def din_batch(rng_seed: int, batch: int, seq_len: int, n_items: int,
              n_context: int, n_ctx_fields: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(rng_seed)
    hist = (_zipf(rng, n_items - 1, (batch, seq_len)) + 1).astype(np.int32)
    target = (_zipf(rng, n_items - 1, (batch,)) + 1).astype(np.int32)
    ctx = rng.integers(0, n_context, (batch, n_ctx_fields)).astype(np.int32)
    # clicks correlate with target popularity (low id = popular)
    p = 1.0 / (1.0 + target / (0.05 * n_items))
    labels = (rng.random(batch) < p).astype(np.float32)
    return {"hist_ids": hist, "target_id": target, "ctx_ids": ctx,
            "labels": labels}


def xdeepfm_batch(rng_seed: int, batch: int, n_fields: int,
                  vocab_per_field: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(rng_seed)
    ids = _zipf(rng, vocab_per_field, (batch, n_fields))
    offsets = np.arange(n_fields, dtype=np.int64) * vocab_per_field
    field_ids = (ids + offsets[None, :]).astype(np.int32)
    labels = (rng.random(batch) < 0.25).astype(np.float32)
    return {"field_ids": field_ids, "labels": labels}


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
