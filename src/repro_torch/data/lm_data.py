"""Synthetic LM token pipeline (a copy of ``repro.data.lm_data``, which
is numpy-only: the port imports nothing of the JAX package).

Deterministic Zipfian token stream with Markov bigram structure so the
loss actually decreases during the example training runs (pure uniform
noise would pin the loss at log V).  Sharding-aware: every host can
regenerate any global batch from (seed, step) alone — that is the
straggler/elasticity story for the data layer (no data server to fail
over; restarts are pure recomputation).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class LMDataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_alpha: float = 1.1
    bigram_weight: float = 0.7   # probability mass following the bigram map


class SyntheticLM:
    """token[t+1] ~ bigram(token[t]) w.p. ``bigram_weight`` else Zipf."""

    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._zipf = (ranks ** -cfg.zipf_alpha)
        self._zipf /= self._zipf.sum()
        # a fixed random permutation as the bigram successor map
        self._succ = rng.permutation(v).astype(np.int64)

    def batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens, labels) of shape (batch, seq_len), labels are
        next-token ids (last label wraps; masked value -1 never emitted)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.batch, cfg.seq_len, cfg.vocab_size
        out = np.empty((B, S + 1), np.int64)
        out[:, 0] = rng.choice(V, size=B, p=self._zipf)
        noise = rng.random((B, S))
        fresh = rng.choice(V, size=(B, S), p=self._zipf)
        for t in range(S):
            follow = self._succ[out[:, t]]
            out[:, t + 1] = np.where(noise[:, t] < cfg.bigram_weight,
                                     follow, fresh[:, t])
        tokens = out[:, :-1].astype(np.int32)
        labels = out[:, 1:].astype(np.int32)
        return tokens, labels

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
