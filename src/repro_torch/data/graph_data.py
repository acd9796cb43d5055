"""Graph data (a copy of the numpy-only ``repro.data.graph_data``, byte-
identical per seed): synthetic power-law graphs + a real uniform neighbor
sampler.

``minibatch_lg`` (Reddit-scale sampled training) needs an actual neighbor
sampler, not a stub: ``NeighborSampler`` builds a CSR adjacency once and
draws uniform fanout samples per minibatch (GraphSAGE's training regime),
padding with self-loops where degree < fanout and emitting validity masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class SynthGraph:
    x: np.ndarray          # (N, F) float32
    edge_src: np.ndarray   # (E,) int32
    edge_dst: np.ndarray   # (E,) int32
    labels: np.ndarray     # (N,) int32


def gen_powerlaw_graph(n_nodes: int, avg_degree: float, d_feat: int,
                       n_classes: int, seed: int = 0,
                       alpha: float = 1.5) -> SynthGraph:
    """Degree-skewed random graph with label-correlated features."""
    rng = np.random.default_rng(seed)
    w = (rng.pareto(alpha, n_nodes) + 0.1)
    p = w / w.sum()
    n_edges = int(n_nodes * avg_degree)
    src = rng.choice(n_nodes, size=n_edges, p=p).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    labels = rng.integers(0, n_classes, size=n_nodes).astype(np.int32)
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    x = (centers[labels] + rng.normal(scale=2.0, size=(n_nodes, d_feat))
         ).astype(np.float32)
    return SynthGraph(x=x, edge_src=src, edge_dst=dst, labels=labels)


def gen_batched_molecules(n_graphs: int, n_nodes: int, n_edges: int,
                          d_feat: int, n_classes: int, seed: int = 0,
                          ) -> SynthGraph:
    """Disjoint union of ``n_graphs`` small graphs (the ``molecule`` shape)."""
    rng = np.random.default_rng(seed)
    srcs: List[np.ndarray] = []
    dsts: List[np.ndarray] = []
    for g in range(n_graphs):
        base = g * n_nodes
        srcs.append(rng.integers(0, n_nodes, n_edges).astype(np.int32) + base)
        dsts.append(rng.integers(0, n_nodes, n_edges).astype(np.int32) + base)
    N = n_graphs * n_nodes
    labels = rng.integers(0, n_classes, N).astype(np.int32)
    x = rng.normal(size=(N, d_feat)).astype(np.float32)
    return SynthGraph(x=x, edge_src=np.concatenate(srcs),
                      edge_dst=np.concatenate(dsts), labels=labels)


class NeighborSampler:
    """Uniform fanout sampling over a CSR adjacency (GraphSAGE §3.1).

    For each seed node: f1 neighbors; for each of those: f2 neighbors.
    Nodes with degree < fanout are padded by repeating sampled neighbors
    (standard GraphSAGE practice: sample WITH replacement); isolated nodes
    fall back to self-loops with mask=0."""

    def __init__(self, edge_src: np.ndarray, edge_dst: np.ndarray,
                 n_nodes: int, seed: int = 0):
        order = np.argsort(edge_dst, kind="stable")
        self.nbr = edge_src[order]
        counts = np.bincount(edge_dst, minlength=n_nodes)
        self.offsets = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=self.offsets[1:])
        self.n_nodes = n_nodes
        self.rng = np.random.default_rng(seed)

    def sample_hop(self, nodes: np.ndarray, fanout: int,
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """nodes (...,) -> (neighbors (..., fanout), mask (..., fanout))."""
        flat = nodes.reshape(-1)
        deg = (self.offsets[flat + 1] - self.offsets[flat])
        has = deg > 0
        # uniform with replacement
        r = self.rng.integers(0, np.maximum(deg, 1),
                              size=(fanout, flat.size))
        idx = self.offsets[flat][None, :] + r
        nbrs = np.where(has[None, :], self.nbr[idx % len(self.nbr)],
                        flat[None, :])
        mask = np.broadcast_to(has[None, :], nbrs.shape)
        nbrs = nbrs.T.reshape(nodes.shape + (fanout,)).astype(np.int32)
        mask = mask.T.reshape(nodes.shape + (fanout,))
        return nbrs, mask

    def sample_batch(self, seeds: np.ndarray, fanouts: Tuple[int, int],
                     x: np.ndarray,
                     ) -> Tuple[Tuple[np.ndarray, ...],
                                Tuple[np.ndarray, ...]]:
        """Returns (feats, masks) matching models.gnn.forward_sampled."""
        f1, f2 = fanouts
        h1, m1 = self.sample_hop(seeds, f1)              # (B, f1)
        h2, m2 = self.sample_hop(h1, f2)                 # (B, f1, f2)
        feats = (x[seeds], x[h1], x[h2])
        return feats, (m1, m2)
