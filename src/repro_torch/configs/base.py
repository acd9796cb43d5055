"""Config schema (port of the matching part of ``repro.configs.base``):
architectures x input shapes.  The port keeps the LM, GNN and RecSys
shape sets, the families its ported archs belong to (dims padded as the
JAX package pads them, the unpadded source numbers kept alongside)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    shape_id: str
    kind: str                 # train | prefill | decode | serve | retrieval
                              # | train_full | train_sampled | mine
    dims: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str               # lm | gnn | recsys | fim
    source: str               # public citation from the assignment
    # config_fn(shape_id) -> model config (GNN models vary d_feat by shape)
    config_fn: Callable[[Optional[str]], Any]
    smoke_config_fn: Callable[[], Any]
    shape_ids: Tuple[str, ...]
    rules_override: Dict[str, Any] = dataclasses.field(default_factory=dict)
    notes: str = ""

    def skip_reason(self, shape_id: str) -> Optional[str]:
        """Brief rule: long_500k needs sub-quadratic attention; pure
        full-attention archs skip it."""
        if self.family == "lm" and shape_id == "long_500k":
            cfg = self.config_fn(shape_id)
            if getattr(cfg, "sliding_window", 0) == 0:
                return ("full-attention arch: 500k-token decode requires "
                        "sub-quadratic attention")
        return None


LM_SHAPES: Dict[str, ShapeDef] = {
    "train_4k": ShapeDef("train_4k", "train",
                         dict(seq=4096, global_batch=256, n_microbatches=8)),
    "prefill_32k": ShapeDef("prefill_32k", "prefill",
                            dict(seq=32768, batch=32)),
    "decode_32k": ShapeDef("decode_32k", "decode",
                           dict(kv_len=32768, batch=128)),
    "long_500k": ShapeDef("long_500k", "decode",
                          dict(kv_len=524288, batch=1)),
}

GNN_SHAPES: Dict[str, ShapeDef] = {
    # cora-like full batch (2708 nodes / 10556 edges padded to /32)
    "full_graph_sm": ShapeDef("full_graph_sm", "train_full",
                              dict(n_nodes=2816, n_edges=10752, d_feat=1433,
                                   n_classes=7, raw_nodes=2708,
                                   raw_edges=10556)),
    # reddit sampled training; assigned cell fanout is 15-10
    "minibatch_lg": ShapeDef("minibatch_lg", "train_sampled",
                             dict(batch_nodes=1024, fanouts=(15, 10),
                                  d_feat=602, n_classes=41,
                                  raw_nodes=232965, raw_edges=114615892)),
    "ogb_products": ShapeDef("ogb_products", "train_full",
                             dict(n_nodes=2449408, n_edges=61859840,
                                  d_feat=100, n_classes=47,
                                  raw_nodes=2449029, raw_edges=61859140)),
    # 128 small graphs as one disjoint union
    "molecule": ShapeDef("molecule", "train_full",
                         dict(n_nodes=3840, n_edges=8192, d_feat=32,
                              n_classes=16, batch_graphs=128,
                              nodes_per_graph=30, edges_per_graph=64)),
}

RECSYS_SHAPES: Dict[str, ShapeDef] = {
    "train_batch": ShapeDef("train_batch", "train",
                            dict(batch=65536, n_microbatches=1)),
    "serve_p99": ShapeDef("serve_p99", "serve", dict(batch=512)),
    "serve_bulk": ShapeDef("serve_bulk", "serve", dict(batch=262144)),
    "retrieval_cand": ShapeDef("retrieval_cand", "retrieval",
                               dict(batch=1, n_candidates=1_000_000)),
}
