"""graphsage-reddit [arXiv:1706.02216; paper-verified].

2 layers, d_hidden=128, mean aggregator, sample sizes 25-10.  The model's
input/output dims follow the dataset of each shape cell (cora-like /
reddit / ogbn-products / molecules), as in the paper's per-dataset runs.
The same values as ``repro.configs.graphsage_reddit``.
"""

from typing import Optional

from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import SAGEConfig


def _config(shape_id: Optional[str] = None) -> SAGEConfig:
    dims = GNN_SHAPES[shape_id or "minibatch_lg"].dims
    return SAGEConfig(
        name="graphsage-reddit",
        n_layers=2, d_hidden=128, aggregator="mean",
        fanouts=tuple(dims.get("fanouts", (25, 10))),
        d_feat=dims["d_feat"], n_classes=dims["n_classes"],
        dtype="float32",
    )


def _smoke() -> SAGEConfig:
    return SAGEConfig(name="graphsage-smoke", n_layers=2, d_hidden=16,
                      d_feat=24, n_classes=5, fanouts=(5, 3),
                      dtype="float32")


SPEC = ArchSpec(
    arch_id="graphsage-reddit",
    family="gnn",
    source="arXiv:1706.02216 (GraphSAGE)",
    config_fn=_config,
    smoke_config_fn=_smoke,
    shape_ids=tuple(GNN_SHAPES),
    rules_override={},
    notes=("Message passing via segment_sum (no CSR SpMM in JAX); "
           "minibatch_lg uses the real uniform fanout sampler."),
)
