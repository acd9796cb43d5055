"""two-tower-retrieval [Yi et al., RecSys'19 (YouTube); unverified tier].

embed_dim=256, tower MLP 1024-512-256, dot-product scoring, in-batch
sampled softmax with logQ correction.  5M users / 2M items.  The same
values as ``repro.configs.two_tower_retrieval``.
"""

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import TwoTowerConfig

_FULL = TwoTowerConfig(
    name="two-tower-retrieval", n_users=5_000_000, n_items=2_000_000,
    n_user_hist=50, embed_dim=256, tower_mlp=(1024, 512, 256),
    temperature=0.05, dtype="float32",
)

_SMOKE = TwoTowerConfig(
    name="two-tower-smoke", n_users=1000, n_items=500, n_user_hist=10,
    embed_dim=32, tower_mlp=(64, 32), dtype="float32",
)

SPEC = ArchSpec(
    arch_id="two-tower-retrieval",
    family="recsys",
    source="Yi et al., RecSys'19 (sampled-softmax two-tower)",
    config_fn=lambda shape_id=None: _FULL,
    smoke_config_fn=lambda: _SMOKE,
    shape_ids=tuple(RECSYS_SHAPES),
    rules_override={},
    notes="ES-transfer hillclimb target (blocked screened retrieval).",
)
