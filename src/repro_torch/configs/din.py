"""din [arXiv:1706.06978; paper-verified].

embed_dim=18, seq_len=100, attention MLP 80-40, main MLP 200-80,
target-attention CTR ranker; item vocab at production scale (1M).  The
same values as ``repro.configs.din``.
"""

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import DINConfig

_FULL = DINConfig(
    name="din", n_items=1_000_000, n_context=100_000, n_context_fields=4,
    embed_dim=18, seq_len=100, attn_mlp=(80, 40), mlp=(200, 80),
    dtype="float32",
)

_SMOKE = DINConfig(
    name="din-smoke", n_items=2000, n_context=100, n_context_fields=4,
    embed_dim=8, seq_len=20, attn_mlp=(16, 8), mlp=(32, 16),
    dtype="float32",
)

SPEC = ArchSpec(
    arch_id="din",
    family="recsys",
    source="arXiv:1706.06978 (Deep Interest Network)",
    config_fn=lambda shape_id=None: _FULL,
    smoke_config_fn=lambda: _SMOKE,
    shape_ids=tuple(RECSYS_SHAPES),
    rules_override={},
    notes=("retrieval_cand ranks 1M candidates through full target "
           "attention (B=1 user, candidate axis batched)."),
)
