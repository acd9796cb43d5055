"""xdeepfm [arXiv:1803.05170; paper-verified].

39 sparse fields, embed_dim=10, CIN 200-200-200, deep MLP 400-400.
Criteo-scale per-field vocab (100k -> 3.9M total rows).  The same values
as ``repro.configs.xdeepfm``.
"""

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import XDeepFMConfig

_FULL = XDeepFMConfig(
    name="xdeepfm", n_fields=39, vocab_per_field=100_000, embed_dim=10,
    cin_layers=(200, 200, 200), mlp=(400, 400), dtype="float32",
)

_SMOKE = XDeepFMConfig(
    name="xdeepfm-smoke", n_fields=8, vocab_per_field=200, embed_dim=6,
    cin_layers=(16, 16), mlp=(32, 16), dtype="float32",
)

SPEC = ArchSpec(
    arch_id="xdeepfm",
    family="recsys",
    source="arXiv:1803.05170 (xDeepFM)",
    config_fn=lambda shape_id=None: _FULL,
    smoke_config_fn=lambda: _SMOKE,
    shape_ids=tuple(RECSYS_SHAPES),
    rules_override={},
    notes="retrieval_cand = offline scoring of 1M candidate rows.",
)
