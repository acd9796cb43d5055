"""sasrec [arXiv:1808.09781; paper-verified].

embed_dim=50, 2 blocks, 1 head, seq_len=50, self-attentive sequential
recommendation.  Catalog scaled to production (1M items) so the embedding
table is the memory object the shapes exercise.  The same values as
``repro.configs.sasrec``.
"""

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import SASRecConfig

# n_negatives=1: the paper trains with one sampled negative per position.
_FULL = SASRecConfig(
    name="sasrec", n_items=1_000_000, embed_dim=50, n_blocks=2,
    n_heads=1, seq_len=50, n_negatives=1, dtype="float32",
)

_SMOKE = SASRecConfig(
    name="sasrec-smoke", n_items=1000, embed_dim=16, n_blocks=2,
    n_heads=1, seq_len=20, n_negatives=5, dtype="float32",
)

SPEC = ArchSpec(
    arch_id="sasrec",
    family="recsys",
    source="arXiv:1808.09781 (SASRec)",
    config_fn=lambda shape_id=None: _FULL,
    smoke_config_fn=lambda: _SMOKE,
    shape_ids=tuple(RECSYS_SHAPES),
    rules_override={},
    notes="retrieval_cand scores the last state against 1M candidates.",
)
