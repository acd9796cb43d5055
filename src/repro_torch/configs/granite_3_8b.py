"""granite-3-8b [hf:ibm-granite/granite-3.0-2b-base family; hf-verified].

40L, d_model=4096, 32 heads (GQA kv=8, head_dim=128), d_ff=12800 SwiGLU,
vocab 49155 (padded to 49280 for TP), tied embeddings.
The same values as ``repro.configs.granite_3_8b``.
"""

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig

_FULL = LMConfig(
    name="granite-3-8b",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=12800, vocab_size=49155, qkv_bias=False, tie_embeddings=True,
    rope_theta=1e4,
    attn_chunk=1024, dtype="bfloat16", remat="dots",
)

_SMOKE = LMConfig(
    name="granite-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=384, vocab_size=515, qkv_bias=False, tie_embeddings=True,
    attn_chunk=64, dtype="float32", remat="none",
)

SPEC = ArchSpec(
    arch_id="granite-3-8b",
    family="lm",
    source="hf:ibm-granite/granite-3.0-2b-base (8b sibling dims)",
    config_fn=lambda shape_id=None: _FULL,
    smoke_config_fn=lambda: _SMOKE,
    shape_ids=tuple(LM_SHAPES),
    rules_override={"kv_heads": None},   # kv=8 < model=16
    notes="GQA; vocab 49155 padded to 49280; long_500k skipped.",
)
