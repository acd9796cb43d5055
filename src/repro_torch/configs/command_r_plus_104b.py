"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01; unverified].

Dense decoder: 64L, d_model=12288, 96 heads (GQA kv=8, head_dim=128),
d_ff=33792 SwiGLU, vocab 256000, no biases, tied embeddings.
The same values as ``repro.configs.command_r_plus_104b``.
"""

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig

_FULL = LMConfig(
    name="command-r-plus-104b",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_head=128,
    d_ff=33792, vocab_size=256000, qkv_bias=False, tie_embeddings=True,
    rope_theta=75_000_000.0,   # command-r family long-context base
    attn_chunk=1024, dtype="bfloat16", remat="full",
)

_SMOKE = LMConfig(
    name="command-r-plus-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=352, vocab_size=512, qkv_bias=False, tie_embeddings=True,
    attn_chunk=64, dtype="float32", remat="none",
)

SPEC = ArchSpec(
    arch_id="command-r-plus-104b",
    family="lm",
    source="hf:CohereForAI/c4ai-command-r-v01 (scaled; unverified tier)",
    config_fn=lambda shape_id=None: _FULL,
    smoke_config_fn=lambda: _SMOKE,
    shape_ids=tuple(LM_SHAPES),
    # kv=8 does not divide model=16: replicate kv projections, shard q
    # heads.  "embed" -> data gives 2D (FSDP x TP) weight sharding: 208GB
    # of bf16 weights land at 0.8GB/chip instead of 13GB/chip.
    rules_override={"kv_heads": None, "embed": "data"},
    notes="GQA no-bias; long_500k skipped (full attention).",
)
