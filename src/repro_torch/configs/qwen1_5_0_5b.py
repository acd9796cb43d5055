"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B; hf-verified].

24L, d_model=1024, 16 heads (kv=16 — plain MHA), d_ff=2816 SwiGLU,
vocab 151936, QKV bias, tied embeddings.  The same values as
``repro.configs.qwen1_5_0_5b``.
"""

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig

_FULL = LMConfig(
    name="qwen1.5-0.5b",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=2816, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6, norm_eps=1e-6,
    attn_chunk=1024, dtype="bfloat16", remat="dots",
)

_SMOKE = LMConfig(
    name="qwen1.5-smoke",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=6, d_head=16,
    d_ff=256, vocab_size=512, qkv_bias=True, tie_embeddings=True,
    attn_chunk=64, dtype="float32", remat="none",
)

SPEC = ArchSpec(
    arch_id="qwen1.5-0.5b",
    family="lm",
    source="hf:Qwen/Qwen1.5-0.5B",
    config_fn=lambda shape_id=None: _FULL,
    smoke_config_fn=lambda: _SMOKE,
    shape_ids=tuple(LM_SHAPES),
    rules_override={},           # kv=16 divides model=16
    notes="QKV bias; long_500k skipped (full attention).",
)
