"""deepseek-v2-236b [arXiv:2405.04434; hf-verified].

60L, d_model=5120, 128 heads with MLA (kv_lora=512, q_lora=1536,
qk_nope=128, qk_rope=64, v=128), MoE: 160 routed experts top-6 +
2 shared, expert d_ff=1536, first layer dense (d_ff=12288),
vocab 102400.
The same values as ``repro.configs.deepseek_v2_236b``.
"""

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig

_FULL = LMConfig(
    name="deepseek-v2-236b",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_head=128,
    d_ff=12288,                      # dense (first_k_dense) layers
    vocab_size=102400, tie_embeddings=False,
    moe=True, n_experts=160, top_k=6, moe_d_ff=1536, n_shared_experts=2,
    first_k_dense=1, capacity_factor=1.25,
    mla=True, q_lora=1536, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=1e4, norm_eps=1e-6,
    attn_chunk=1024, dtype="bfloat16", remat="full",
)

_SMOKE = LMConfig(
    name="deepseek-v2-smoke",
    n_layers=3, d_model=96, n_heads=4, n_kv_heads=4, d_head=24,
    d_ff=256, vocab_size=512, tie_embeddings=False,
    moe=True, n_experts=8, top_k=2, moe_d_ff=48, n_shared_experts=1,
    first_k_dense=1, mla=True, q_lora=48, kv_lora=32, qk_nope_dim=16,
    qk_rope_dim=8, v_head_dim=16,
    attn_chunk=64, dtype="float32", remat="none",
)

SPEC = ArchSpec(
    arch_id="deepseek-v2-236b",
    family="lm",
    source="arXiv:2405.04434 (DeepSeek-V2)",
    config_fn=lambda shape_id=None: _FULL,
    smoke_config_fn=lambda: _SMOKE,
    shape_ids=tuple(LM_SHAPES),
    # 160 experts / 16 = 10 per chip: expert parallelism over "model";
    # "embed" -> data adds the FSDP axis (472GB bf16 -> 1.8GB/chip);
    # MLA latent dims stay replicated.
    rules_override={"embed": "data"},
    notes=("MLA absorbed decode caches (c_kv 512 + rope 64) only. "
           "long_500k skipped: MLA compresses the cache ~9x but attention "
           "is still O(S) per step / O(S^2) prefill."),
)
