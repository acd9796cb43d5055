"""mixtral-8x22b [arXiv:2401.04088; hf-verified].

56L, d_model=6144, 48 heads (GQA kv=8, head_dim=128), MoE 8 experts
top-2 with d_ff=16384, vocab 32768, sliding-window attention
(window 4096; the ring KV cache is what makes the long_500k decode
cell sub-quadratic).
The same values as ``repro.configs.mixtral_8x22b``.
"""

from repro_torch.configs.base import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig

_FULL = LMConfig(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16384,
    vocab_size=32768, tie_embeddings=False,
    moe=True, n_experts=8, top_k=2, moe_d_ff=16384, n_shared_experts=0,
    first_k_dense=0, capacity_factor=1.25,
    sliding_window=4096,
    rope_theta=1e6,
    attn_chunk=1024, dtype="bfloat16", remat="full",
)

_SMOKE = LMConfig(
    name="mixtral-smoke",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_head=16,
    d_ff=256, vocab_size=512, tie_embeddings=False,
    moe=True, n_experts=4, top_k=2, moe_d_ff=256,
    sliding_window=32, attn_chunk=64, dtype="float32", remat="none",
)

SPEC = ArchSpec(
    arch_id="mixtral-8x22b",
    family="lm",
    source="arXiv:2401.04088 (Mixtral of Experts)",
    config_fn=lambda shape_id=None: _FULL,
    smoke_config_fn=lambda: _SMOKE,
    shape_ids=tuple(LM_SHAPES),
    # 8 experts < model=16: tensor-parallel INSIDE each expert instead of
    # expert parallelism (d_ff 16384 / 16 = 1024), kv heads replicated;
    # "embed" -> data adds the FSDP axis (280GB bf16 -> 1.1GB/chip).
    rules_override={"experts": None, "experts_act": None,
                    "expert_ff": "model", "kv_heads": None,
                    "embed": "data"},
    notes="SWA ring cache => long_500k runs with a 4096-slot cache.",
)
