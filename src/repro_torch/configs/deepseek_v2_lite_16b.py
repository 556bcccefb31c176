"""DeepSeek-V2-Lite 16B [arXiv:2405.04434].

27L d_model=2048 16H d_ff=1408(expert) vocab=102400; MLA kv_lora=512;
MoE: 64 routed top-6 + 2 shared experts (structured assignment field; the free-text
"160 routed" is full V2, not Lite — see DESIGN.md §4). First layer is dense.
"""
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                  moe_period=1, first_dense=1),
    mlp_variant="swiglu",
    source="arXiv:2405.04434",
)
