"""Granite-MoE 3B-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base].

32L d_model=1536 24H (GQA kv=8) d_ff=512(expert) vocab=49155; MoE 40 experts
top-8 on every layer (structured assignment field "MoE 40e top-8"; the free-text
"32 experts" differs — we follow the structured field, see DESIGN.md §4).
"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512, moe_period=1),
    mlp_variant="swiglu",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
