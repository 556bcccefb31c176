"""Jamba-v0.1 52B [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; Mamba+attention 1:7
interleave (attention at offset 3 of each 8-layer period); MoE 16 experts top-2
every 2nd layer.

TPU adaptation (DESIGN.md §2/§4): the Mamba layers use the Mamba-2 SSD formulation
(chunked matmuls -> MXU) instead of Jamba's original Mamba-1 selective scan; the
hybrid interleave, MoE placement and head geometry follow the assignment sheet.
"""
from repro_torch.models.config import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern=("m", "m", "m", "a", "m", "m", "m", "m"),
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, n_groups=1, chunk=256),
    moe=MoEConfig(n_experts=16, top_k=2, moe_period=2, d_expert=14336),
    mlp_variant="swiglu",
    source="arXiv:2403.19887",
)
