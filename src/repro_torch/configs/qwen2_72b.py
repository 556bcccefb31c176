"""Qwen2-72B [arXiv:2407.10671].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064; QKV bias.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    arch_type="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    mlp_variant="swiglu",
    source="arXiv:2407.10671",
)
