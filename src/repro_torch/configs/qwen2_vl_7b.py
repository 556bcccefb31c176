"""Qwen2-VL-7B [arXiv:2409.12191] — transformer backbone only (vision frontend is a
stub per the assignment carve-out: ``input_specs`` supplies patch embeddings).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064; M-RoPE with t/h/w sections
(16, 24, 24) over the 64 rotary half-dims; QKV bias.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_variant="mrope",
    mrope_sections=(16, 24, 24),
    mlp_variant="swiglu",
    frontend="vision",
    n_vision_tokens=1024,
    source="arXiv:2409.12191",
)
