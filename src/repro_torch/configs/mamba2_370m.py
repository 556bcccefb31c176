"""Mamba2-370M [arXiv:2405.21060] — attention-free SSD (state-space duality).

48L d_model=1024 vocab=50280 ssm_state=128; expand=2 -> d_inner=2048, headdim=64
-> 32 SSD heads. No FFN (d_ff=0): pure Mamba-2 blocks.
"""
from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    arch_type="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,          # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("m",),
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, n_groups=1, chunk=256),
    rope_variant="none",
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
