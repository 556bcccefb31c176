"""Yi-34B [arXiv:2403.04652] — llama-architecture GQA dense model.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    arch_type="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    mlp_variant="swiglu",
    source="arXiv:2403.04652",
)
