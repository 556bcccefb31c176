"""DeepSeek-Coder-33B [arXiv:2401.14196] — llama-architecture dense model.

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    mlp_variant="swiglu",
    source="arXiv:2401.14196",
)
