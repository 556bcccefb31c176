"""MusicGen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.

48L d_model=1536 24H (kv=24 -> MHA) d_ff=6144 vocab=2048 per codebook;
4 EnCodec codebooks (summed embeddings, 4 LM heads, delay pattern handled by
``repro.data.audio``); cross-attention to the (stubbed) text-conditioning memory;
sinusoidal positions (MusicGen convention).

The EnCodec audio codec itself is a stub per the assignment carve-out —
``input_specs`` supplies precomputed codebook token frames.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    arch_type="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    mlp_variant="gelu",
    rope_variant="sinusoidal",
    n_codebooks=4,
    cross_attention=True,
    frontend="audio",
    n_cond_tokens=64,
    source="arXiv:2306.05284",
)
