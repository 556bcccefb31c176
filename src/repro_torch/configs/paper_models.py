"""The QEIL paper's own five model families (Table 16), as ArchConfigs.

These drive the paper-reproduction benchmarks (scaling-formalism fitting, the
heterogeneity ablation, the main results table) and the end-to-end serving example.
Geometries follow the public model cards; the reproduction benches mostly need the
parameter count N and the prefill/decode FLOP/byte profiles that the configs imply.
"""
from repro_torch.models.config import ArchConfig

GPT2_125M = ArchConfig(
    name="gpt2-125m", arch_type="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=50257,
    mlp_variant="gelu", rope_variant="sinusoidal", tie_embeddings=True,
    source="paper (GPT-2 family)")

GRANITE_350M = ArchConfig(
    name="granite-350m", arch_type="dense", n_layers=28, d_model=1024,
    n_heads=16, n_kv_heads=4, d_ff=2048, vocab_size=49155,
    mlp_variant="swiglu", source="paper (Granite family)")

QWEN2_05B = ArchConfig(
    name="qwen2-0.5b", arch_type="dense", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_ff=4864, vocab_size=151936,
    qkv_bias=True, mlp_variant="swiglu", tie_embeddings=True,
    source="paper (Qwen2 family)")

LLAMA32_1B = ArchConfig(
    name="llama-3.2-1b", arch_type="dense", n_layers=16, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab_size=128256,
    mlp_variant="swiglu", tie_embeddings=True,
    source="paper (Llama-3.2 family)")

LFM2_26B = ArchConfig(
    name="lfm2-2.6b", arch_type="dense", n_layers=32, d_model=2560,
    n_heads=20, n_kv_heads=4, d_ff=8960, vocab_size=65536,
    mlp_variant="swiglu", source="paper (LFM2 family)")

PAPER_MODELS = {m.name: m for m in
                (GPT2_125M, GRANITE_350M, QWEN2_05B, LLAMA32_1B, LFM2_26B)}
