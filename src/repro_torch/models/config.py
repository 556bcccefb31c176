"""Architecture configuration system.

Every assigned architecture (and the paper's own model families) is described by an
``ArchConfig``. Configs are pure data: the unified ``repro_torch.models.model.Model`` turns a
config into parameter specs / init / forward / prefill / decode functions.

Design notes
------------
* ``layer_pattern`` drives hybrid architectures (jamba): the model stacks identical
  "super-blocks" (one period of the pattern) and scans over them, so HLO size is O(1)
  in depth for every architecture.
* ``attn_window`` enables the sliding-window variant used to run dense archs at the
  ``long_500k`` shape (see DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None  # V2-Lite has no q compression
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0              # shared (always-on) experts, DeepSeek-style
    d_expert: int = 0              # expert FFN hidden dim (0 -> use cfg.d_ff)
    moe_period: int = 1            # MoE every `period` layers (1 = every layer)
    first_dense: int = 0           # leading dense layers before MoE starts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration."""

    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                 # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- attention ---
    qkv_bias: bool = False
    attn_window: Optional[int] = None
    mla: Optional[MLAConfig] = None
    mla_absorbed: bool = True   # latent-space decode (paper-relevant bytes opt)
    # --- position encoding ---
    rope_variant: str = "rope"     # rope | partial | mrope | none
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0     # fraction of head_dim rotated ("partial"/chatglm)
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl, sums to rotary half-dim
    # --- FFN ---
    mlp_variant: str = "swiglu"    # swiglu | gelu
    moe: Optional[MoEConfig] = None
    # --- SSM / hybrid ---
    ssm: Optional[SSMConfig] = None
    # §Perf pair-1 variant: separate z/xBC/dt projections instead of one fused
    # in_proj — each output is then independently tensor-sharded, eliminating
    # the shard-misaligned slice that forces activation all-gathers.
    ssm_split_proj: bool = False
    layer_pattern: Optional[Tuple[str, ...]] = None  # one period, e.g. 7*('m',)+('a',)
    # --- modality frontends (stubs per carve-out) ---
    frontend: Optional[str] = None  # vision | audio
    n_codebooks: int = 1            # musicgen EnCodec codebooks
    n_vision_tokens: int = 256      # stub patch-embedding count for vlm shapes
    n_cond_tokens: int = 64         # stub conditioning memory length (audio)
    cross_attention: bool = False
    # §Perf beyond-paper: cache the cross-attention K/V of the static
    # conditioning memory at prefill instead of re-projecting every decode step
    cross_kv_cache: bool = False
    # §Perf beyond-paper: dense all-experts MoE for small decode batches
    # (skips sort/scatter dispatch; exact — no capacity drops)
    moe_dense_decode: bool = False
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""               # citation

    # ------------------------------------------------------------------ helpers
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so logits shard on the tensor
        axis (MaxText-style); padded columns are masked to -inf so the loss
        and sampling are exact. Affects mamba2 (50280->50432) and granite
        (49155->49408) only."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.headdim

    @property
    def pattern(self) -> Tuple[str, ...]:
        """Per-layer kinds for one super-block period."""
        if self.layer_pattern is not None:
            return self.layer_pattern
        if self.arch_type == "ssm":
            return ("m",)
        return ("a",)

    @property
    def n_super_blocks(self) -> int:
        period = len(self.pattern)
        assert self.n_layers % period == 0, (self.name, self.n_layers, period)
        return self.n_layers // period

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        if layer_idx < self.moe.first_dense:
            return False
        return (layer_idx - self.moe.first_dense) % self.moe.moe_period == 0

    def expert_ff(self) -> int:
        assert self.moe is not None
        return self.moe.d_expert or self.d_ff

    def param_count(self) -> int:
        """Analytic parameter count (used by the scaling formalisms' N)."""
        from repro_torch.models.model import Model  # local import to avoid cycle

        return Model(self).param_count()

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 super-blocks, d_model<=256, <=4 experts."""
        period = len(self.pattern)
        n_layers = period * min(2, self.n_super_blocks)
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        kw = dict(
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.hd >= 64 else self.hd,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=min(4, self.moe.n_experts),
                top_k=min(2, self.moe.top_k),
                n_shared=min(1, self.moe.n_shared),
                d_expert=min(128, self.expert_ff()),
            )
        if self.mla is not None:
            kw["mla"] = dataclasses.replace(
                self.mla, kv_lora_rank=64, qk_nope_head_dim=32,
                qk_rope_head_dim=16, v_head_dim=32)
            kw["head_dim"] = 0
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, headdim=32, chunk=32)
        if self.mrope_sections:
            # keep sections summing to rotary half-dim (hd=64 -> half=32)
            kw["mrope_sections"] = (8, 12, 12)
        return self.with_overrides(**kw)


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
