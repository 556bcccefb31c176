"""Energy-aware task decomposition (paper Section 3.5, Eq. 9).

Inference = Embedding + Decoder Layers + LM Head, with each decoder layer further
split into its prefill (compute-bound) and decode (memory-bound) phases. Each
stage carries analytic FLOP and byte counts derived from the ArchConfig, so the
orchestrator can compute arithmetic intensity, roofline time, and energy per
candidate device — this is the "granular operations with distinct hardware
sensitivity" decomposition the paper inherits from Asgar et al.

Byte-accounting conventions:
* prefill — weights stream once per pass; activations 3x d_model per token.
* decode — weights re-stream every autoregressive step (the memory-bound
  regime, paper Formalism 3's B_i/B_0 term), plus per-token KV/state reads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.models.config import ArchConfig


@dataclass(frozen=True)
class Workload:
    batch: int = 1
    prompt_tokens: int = 128      # T_in per sample
    decode_tokens: int = 128      # T_out per sample
    samples: int = 1              # S (repeated sampling)
    bytes_per_param: float = 2.0  # quantization: 2=bf16, 1=fp8/int8, 0.5=int4
    bytes_per_act: float = 2.0
    bytes_per_kv: Optional[float] = None  # KV-cache element bytes (int8 KV=1);
                                          # None -> bytes_per_act
    # Speculative decode (repro_torch.spec): one verify forward scores
    # ``spec_queries_per_step`` tokens (1 + draft depth) and commits
    # ``spec_tokens_per_step`` in expectation — so weights re-stream once per
    # ``spec_tokens_per_step`` committed tokens while per-query compute and
    # activation/KV traffic scale with the scored queries. 1.0/1.0 = off.
    spec_tokens_per_step: float = 1.0
    spec_queries_per_step: float = 1.0

    @property
    def kv_bytes_per_el(self) -> float:
        return self.bytes_per_act if self.bytes_per_kv is None \
            else self.bytes_per_kv

    @property
    def spec_query_factor(self) -> float:
        """Scored query tokens per committed decode token (>= 1 when
        drafting; the compute-side price speculation pays for fewer weight
        re-streams)."""
        return self.spec_queries_per_step / max(self.spec_tokens_per_step,
                                                1e-9)

    @property
    def quant_factor(self) -> float:
        """Paper's f(Q): FP16 -> 1.0, FP8/INT8 -> 0.65, INT4 -> 0.45."""
        if self.bytes_per_param >= 2.0:
            return 1.0
        return 0.65 if self.bytes_per_param >= 1.0 else 0.45

    @property
    def n_prefill_tokens(self) -> int:
        return self.batch * self.samples * self.prompt_tokens

    @property
    def n_decode_tokens(self) -> int:
        return self.batch * self.samples * self.decode_tokens


@dataclass
class Stage:
    name: str                 # e.g. "layer12.attn.decode"
    phase: str                # embed | prefill | decode | head
    layer: int                # -1 for embed, n_layers for head
    flops: float
    bytes_moved: float
    param_bytes: float        # resident weights for this stage
    width: int = 0            # boundary tensor width (d_model elements/token)

    @property
    def intensity(self) -> float:
        return self.flops / max(self.bytes_moved, 1.0)


# ------------------------------------------------------------------ per-token
# Each helper returns (flops_per_token, act_bytes_per_token, param_bytes).

def _attn_counts(cfg: ArchConfig, w: Workload, decode: bool
                 ) -> Tuple[float, float, float]:
    d, H, hd, kv = cfg.d_model, cfg.n_heads, cfg.hd, cfg.n_kv_heads
    bpa, bpp = w.bytes_per_act, w.bytes_per_param
    # average attended context length
    ctx = (w.prompt_tokens + w.decode_tokens / 2) if decode \
        else w.prompt_tokens / 2
    if cfg.attn_window:
        ctx = min(ctx, cfg.attn_window)

    if cfg.mla is not None:
        m = cfg.mla
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        proj = 2 * d * H * qd + 2 * d * (m.kv_lora_rank + m.qk_rope_head_dim)
        out = 2 * H * m.v_head_dim * d
        pbytes = (d * H * qd + d * (m.kv_lora_rank + m.qk_rope_head_dim) +
                  m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim) +
                  H * m.v_head_dim * d) * bpp
        if decode:   # absorbed: scores + context in latent space
            absorb = 2 * H * m.qk_nope_head_dim * m.kv_lora_rank * 2
            attn = 2 * H * ctx * (m.kv_lora_rank + m.qk_rope_head_dim) * 2
            flops = proj + absorb + attn + out
            cache = ctx * (m.kv_lora_rank + m.qk_rope_head_dim) * w.kv_bytes_per_el
        else:        # decompressed (MXU-friendly)
            dec = 2 * m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
            attn = 2 * H * ctx * (qd + m.v_head_dim)
            flops = proj + dec + attn + out
            cache = 0.0
    else:
        proj = 2 * d * hd * (H + 2 * kv) + 2 * H * hd * d
        attn = 2 * H * ctx * hd * 2
        flops = proj + attn
        cache = (ctx * 2 * kv * hd * w.kv_bytes_per_el) if decode else 0.0
        pbytes = (d * hd * (H + 2 * kv) + H * hd * d) * bpp

    if cfg.cross_attention:
        flops += 4 * d * H * hd + 2 * H * cfg.n_cond_tokens * hd * 2
        pbytes += 4 * d * H * hd * bpp

    return flops, 3 * d * bpa + cache, pbytes


def _ffn_counts(cfg: ArchConfig, w: Workload, layer_idx: int
                ) -> Tuple[float, float, float, float]:
    """Returns (flops/token, act bytes/token, active param bytes, total param bytes)."""
    d = cfg.d_model
    bpa, bpp = w.bytes_per_act, w.bytes_per_param
    if cfg.is_moe_layer(layer_idx):
        m = cfg.moe
        ff = cfg.expert_ff()
        active = m.top_k + m.n_shared
        flops = 2 * 3 * d * ff * active + 2 * d * m.n_experts
        p_active = (3 * d * ff * active + d * m.n_experts) * bpp
        p_total = (3 * d * ff * (m.n_experts + m.n_shared) +
                   d * m.n_experts) * bpp
    elif cfg.d_ff > 0:
        mult = 3 if cfg.mlp_variant == "swiglu" else 2
        flops = 2 * mult * d * cfg.d_ff
        p_active = p_total = mult * d * cfg.d_ff * bpp
    else:
        return 0.0, 0.0, 0.0, 0.0
    return flops, 3 * d * bpa, p_active, p_total


def _ssm_counts(cfg: ArchConfig, w: Workload, decode: bool
                ) -> Tuple[float, float, float]:
    s = cfg.ssm
    d, di = cfg.d_model, cfg.d_inner
    H, P, N, G = cfg.ssm_heads, s.headdim, s.d_state, s.n_groups
    bpa, bpp = w.bytes_per_act, w.bytes_per_param
    proj = 2 * d * (2 * di + 2 * G * N + H) + 2 * di * d
    conv = 2 * s.d_conv * (di + 2 * G * N)
    if decode:
        ssd = 2 * H * P * N * 3                 # state update + readout
        state = H * P * N * 4 * 2               # f32 state read+write
    else:
        Q = s.chunk
        ssd = 2 * H * (Q * (N + P) + 2 * P * N)  # amortized chunked SSD
        state = 0.0
    pbytes = (d * (2 * di + 2 * G * N + H) + di * d +
              s.d_conv * (di + 2 * G * N)) * bpp
    return proj + conv + ssd, 3 * d * bpa + state, pbytes


# ------------------------------------------------------------------ assembly

def decompose(cfg: ArchConfig, w: Workload) -> List[Stage]:
    """Full stage list for a workload: embed + per-layer x phase + head."""
    stages: List[Stage] = []
    bpa, bpp = w.bytes_per_act, w.bytes_per_param
    d, V = cfg.d_model, cfg.vocab_size
    n_pre, n_dec = w.n_prefill_tokens, w.n_decode_tokens
    # Speculative verify scores spec_query_factor tokens per committed token
    # (embed/head/per-layer compute and activation bytes scale with scored
    # queries), while weights re-stream only once per verify step — the
    # roofline trade `repro_torch.spec.routing.spec_workload` prices.
    qf = w.spec_query_factor
    n_dec_scored = n_dec * qf
    n_all = n_pre + n_dec_scored
    decode_steps = w.decode_tokens / max(w.spec_tokens_per_step, 1e-9)

    embed_pbytes = V * d * cfg.n_codebooks * bpp
    stages.append(Stage("embed", "embed", -1,
                        flops=2.0 * d * n_all,
                        bytes_moved=n_all * d * bpa + n_all * d * bpp,
                        param_bytes=embed_pbytes, width=d))

    period = len(cfg.pattern)
    for layer in range(cfg.n_layers):
        mixer = cfg.pattern[layer % period]
        kind = "attn" if mixer == "a" else "ssm"
        for phase in ("prefill", "decode"):
            decode = phase == "decode"
            n_tok = n_dec_scored if decode else n_pre
            if n_tok == 0:
                continue
            if mixer == "a":
                f1, a1, p1 = _attn_counts(cfg, w, decode)
            else:
                f1, a1, p1 = _ssm_counts(cfg, w, decode)
            f2, a2, p2_active, p2_total = _ffn_counts(cfg, w, layer)
            flops = (f1 + f2) * n_tok
            if decode:
                weight_bytes = (p1 + p2_active) * decode_steps
            else:
                weight_bytes = p1 + p2_active
            bytes_moved = weight_bytes + n_tok * (a1 + a2)
            stages.append(Stage(f"layer{layer:02d}.{kind}+ffn.{phase}",
                                phase, layer, flops, bytes_moved,
                                p1 + p2_total, width=d))

    head_pbytes = V * d * cfg.n_codebooks * bpp
    stages.append(Stage("lm_head", "head", cfg.n_layers,
                        flops=2.0 * d * V * cfg.n_codebooks * n_all,
                        bytes_moved=head_pbytes + n_all * (d + V) * bpa,
                        param_bytes=head_pbytes, width=d))
    return stages


def phase_totals(stages: List[Stage]) -> dict:
    """Aggregate flops/bytes by phase — feeds the energy breakdown (Table 7)."""
    out = {}
    for st in stages:
        acc = out.setdefault(st.phase, {"flops": 0.0, "bytes": 0.0})
        acc["flops"] += st.flops
        acc["bytes"] += st.bytes_moved
    return out
