"""Operations and bytes of the work a run did, from the configuration's widths.

The yardstick of the benchmark's roofline and MFU metrics. Everything is
counted for the operation, whatever implements it: each input byte once and
each output byte once, whatever a kernel reads again. Layers are counted by
kind: every layer's attention (grouped-query, or MLA's latent attention),
and its FFN, an MoE's where the program's `ArchConfig.is_moe_layer` holds
(from ``first_dense`` on, every ``moe_period``-th layer), else a dense one.

* A forward's model FLOPs: 2 x the matmul parameters a token uses in the
  whole stack x the tokens, plus attention's score and P.V products at each
  position a query attends to, plus the vocabulary head at the positions
  whose logits are needed (the last prompt position of a prefill, every row
  of a decode step). A layer's parameters a token: grouped-query attention's
  q, k, v and o; MLA's q (or q_a and q_b with q compression), kv_a (d to the
  latent and the rope key), kv_b (the latent to every head's nope key and
  value) and o; an MoE FFN's router, its top-k routed and its shared SwiGLU
  experts; a dense FFN's SwiGLU. Attention a position: 4 x heads x head dim
  for grouped-query, 2 x heads x (nope + rope) + 2 x heads x v for MLA, its
  published, decompressed form.
* Paged decode attention, one call (one layer, one decode step of one
  batch): FLOPs 4 x rows x heads x head dim x context; bytes the queries
  and outputs, and the K and V of every distinct position, where the k
  samples of a request share the prompt's positions: read once a batch. A
  latent (MLA) cache holds a position's latent and rope key, (kv_lora +
  rope) x 2 bytes, and is attended in the latent form: scores over kv_lora
  + rope, P.V over kv_lora, queries and outputs of those widths.
* The MoE grouped GEMM, one call (one of gate, up, down, one MoE layer, one
  forward): FLOPs 2 x (tokens x top-k) x d_in x d_out; bytes every expert's
  weights once (at 160 tokens x top-8 of 40 experts the chance that an
  expert gets no token is (32/40)^160, about 3e-16), plus each routed row
  in and out.

A port group with layers of another kind (Mamba, cross-attention, a window,
a layer pattern, several codebooks, an FFN other than SwiGLU) is refused:
its counts are not written.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
BF16 = 2


@dataclass(frozen=True)
class Widths:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    d_ff: int            # dense FFN width
    experts: int         # routed experts (0 without MoE)
    top_k: int
    d_expert: int        # a routed or shared expert's width
    n_shared: int        # shared experts, always on
    first_dense: int     # leading dense layers
    moe_period: int      # an MoE layer every moe_period layers from there
    kv_lora: int         # MLA's latent width (0 without MLA)
    q_lora: int          # MLA's q compression (0: none)
    qk_nope: int
    qk_rope: int
    v_dim: int

    #: port keys whose layers these counts do not know
    UNCOUNTED = ("ssm", "layer_pattern", "cross_attention", "attn_window")

    @classmethod
    def of(cls, port: Dict[str, Any]) -> "Widths":
        found = [k for k in cls.UNCOUNTED if port.get(k)]
        if int(port.get("n_codebooks", 1)) != 1:
            found.append("n_codebooks")
        if port.get("mlp_variant", "swiglu") != "swiglu":
            found.append(f"mlp_variant {port['mlp_variant']}")
        if found:
            raise ValueError(f"{port.get('name')!r}: work.py has no counts "
                             f"for {found}")
        moe = port.get("moe") or {}
        mla = port.get("mla") or {}
        d, h = int(port["d_model"]), int(port["n_heads"])
        return cls(int(port["n_layers"]), d, h, int(port["n_kv_heads"]),
                   int(port.get("head_dim") or d // h),
                   int(port["vocab_size"]), int(port["d_ff"]),
                   int(moe.get("n_experts", 0)), int(moe.get("top_k", 0)),
                   int(moe.get("d_expert") or port["d_ff"]) if moe else 0,
                   int(moe.get("n_shared", 0)),
                   int(moe.get("first_dense", 0)),
                   int(moe.get("moe_period", 1)),
                   int(mla.get("kv_lora_rank", 0)),
                   int(mla.get("q_lora_rank") or 0),
                   int(mla.get("qk_nope_head_dim", 0)),
                   int(mla.get("qk_rope_head_dim", 0)),
                   int(mla.get("v_head_dim", 0)))

    @property
    def moe_layers(self) -> int:
        """Layers whose FFN is the MoE."""
        if not self.experts:
            return 0
        return len(range(self.first_dense, self.layers, self.moe_period))

    @property
    def dense_layers(self) -> int:
        return self.layers - self.moe_layers


def attn_params_per_token(w: Widths) -> int:
    """Matmul parameters one token uses in one layer's attention."""
    if not w.kv_lora:
        return w.d * w.heads * w.head_dim * 2 \
            + w.d * w.kv_heads * w.head_dim * 2
    qk = w.qk_nope + w.qk_rope
    q = w.d * w.q_lora + w.q_lora * w.heads * qk if w.q_lora \
        else w.d * w.heads * qk
    return (q + w.d * (w.kv_lora + w.qk_rope)
            + w.kv_lora * w.heads * (w.qk_nope + w.v_dim)
            + w.heads * w.v_dim * w.d)


def moe_ffn_params_per_token(w: Widths) -> int:
    """The router, the top-k routed experts and the shared ones."""
    return w.d * w.experts + (w.top_k + w.n_shared) * 3 * w.d * w.d_expert


def dense_ffn_params_per_token(w: Widths) -> int:
    return 3 * w.d * w.d_ff


def layer_params_per_token(w: Widths) -> int:
    """Matmul parameters one token uses in one layer: its attention and, in
    a model with experts, an MoE FFN, else a dense one."""
    return attn_params_per_token(w) + (
        moe_ffn_params_per_token(w) if w.experts
        else dense_ffn_params_per_token(w))


def stack_params_per_token(w: Widths) -> int:
    """Matmul parameters one token uses in all layers, the head left out."""
    return (w.layers * attn_params_per_token(w)
            + w.moe_layers * moe_ffn_params_per_token(w)
            + w.dense_layers * dense_ffn_params_per_token(w))


def attn_flops_per_position(w: Widths) -> int:
    """One layer's score and P.V FLOPs for a query at one position of its
    context."""
    if w.kv_lora:
        return 2 * w.heads * (w.qk_nope + w.qk_rope) + 2 * w.heads * w.v_dim
    return 4 * w.heads * w.head_dim


def forward_flops(w: Widths, tokens: int, context_sum: int,
                  head_rows: int) -> float:
    """Model FLOPs of a forward over ``tokens`` tokens whose contexts sum to
    ``context_sum``, with the vocabulary head at ``head_rows`` positions."""
    return (2.0 * stack_params_per_token(w) * tokens
            + float(w.layers * attn_flops_per_position(w)) * context_sum
            + 2.0 * w.d * w.vocab * head_rows)


def prefill_flops(w: Widths, prompts: int, plen: int) -> float:
    return forward_flops(w, prompts * plen, prompts * plen * (plen + 1) // 2,
                         prompts)


def decode_flops(w: Widths, rows: int, context: int) -> float:
    """One decode step of ``rows`` rows, each attending to ``context``
    positions (its own included)."""
    return forward_flops(w, rows, rows * context, rows)


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def paged_decode_call(w: Widths, prompts: int, plen: int, rows: int,
                      context: int, table_blocks: int) -> tuple:
    """(FLOPs, bytes) of one paged decode attention call: ``rows`` rows of
    ``prompts`` distinct prompts of ``plen`` tokens, each row at ``context``
    positions (the prompt's and its own ``context - plen`` decoded ones),
    through a block table of ``table_blocks`` entries a row."""
    positions = prompts * plen + rows * (context - plen)
    if w.kv_lora:
        lat = w.kv_lora + w.qk_rope
        flops = (2.0 * rows * w.heads * lat * context
                 + 2.0 * rows * w.heads * w.kv_lora * context)
        kv = positions * lat * BF16
        qo = rows * w.heads * (lat + w.kv_lora) * BF16
    else:
        flops = 4.0 * rows * w.heads * w.head_dim * context
        kv = positions * w.kv_heads * w.head_dim * BF16 * 2
        qo = 2 * rows * w.heads * w.head_dim * BF16
    pos = positions * 4
    table = rows * table_blocks * 4 + rows * 4
    return flops, float(kv + pos + qo + table)


def moe_gemm_call(w: Widths, tokens: int, d_in: int, d_out: int) -> tuple:
    """(FLOPs, bytes) of one grouped expert product over a forward's
    ``tokens`` tokens."""
    routed = tokens * w.top_k
    flops = 2.0 * routed * d_in * d_out
    nbytes = (w.experts * d_in * d_out + routed * (d_in + d_out)) * BF16
    return flops, float(nbytes)


def moe_forward_calls(w: Widths, tokens: int):
    """The three grouped products of one MoE layer's forward."""
    gate = moe_gemm_call(w, tokens, w.d, w.d_expert)
    return [gate, gate, moe_gemm_call(w, tokens, w.d_expert, w.d)]
