"""Operations and bytes of the work a run did, from the configuration's widths.

The yardstick of the benchmark's roofline and MFU metrics. Everything is
counted for the operation, whatever implements it: each input byte once and
each output byte once, whatever a kernel reads again.

* A forward's model FLOPs: 2 x the matmul parameters a token uses (MoE: the
  router and its top-k experts) x the tokens, plus attention's score and
  P.V products, 4 x heads x head dim x the context each query attends to,
  plus the vocabulary head at the positions whose logits are needed (the
  last prompt position of a prefill, every row of a decode step).
* Paged decode attention, one call (one layer, one decode step of one
  batch): FLOPs 4 x rows x heads x head dim x context; bytes the queries
  and outputs, and the K and V of every distinct position, where the k
  samples of a request share the prompt's positions: read once a batch.
* The MoE grouped GEMM, one call (one of gate, up, down, one layer, one
  forward): FLOPs 2 x (tokens x top-k) x d_in x d_out; bytes every expert's
  weights once (at 160 tokens x top-8 of 40 experts the chance that an
  expert gets no token is (32/40)^160, about 3e-16), plus each routed row
  in and out.
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
    d_ff: int            # dense MLP width (0 with MoE)
    experts: int
    top_k: int
    d_expert: int

    @classmethod
    def of(cls, port: Dict[str, Any]) -> "Widths":
        moe = port.get("moe") or {}
        d, h = int(port["d_model"]), int(port["n_heads"])
        return cls(int(port["n_layers"]), d, h, int(port["n_kv_heads"]),
                   int(port.get("head_dim") or d // h),
                   int(port["vocab_size"]),
                   0 if moe else int(port["d_ff"]),
                   int(moe.get("n_experts", 0)), int(moe.get("top_k", 0)),
                   int(moe.get("d_expert") or port["d_ff"]) if moe else 0)


def layer_params_per_token(w: Widths) -> int:
    """Matmul parameters one token uses in one layer."""
    attn = w.d * w.heads * w.head_dim * 2 + w.d * w.kv_heads * w.head_dim * 2
    if w.experts:
        ffn = w.d * w.experts + w.top_k * 3 * w.d * w.d_expert
    else:
        ffn = 3 * w.d * w.d_ff
    return attn + ffn


def forward_flops(w: Widths, tokens: int, context_sum: int,
                  head_rows: int) -> float:
    """Model FLOPs of a forward over ``tokens`` tokens whose contexts sum to
    ``context_sum``, with the vocabulary head at ``head_rows`` positions."""
    return (2.0 * layer_params_per_token(w) * w.layers * tokens
            + 4.0 * w.layers * w.heads * w.head_dim * context_sum
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
    flops = 4.0 * rows * w.heads * w.head_dim * context
    positions = prompts * plen + rows * (context - plen)
    kv = positions * w.kv_heads * w.head_dim * BF16 * 2
    pos = positions * 4
    qo = 2 * rows * w.heads * w.head_dim * BF16
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
