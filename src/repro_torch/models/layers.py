"""Primitive layers: norms, MLPs, rotary position embeddings, embeddings.

Layers are plain functions over parameter dicts of tensors, in the layouts of
``repro.models.layers``: dense weights are ``(d_in, d_out)`` and
``y = x @ w + b``. ``*_init`` draw from an explicit ``torch.Generator`` with
the reference's distributions (normal * d_in^-1/2 for dense and head weights,
normal * 0.02 for embeddings, ones for norms, zeros for biases); the draws
themselves differ from JAX's, so parity tests convert the reference's params
instead (`repro_torch.convert`). ``*_shapes`` give shapes without allocating.
A weight-only quantized dense dict (``{"qw", "scale"[, "b"]}``, from
`repro_torch.quant.quantize_model`) goes through `dense` like any other.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Shapes = Dict[str, Tuple[int, ...]]


# --------------------------------------------------------------------------- init utils

def normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with normal * ``std``, drawn in f32 and cast to
    ``t``'s dtype (the reference draws f32 and casts). Stacked leaves are
    filled one slice at a time to bound the f32 temporary."""
    if t.dim() >= 3:
        for i in range(t.shape[0]):
            normal_(t[i], std, gen)
        return t
    x = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    x.normal_(generator=gen)
    t.copy_(x * std)
    return t


def dense_shapes(d_in: int, d_out: int, bias: bool = False) -> Shapes:
    s = {"w": (d_in, d_out)}
    if bias:
        s["b"] = (d_out,)
    return s


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               bias: bool = False, stack: Tuple[int, ...] = ()) -> Params:
    """``stack`` prepends the super-block axis of scanned layers."""
    w = torch.empty(stack + (d_in, d_out), dtype=dtype, device=device)
    p = {"w": normal_(w, 1.0 / np.sqrt(d_in), gen)}
    if bias:
        p["b"] = torch.zeros(stack + (d_out,), dtype=dtype, device=device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "qw" in p:
        # weight-only quantized layer: the dequant-matmul kernel on the card,
        # its plain version on the CPU (picked by the tensors' device)
        from repro_torch.quant.quantize import qdense
        return qdense(p, x)
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# --------------------------------------------------------------------------- norms

def rmsnorm_init(d: int, dtype, device, stack: Tuple[int, ...] = ()) -> Params:
    return {"scale": torch.ones(stack + (d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------- MLPs

def mlp_shapes(d_model: int, d_ff: int, variant: str) -> Dict[str, Shapes]:
    if variant == "swiglu":
        return {"gate": dense_shapes(d_model, d_ff),
                "up": dense_shapes(d_model, d_ff),
                "down": dense_shapes(d_ff, d_model)}
    return {"fc_in": dense_shapes(d_model, d_ff, bias=True),
            "fc_out": dense_shapes(d_ff, d_model, bias=True)}


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, variant: str,
             dtype, device, stack: Tuple[int, ...] = ()) -> Params:
    if variant == "swiglu":
        return {
            "gate": dense_init(gen, d_model, d_ff, dtype, device, stack=stack),
            "up": dense_init(gen, d_model, d_ff, dtype, device, stack=stack),
            "down": dense_init(gen, d_ff, d_model, dtype, device, stack=stack),
        }
    return {
        "fc_in": dense_init(gen, d_model, d_ff, dtype, device, bias=True,
                            stack=stack),
        "fc_out": dense_init(gen, d_ff, d_model, dtype, device, bias=True,
                             stack=stack),
    }


def mlp(p: Params, x: torch.Tensor, variant: str) -> torch.Tensor:
    if variant == "swiglu":
        return dense(p["down"], F.silu(dense(p["gate"], x)) * dense(p["up"], x))
    # jax.nn.gelu defaults to the tanh approximation
    return dense(p["fc_out"], F.gelu(dense(p["fc_in"], x), approximate="tanh"))


# --------------------------------------------------------------------------- RoPE

def rope_freqs(rotary_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for half the rotary dim."""
    half = rotary_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_fraction: float = 1.0,
               mrope_sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """Rotate ``x`` (..., seq, heads, head_dim) by position embeddings.

    positions: (..., seq) int for standard rope, or (..., seq, 3) for M-RoPE
    (temporal/height/width coordinates, qwen2-vl style). Only the first
    ``rope_fraction`` of the head dim rotates (chatglm: 0.5).
    """
    hd = x.shape[-1]
    rot = int(hd * rope_fraction)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    inv = rope_freqs(rot, theta, device=x.device)  # (rot/2,)

    if mrope_sections:
        if positions.shape[-1] != 3 or sum(mrope_sections) != rot // 2:
            raise ValueError(f"mrope sections {mrope_sections} need (..., 3) "
                             f"positions and must sum to {rot // 2}")
        # each frequency f uses one of the 3 position kinds (t/h/w
        # sections); built from views, with no host-to-device index copy,
        # so that a CUDA graph can capture it
        pos_sel = torch.cat([positions[..., i:i + 1].expand(
            *positions.shape[:-1], n) for i, n in enumerate(mrope_sections)],
            dim=-1)
        ang = pos_sel.float() * inv
    else:
        ang = positions[..., None].float() * inv  # (..., seq, rot/2)

    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


# --------------------------------------------------------------------------- embeddings

def embed_shapes(vocab: int, d_model: int, n_codebooks: int = 1) -> Shapes:
    if n_codebooks > 1:
        return {"table": (n_codebooks, vocab, d_model)}
    return {"table": (vocab, d_model)}


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype, device,
               n_codebooks: int = 1) -> Params:
    t = torch.empty(embed_shapes(vocab, d_model, n_codebooks)["table"],
                    dtype=dtype, device=device)
    return {"table": normal_(t, 0.02, gen)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) int, or (B, S, K) for multi-codebook (summed)."""
    table = p["table"]
    if table.dim() == 3:  # multi-codebook: sum_k table[k, tokens[...,k]]
        return sum(table[k][tokens[..., k].long()]
                   for k in range(table.shape[0]))
    return table[tokens.long()]


def lm_head_shapes(d_model: int, vocab: int, n_codebooks: int = 1) -> Shapes:
    if n_codebooks > 1:
        return {"w": (n_codebooks, d_model, vocab)}
    return {"w": (d_model, vocab)}


def lm_head_init(gen: torch.Generator, d_model: int, vocab: int, dtype,
                 device, n_codebooks: int = 1) -> Params:
    w = torch.empty(lm_head_shapes(d_model, vocab, n_codebooks)["w"],
                    dtype=dtype, device=device)
    return {"w": normal_(w, 1.0 / np.sqrt(d_model), gen)}


def lm_head(p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p["w"]
    if w.dim() == 3:  # (K, D, V) -> logits (B,S,K,V)
        return torch.einsum("bsd,kdv->bskv", x, w)
    return x @ w
