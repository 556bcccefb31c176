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

from repro_torch.obs.segments import mark

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
    """The dense FFN, its segments marked (`repro_torch.obs.segments`)."""
    mark("mlp.up")
    if variant == "swiglu":
        g, u = dense(p["gate"], x), dense(p["up"], x)
        mark("mlp.act")
        g = F.silu(g)          # rebound: the pre-activation is freed
        a = g * u
        mark("mlp.down")
        return dense(p["down"], a)
    u = dense(p["fc_in"], x)
    mark("mlp.act")
    # jax.nn.gelu defaults to the tanh approximation
    a = F.gelu(u, approximate="tanh")
    mark("mlp.down")
    return dense(p["fc_out"], a)


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


# --------------------------------------------------------------------------- tensor-parallel

# Under the sharded step (`repro_torch.distributed.step`) ``tp`` is the
# rank's `repro_torch.distributed.tp.TensorParallel`: parameter leaves are
# taken through ``tp.take`` and the residual stream is sharded on d_model
# over the tensor group. The functions below are the layers above on those
# shards; the collectives are the context's.

def dense_tp(p: Params, x: torch.Tensor, tp, sets) -> torch.Tensor:
    """`dense` on the columns ``sets[rank]`` of a projection leaf (its
    bias's too)."""
    y = x @ tp.take(p["w"], -1, sets)
    if "b" in p:
        y = y + tp.take(p["b"], 0, sets)
    return y


def rmsnorm_tp(p: Params, x: torch.Tensor, eps: float, tp) -> torch.Tensor:
    """`rmsnorm` of a d-sharded ``x``: the sum of squares all-reduced over
    the tensor group, the scale's own range (one tensor rank: `rmsnorm`
    itself)."""
    d = x.shape[-1] * tp.n
    scale = tp.take(p["scale"], 0, tp.range_sets(d))
    if tp.n == 1:
        return rmsnorm({"scale": scale}, x, eps)
    xf = x.float()
    var = tp.all_reduce_both(torch.sum(xf * xf, dim=-1, keepdim=True)) / d
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def embed_tp(p: Params, tokens: torch.Tensor, tp) -> torch.Tensor:
    """`embed` into the rank's d_model range (the table's at-rest tensor
    shard): no exchange along the tensor axis."""
    table = p["table"]
    d = table.shape[-1]
    t = tp.take(table, -1, tp.range_sets(d))
    return embed({"table": t}, tokens)


def mlp_partial(p: Params, h: torch.Tensor, variant: str, tp) -> torch.Tensor:
    """The MLP on the rank's hidden range of the whole input ``h``: the
    column-parallel products, then the row-parallel one, whose (B, S, d)
    output is this rank's partial sum (``fc_out``'s bias not added)."""
    if variant == "swiglu":
        sets = tp.range_sets(p["gate"]["w"].shape[-1])
        g = h @ tp.take(p["gate"]["w"], -1, sets)
        u = h @ tp.take(p["up"]["w"], -1, sets)
        return (F.silu(g) * u) @ tp.take(p["down"]["w"], 0, sets)
    sets = tp.range_sets(p["fc_in"]["w"].shape[-1])
    a = h @ tp.take(p["fc_in"]["w"], -1, sets) + \
        tp.take(p["fc_in"]["b"], 0, sets)
    return F.gelu(a, approximate="tanh") @ tp.take(p["fc_out"]["w"], 0, sets)


def mlp_tp(p: Params, x: torch.Tensor, variant: str, tp) -> torch.Tensor:
    """`mlp` from and to the d-sharded residual stream: the input
    all-gathered, the output reduce-scattered (the row-parallel route for
    ``down``, PERF.md)."""
    y = tp.reduce_scatter(mlp_partial(p, tp.gather_input(x), variant, tp))
    if variant != "swiglu":
        d = y.shape[-1] * tp.n
        y = y + tp.take(p["fc_out"]["b"], 0, tp.range_sets(d))
    return y


def lm_head_tp(w, h: torch.Tensor, tp, tied: bool) -> torch.Tensor:
    """The rank's vocabulary range of the logits from the d-sharded final
    hidden state: ``w`` is the head (d, V) / (K, d, V), or with ``tied``
    the embedding table (V, d) / (K, V, d)."""
    x = tp.gather_input(h)
    V = w.shape[-2] if tied else w.shape[-1]
    sets = tp.range_sets(V)
    if tied:
        t = tp.take(w, -2, sets)
        return x @ t.T if t.dim() == 2 else torch.einsum("bsd,kvd->bskv",
                                                         x, t)
    t = tp.take(w, -1, sets)
    return x @ t if t.dim() == 2 else torch.einsum("bsd,kdv->bskv", x, t)
