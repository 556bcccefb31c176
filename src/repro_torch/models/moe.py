"""Mixture-of-Experts FFN with sort-based capacity dispatch, ported from
``repro.models.moe``.

Routing is a softmax router with top-k experts per token and renormalised
gates; tokens go to per-expert buffers of capacity
``C = max(ceil(T*k/E * capacity_factor), k)`` in (expert, token) order, and
overflow tokens drop (standard capacity-based MoE semantics). The expert
SwiGLU runs as three grouped products ``(E, C, d) x (E, d, f)``: through the
hand-written kernel `repro_torch.kernels.moe_gemm` with ``use_kernel`` (its
plain version on CPU tensors), else plain einsums. A Switch-style
load-balancing aux loss is returned for the training loop.

Where the port departs from a line-by-line copy, and why:

* **Top-k ties.** ``jax.lax.top_k`` puts the lower index first among equal
  values; ``torch.topk`` promises no order. A stable descending sort keeps
  the lower index first, so a tie at the k-th place picks what the reference
  picks.
* **No host syncs.** Expert counts are a ``scatter_add_`` into ``zeros(E)``
  (``torch.bincount`` reads its max back to the host), and dropped tokens go
  to a drop slot at ``E*C`` as in the reference, so every shape is static.
* **A deterministic combine.** The reference scatter-adds the T*k
  contributions in f32; ``index_add_`` on CUDA would add them with atomics
  in an order that changes from run to run. The port inverts the sort, lays
  the contributions out as (T, k, d) and sums over k in a fixed order. The
  sums differ from the reference's by f32 rounding, not more.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (Params, dense, dense_init, mlp,
                                       mlp_init, normal_)


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype, device,
             stack: Tuple[int, ...] = ()) -> Params:
    """The reference's distributions: a dense router, stacked expert
    weights normal * d^-1/2 (gate, up) and normal * f^-1/2 (down), and the
    shared experts as one SwiGLU of width ``f * n_shared``."""
    m = cfg.moe
    d, ff = cfg.d_model, cfg.expert_ff()
    E = m.n_experts

    def stacked(shape, std):
        t = torch.empty(stack + shape, dtype=dtype, device=device)
        return normal_(t, std, gen)

    p = {"router": dense_init(gen, d, E, dtype, device, stack=stack),
         "gate": stacked((E, d, ff), 1.0 / np.sqrt(d)),
         "up": stacked((E, d, ff), 1.0 / np.sqrt(d)),
         "down": stacked((E, ff, d), 1.0 / np.sqrt(ff))}
    if m.n_shared:
        p["shared"] = mlp_init(gen, d, ff * m.n_shared, "swiglu", dtype,
                               device, stack)
    return p


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens: the reference's expression,
    in Python floats (the drops depend on it)."""
    m = cfg.moe
    TK = n_tokens * m.top_k
    return max(int(math.ceil(TK / m.n_experts * m.capacity_factor)), m.top_k)


def _aux_loss(cfg: ArchConfig, probs: torch.Tensor,
              expert_idx: torch.Tensor) -> torch.Tensor:
    """Switch aux loss ``E * sum_e f_e * p_e``: mean router probability
    times the share of the T*k assignments each expert received."""
    m = cfg.moe
    T, K = expert_idx.shape
    me = probs.mean(dim=0)
    ce = torch.zeros(m.n_experts, dtype=torch.float32, device=probs.device)
    ce.scatter_add_(0, expert_idx.reshape(-1),
                    torch.ones(T * K, dtype=torch.float32,
                               device=probs.device))
    ce = ce / (T * K)
    return m.n_experts * torch.sum(me * ce) * m.router_aux_weight


def moe_forward(p: Params, cfg: ArchConfig, x: torch.Tensor,
                use_kernel: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss f32 scalar)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    dev = x.device
    xf = x.reshape(T, d)

    logits = dense(p["router"], xf).float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = top_p[:, :K], top_i[:, :K]          # (T, K)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    aux = _aux_loss(cfg, probs, expert_idx)

    if cfg.moe_dense_decode and T <= 512:
        # every expert on every token: exact (no capacity drops), for a
        # handful of decode tokens
        h_all = F.silu(torch.einsum("td,edf->tef", xf, p["gate"])) * \
            torch.einsum("td,edf->tef", xf, p["up"])
        y_all = torch.einsum("tef,efd->ted", h_all, p["down"])  # (T, E, d)
        weights = torch.zeros((T, E), dtype=torch.float32, device=dev)
        weights.scatter_add_(1, expert_idx, gate_vals)
        y = torch.einsum("te,ted->td", weights, y_all.float())
        y = y.to(x.dtype).reshape(B, S, d)
        if m.n_shared:
            y = y + mlp(p["shared"], x, "swiglu")
        return y, aux

    # ---- sort-based dispatch: (expert, token) order, capacity C per expert
    TK = T * K
    flat_e = expert_idx.reshape(TK)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = torch.div(order, K, rounding_mode="floor")    # token of each
    counts = torch.zeros(E, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    seg_start = torch.cumsum(counts, dim=0) - counts
    pos_in_e = torch.arange(TK, device=dev) - seg_start[e_sorted]

    C = capacity(cfg, T)
    keep = pos_in_e < C
    dest = torch.where(keep, e_sorted * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))       # drop slot

    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    buf[dest] = xf[tok_sorted]
    xe = buf[:E * C].reshape(E, C, d)

    # ---- expert SwiGLU: three grouped products
    if use_kernel:
        from repro_torch.kernels.moe_gemm import ops as mg_ops
        h = F.silu(mg_ops.moe_gemm(xe, p["gate"])) * \
            mg_ops.moe_gemm(xe, p["up"])
        ye = mg_ops.moe_gemm(h, p["down"])                      # (E, C, d)
    else:
        h = F.silu(torch.einsum("ecd,edf->ecf", xe, p["gate"])) * \
            torch.einsum("ecd,edf->ecf", xe, p["up"])
        ye = torch.einsum("ecf,efd->ecd", h, p["down"])

    # ---- combine: each (token, k) reads its slot (the zero drop row when
    # dropped), scaled by its gate in the model dtype, summed over k in f32
    ye_flat = torch.cat([ye.reshape(E * C, d),
                         torch.zeros((1, d), dtype=ye.dtype, device=dev)])
    slot = torch.empty_like(dest)
    slot[order] = dest                                          # flat (t, k)
    contrib = ye_flat[slot] * gate_vals.reshape(TK, 1).to(ye.dtype)
    y = contrib.float().reshape(T, K, d).sum(dim=1)
    y = y.to(x.dtype).reshape(B, S, d)

    if m.n_shared:
        y = y + mlp(p["shared"], x, "swiglu")
    return y, aux
