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

**Data-parallel rows.** Under the sharded train step
(`repro_torch.distributed.step`, `moe_forward_tp`) each rank runs its own
rows of the batch, where the reference's GSPMD keeps the whole batch's
meaning. ``dp``, the
process group of the ranks that split the batch (rows in rank order),
keeps the three values that depend on the batch global: the capacity comes
from the global token count; a token's slot in its expert counts the
tokens of the same expert on lower ranks before its own, so the same
tokens drop as in one global dispatch; and the aux loss takes the global
per-expert means (all-reduced sums). The aux loss's gradient on each rank
is ``dp``'s size times its own rows' share, so that gradients summed over
the group and divided by its size (the token mean's scaling) give the
global aux loss's gradient. Without ``dp`` nothing is exchanged.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (Params, dense, dense_init, mlp,
                                       mlp_init, mlp_partial, normal_)
from repro_torch.obs.segments import mark


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


def _expert_counts(cfg: ArchConfig, expert_idx: torch.Tensor
                   ) -> torch.Tensor:
    """How many of the T*k assignments each expert received (f32)."""
    ce = torch.zeros(cfg.moe.n_experts, dtype=torch.float32,
                     device=expert_idx.device)
    return ce.scatter_add_(0, expert_idx.reshape(-1),
                           torch.ones(expert_idx.numel(), dtype=torch.float32,
                                      device=expert_idx.device))


def _aux_loss(cfg: ArchConfig, probs: torch.Tensor,
              expert_idx: torch.Tensor) -> torch.Tensor:
    """Switch aux loss ``E * sum_e f_e * p_e``: mean router probability
    times the share of the T*k assignments each expert received."""
    m = cfg.moe
    me = probs.mean(dim=0)
    ce = _expert_counts(cfg, expert_idx) / expert_idx.numel()
    return m.n_experts * torch.sum(me * ce) * m.router_aux_weight


def _all_reduced(x: torch.Tensor, dp) -> torch.Tensor:
    """The sum of ``x`` over the group (no gradient)."""
    total = x.detach().clone()
    dist.all_reduce(total, group=dp)
    return total


def _aux_loss_dp(cfg: ArchConfig, probs: torch.Tensor,
                 expert_idx: torch.Tensor, dp) -> torch.Tensor:
    """`_aux_loss` of the whole batch, whose rows the ranks of ``dp``
    split: the value is the global one, and the gradient through this
    rank's probabilities ``dp``'s size times its share (module
    docstring)."""
    m = cfg.moe
    n = dist.get_world_size(dp)
    T = probs.shape[0] * n
    local = probs.sum(dim=0) * n
    me = (local + (_all_reduced(probs.sum(dim=0), dp) - local).detach()) / T
    ce = _all_reduced(_expert_counts(cfg, expert_idx), dp) / (
        expert_idx.numel() * n)
    return m.n_experts * torch.sum(me * ce) * m.router_aux_weight


def _route(router: Params, cfg: ArchConfig, xf: torch.Tensor, dp):
    """The router's probabilities, each token's top-k gates (renormalised)
    and experts, and the aux loss."""
    K = cfg.moe.top_k
    logits = dense(router, xf).float()                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = top_p[:, :K], top_i[:, :K]          # (T, K)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    aux = (_aux_loss(cfg, probs, expert_idx) if dp is None
           else _aux_loss_dp(cfg, probs, expert_idx, dp))
    return gate_vals, expert_idx, aux


def _dispatch(cfg: ArchConfig, expert_idx: torch.Tensor, n_dp: int, dp,
              compact: bool = False, balanced: bool = False):
    """Sort-based dispatch: the (expert, token) order of the T*k
    assignments, the token of each, its slot ``e * C + position`` (the drop
    slot ``E * C`` past capacity) and C. With ``compact`` (and ``dp``) the
    slots are this rank's own: position among its own tokens of the
    expert, C no more than its T tokens (which tokens drop is the global
    dispatch's all the same). With ``balanced`` as well (meta tensors,
    which hold no counts) C is a balanced router's share of the rank's
    tokens, ``min(C, ceil(T * k / E))``."""
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    T = expert_idx.shape[0]
    dev = expert_idx.device
    TK = T * K
    flat_e = expert_idx.reshape(TK)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = torch.div(order, K, rounding_mode="floor")    # token of each
    counts = torch.zeros(E, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    seg_start = torch.cumsum(counts, dim=0) - counts
    pos_in_e = torch.arange(TK, device=dev) - seg_start[e_sorted]

    C = capacity(cfg, T * n_dp)
    if dp is None:
        keep = pos_in_e < C
    else:       # the tokens of the same expert on lower ranks come first
        every = [torch.empty_like(counts) for _ in range(n_dp)]
        dist.all_gather(every, counts, group=dp)
        below = sum(every[:dist.get_rank(dp)], torch.zeros_like(counts))
        keep = pos_in_e + below[e_sorted] < C
    if compact and dp is not None:
        C = min(C, -(-TK // E) if balanced else T)
    dest = torch.where(keep, e_sorted * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))       # drop slot
    return order, tok_sorted, dest, C


def _combine(ye: torch.Tensor, order: torch.Tensor, dest: torch.Tensor,
             gate_vals: torch.Tensor, T: int, K: int) -> torch.Tensor:
    """Each (token, k) reads its slot of ``ye`` (E', C, d) (the zero drop
    row past the end when dropped), scaled by its gate in the model dtype,
    summed over k in f32: (T, d)."""
    d = ye.shape[-1]
    ye_flat = torch.cat([ye.reshape(-1, d),
                         torch.zeros((1, d), dtype=ye.dtype,
                                     device=ye.device)])
    slot = torch.empty_like(dest)
    slot[order] = dest                                          # flat (t, k)
    contrib = ye_flat[slot] * gate_vals.reshape(T * K, 1).to(ye.dtype)
    return contrib.float().reshape(T, K, d).sum(dim=1)


def moe_forward(p: Params, cfg: ArchConfig, x: torch.Tensor,
                use_kernel: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss f32 scalar); the sharded
    step's counterpart is `moe_forward_tp`."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    dev = x.device
    xf = x.reshape(T, d)

    mark("moe.route")
    gate_vals, expert_idx, aux = _route(p["router"], cfg, xf, None)

    if cfg.moe_dense_decode and T <= 512:
        # every expert on every token: exact (no capacity drops), for a
        # handful of decode tokens
        mark("moe.gemm")
        h_all = F.silu(torch.einsum("td,edf->tef", xf, p["gate"])) * \
            torch.einsum("td,edf->tef", xf, p["up"])
        y_all = torch.einsum("tef,efd->ted", h_all, p["down"])  # (T, E, d)
        mark("moe.combine")
        weights = torch.zeros((T, E), dtype=torch.float32, device=dev)
        weights.scatter_add_(1, expert_idx, gate_vals)
        y = torch.einsum("te,ted->td", weights, y_all.float())
        y = y.to(x.dtype).reshape(B, S, d)
        if m.n_shared:
            y = y + mlp(p["shared"], x, "swiglu")
        return y, aux

    # ---- sort-based dispatch: (expert, token) order, capacity C per expert
    order, tok_sorted, dest, C = _dispatch(cfg, expert_idx, 1, None)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    buf[dest] = xf[tok_sorted]
    xe = buf[:E * C].reshape(E, C, d)

    # ---- expert SwiGLU: three grouped products
    mark("moe.gemm")
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
    mark("moe.combine")
    y = _combine(ye, order, dest, gate_vals, T, K)
    y = y.to(x.dtype).reshape(B, S, d)

    if m.n_shared:
        y = y + mlp(p["shared"], x, "swiglu")
    return y, aux


def moe_forward_tp(p: Params, cfg: ArchConfig, x: torch.Tensor, tp,
                   dp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`moe_forward` from and to the d-sharded residual stream over the
    tensor group of ``tp`` (`repro_torch.distributed.tp`).

    The router runs on the gathered input on every tensor rank alike (the
    same inputs and weights route alike; ``tp.check_replicated`` asserts it
    when the tests turn the check on), so capacity, slots, drops and the
    aux loss are the whole batch's as without ``tp``. Experts split over
    the tensor ranks where the policy puts E on the tensor axis: a rank
    runs its experts' slots (with the batch split over ranks, only the
    slots its own rows hold: one product an expert over its kept tokens,
    whose counts it reads back; on meta tensors, which hold no counts, a
    balanced router's share of its tokens an expert, ``ceil(T * k / E)``,
    up to the capacity). Otherwise every rank runs every expert on its
    range of the expert hidden dim (``down`` re-laid to those rows). Either
    way a rank's combine is a partial sum, reduce-scattered in f32 to the
    residual's d-shards; the experts' input and the gates carry partial
    gradients, so they pass through ``copy_to`` (all-reduced in the
    backward), and the router's whole ones do not."""
    m = cfg.moe
    h = tp.gather_input(x, dual="slice")
    B, S, d = h.shape
    T = B * S
    n_dp = 1 if dp is None else dist.get_world_size(dp)
    E, K = m.n_experts, m.top_k
    xf = h.reshape(T, d)

    gate_vals, expert_idx, aux = _route(tp.whole(p["router"]), cfg, xf, dp)
    tp.check_replicated(expert_idx, "the MoE routing")
    xs = tp.copy_to(xf)
    gates = tp.copy_to(gate_vals)

    if tp.placement(p["gate"]) == 0:                # experts on the axis
        mine = tp.own(E)
        sets = tp.range_sets(E)
        wg, wu = tp.take(p["gate"], 0, sets), tp.take(p["up"], 0, sets)
        wd = tp.take(p["down"], 0, sets)
    else:                                           # their hidden dim
        mine = range(0, E)
        sets = tp.range_sets(p["gate"].shape[-1])
        wg, wu = tp.take(p["gate"], -1, sets), tp.take(p["up"], -1, sets)
        wd = tp.take(p["down"], 1, sets)

    if cfg.moe_dense_decode and T * n_dp <= 512:
        h_all = F.silu(torch.einsum("td,edf->tef", xs, wg)) * \
            torch.einsum("td,edf->tef", xs, wu)
        y_all = torch.einsum("tef,efd->ted", h_all, wd)
        weights = torch.zeros((T, E), dtype=torch.float32, device=x.device)
        weights = weights.scatter_add(1, expert_idx, gates)
        y = torch.einsum("te,ted->td", weights[:, mine.start:mine.stop],
                         y_all.float())
    elif n_dp > 1 and x.device.type != "meta":
        # the rank's own kept tokens only, one product an expert: a rank's
        # rows fill only their own slots of the global dispatch
        order, tok_sorted, dest, C = _dispatch(cfg, expert_idx, n_dp, dp)
        e_sorted = torch.div(dest, C, rounding_mode="floor")
        here = (dest < E * C) & (e_sorted >= mine.start) & \
            (e_sorted < mine.stop)
        sel = torch.nonzero(here)[:, 0]
        counts = torch.bincount(e_sorted[sel] - mine.start,
                                minlength=len(mine)).tolist()
        xk = xs[tok_sorted[sel]]
        outs, start = [], 0
        for e, c in enumerate(counts):
            seg = xk[start:start + c]
            outs.append((F.silu(seg @ wg[e]) * (seg @ wu[e])) @ wd[e])
            start += c
        row = torch.full_like(dest, len(sel))
        row[sel] = torch.arange(len(sel), device=x.device)
        y = _combine(torch.cat(outs) if outs else xk[:0], order, row, gates,
                     T, K)
    else:
        order, tok_sorted, dest, C = _dispatch(
            cfg, expert_idx, n_dp, dp, compact=True,
            balanced=x.device.type == "meta")
        lo, n_local = mine.start * C, len(mine) * C
        dest = torch.where((dest >= lo) & (dest < lo + n_local), dest - lo,
                           torch.full_like(dest, n_local))
        buf = torch.zeros((n_local + 1, d), dtype=x.dtype, device=x.device)
        buf[dest] = xs[tok_sorted]
        xe = buf[:n_local].reshape(len(mine), C, d)
        hh = F.silu(torch.einsum("ecd,edf->ecf", xe, wg)) * \
            torch.einsum("ecd,edf->ecf", xe, wu)
        ye = torch.einsum("ecf,efd->ecd", hh, wd)
        y = _combine(ye, order, dest, gates, T, K)
    if m.n_shared:
        # one tensor rank: the input itself, as `moe_forward` reads it, so
        # that its gradient sums in the same order
        hs = h if tp.n == 1 else xs.reshape(B, S, d)
        y = y + mlp_partial(p["shared"], hs, "swiglu",
                            tp).reshape(T, d).float()
    return tp.reduce_scatter(y.reshape(B, S, d)).to(x.dtype), aux
