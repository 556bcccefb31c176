"""Mamba-2 (state-space duality) block, ported from ``repro.models.ssm``.

Prefill / train: the chunked SSD scan. Its intra-chunk half runs in the
hand-written kernel `repro_torch.kernels.ssd_scan.ssd_chunk` with
``use_kernel`` (its plain version on CPU tensors), else in the plain einsums
of `ssd_chunk_ref`; the inter-chunk state carry is a Python loop over chunks
where the reference runs ``jax.lax.scan``. Decode (S == 1 with a cache): the
exact one-token recurrence

    state <- state * exp(dt*A) + dt * (B outer x);   y = <C, state> + D*x

in plain torch (the reference has no kernel for it either).

Where the port departs from a line-by-line copy, and why:

* **In-place cache.** The new SSM state and conv tail are copied into the
  cache entry the caller passed (`repro_torch.models.model` hands each layer
  views of the stacked cache), as the port's attention does.
* **No copies of B and C per head.** ``jnp.repeat`` over the groups becomes
  a stride-0 ``expand`` view when there is one group (every config here),
  which the kernel reads through its strides; ``reshape`` copies only for
  several groups, with ``repeat_interleave``'s order. A prompt that is not a
  whole number of chunks pads the one group row and expands it again, so
  that the padded B and C keep their stride-0 head axis.
* **Softplus** is ``logaddexp(x, 0)``, the function ``jax.nn.softplus``
  computes, not ``F.softplus`` with its linear cut-over.
* **Sharding hints** (`repro_torch.distributed.hints`) sit where the
  reference puts them, on x, B, C and the dt projection. They are off
  unless enabled (the dry-run's ``--hints``), and act only on a DTensor.
  The sharded step does not need them: `ssm_forward_tp` splits the SSD's
  heads over the tensor ranks with or without them, which is what the
  reference's hint pins.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import segsum, ssd_chunk_ref
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (Params, Shapes, dense, dense_init,
                                       dense_shapes, dense_tp, normal_)

__all__ = ["segsum", "ssm_shapes", "ssm_init", "ssd_chunked",
           "ssd_decode_step", "ssm_forward", "ssm_forward_tp"]

#: leaves kept in f32 whatever the model dtype (as the reference keeps them)
F32_KEYS = frozenset({"A_log", "dt_bias", "D"})


# --------------------------------------------------------------------------- params

def ssm_shapes(cfg: ArchConfig) -> Dict:
    s = cfg.ssm
    d_in, H = cfg.d_inner, cfg.ssm_heads
    bc = 2 * s.n_groups * s.d_state
    if cfg.ssm_split_proj:
        proj: Dict[str, Shapes] = {
            "in_proj_z": dense_shapes(cfg.d_model, d_in),
            "in_proj_x": dense_shapes(cfg.d_model, d_in),
            "in_proj_bc": dense_shapes(cfg.d_model, bc),
            "in_proj_dt": dense_shapes(cfg.d_model, H)}
    else:
        proj = {"in_proj": dense_shapes(cfg.d_model, 2 * d_in + bc + H)}
    return {**proj, "conv_w": (s.d_conv, d_in + bc), "conv_b": (d_in + bc,),
            "A_log": (H,), "dt_bias": (H,), "D": (H,),
            "norm_scale": (d_in,), "out_proj": dense_shapes(d_in, cfg.d_model)}


def ssm_init(gen: torch.Generator, cfg: ArchConfig, dtype, device,
             stack: Tuple[int, ...] = ()) -> Params:
    """The reference's distributions: dense projections normal * d_in^-1/2,
    conv weights normal * d_conv^-1/2, ``A_log = log(1..H)``, ``D = 1``, and
    ``dt_bias`` the inverse softplus of a dt drawn log-uniform in
    ``[dt_min, dt_max]``; ``A_log``, ``dt_bias`` and ``D`` are f32."""
    s = cfg.ssm
    d_in, H = cfg.d_inner, cfg.ssm_heads
    bc = 2 * s.n_groups * s.d_state

    def proj(d_out):
        return dense_init(gen, cfg.d_model, d_out, dtype, device, stack=stack)

    if cfg.ssm_split_proj:
        p: Params = {"in_proj_z": proj(d_in), "in_proj_x": proj(d_in),
                     "in_proj_bc": proj(bc), "in_proj_dt": proj(H)}
    else:
        p = {"in_proj": proj(2 * d_in + bc + H)}
    u = torch.empty(stack + (H,), dtype=torch.float32, device=device)
    u.uniform_(generator=gen)
    lo, hi = np.log(s.dt_min), np.log(s.dt_max)
    dt = torch.exp(u * (hi - lo) + lo)
    conv_w = torch.empty(stack + (s.d_conv, d_in + bc), dtype=dtype,
                         device=device)
    p.update({
        "conv_w": normal_(conv_w, 1.0 / np.sqrt(s.d_conv), gen),
        "conv_b": torch.zeros(stack + (d_in + bc,), dtype=dtype,
                              device=device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=device)).expand(
                                            stack + (H,)).clone(),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),   # inverse softplus
        "D": torch.ones(stack + (H,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones(stack + (d_in,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, d_in, cfg.d_model, dtype, device,
                               stack=stack),
    })
    return p


# --------------------------------------------------------------------------- SSD core

def _pad_rows(a: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, L, H, N) -> (B, L + pad, H, N) with zero rows at the end. A
    stride-0 head axis stays one: the group row is padded, then expanded."""
    if a.stride(2) == 0:
        return F.pad(a[:, :, :1], (0, 0, 0, 0, 0, pad)).expand(
            -1, -1, a.shape[2], -1)
    return F.pad(a, (0, 0, 0, 0, 0, pad))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                use_kernel: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x (B, L, H, P); dt (B, L, H) positive step sizes (f32); A (H,) negative
    decay rates; Bm, Cm (B, L, H, N) (groups already broadcast over heads).
    Returns (y (B, L, H, P) in x's dtype, final_state (B, H, P, N) f32).
    """
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-L) % chunk
    if pad:
        # zero rows at the end: dt = 0 there, so they add nothing
        x, dt = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)) for a in (x, dt))
        Bm, Cm = _pad_rows(Bm, pad), _pad_rows(Cm, pad)
    nc = x.shape[1] // chunk

    def to_chunks(a):
        return a.reshape((B, nc, chunk) + tuple(a.shape[2:]))

    xc, dtc, Bc, Cc = map(to_chunks, (x, dt, Bm, Cm))
    dA = dtc * A                                           # (B,nc,Q,H)
    dA_cs = torch.cumsum(dA, dim=2)
    chunk_fn = ssd_ops.ssd_chunk if use_kernel else ssd_chunk_ref
    Y_diag, chunk_states = chunk_fn(xc, dtc, dA, dA_cs, Bc, Cc)

    # inter-chunk recurrence (sequential over chunks, O(1) state)
    state = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])            # (B,nc,H)
    prev = []
    for c in range(nc):
        prev.append(state)                                 # state before c
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (B,nc,H,P,N)

    # contribution of the inherited state within each chunk
    Y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Cc.float(), prev_states,
                         torch.exp(dA_cs))
    y = (Y_diag + Y_off).reshape(B, nc * chunk, H, P)[:, :L]
    return y.to(x.dtype), state


def ssd_decode_step(x, dt, A, Bm, Cm, state):
    """Exact single-token recurrence. x (B,1,H,P), dt (B,1,H), Bm/Cm
    (B,1,H,N), state (B,H,P,N) f32. Returns (y (B,1,H,P), new state)."""
    dA = torch.exp(dt[:, 0] * A)                           # (B,H)
    dBx = torch.einsum("bhn,bh,bhp->bhpn", Bm[:, 0].float(), dt[:, 0].float(),
                       x[:, 0].float())
    new_state = state * dA[:, :, None, None] + dBx
    y = torch.einsum("bhn,bhpn->bhp", Cm[:, 0].float(), new_state)
    return y[:, None].to(x.dtype), new_state


# --------------------------------------------------------------------------- block

def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor]):
    """Depthwise causal conv1d. xBC (B,S,Ch), w (K,Ch). Returns (y, new
    state: the last K-1 rows of the context)."""
    K = w.shape[0]
    B, S, Ch = xBC.shape
    if conv_state is None:
        ctx = F.pad(xBC, (0, 0, K - 1, 0))
    else:
        ctx = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    # y[t] = sum_k w[k] * ctx[t + k]
    y = sum(ctx[:, k:k + S] * w[k] for k in range(K)) + b
    new_state = ctx[:, ctx.shape[1] - (K - 1):]
    return y, new_state


def ssm_forward(p: Params, cfg: ArchConfig, u: torch.Tensor,
                cache: Optional[Dict] = None,
                use_kernel: bool = False) -> Tuple[torch.Tensor,
                                                   Optional[Dict]]:
    """Full Mamba-2 block: in_proj -> conv -> SSD -> gated norm -> out_proj.

    cache: {"ssm": (B,H,P,N) f32, "conv": (B,K-1,Ch)}, updated in place and
    returned (None without a cache)."""
    s = cfg.ssm
    B, S, _ = u.shape
    d_in, H, N, G = cfg.d_inner, cfg.ssm_heads, s.d_state, s.n_groups
    P = s.headdim

    if cfg.ssm_split_proj:
        z = dense(p["in_proj_z"], u)
        xBC = torch.cat([dense(p["in_proj_x"], u), dense(p["in_proj_bc"], u)],
                        dim=-1)
        dt_raw = dense(p["in_proj_dt"], u)
    else:
        zxbcdt = dense(p["in_proj"], u)
        z = zxbcdt[..., :d_in]
        xBC = zxbcdt[..., d_in:2 * d_in + 2 * G * N]
        dt_raw = zxbcdt[..., zxbcdt.shape[-1] - H:]

    conv_state = cache["conv"] if cache is not None else None
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC)

    x = xBC[..., :d_in].reshape(B, S, H, P)

    def per_head(a):            # (B,S,G*N) -> (B,S,H,N), head h reads group h // rep
        a = a.reshape(B, S, G, 1, N).expand(B, S, G, H // G, N)
        return a.reshape(B, S, H, N)

    Bm = per_head(xBC[..., d_in:d_in + G * N])
    Cm = per_head(xBC[..., d_in + G * N:])

    # the reference's hint: pin the head dim to the tensor axis (no-op
    # unless enabled)
    from repro_torch.distributed import hints
    if hints.enabled():
        x = hints.constrain(x, (None, None, "tensor", None), divisible_dim=2)
        Bm = hints.constrain(Bm, (None, None, "tensor", None), divisible_dim=2)
        Cm = hints.constrain(Cm, (None, None, "tensor", None), divisible_dim=2)
        dt_raw = hints.constrain(dt_raw, (None, None, "tensor"),
                                 divisible_dim=2)

    dt = torch.logaddexp(dt_raw.float() + p["dt_bias"],
                         torch.zeros((), device=u.device))
    A = -torch.exp(p["A_log"])

    init_state = cache["ssm"] if cache is not None else None
    if S == 1 and init_state is not None:
        y, new_state = ssd_decode_step(x, dt, A, Bm, Cm, init_state)
    else:
        y, new_state = ssd_chunked(x, dt, A, Bm, Cm, s.chunk, init_state,
                                   use_kernel=use_kernel)

    y = y + x * p["D"][:, None].to(y.dtype)
    y = y.reshape(B, S, d_in)

    # gated RMSNorm (mamba2), in f32
    g = y.float() * F.silu(z.float())
    var = torch.mean(g * g, dim=-1, keepdim=True)
    g = g * torch.rsqrt(var + cfg.norm_eps) * p["norm_scale"].float()
    out = dense(p["out_proj"], g.to(u.dtype))

    if cache is not None:
        cache["ssm"].copy_(new_state)
        cache["conv"].copy_(new_conv)
    return out, cache


# --------------------------------------------------------------------------- tensor-parallel

def _head_sets(cfg: ArchConfig, tp):
    """Each rank's SSD heads (floor ranges), the groups they read, and its
    index sets: ``"proj"`` into ``in_proj``'s columns (z and x of its
    heads, B and C of its groups, dt of its heads), ``"ch"`` into the conv
    channels (x, B, C), ``"bc"`` into ``in_proj_bc``'s columns (B, C)."""
    s = cfg.ssm
    d_in, H, N, G, P = (cfg.d_inner, cfg.ssm_heads, s.d_state, s.n_groups,
                        s.headdim)
    rep = H // G
    heads = tp.ranges(H)
    groups = [range(r.start // rep, (r.stop - 1) // rep + 1) if len(r)
              else range(0, 0) for r in heads]

    def parts(r):
        hs, gs = heads[r], groups[r]
        x = np.arange(hs.start * P, hs.stop * P)
        bc = np.arange(gs.start * N, gs.stop * N)
        return x, bc, np.arange(hs.start, hs.stop)

    def make(kind):
        out = []
        for r in range(tp.n):
            x, bc, dt = parts(r)
            out.append({
                "proj": [x, d_in + x, 2 * d_in + bc, 2 * d_in + G * N + bc,
                         2 * d_in + 2 * G * N + dt],
                "ch": [x, d_in + bc, d_in + G * N + bc],
                "bc": [bc, G * N + bc]}[kind])
        return [np.concatenate(a) for a in out]

    sets = {k: tp.index_sets(("ssm", k, d_in, H, N, G, P),
                             lambda k=k: make(k))
            for k in ("proj", "ch", "bc")}
    return heads, groups, sets


def ssm_forward_tp(p: Params, cfg: ArchConfig, x: torch.Tensor,
                   cache: Optional[Dict], tp) -> Tuple[torch.Tensor,
                                                       Optional[Dict]]:
    """`ssm_forward` from and to the d-sharded residual stream over the
    tensor group ``tp`` (`repro_torch.distributed.tp`), its SSD heads split
    over the tensor ranks (floor ranges: mamba2-370m's 32 heads on 16 ranks
    give 2 each, jamba's 128 give 8).

    ``in_proj`` is taken with one index set a rank along its columns: z, x
    and dt of the rank's heads, B and C of the groups they read (every
    group on every rank with one group); with ``ssm_split_proj`` each of
    the four projections with its own set. B and C are computed alike on
    every rank, but each rank's heads read them, so their gradients are
    partial sums, as every other consumer of the gathered input's are: the
    overlapping sets sum them back into the leaf in the backward. The conv
    takes the same channels, ``A_log``, ``dt_bias``, ``D`` and
    ``norm_scale`` the rank's slice; the SSD runs on the rank's heads; the
    gated RMSNorm's sum of squares over d_inner is all-reduced both ways;
    ``out_proj`` is re-laid to the rows of the rank's channels and its
    partial output reduce-scattered. The SSM state (B, H, P, N) is read and
    written in place when the cache holds it chunked on H (the rank's
    heads); the conv state (B, K-1, Ch), chunked evenly over channels that
    do not line up with the rank's sets, is gathered for the layer (K - 1
    rows) and the rank's chunk written back. Plain PyTorch: the kernels
    take no shards. With one tensor rank, `ssm_forward`'s arithmetic."""
    s = cfg.ssm
    B, S, _ = x.shape
    d_in, H, N, G, P = (cfg.d_inner, cfg.ssm_heads, s.d_state, s.n_groups,
                        s.headdim)
    if H < tp.n:
        raise ValueError(f"{H} SSD heads over a {tp.n}-wide tensor axis")
    heads, groups, sets = _head_sets(cfg, tp)
    hs, gs = heads[tp.rank], groups[tp.rank]
    hl, gl, xl = len(hs), len(gs), len(hs) * P
    u = tp.gather_input(x)

    if cfg.ssm_split_proj:
        x_sets = tp.head_sets(heads, P)
        z = dense_tp(p["in_proj_z"], u, tp, x_sets)
        xBC = torch.cat([dense_tp(p["in_proj_x"], u, tp, x_sets),
                         dense_tp(p["in_proj_bc"], u, tp, sets["bc"])], dim=-1)
        dt_raw = dense_tp(p["in_proj_dt"], u, tp, tp.range_sets(H))
    else:
        zxbcdt = dense_tp(p["in_proj"], u, tp, sets["proj"])
        z = zxbcdt[..., :xl]
        xBC = zxbcdt[..., xl:2 * xl + 2 * gl * N]
        dt_raw = zxbcdt[..., zxbcdt.shape[-1] - hl:]

    conv_state = None
    if cache is not None:           # the conv tail, gathered for the layer
        conv = cache["conv"]
        if tp.cache_dims.get("conv") is not None:
            conv = tp.gather(conv, tp.cache_dims["conv"])
        conv_state = tp.select(conv, 2, sets["ch"])
    xBC, new_conv = _causal_conv(xBC, tp.take(p["conv_w"], -1, sets["ch"]),
                                 tp.take(p["conv_b"], 0, sets["ch"]),
                                 conv_state)
    xBC = F.silu(xBC)

    xh = xBC[..., :xl].reshape(B, S, hl, P)
    rep = H // G

    def per_head(a):            # (B,S,gl*N) -> (B,S,hl,N): the rank's heads
        if gl == 1:
            return a.reshape(B, S, 1, N).expand(B, S, hl, N)
        if hs.start % rep == 0 and hl == gl * rep:     # whole groups
            a = a.reshape(B, S, gl, 1, N).expand(B, S, gl, rep, N)
            return a.reshape(B, S, hl, N)
        idx = [(hs.start + i) // rep - gs.start for i in range(hl)]
        return a.reshape(B, S, gl, N)[:, :, idx]

    Bm = per_head(xBC[..., xl:xl + gl * N])
    Cm = per_head(xBC[..., xl + gl * N:])

    h_sets = tp.range_sets(H)
    dt = torch.logaddexp(dt_raw.float() + tp.take(p["dt_bias"], 0, h_sets),
                         torch.zeros((), device=x.device))
    A = -torch.exp(tp.take(p["A_log"], 0, h_sets))

    state = None
    if cache is not None:
        state = cache["ssm"]
        if tp.cache_dims.get("ssm") is None:           # held whole: a view
            state = state[:, hs.start:hs.stop]
    if S == 1 and state is not None:
        y, new_state = ssd_decode_step(xh, dt, A, Bm, Cm, state)
    else:
        y, new_state = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk, state)

    y = y + xh * tp.take(p["D"], 0, h_sets)[:, None].to(y.dtype)
    y = y.reshape(B, S, xl)

    # gated RMSNorm over the whole d_inner, in f32
    g = y.float() * F.silu(z.float())
    if tp.n == 1:
        var = torch.mean(g * g, dim=-1, keepdim=True)
    else:
        var = tp.all_reduce_both(torch.sum(g * g, dim=-1,
                                           keepdim=True)) / d_in
    x_sets = tp.head_sets(heads, P)
    g = g * torch.rsqrt(var + cfg.norm_eps) * \
        tp.take(p["norm_scale"], 0, x_sets).float()
    out = tp.reduce_scatter(g.to(x.dtype) @ tp.take(p["out_proj"]["w"], 0,
                                                    x_sets))

    if cache is not None:
        if tp.cache_dims.get("ssm") is None and tp.n > 1:
            cache["ssm"].copy_(tp.gather_sets(new_state, 1, heads, H))
        else:
            state.copy_(new_state)
        whole = tp.gather_sets(new_conv, 2, sets["ch"], d_in + 2 * G * N)
        cdim = tp.cache_dims.get("conv")
        cache["conv"].copy_(tp.chunk(whole, cdim) if cdim is not None
                            else whole)
    return out, cache
