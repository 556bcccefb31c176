"""Plain PyTorch reference of the two configurations' decoders, in float32.

Written from the published architectures, not from the program, and it
imports nothing of the program:

* chatglm3-6b: pre-norm RMSNorm blocks; grouped-query attention (32 query
  heads over 2 key/value groups of 128) with biases on q, k and v; rotary
  embedding on the first half of each head (64 dims, theta 10000); a SwiGLU
  MLP; a final RMSNorm and an untied vocabulary head.
* granite-moe-3b-a800m: the same skeleton with 24 query heads over 8 KV
  heads of 64, rotary over the whole head, the embedding, residual,
  attention and logit multipliers, and a mixture-of-experts FFN: softmax
  router, top-8 of 40 experts, gates renormalised over the chosen 8, SwiGLU
  experts of width 512. The configuration as run keeps the program's expert
  capacity (``departures`` in its file): within one forward of T tokens an expert takes at most
  ``max(ceil(T * k / E * 1.25), k)`` assignments, in (token, slot) order,
  and drops the rest. Which tokens share a forward is therefore part of
  the result, so an MoE batch is recomputed whole: its prompts as one
  prefill forward and each decode position's rows as one decode forward.

`judge` recomputes a served batch with teacher forcing: the prompts and the
program's served tokens go in, and each served token is judged against the
reference's scores at its position: ``logits / T + g`` with the batch's
Gumbel draw ``g`` at temperature T > 0 (the benchmark hands the same draws
to the program), the logits themselves when T = 0. Its gap is how far the
served token's score lies below the best one; a token the reference would
also have chosen has gap 0.

Weights are the benchmark's tree, in the program's parameter layout
(stacked layers under ``blocks/l0``); every product is taken in float32
with TF32 off.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Spec:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    d_ff: int
    experts: int
    top_k: int
    d_expert: int
    capacity_factor: float
    eps: float
    rope_theta: float
    rotary_dim: int
    embedding_multiplier: float
    residual_multiplier: float
    attention_multiplier: float
    logits_scaling: float


def spec_of(config: Dict[str, Any]) -> Spec:
    """The reference's sizes from a configuration file: its published keys,
    with the sizes it ``assumed`` and its ``departures`` (where the
    configuration as run departs from the published one) over them."""
    config = {**config, **config.get("assumed", {}),
              **config.get("departures", {})}
    mt = config["model_type"]
    if mt == "chatglm":
        d, h = config["hidden_size"], config["num_attention_heads"]
        hd = config["kv_channels"]
        return Spec(config["num_layers"], d, h,
                    config["multi_query_group_num"], hd,
                    config["padded_vocab_size"], config["ffn_hidden_size"],
                    0, 0, 0, 0.0, config["layernorm_epsilon"],
                    float(config["rope_theta"]), int(config["rotary_dim"]),
                    1.0, 1.0, hd ** -0.5, 1.0)
    if mt == "granitemoe":
        d, h = config["hidden_size"], config["num_attention_heads"]
        hd = d // h
        return Spec(config["num_hidden_layers"], d, h,
                    config["num_key_value_heads"], hd, config["vocab_size"],
                    0, config["num_local_experts"],
                    config["num_experts_per_tok"], config["intermediate_size"],
                    float(config["moe_capacity_factor"]),
                    config["rms_norm_eps"], float(config["rope_theta"]), hd,
                    float(config["embedding_multiplier"]),
                    float(config["residual_multiplier"]),
                    float(config["attention_multiplier"]),
                    float(config["logits_scaling"]))
    raise ValueError(f"no reference for model_type {mt!r}")


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, pos: torch.Tensor, s: Spec) -> torch.Tensor:
    """x (..., S, H, hd), pos (S,): dims i and i + rot/2 of the first
    ``rotary_dim`` rotate together by pos * theta^(-2i / rot)."""
    rot = s.rotary_dim
    half = rot // 2
    inv = s.rope_theta ** (-torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = pos.float()[:, None] * inv                     # (S, half)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2, rest = x[..., :half], x[..., half:rot], x[..., rot:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos, rest], -1)


def _attend(q, k, v, qpos, kpos, scale):
    """q (b, Sq, H, hd), k/v (b, Sk, Hkv, hd); causal by absolute position
    (qpos (Sq,), kpos (Sk,))."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, hd)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * scale
    ok = kpos[None, :] <= qpos[:, None]
    sc = sc.masked_fill(~ok, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(b, sq, h, hd)


class _Layer:
    """Layer ``i``'s weights in float32."""

    def __init__(self, weights, i: int):
        blk = weights["blocks"]["l0"]
        f = lambda t: t[i].float()                  # noqa: E731
        self.ln1 = f(blk["ln1"]["scale"])
        self.ln2 = f(blk["ln2"]["scale"])
        at = blk["attn"]
        self.w = {k: f(at[k]["w"]) for k in ("wq", "wk", "wv", "wo")}
        self.b = {k: f(at[k]["b"]) for k in ("wq", "wk", "wv")
                  if "b" in at[k]}
        if "moe" in blk:
            m = blk["moe"]
            self.router = f(m["router"]["w"])
            self.eg, self.eu, self.ed = f(m["gate"]), f(m["up"]), f(m["down"])
            self.mlp = None
        else:
            m = blk["mlp"]
            self.mlp = tuple(f(m[k]["w"]) for k in ("gate", "up", "down"))

    def proj(self, x, name):
        y = x @ self.w[name]
        return y + self.b[name] if name in self.b else y


def _capacity(s: Spec, tokens: int) -> int:
    return max(int(math.ceil(tokens * s.top_k / s.experts
                             * s.capacity_factor)), s.top_k)


def _moe(L: _Layer, s: Spec, x: torch.Tensor,
         group_sizes: Sequence[int]) -> torch.Tensor:
    """x (T, d), tokens contiguous by forward (``group_sizes``), each forward
    in its own token order."""
    T = x.shape[0]
    E, K = s.experts, s.top_k
    probs = torch.softmax(x @ L.router, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top_p[:, :K]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    e = top_i[:, :K].reshape(-1)
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    sizes = torch.as_tensor(list(group_sizes), device=x.device)
    group = torch.repeat_interleave(torch.arange(len(group_sizes),
                                                 device=x.device), sizes)
    caps = torch.as_tensor([_capacity(s, n) for n in group_sizes],
                           device=x.device)
    key = group[tok] * E + e
    order = torch.argsort(key, stable=True)
    ks = key[order]
    counts = torch.bincount(key, minlength=len(group_sizes) * E)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=x.device) - start[ks]
    kept = order[pos < caps[torch.div(ks, E, rounding_mode="floor")]]
    g = gates.reshape(-1)
    out = torch.zeros_like(x)
    for ex in range(E):
        sel = kept[e[kept] == ex]
        if sel.numel() == 0:
            continue
        xs = x[tok[sel]]
        y = (F.silu(xs @ L.eg[ex]) * (xs @ L.eu[ex])) @ L.ed[ex]
        out.index_add_(0, tok[sel], y * g[sel, None])
    return out


def _ffn(L: _Layer, s: Spec, x: torch.Tensor, group_sizes) -> torch.Tensor:
    if L.mlp is None:
        return _moe(L, s, x, group_sizes)
    wg, wu, wd = L.mlp
    return (F.silu(x @ wg) * (x @ wu)) @ wd


@torch.no_grad()
def judge(s: Spec, weights: Dict[str, Any], prompts: torch.Tensor,
          row_prompt: torch.Tensor, tokens: torch.Tensor, rows: torch.Tensor,
          temperature: float, noise: Optional[Callable[[int], torch.Tensor]]
          ) -> Dict[str, Any]:
    """Judge the served ``tokens`` (B, N) of rows ``rows`` of one batch.

    ``prompts`` (R, L) are the batch's prompts in its order and
    ``row_prompt`` (B,) each row's prompt; ``noise(j)`` gives the batch's
    Gumbel draw for token j, (B, >= vocab). An MoE configuration is
    recomputed over every row (``rows`` must be all of them); a dense one
    over ``rows`` and their prompts only. Returns, for each judged row, the
    largest gap, the sum of its gaps, the number of its tokens the reference
    would not have chosen and the mean log-probability of its tokens."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        dev = prompts.device
        B, N = tokens.shape
        if s.experts and rows.numel() != B:
            raise ValueError("an MoE batch is judged over all of its rows")
        used = torch.unique(row_prompt[rows])
        remap = torch.full((prompts.shape[0],), -1, dtype=torch.long,
                           device=dev)
        remap[used] = torch.arange(used.numel(), device=dev)
        P = prompts[used].long()
        rp = remap[row_prompt[rows]]
        toks = tokens[rows].long()
        out = (weights["final_norm"]["scale"].float(),
               weights["lm_head"]["w"][:, :s.vocab].float())
        hidden = _final_hidden(s, weights, P, rp, toks)
        return _gaps(s, out, hidden, toks, rows, temperature, noise)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _scores(s, out, h, j, rows, temperature, noise):
    """Logits and scores of the hidden states ``h`` at token j; ``out`` is
    the final norm's scale and the vocabulary head, in float32."""
    fn, head = out
    logits = (_rms(h, fn, s.eps) @ head) / s.logits_scaling
    score = logits
    if temperature > 0:
        score = logits / temperature + noise(j)[rows, :s.vocab].float()
    return logits, score


def _gaps(s, out, hidden, toks, rows, temperature, noise):
    Bn, N = toks.shape
    dev = toks.device
    gap_max = torch.zeros(Bn, dtype=torch.float64, device=dev)
    gap_sum = torch.zeros(Bn, dtype=torch.float64, device=dev)
    misses = torch.zeros(Bn, dtype=torch.long, device=dev)
    lp_sum = torch.zeros(Bn, dtype=torch.float64, device=dev)
    for j in range(N):
        logits, score = _scores(s, out, hidden[j], j, rows, temperature,
                                noise)
        tok = toks[:, j]
        lp_sum += torch.log_softmax(logits, -1).gather(
            1, tok[:, None])[:, 0].double()
        gaps = (score.max(-1).values
                - score.gather(1, tok[:, None])[:, 0]).double()
        gap_max = torch.maximum(gap_max, gaps)
        gap_sum += gaps
        misses += gaps > 0
    return {"gap_max": gap_max.tolist(), "gap_sum": gap_sum.tolist(),
            "misses": misses.tolist(), "tokens": N,
            "mean_logprob": (lp_sum / N).tolist()}


def _final_hidden(s, weights, P, rp, toks):
    """The last layer's output at every position whose logits pick a
    token: (N, B', d), position j predicting token j of each row."""
    dev = P.device
    Rn, L = P.shape
    Bn, N = toks.shape
    n_dec = N - 1
    table = weights["embed"]["table"]
    xp = table[P].float() * s.embedding_multiplier            # (R', L, d)
    # decode positions j-major: a decode forward's rows are contiguous
    xd = (table[toks[:, :n_dec].T].float()
          * s.embedding_multiplier)                           # (N-1, B', d)
    ppos = torch.arange(L, device=dev)
    dpos = L + torch.arange(n_dec, device=dev)
    groups = [Rn * L] + [Bn] * n_dec
    hd = s.head_dim
    q_chunk = max(1, int(2.5e8 // (s.heads * max(n_dec, 1) * (L + n_dec))))
    for i in range(s.layers):
        Lw = _Layer(weights, i)
        hp = _rms(xp, Lw.ln1, s.eps)
        hdec = _rms(xd, Lw.ln1, s.eps)
        qp = _rope(Lw.proj(hp, "wq").view(Rn, L, s.heads, hd), ppos, s)
        kp = _rope(Lw.proj(hp, "wk").view(Rn, L, s.kv_heads, hd), ppos, s)
        vp = Lw.proj(hp, "wv").view(Rn, L, s.kv_heads, hd)
        qd = _rope(Lw.proj(hdec, "wq").view(n_dec, Bn, s.heads, hd)
                   .transpose(0, 1), dpos, s)
        kd = _rope(Lw.proj(hdec, "wk").view(n_dec, Bn, s.kv_heads, hd)
                   .transpose(0, 1), dpos, s)
        vd = Lw.proj(hdec, "wv").view(n_dec, Bn, s.kv_heads, hd) \
            .transpose(0, 1)
        op = torch.empty_like(qp)
        for r in range(Rn):
            for a in range(0, L, 512):
                op[r:r + 1, a:a + 512] = _attend(
                    qp[r:r + 1, a:a + 512], kp[r:r + 1, :a + 512],
                    vp[r:r + 1, :a + 512], ppos[a:a + 512], ppos[:a + 512],
                    s.attention_multiplier)
        od = torch.empty_like(qd)
        kpos = torch.cat([ppos, dpos])
        for a in range(0, Bn, q_chunk):
            sl = slice(a, a + q_chunk)
            k = torch.cat([kp[rp[sl]], kd[sl]], 1)
            v = torch.cat([vp[rp[sl]], vd[sl]], 1)
            od[sl] = _attend(qd[sl], k, v, dpos, kpos, s.attention_multiplier)
        xp = xp + s.residual_multiplier * (
            op.reshape(Rn, L, -1) @ Lw.w["wo"])
        xd = xd + s.residual_multiplier * (
            od.transpose(0, 1).reshape(n_dec, Bn, -1) @ Lw.w["wo"])
        flat = torch.cat([_rms(xp, Lw.ln2, s.eps).reshape(-1, s.d),
                          _rms(xd, Lw.ln2, s.eps).reshape(-1, s.d)])
        f = _ffn(Lw, s, flat, groups)
        xp = xp + s.residual_multiplier * f[:Rn * L].view(Rn, L, s.d)
        xd = xd + s.residual_multiplier * f[Rn * L:].view(n_dec, Bn, s.d)
        del Lw
    return torch.cat([xp[rp, L - 1][None], xd])
