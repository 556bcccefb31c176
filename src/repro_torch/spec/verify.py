"""Distribution-preserving accept/reject for speculative verify.

Ported from ``repro.spec.verify``. One verify forward scores S = n + 1 query
tokens (the last committed token plus n drafted ones), giving
``logits[:, j]`` = the target model's next-token distribution *after* draft
prefix ``d_1..d_j``. Draft proposals are deterministic (point-mass proposals
q = delta(d)), so the exact rejection-sampling rule collapses to:

  accept d_{j+1}  with probability  p_j(d_{j+1})      (p_j = target at step j)
  on the first rejection at j = L, emit one corrective token sampled from
  the residual  p_L(x) * 1[x != d_{L+1}] / (1 - p_L(d_{L+1}))
  if all n drafts survive, emit one bonus token sampled from p_n.

Marginally every emitted token is distributed exactly as sequential sampling
from the target. The greedy path (temperature == 0) replaces "accept w.p.
p(d)" with "accept iff d == argmax p" and the correction/bonus with argmax,
which commits exactly the token chain sequential greedy decode would give.

Reported logprobs are ``log_softmax(logits)`` (untempered), as the decode
step reports them; acceptance and resampling use the tempered distribution
``softmax(logits / temperature)``.

The reference draws its randomness inside the function (a uniform per draft
and ``jax.random.categorical``, which is ``argmax(scores + gumbel)``); the
port takes the draws as tensors, ``u`` (B, n) uniform in [0, 1) and ``g``
(B, V) standard Gumbel, so that the caller decides where they come from (a
CUDA graph reads them from static buffers; a test feeds the reference's).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30


def verify_tokens(logits: torch.Tensor, drafts: torch.Tensor,
                  temperature: float, greedy: bool,
                  u: Optional[torch.Tensor] = None,
                  g: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Accept/reject n drafted tokens against target logits.

    logits (B, n+1, V); drafts (B, n) token ids; ``u`` (B, n) uniform and
    ``g`` (B, V) Gumbel draws, read only on the sampled path (``greedy``
    False), where both are required.

    Returns (accept_len (B,) int64 in [0, n], out_tokens (B, n+1) int64,
    out_logps (B, n+1) float32): row b emits ``out_tokens[b, :accept_len[b]
    + 1]``, the accepted draft prefix plus one correction/bonus token.
    Entries past that prefix are garbage and must not be read. No value
    goes to the host, so the function can run inside a CUDA graph.
    """
    B, n_q, V = logits.shape
    n = n_q - 1
    dev = logits.device
    lf = logits.float()
    drafts = drafts.long()
    logp = torch.log_softmax(lf, dim=-1)               # reported logprobs
    if greedy:
        top = torch.argmax(lf, dim=-1)                 # (B, n+1)
        acc = (drafts == top[:, :n]).long()
        accept_len = torch.cumprod(acc, dim=1).sum(dim=1) if n else \
            torch.zeros(B, dtype=torch.long, device=dev)
        final = torch.gather(top, 1, accept_len[:, None])[:, 0]
    else:
        if g is None or (n and u is None):
            raise ValueError("sampled verify needs the draws u and g")
        scaled = lf / temperature
        if n:
            logp_t = torch.log_softmax(scaled[:, :n], dim=-1)
            p_draft = torch.exp(torch.gather(logp_t, -1,
                                             drafts[..., None])[..., 0])
            accepted = torch.cumprod((u < p_draft).long(), dim=1)
            accept_len = accepted.sum(dim=1)
        else:
            accept_len = torch.zeros(B, dtype=torch.long, device=dev)
        # correction (L < n: residual, the draft token masked out) or bonus
        # (L == n: a plain target sample) from one categorical draw
        scores = torch.gather(
            scaled, 1, accept_len[:, None, None].expand(B, 1, V))[:, 0]
        if n:
            d_next = torch.gather(drafts, 1,
                                  accept_len.clamp(max=n - 1)[:, None])[:, 0]
            mask = (torch.arange(V, device=dev)[None] == d_next[:, None]) \
                & (accept_len < n)[:, None]
            scores = scores.masked_fill(mask, NEG_INF)
        final = torch.argmax(scores + g, dim=-1)

    chain = torch.cat([drafts, torch.zeros((B, 1), dtype=torch.long,
                                           device=dev)], dim=1)
    at = torch.arange(n + 1, device=dev)[None] == accept_len[:, None]
    out_tokens = torch.where(at, final[:, None], chain)
    out_logps = torch.gather(logp, -1, out_tokens[..., None])[..., 0]
    return accept_len, out_tokens, out_logps


def emission_distribution(probs_next, draft_token: int):
    """Analytic marginal of the accept/reject rule at one step (numpy):
    accept the point-mass draft w.p. p(d), else sample the renormalized
    residual. Equals ``probs_next`` identically: the algebra the
    distribution-preservation tests pin against the sampled implementation.
    """
    p = np.asarray(probs_next, np.float64)
    out = np.zeros_like(p)
    pd = p[draft_token]
    out[draft_token] = pd
    if pd < 1.0:
        resid = p.copy()
        resid[draft_token] = 0.0
        out += (1.0 - pd) * resid / max(1.0 - pd, 1e-300)
    return out
