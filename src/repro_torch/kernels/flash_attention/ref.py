"""Plain PyTorch version of the flash attention kernel (the CPU path of
`ops.flash_attention`, and what the kernel is held to on the card)."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention, q (B,Sq,H,D), k/v (B,Sk,Hkv,D|Dv) -> (B,Sq,H,Dv); positions are an
    iota from 0 for q and k. Materialized f32 softmax. A query row with no
    valid key comes out 0, as from the TPU and CUDA kernels."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    if scale is None:
        scale = D ** -0.5
    g = H // Hkv
    qg = q.reshape(B, Sq, Hkv, g, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    o = o * mask.any(dim=-1).to(o.dtype)[None, :, None, None, None]
    return o.reshape(B, Sq, H, Dv).to(q.dtype)
