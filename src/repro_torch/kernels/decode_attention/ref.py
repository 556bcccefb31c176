"""Plain PyTorch versions of the decode attention kernels (the CPU path of
`ops`, and what the kernels are held to on the card)."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: torch.Tensor,
                         q_pos: torch.Tensor, *,
                         scale: Optional[float] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """q (B,1,H,D); caches (B,W,Hkv,D|Dv); pos (B,W) absolute position per
    slot (-1 = empty); q_pos (B,). Returns (B,1,H,Dv).

    A row with no valid slot comes out 0, as from the TPU kernel and the
    CUDA one (the jnp oracle's softmax over all-masked scores gives the mean
    of V there instead)."""
    B, _, H, D = q.shape
    _, W, Hkv, Dv = v_cache.shape
    if scale is None:
        scale = D ** -0.5
    g = H // Hkv
    qg = q.reshape(B, 1, Hkv, g, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float()) * scale
    valid = (pos >= 0) & (pos <= q_pos[:, None])
    if window is not None:
        valid &= pos > (q_pos[:, None] - window)
    s = torch.where(valid[:, None, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
    o = o * valid.any(dim=-1).to(o.dtype)[:, None, None, None, None]
    return o.reshape(B, 1, H, Dv).to(q.dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, pos_pool: torch.Tensor,
                               block_table: torch.Tensor, q_pos: torch.Tensor,
                               *, scale: Optional[float] = None,
                               kv_len: Optional[int] = None) -> torch.Tensor:
    """Gather each sequence's pool blocks in logical order into a dense
    (B, nb*bs) view, then run `decode_attention_ref`. pools (P,bs,Hkv,D|Dv),
    pos_pool (P,bs), block_table (B,nb). A table entry outside [0, P) reads
    as an empty block, as in the CUDA kernel."""
    B = q.shape[0]
    P = pos_pool.shape[0]
    bt = block_table.long()
    in_pool = (bt >= 0) & (bt < P)
    bt = torch.where(in_pool, bt, torch.zeros_like(bt))
    kc = k_pool[bt].reshape(B, -1, *k_pool.shape[2:])
    vc = v_pool[bt].reshape(B, -1, *v_pool.shape[2:])
    pc = torch.where(in_pool[..., None], pos_pool[bt],
                     torch.full_like(pos_pool[bt], -1)).reshape(B, -1)
    if kv_len is not None:
        kc, vc, pc = kc[:, :kv_len], vc[:, :kv_len], pc[:, :kv_len]
    return decode_attention_ref(q, kc, vc, pc, q_pos, scale=scale)
