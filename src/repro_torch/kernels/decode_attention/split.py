"""The decode kernels' split of the slot axis (flash-decoding): how the
wrappers cut a dense ring of W slots, or the nb * bs logical slots of a
block-table row, across blocks, and plain versions of the kernels'
per-split partials and their merge.

`plan_splits` runs on every kernel launch. `decode_attention_split_ref` and
`paged_decode_attention_split_ref` repeat the kernels' arithmetic for the
tests; the wrappers never call them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
#: cache slots a block copies and scores at a time (``split::TILE``)
TILE = 32
#: query heads one block serves at most (``split::HB``)
HEADS_PER_BLOCK = 16
#: splits of one sequence at most: the merge keeps a head's split factors
#: in one 32-float row of shared memory
MAX_SPLITS = TILE
#: warps of a paged block; warp w takes slots 8w .. 8w+7 of every tile
#: (``paged::WARPS``)
PAGED_WARPS = 4


def plan_splits(B: int, Hkv: int, W: int, group: int, n_sm: int,
                blocks_per_sm: int) -> Tuple[int, int, int]:
    """(n_split, split_slots, n_hb) for a dense decode over B sequences of
    ``W`` slots, ``Hkv`` kv heads of ``group`` query heads each, on a card
    of ``n_sm`` SMs that hold ``blocks_per_sm`` blocks of the kernel each.

    A block serves up to 16 query heads of one kv head (``n_hb`` head
    batches a kv head) and one range of ``split_slots`` slots, a multiple of
    the 32-slot tile. The planner gives each (sequence, kv head, head batch)
    as many splits as still fit every block in one wave of the card, never
    more splits than tiles or than 32, and then takes the fewest splits of
    that many tiles: every slot falls in exactly one split and no split is
    empty of slots (W = 0 gives one empty split)."""
    n_hb = max(1, math.ceil(group / HEADS_PER_BLOCK))
    tiles = max(1, math.ceil(W / TILE))
    pairs = max(1, B * Hkv * n_hb)
    n_split = min(tiles, MAX_SPLITS, max(1, n_sm * blocks_per_sm // pairs))
    split_slots = math.ceil(tiles / n_split) * TILE
    n_split = max(1, math.ceil(W / split_slots))
    return n_split, split_slots, n_hb


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, pos: torch.Tensor,
                               q_pos: torch.Tensor, *, n_split: int,
                               split_slots: int,
                               scale: Optional[float] = None,
                               window: Optional[int] = None) -> torch.Tensor:
    """`decode_attention_ref` computed as the split kernel computes it: each
    range of ``split_slots`` slots reduced to a partial (m, l, acc) per
    query head, a range with no valid slot giving (NEG_INF, 0, 0), then the
    partials merged by ``exp(m_i - m_safe)`` with the TPU kernel's guard. A
    row whose ranges are all empty comes out 0. f32 throughout; returns
    (B,1,H,Dv) in q's dtype."""
    B, _, H, D = q.shape
    _, W, Hkv, Dv = v_cache.shape
    if scale is None:
        scale = D ** -0.5
    g = H // Hkv
    pad = n_split * split_slots - W
    if pad < 0:
        raise ValueError(f"{n_split} splits of {split_slots} slots do not "
                         f"cover {W} slots")
    qg = q.reshape(B, Hkv, g, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    valid = (pos >= 0) & (pos <= q_pos[:, None])
    if window is not None:
        valid &= pos > (q_pos[:, None] - window)
    valid = torch.nn.functional.pad(valid, (0, pad))[:, None, None]
    s = torch.nn.functional.pad(s, (0, pad))
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    s = s.reshape(B, Hkv, g, n_split, split_slots)
    valid = valid.reshape(B, 1, 1, n_split, split_slots)
    # per split: the running max, its guarded shift, the sums
    m = s.amax(dim=-1)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(valid, torch.exp(s - m_safe[..., None]),
                    torch.zeros_like(s))
    l = p.sum(dim=-1)
    vc = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, 0, 0, pad))
    vc = vc.reshape(B, n_split, split_slots, Hkv, Dv)
    acc = torch.einsum("bhgnk,bnkhd->bhgnd", p, vc)
    # the merge
    m_max = m.amax(dim=-1, keepdim=True)
    m_max = torch.where(m_max <= NEG_INF / 2, torch.zeros_like(m_max), m_max)
    f = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                    torch.exp(m - m_max))
    l_sum = (f * l).sum(dim=-1)
    a_sum = (f[..., None] * acc).sum(dim=-2)
    o = a_sum / torch.clamp(l_sum, min=1e-20)[..., None]
    return o.reshape(B, 1, H, Dv).to(q.dtype)


def _bf16_hi_lo(p: torch.Tensor) -> torch.Tensor:
    """p as the paged kernel's bf16 P . V takes it: a bf16 high part plus
    the bf16 rounding of what is left, summed in f32 (about 16 bits)."""
    hi = p.to(torch.bfloat16).float()
    return hi + (p - hi).to(torch.bfloat16).float()


def paged_decode_attention_split_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     pos_pool: torch.Tensor,
                                     block_table: torch.Tensor,
                                     q_pos: torch.Tensor, *, n_split: int,
                                     split_slots: int,
                                     scale: Optional[float] = None,
                                     split_p: bool = True) -> torch.Tensor:
    """`paged_decode_attention_ref` computed as the paged split kernel
    computes it. The slots are addressed through the table: logical slot j
    of row b is pool row ``block_table[b, j // bs] * bs + j % bs``, and an
    entry outside [0, P) reads as an empty block. Each range of
    ``split_slots`` logical slots is one block; warp w of it takes slots 8w
    .. 8w+7 of every 32-slot tile and reduces them to a partial (m, l, acc)
    per query head, (NEG_INF, 0, 0) with no valid slot. The warps' partials
    merge into the block's, and the blocks' into the output, by ``exp(m_i -
    m_safe)`` under the TPU kernel's guard, so a row with no valid slot
    comes out 0. With ``split_p``, P enters P . V as a bf16 high part plus a
    bf16 low part, as in the bf16 kernel. f32 throughout (the kernel's
    online rescaling is the same algebra, rounded at other places); returns
    (B,1,H,Dv) in q's dtype."""
    B, _, H, D = q.shape
    P, bs, Hkv, Dv = v_pool.shape
    nb = block_table.shape[1]
    W = nb * bs
    if scale is None:
        scale = D ** -0.5
    if split_slots % TILE:
        raise ValueError(f"splits of {split_slots} slots are not whole "
                         f"{TILE}-slot tiles")
    pad = n_split * split_slots - W
    if pad < 0:
        raise ValueError(f"{n_split} splits of {split_slots} slots do not "
                         f"cover {W} slots")
    g = H // Hkv
    bt = block_table.long()
    in_pool = (bt >= 0) & (bt < P)
    bt = torch.where(in_pool, bt, torch.zeros_like(bt))
    kc = k_pool[bt].reshape(B, W, Hkv, D).float()
    vc = v_pool[bt].reshape(B, W, Hkv, Dv).float()
    pos = torch.where(in_pool[..., None], pos_pool[bt],
                      torch.full_like(pos_pool[bt], -1)).reshape(B, W)
    valid = (pos >= 0) & (pos <= q_pos[:, None])
    s = torch.einsum("bhgd,bkhd->bhgk", q.reshape(B, Hkv, g, D).float(),
                     kc) * scale
    s = torch.nn.functional.pad(s, (0, pad))
    valid = torch.nn.functional.pad(valid, (0, pad))[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    vc = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, pad))
    # (split, tile, warp, slot of the warp) -> (split, warp, its slots)
    tiles, nw = split_slots // TILE, PAGED_WARPS
    s = s.reshape(B, Hkv, g, n_split, tiles, nw, TILE // nw)
    s = s.transpose(4, 5).reshape(B, Hkv, g, n_split, nw, -1)
    valid = valid.reshape(B, 1, 1, n_split, tiles, nw, TILE // nw)
    valid = valid.transpose(4, 5).reshape(B, 1, 1, n_split, nw, -1)
    vc = vc.reshape(B, n_split, tiles, nw, TILE // nw, Hkv, Dv)
    vc = vc.transpose(2, 3).reshape(B, n_split, nw, -1, Hkv, Dv)
    # per warp: its max, guarded shift, sums
    m = s.amax(dim=-1)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(valid, torch.exp(s - m_safe[..., None]),
                    torch.zeros_like(s))
    l = p.sum(dim=-1)
    if split_p:
        p = _bf16_hi_lo(p)
    acc = torch.einsum("bhgnwk,bnwkhd->bhgnwd", p, vc)

    def merge(m, l, acc):
        # partials along the last axis of m, l (and the one before last of
        # acc) into one, by exp(m_i - m_safe) under the guard
        m_max = m.amax(dim=-1, keepdim=True)
        m_max_safe = torch.where(m_max <= NEG_INF / 2,
                                 torch.zeros_like(m_max), m_max)
        f = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                        torch.exp(m - m_max_safe))
        return (m_max[..., 0], (f * l).sum(dim=-1),
                (f[..., None] * acc).sum(dim=-2))

    m, l, acc = merge(m, l, acc)       # the warps of a block
    _, l, acc = merge(m, l, acc)       # the blocks of a row
    o = acc / torch.clamp(l, min=1e-20)[..., None]
    return o.reshape(B, 1, H, Dv).to(q.dtype)


__all__ = ["plan_splits", "decode_attention_split_ref",
           "paged_decode_attention_split_ref", "TILE", "HEADS_PER_BLOCK",
           "MAX_SPLITS", "PAGED_WARPS"]
