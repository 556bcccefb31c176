"""The dense decode kernel's split of the slot axis (flash-decoding): how the
wrapper cuts a ring of W slots across blocks, and a plain version of the
kernel's per-split partials and their merge.

`plan_splits` runs on every kernel launch. `decode_attention_split_ref`
repeats the kernel's arithmetic for the tests; the wrappers never call it.
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


__all__ = ["plan_splits", "decode_attention_split_ref", "TILE",
           "HEADS_PER_BLOCK", "MAX_SPLITS"]
