"""The decode kernels' split of the slot axis (flash-decoding): how the
wrappers cut a dense ring of W slots, or the nb * bs logical slots of a
block-table row, across blocks, and plain versions of the kernels'
per-split partials and their merge.

`plan_splits` runs on every kernel launch. `decode_attention_split_ref` and
`paged_decode_attention_split_ref` repeat the kernels' arithmetic for the
tests; the wrappers never call them.

The grouped path of the paged kernel: the k sample rows of a request share
their prompt's leading blocks. `prefix_groups` (run by the serving layer's
`build_paged_layout`) gives each row the first row of its group and the
blocks the group shares. The planner's thresholds live here alone: the
wrapper takes the grouped path at the shapes `groups_engage` takes, and
both kernels treat a group sharing fewer than `min_shared_blocks` blocks
as no group (`groups_taken`); `plan_prefix` sizes the prefix kernel's
launch from shapes alone, and `row_tiles` / `prefix_split_count` /
`group_prefix_splits` are what the kernel computes on the card from the
descriptor, so a CUDA graph captured for one grouping serves any other at
the same shape.
`paged_decode_attention_grouped_ref` repeats the grouped arithmetic.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
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
#: query rows of a prefix block (``paged::MT``): an m16 tile a warp
PREFIX_ROWS = 16 * PAGED_WARPS
#: splits of a group's prefix at most, for each (row tile, kv head)
PREFIX_MAX_SPLITS = 16
#: the grouped path pays for its second launch and its merges when a row
#: tile's prefix saves the per-row kernel this many (row, 32-slot tile)
#: reads. On an H100, 160 rows: it lost to the per-row kernel at 4 x 4
#: (chatglm3-6b's four rows a tile, a 128-token prompt: 51.3 against 40.4
#: us a call) and at 4 x 8 (55.1 against 52.4), won at 4 x 12 (59.7
#: against 65.0) and from 21 x 4 (granite's 21 rows: 62.2 against 63.2)
PREFIX_MIN_ROW_TILES = 64
#: (sequence, kv head) pairs below which the per-row kernel already cuts
#: each row into many splits over the card and the grouped path does not
#: pay (chatglm3-6b's 20 rows x 2 kv heads: 38.7 against 28.7 us at a
#: 1024-token prompt)
PREFIX_MIN_PAIRS = 128


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


def min_prefix_slots(group: int) -> Optional[int]:
    """The shortest shared prefix the grouped path takes at ``group`` query
    heads a kv head (None: it takes none), so that each row tile saves
    `PREFIX_MIN_ROW_TILES` (row, tile) reads."""
    if group > PREFIX_ROWS // 2:        # a row tile must hold two rows
        return None
    rows = PREFIX_ROWS // group
    return TILE * -(-PREFIX_MIN_ROW_TILES // rows)


def min_shared_blocks(group: int, block_size: int) -> int:
    """The fewest shared blocks of ``block_size`` slots that the kernels
    take as a group at ``group`` query heads a kv head (`min_prefix_slots`;
    the wrapper takes no grouped path where that is None)."""
    return -(-(min_prefix_slots(group) or 0) // block_size)


def prefix_groups(repeats: Sequence[int], shared_blocks: int
                  ) -> np.ndarray:
    """The group descriptor of a batch, (B, 2) int32: for each row the first
    row of its group and the blocks the group's tables share at their head
    (0: no group). Request i's ``repeats[i]`` rows are consecutive and share
    ``shared_blocks`` full prompt blocks; a request of one row, or a prompt
    with no full block, forms no group."""
    rows = []
    for k in repeats:
        first = len(rows)
        for _ in range(k):
            rows.append((first, shared_blocks) if k > 1 and shared_blocks
                        else (len(rows), 0))
    return np.asarray(rows, np.int32).reshape(-1, 2)


def groups_engage(group: int, n_slots: int, pairs: int) -> bool:
    """Whether the paged wrapper takes the grouped path at this many query
    heads a kv head, table width (some row may share a prefix as long as
    `min_prefix_slots`) and (row, kv head) pairs (`PREFIX_MIN_PAIRS`)."""
    least = min_prefix_slots(group)
    return least is not None and n_slots > least and \
        pairs >= PREFIX_MIN_PAIRS


def groups_taken(groups: np.ndarray, min_shared: int) -> np.ndarray:
    """The descriptor as both kernels read it: a row whose group shares
    fewer than ``min_shared`` blocks (or none) is a group of its own with
    no prefix, and walks its whole table."""
    g = np.array(groups, np.int64).reshape(-1, 2)
    short = g[:, 1] < max(1, min_shared)
    g[short, 0] = np.flatnonzero(short)
    g[short, 1] = 0
    return g


def plan_prefix(n_split: int, n_sm: int,
                prefix_blocks_per_sm: int) -> Tuple[int, int]:
    """(grid, p_cap) of the prefix kernel: one wave of the card, and the
    prefix splits a (row tile, kv head) may take beside the row's
    ``n_split`` tail splits (the merge holds 32 at most)."""
    return (max(1, n_sm * prefix_blocks_per_sm),
            max(1, min(PREFIX_MAX_SPLITS, MAX_SPLITS - n_split)))


def row_tiles(groups: np.ndarray, group: int) -> List[Tuple[int, int]]:
    """(first row, rows) of each row tile, as the prefix kernel lists them:
    a tile starts at every ``PREFIX_ROWS // group``-th row of a group and
    holds the group's rows up to that many."""
    g = np.asarray(groups).reshape(-1, 2)
    rt = max(1, PREFIX_ROWS // group)
    tiles = []
    for r, (lead, shared) in enumerate(g.tolist()):
        if shared > 0 and 0 <= lead <= r and (r - lead) % rt == 0:
            n = 1
            while n < rt and r + n < len(g) and g[r + n, 0] == lead:
                n += 1
            tiles.append((r, n))
    return tiles


def prefix_split_count(n_tiles: int, Hkv: int, grid: int,
                       p_cap: int) -> int:
    """The prefix splits a (row tile, kv head) pair may take: as many as
    still fit every pair in the kernel's one-wave grid, at most ``p_cap``."""
    pairs = n_tiles * Hkv
    return max(1, min(p_cap, grid // pairs)) if pairs else 1


def group_prefix_splits(n_ps: int, n_slots: int) -> Tuple[int, int]:
    """(splits, tiles a split) of a group's prefix of ``n_slots`` slots when
    a pair may take ``n_ps``: never more splits than 32-slot tiles, none
    empty. The per-row kernel recomputes it to find a row's prefix
    partials."""
    tiles = -(-n_slots // TILE)
    k = min(n_ps, tiles)
    if k <= 0:
        return 0, 0
    per = -(-tiles // k)
    return -(-tiles // per), per


def grouped_ranges(groups: np.ndarray, group: int, Hkv: int, nb: int,
                   bs: int, n_split: int, split_slots: int, grid: int,
                   p_cap: int) -> List[List[Tuple[int, int]]]:
    """Each row's ranges of logical slots on the grouped path, in the order
    of its partials: its ``n_split`` tail ranges (without a group the whole
    row as `plan_splits` cuts it, else the slots past the group's prefix in
    ``n_split`` ranges of equal tiles, some of them empty), then its group's
    prefix splits. Every slot of a row falls in exactly one range."""
    g = np.asarray(groups).reshape(-1, 2)
    W = nb * bs
    n_ps = prefix_split_count(len(row_tiles(g, group)), Hkv, grid, p_cap)
    out = []
    for shared in g[:, 1].tolist():
        pre = min(shared, nb) * bs if shared > 0 else 0
        if pre:
            tiles = -(-(W - pre) // TILE)
            span = max(1, -(-tiles // n_split)) * TILE
        else:
            span = split_slots
        ranges = [(min(W, pre + s * span), min(W, pre + (s + 1) * span))
                  for s in range(n_split)]
        k, per = group_prefix_splits(n_ps, pre)
        ranges += [(s * per * TILE, min(pre, (s + 1) * per * TILE))
                   for s in range(k)]
        out.append(ranges)
    return out


def paged_decode_attention_grouped_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                       v_pool: torch.Tensor,
                                       pos_pool: torch.Tensor,
                                       block_table: torch.Tensor,
                                       q_pos: torch.Tensor,
                                       groups: torch.Tensor, *,
                                       n_split: int, split_slots: int,
                                       grid: int, p_cap: int,
                                       min_shared: int = 1,
                                       scale: Optional[float] = None,
                                       split_p: bool = True) -> torch.Tensor:
    """`paged_decode_attention_ref` computed as the grouped path computes
    it: each row tile's prefix splits read the shared blocks through the
    tile's first table row and score them for every row of the tile, each
    row masked by its own ``q_pos`` (a group of fewer than ``min_shared``
    blocks taken as none, `groups_taken`); each row's tail ranges read its
    own table; every range gives a partial (m, l, acc) per query head
    ((NEG_INF, 0, 0) with no valid slot, P as bf16 hi + lo with
    ``split_p``), and a row's partials merge by ``exp(m_i - m_safe)`` under
    the TPU kernel's guard, so a row with no valid slot comes out 0. f32
    throughout (the kernels' online rescaling is the same algebra, rounded
    at other places); returns (B,1,H,Dv) in q's dtype."""
    B, _, H, D = q.shape
    P, bs, Hkv, Dv = v_pool.shape
    nb = block_table.shape[1]
    if scale is None:
        scale = D ** -0.5
    g = H // Hkv
    grp = groups_taken(groups.cpu() if torch.is_tensor(groups) else groups,
                       min_shared)
    # the prefix kernel reads a tile's shared blocks through its first row
    bt = block_table.long().clone()
    for r0, n in row_tiles(grp, g):
        shared = min(int(grp[r0, 1]), nb)
        bt[r0:r0 + n, :shared] = bt[r0, :shared]
    in_pool = (bt >= 0) & (bt < P)
    bt = torch.where(in_pool, bt, torch.zeros_like(bt))
    kc = k_pool[bt].reshape(B, nb * bs, Hkv, D).float()
    vc = v_pool[bt].reshape(B, nb * bs, Hkv, Dv).float()
    pos = torch.where(in_pool[..., None], pos_pool[bt],
                      torch.full_like(pos_pool[bt], -1)).reshape(B, -1)
    valid = (pos >= 0) & (pos <= q_pos[:, None])
    qf = q.reshape(B, Hkv, g, D).float()
    out = torch.zeros(B, Hkv, g, Dv)
    ranges = grouped_ranges(grp, g, Hkv, nb, bs, n_split, split_slots, grid,
                            p_cap)
    for b in range(B):
        ms, ls, accs = [], [], []
        for lo, hi in ranges[b]:
            s = torch.einsum("hgd,khd->hgk", qf[b], kc[b, lo:hi]) * scale
            ok = valid[b, lo:hi][None, None]
            s = torch.where(ok, s, torch.full_like(s, NEG_INF))
            m = (s.amax(dim=-1) if hi > lo
                 else torch.full((Hkv, g), NEG_INF))
            m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
            p = torch.where(ok, torch.exp(s - m_safe[..., None]),
                            torch.zeros_like(s))
            ls.append(p.sum(dim=-1))
            ms.append(m)
            if split_p:
                p = _bf16_hi_lo(p)
            accs.append(torch.einsum("hgk,khd->hgd", p, vc[b, lo:hi]))
        m, l, acc = torch.stack(ms, -1), torch.stack(ls, -1), \
            torch.stack(accs, -2)
        m_max = m.amax(dim=-1, keepdim=True)
        m_max = torch.where(m_max <= NEG_INF / 2, torch.zeros_like(m_max),
                            m_max)
        f = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                        torch.exp(m - m_max))
        out[b] = (f[..., None] * acc).sum(dim=-2) / torch.clamp(
            (f * l).sum(dim=-1), min=1e-20)[..., None]
    return out.reshape(B, 1, H, Dv).to(q.dtype)


__all__ = ["plan_splits", "decode_attention_split_ref",
           "paged_decode_attention_split_ref", "prefix_groups",
           "min_prefix_slots", "min_shared_blocks", "groups_engage",
           "groups_taken", "plan_prefix", "row_tiles", "prefix_split_count",
           "group_prefix_splits", "grouped_ranges",
           "paged_decode_attention_grouped_ref", "TILE", "HEADS_PER_BLOCK",
           "MAX_SPLITS", "PAGED_WARPS", "PREFIX_ROWS", "PREFIX_MAX_SPLITS",
           "PREFIX_MIN_ROW_TILES", "PREFIX_MIN_PAIRS"]
