"""Which kernel the SSD chunk launches, and with which head blocks; and a
plain version of the tensor-core kernel's arithmetic.

`plan_ssd_chunk` is a pure function of the shapes, the dtype, the operands'
alignment, whether B and C are shared by all heads, and the card's SM
count. The wrapper calls it before every launch; the tests call it on the
CPU. `ssd_chunk_tc_ref` repeats the tensor-core kernel's decomposition for
the tests; the wrapper never calls it.

Routes:

* ``"mma"``: ``ssd_scan_chunk_tc_kernel``, for bf16 x, B and C with Q a
  multiple of 64 up to 256, P a multiple of 16 up to 64, N a multiple of 16
  up to 128, and 16-byte aligned base pointers and batch, chunk, row and
  head strides (cp.async moves 16 bytes). The raw scores C . B^T are built
  once per block of heads that read one B and C, on the tensor cores.
* ``"fma"``: the scalar-FMA kernel (``ssd_scan_chunk_kernel``) for every
  other shape and for f32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

#: query rows of a Y block, key rows of a key tile (``tc::TQ``)
TILE = 64
#: the tensor-core kernel's largest chunk, head dim and state dim
#: (``tc::MAX_KT`` key tiles, ``tc::MAX_PT`` 16-column tiles, ``tc::MAX_N``)
MAX_Q, MAX_P, MAX_N = 4 * TILE, 64, 128
#: Y blocks the planner aims for, in blocks per SM (one block of 16 warps
#: fits an SM: about 190 KB of shared memory at Q = 256)
WAVES = 8
#: heads a block at most: their cs and dt stay in shared memory
#: (``tc::MAX_HB``)
MAX_HB = 16
#: the Y partial sums a block exchanges (``tc::EX_BYTES``)
EXCHANGE_BYTES = 16 * (MAX_P // 8) * 32 * 16


class SsdPlan(NamedTuple):
    route: str              # "mma" or "fma"
    shared: bool            # B and C have a stride-0 head axis
    heads_per_block: int    # heads a block walks (1 on "fma": one a head)
    grid: tuple             # (roles, head blocks, batch * chunks)


def plan_ssd_chunk(BC: int, Q: int, H: int, P: int, N: int, *, is_bf16: bool,
                   aligned: bool, shared: bool, n_sm: int) -> SsdPlan:
    """The kernel and head blocks of one SSD chunk call over ``BC`` (batch x
    chunks) chunks of ``Q`` rows, ``H`` heads of width ``P`` and state width
    ``N`` on a card of ``n_sm`` SMs. ``aligned``: base pointers and strides
    of x, B and C are 16-byte aligned; ``shared``: B and C have a stride-0
    head axis, so that every head reads the same B and C.

    On ``"mma"`` the grid's roles are one state block and ``Q / 64`` Y
    blocks (one a 64-row query tile) for each head block and chunk. A head
    block is ``heads_per_block`` consecutive heads of one group: all H heads
    form one group when B and C are shared, else each head is its own group
    (one head a block). The planner takes the most heads a block that still
    give ``WAVES`` Y blocks an SM, up to ``MAX_HB``, so that the raw scores
    are built as few times as fill the card.
    """
    nqt = Q // TILE
    if not (is_bf16 and aligned and Q % TILE == 0 and 0 < Q <= MAX_Q
            and P % 16 == 0 and 0 < P <= MAX_P and N % 16 == 0
            and 0 < N <= MAX_N):
        return SsdPlan("fma", shared, 1,
                       (math.ceil(Q / 64) * math.ceil(P / 64)
                        + math.ceil(P / 64) * math.ceil(N / 64), H, BC))
    if not shared:
        hb = 1
    else:
        n_hb = min(H, max(1, math.ceil(WAVES * n_sm / (BC * nqt)),
                          math.ceil(H / MAX_HB)))
        hb = math.ceil(H / n_hb)
    return SsdPlan("mma", shared, hb, (1 + nqt, math.ceil(H / hb), BC))


def smem_bytes(Q: int, P: int, N: int, heads_per_block: int) -> int:
    """Dynamic shared memory of a tensor-core block (``tc::layout``)."""
    row = lambda n: 2 * n + 16  # noqa: E731
    return (max((TILE + Q) * row(N), EXCHANGE_BYTES) + 2 * Q * row(P)
            + (2 * heads_per_block + 1) * Q * 4)


# ------------------------------------------------ the kernel's arithmetic

def _bf16_hi_lo(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo), both bf16 values held in f32: hi = bf16(v), lo =
    bf16(v - hi), as the kernel's ``split_pair`` rounds them."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _k16_sum(a: torch.Tensor, b: torch.Tensor, eq: str, dim_a: int,
             dim_b: int) -> torch.Tensor:
    """``einsum(eq, a, b)`` over a contraction axis taken 16 at a time, each
    step's sum of 16 products added to an f32 accumulator in order: one
    mma.sync m16n8k16 after another."""
    acc = None
    for k in range(0, a.shape[dim_a], 16):
        part = torch.einsum(eq, a.narrow(dim_a, k, 16), b.narrow(dim_b, k, 16))
        acc = part if acc is None else acc + part
    return acc


def ssd_chunk_tc_ref(x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
                     dA_cs: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`ssd_chunk_ref` computed as the tensor-core kernel computes it, in
    the model layout: x (B,nc,Q,H,P), dt, dA, dA_cs (B,nc,Q,H) f32, B, C
    (B,nc,Q,H,N) holding bf16 values; Q and the widths multiples of 16.

    * The raw scores C . B^T once per head group (once for all heads when
      B and C have a stride-0 head axis, else per head), accumulated 16 of
      N at a time in f32.
    * A head's scores raw * exp(cs_q - cs_s) * dt_s, masked by select;
      split into bf16 hi + lo, both multiplied by x. Warp wk of a row
      group's four takes keys 16 wk .. 16 wk + 15 of every 64-key tile, one
      k16 step a tile (hi, then lo); the four sums are added last, in
      order.
    * The state from x * w (w = exp(cs_last - cs_q) * dt_q) split into bf16
      hi + lo, times B, 16 rows a step.

    ``dA`` enters through ``dA_cs`` only. Returns (Y_diag (B,nc,Q,H,P),
    states (B,nc,H,P,N)) in f32."""
    Bsz, nc, Q, H, P = x.shape
    xf, Bf, Cf = x.float(), B.float(), C.float()
    if B.stride(3) == 0 and C.stride(3) == 0:
        raw = _k16_sum(Cf[:, :, :, 0], Bf[:, :, :, 0], "bcqn,bcsn->bcqs",
                       3, 3)[:, :, None]                        # (B,nc,1,Q,Q)
    else:
        raw = _k16_sum(Cf, Bf, "bcqhn,bcshn->bchqs", 4, 4)     # (B,nc,H,Q,Q)
    cs = dA_cs.movedim(3, 2)                                   # (B,nc,H,Q)
    decay = torch.exp(cs[..., :, None] - cs[..., None, :])
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    scores = torch.where(causal, raw * decay * dt.movedim(3, 2)[..., None, :],
                         torch.zeros((), device=x.device))
    hi, lo = _bf16_hi_lo(scores)                               # (B,nc,H,Q,Q)
    y = None
    for wk in range(4):
        acc = None
        for s0 in range(16 * wk, Q, 64):
            ks = slice(s0, s0 + 16)
            for part in (hi, lo):
                step = torch.einsum("bchqs,bcshp->bcqhp", part[..., ks],
                                    xf[:, :, ks])
                acc = step if acc is None else acc + step
        y = acc if y is None else y + acc
    w = torch.exp(dA_cs[:, :, -1:] - dA_cs) * dt                # (B,nc,Q,H)
    whi, wlo = _bf16_hi_lo(xf * w[..., None])                  # (B,nc,Q,H,P)
    st = None
    for k in range(0, Q, 16):
        for part in (whi, wlo):
            step = torch.einsum("bcqhp,bcqhn->bchpn", part[:, :, k:k + 16],
                                Bf[:, :, k:k + 16])
            st = step if st is None else st + step
    return y, st


__all__ = ["SsdPlan", "plan_ssd_chunk", "smem_bytes", "ssd_chunk_tc_ref",
           "TILE", "MAX_Q", "MAX_P", "MAX_N", "MAX_HB", "WAVES"]
