"""Which kernel the grouped expert GEMM launches, and with which tiles.

`plan_moe_gemm` is a pure function of the shapes, the dtype, the operands'
alignment and the card's SM count. The wrapper calls it before every launch;
the tests call it on the CPU.

Routes:

* ``"wgmma"``: the TMA + wgmma kernel (``moe_gemm_tc_kernel``), for bf16
  with d and f multiples of 8 (rows of 16 bytes, as TMA needs) and 16-byte
  aligned base pointers. One consumer warpgroup and 64-row tiles at decode
  (C <= 64); two and 128-row tiles at prefill, unless those give fewer than
  two waves of blocks on the card, where the 64-row tile doubles them.
* ``"cp_async"``: the cp.async + ``mma.sync`` kernel for every other bf16
  shape, and its scalar-FMA sibling for f32.
"""
from __future__ import annotations

import math
from typing import NamedTuple

#: output columns of a block of the wgmma kernel (``tc::BN``)
WGMMA_BN = 128
#: output rows of a consumer warpgroup
WGMMA_BM = 64
#: the capacity at or below which a call is a decode: one 64-row tile
DECODE_ROWS = 64
#: ring stages of the wgmma kernel, by consumer warpgroups: two blocks an
#: SM either way (24 KB and 32 KB a stage), the fastest of 3 to 8 stages on
#: an H100 at the serves' shapes
STAGES = {1: 4, 2: 3}
#: the cp.async kernel's tile (``BM`` x ``BN``)
CP_ASYNC_TILE = 64


class MoePlan(NamedTuple):
    route: str              # "wgmma" or "cp_async"
    consumers: int          # consumer warpgroups of a wgmma block (0: none)
    stages: int             # ring stages of a wgmma block (0: none)
    grid: tuple             # (C tiles, f tiles, experts)

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)


def plan_moe_gemm(E: int, C: int, d: int, f: int, *, is_bf16: bool,
                  aligned: bool, n_sm: int) -> MoePlan:
    """The kernel and tiles of ``x (E, C, d) @ w (E, d, f)`` on a card of
    ``n_sm`` SMs; ``aligned``: both base pointers are 16-byte aligned."""
    if not (is_bf16 and aligned and d % 8 == 0 and f % 8 == 0):
        t = CP_ASYNC_TILE
        return MoePlan("cp_async", 0, 0,
                       (math.ceil(C / t), math.ceil(f / t), E))
    consumers = 1
    if C > DECODE_ROWS:
        wide = math.ceil(C / (2 * WGMMA_BM)) * math.ceil(f / WGMMA_BN) * E
        consumers = 2 if wide >= 2 * n_sm else 1
    bm = WGMMA_BM * consumers
    return MoePlan("wgmma", consumers, STAGES[consumers],
                   (math.ceil(C / bm), math.ceil(f / WGMMA_BN), E))


__all__ = ["MoePlan", "plan_moe_gemm", "WGMMA_BN", "WGMMA_BM", "DECODE_ROWS",
           "STAGES", "CP_ASYNC_TILE"]
