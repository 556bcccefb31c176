"""The dequant-matmul's plans: which kernel a call takes, how the split-K
kernels cut N into strips and K into slices at decode, and plain versions
of the split kernels' per-slice partials and their merge.

`plan_splitk` runs on every int4 launch and `plan_int8` on every int8 one.
`dequant_matmul_int4_split_ref` and `dequant_matmul_int8_split_ref` repeat
the split kernels' arithmetic for the tests; the wrappers never call them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.dequant_matmul.ref import unpack_int4

#: x rows the split-K kernel serves at most; more rows take the TMA + wgmma
#: kernel or the tiled one
MAX_ROWS = 64
#: groups the TMA + wgmma kernel takes: whole 16-row steps, whole groups a
#: 64-row stage
WGMMA_GROUPS = (16, 32, 64)
#: input rows (K) a stage of the split-K kernel (``sk::BK``)
TILE_K = 128
#: output columns a block of the split-K kernel (``sk::BN``)
STRIP = 128
#: slices of a strip at most: the last block of a strip reads every
#: slice's partial (more ran slower at chatglm3-6b's decode on an H100)
MAX_SLICES = 8


class SplitPlan(NamedTuple):
    route: str              # "split_k", "wgmma" or "tiled"
    rows: int               # x rows the split kernel computes (16, 32, 64)
    n_strips: int           # 128-column strips of N
    n_slices: int           # slices of K
    slice_k: int            # rows of every slice but the last
    workspace_floats: int   # f32 partials of the launch (0 with one slice)

    @property
    def blocks(self) -> int:
        return self.n_strips * self.n_slices


def padded_rows(M: int) -> int:
    """x rows the split kernel computes for M rows: 16, 32 or 64."""
    return 16 if M <= 16 else 32 if M <= 32 else 64


def plan_splitk(M: int, K: int, N: int, gs: int, n_sm: int,
                blocks_per_sm: int, *, is_bf16: bool,
                aligned: bool) -> SplitPlan:
    """The kernel and split of ``x (M, K) @ dequantize_int4(packed (K/2, N),
    scale (K/gs, N))`` on a card of ``n_sm`` SMs that hold
    ``blocks_per_sm`` split-K blocks each; ``aligned``: x, packed and scale
    start on 16-byte boundaries.

    M > 64 (prefill) takes the TMA + wgmma kernel for bf16 x when TMA can
    read the operands (K % 64 == 0, N % 16 == 0, aligned bases) and gs is
    16, 32 or 64, and the tiled kernel otherwise. Otherwise N is cut into
    128-column
    strips and K into slices whose length is a multiple of both the
    128-row k tile and gs, so a group never spans two slices; the last
    slice ends at K, and no slice is empty. The planner takes as many
    slices as one wave of resident blocks holds, never more than K has
    quanta nor more than ``MAX_SLICES``, and at least one."""
    if M < 1 or M > MAX_ROWS:
        if (is_bf16 and aligned and K % 64 == 0 and N % 16 == 0
                and gs in WGMMA_GROUPS):
            return _wgmma_plan(N)
        return _tiled_plan(N)
    # lcm(TILE_K, gs): a slice never splits a group
    return _slices(M, K, N, TILE_K * gs // math.gcd(TILE_K, gs), n_sm,
                   blocks_per_sm)


def plan_int8(M: int, K: int, N: int, n_sm: int, blocks_per_sm: int, *,
              is_bf16: bool, aligned: bool) -> SplitPlan:
    """The kernel and split of ``x (M, K) @ dequantize_int8(qw (K, N),
    scale (N,))`` on a card of ``n_sm`` SMs that hold ``blocks_per_sm``
    split-K blocks each; ``aligned``: x, qw and scale start on 16-byte
    boundaries.

    bf16 x with aligned operands and N % 16 == 0 takes the split-K kernel
    at M <= 64 (K % 8 == 0: 16-byte x rows) and the TMA + wgmma kernel
    above it (K % 64 == 0: whole 64-row stages); f32 x and every other
    shape take the tiled kernel. The split is `plan_splitk`'s with slices of
    whole 128-row k tiles (the int8 scale is per column: no groups)."""
    tma = is_bf16 and aligned and N % 16 == 0
    if M < 1 or M > MAX_ROWS:
        return _wgmma_plan(N) if tma and K % 64 == 0 else _tiled_plan(N)
    if not (tma and K % 8 == 0):
        return _tiled_plan(N)
    return _slices(M, K, N, TILE_K, n_sm, blocks_per_sm)


def _wgmma_plan(N: int) -> SplitPlan:
    return SplitPlan("wgmma", 0, math.ceil(N / STRIP), 1, 0, 0)


def _tiled_plan(N: int) -> SplitPlan:
    return SplitPlan("tiled", 0, math.ceil(N / 64), 1, 0, 0)


def _slices(M: int, K: int, N: int, q: int, n_sm: int,
            blocks_per_sm: int) -> SplitPlan:
    """The split-K plan over slices of whole ``q``-row quanta."""
    rows = padded_rows(M)
    units = math.ceil(K / q)
    strips = math.ceil(N / STRIP)
    # never more blocks than the wave holds: a block past it would run in a
    # second wave of its own
    fit = n_sm * blocks_per_sm // strips
    n = max(1, min(fit, units, MAX_SLICES))
    slice_k = math.ceil(units / n) * q
    n = math.ceil(K / slice_k)
    ws = strips * n * M * STRIP if n > 1 else 0
    return SplitPlan("split_k", rows, strips, n, slice_k, ws)


def dequant_matmul_int4_split_ref(x: torch.Tensor, packed: torch.Tensor,
                                  scale: torch.Tensor, *,
                                  slice_k: int) -> torch.Tensor:
    """`dequant_matmul_int4_ref` computed as the split kernel computes it:
    per group, the integer weights' product with x, scaled by the group's
    scale and summed over the slice's groups in order; then the slices'
    partials summed in slice order. f32 throughout; returns (M, N) in x's
    dtype."""
    M, K = x.shape
    G, N = scale.shape
    gs = K // G
    if slice_k % gs:
        raise ValueError(f"slices of {slice_k} rows split groups of {gs}")
    q = unpack_int4(packed).float()                  # (K, N)
    xf = x.float()
    out = None
    for k0 in range(0, K, slice_k):
        acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
        for g0 in range(k0, min(K, k0 + slice_k), gs):
            part = xf[:, g0:g0 + gs] @ q[g0:g0 + gs]
            acc = acc + part * scale[g0 // gs].float()
        out = acc if out is None else out + acc
    return out.to(x.dtype)


def dequant_matmul_int8_split_ref(x: torch.Tensor, qw: torch.Tensor,
                                  scale: torch.Tensor, *,
                                  slice_k: int) -> torch.Tensor:
    """`dequant_matmul_int8_ref` computed as the int8 split kernel computes
    it: each slice's product of x with the integer weights, the slices'
    partials summed in slice order, then the per-column scale once. f32
    throughout; returns (M, N) in x's dtype."""
    K = x.shape[1]
    xf, q = x.float(), qw.float()
    out = None
    for k0 in range(0, K, slice_k):
        part = xf[:, k0:k0 + slice_k] @ q[k0:k0 + slice_k]
        out = part if out is None else out + part
    return (out * scale.float()).to(x.dtype)


__all__ = ["SplitPlan", "plan_splitk", "plan_int8",
           "dequant_matmul_int4_split_ref", "dequant_matmul_int8_split_ref",
           "padded_rows", "MAX_ROWS", "TILE_K", "STRIP", "MAX_SLICES",
           "WGMMA_GROUPS"]
