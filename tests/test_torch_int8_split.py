"""The int8 dequant-matmul's plan and its split of K at decode, on the CPU:
the planner that routes a call (split-K, TMA + wgmma or tiled) and cuts K
into slices (`plan_int8`), and the per-slice partials, their merge and the
scale applied once (`dequant_matmul_int8_split_ref`, the split kernel's
arithmetic in plain torch) against the reference's jnp oracle and its
Pallas kernel in interpret mode, f32 at 1e-5."""
import math

import numpy as np
import pytest

from _torch_parity import close, jnp, torch

from repro.kernels.dequant_matmul import (  # noqa: E402
    dequant_matmul_int8_pallas, dequant_matmul_int8_ref as j_int8_ref)
from repro.quant import quantize as jq  # noqa: E402
from repro_torch.kernels.dequant_matmul.split import (  # noqa: E402
    MAX_ROWS, MAX_SLICES, STRIP, TILE_K, dequant_matmul_int8_split_ref,
    padded_rows, plan_int8)

TOL = 1e-5
#: the card the planner runs on: an H100 SXM's SMs, and the int8 split
#: kernel's occupancy there at 32 rows of bf16 x (two blocks an SM: a ring
#: of three 27 KB stages)
N_SM, BLOCKS_PER_SM = 132, 2
CARD = (N_SM, BLOCKS_PER_SM)
#: bf16 x, and every operand on a 16-byte boundary (as torch allocates)
BF16 = dict(is_bf16=True, aligned=True)


@pytest.mark.parametrize("M", [1, 16, 32, 64, 65, 2048])
@pytest.mark.parametrize("K", [64, 96, 4096, 4104, 13696])
def test_plan_routes_and_covers_k_within_the_workspace(M, K):
    for N in (16, 19, 256, 4096, 13696):
        plan = plan_int8(M, K, N, *CARD, **BF16)
        if M > MAX_ROWS:
            tma = K % 64 == 0 and N % 16 == 0
            assert plan.route == ("wgmma" if tma else "tiled"), (K, N)
            assert plan.n_slices == 1 and plan.workspace_floats == 0
            continue
        if N % 16:
            assert plan.route == "tiled"
            continue
        assert plan.route == "split_k"
        assert plan.rows == padded_rows(M) >= M
        assert plan.slice_k % TILE_K == 0
        assert 1 <= plan.n_slices <= MAX_SLICES
        cover = np.zeros(K, np.int64)
        for s in range(plan.n_slices):
            lo, hi = s * plan.slice_k, min(K, (s + 1) * plan.slice_k)
            assert hi > lo, (s, plan)
            cover[lo:hi] += 1
        assert (cover == 1).all(), plan
        assert (plan.n_strips - 1) * STRIP < N <= plan.n_strips * STRIP
        assert plan.blocks <= N_SM * BLOCKS_PER_SM or plan.n_slices == 1
        want = (plan.n_strips * plan.n_slices * M * STRIP
                if plan.n_slices > 1 else 0)
        assert plan.workspace_floats == want


def test_plan_takes_the_tiled_kernel_for_f32_and_ragged_shapes():
    for M in (1, 32, 64, 65, 2048):
        # f32 x, an unaligned operand, N not whole 16-byte rows
        assert plan_int8(M, 4096, 4096, *CARD, is_bf16=False,
                         aligned=True).route == "tiled"
        assert plan_int8(M, 4096, 4096, *CARD, is_bf16=True,
                         aligned=False).route == "tiled"
        assert plan_int8(M, 4096, 4100, *CARD, **BF16).route == "tiled"
    # x rows not 16-byte aligned at decode; K past whole 64-row stages at
    # prefill
    assert plan_int8(32, 4100, 4096, *CARD, **BF16).route == "tiled"
    assert plan_int8(32, 4104, 4096, *CARD, **BF16).route == "split_k"
    assert plan_int8(65, 4104, 4096, *CARD, **BF16).route == "tiled"
    assert plan_int8(64, 4096, 4096, *CARD, **BF16).route == "split_k"
    assert plan_int8(65, 4096, 4096, *CARD, **BF16).route == "wgmma"


def test_plan_fills_a_wave_at_the_chatglm_decode_shapes():
    """132 x 2 blocks at 32 rows: gate / up (N = 13696, 107 strips) take the
    2 slices of 2048 rows one wave holds; down (K = 13696), wq / wo and wk
    / wv take the most, 8 (down's in slices of 1792 rows, 14 k tiles)."""
    p = plan_int8(32, 4096, 13696, *CARD, **BF16)
    assert (p.n_strips, p.n_slices, p.slice_k) == (107, 2, 2048)
    p = plan_int8(32, 13696, 4096, *CARD, **BF16)
    assert (p.n_strips, p.n_slices, p.slice_k) == (32, 8, 1792)
    p = plan_int8(32, 4096, 256, *CARD, **BF16)
    assert (p.n_strips, p.n_slices, p.slice_k) == (2, 8, 512)
    p = plan_int8(32, 4096, 4096, *CARD, **BF16)
    assert (p.n_strips, p.n_slices, p.slice_k) == (32, 8, 512)
    assert plan_int8(32, 4096, 13696, N_SM, 1, **BF16).n_slices == 1


def _quantized(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    qw, s = jq.quantize_int8(jnp.asarray(rng.normal(size=(K, N)) * K ** -0.5,
                                         jnp.float32))
    return x, np.array(qw), np.array(s)


SPLIT_CASES = [
    # (M, K, N, slice_k)
    (5, 768, 40, 256),          # 3 slices
    (17, 512, 33, 128),         # 4 slices of one k tile
    (3, 400, 130, 256),         # the last slice shorter (144 rows)
    (32, 4096, 64, 512),        # chatglm's K, 8 slices
    (64, 1024, 48, 1024),       # one slice
]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_partials_and_merge_match_the_oracle(case):
    M, K, N, slice_k = case
    x, qw, s = _quantized(M, K, N, 0)
    got = dequant_matmul_int8_split_ref(torch.from_numpy(x),
                                        torch.from_numpy(qw),
                                        torch.from_numpy(s), slice_k=slice_k)
    close(got, j_int8_ref(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(s)),
          TOL)


@pytest.mark.parametrize("case", [(5, 768, 40, 256), (17, 512, 33, 128)])
def test_split_partials_and_merge_match_the_interpret_kernel(case):
    M, K, N, slice_k = case
    x, qw, s = _quantized(M, K, N, 1)
    got = dequant_matmul_int8_split_ref(torch.from_numpy(x),
                                        torch.from_numpy(qw),
                                        torch.from_numpy(s), slice_k=slice_k)
    pallas = dequant_matmul_int8_pallas(jnp.asarray(x), jnp.asarray(qw),
                                        jnp.asarray(s), interpret=True)
    close(got, pallas, TOL)


@pytest.mark.parametrize("M,K,N", [(32, 4096, 256), (16, 1408, 208),
                                   (64, 13696, 16)])
def test_split_at_the_planners_own_plan_matches_the_oracle(M, K, N):
    plan = plan_int8(M, K, N, *CARD, **BF16)
    assert plan.route == "split_k" and plan.n_slices > 1
    x, qw, s = _quantized(M, K, N, 2)
    got = dequant_matmul_int8_split_ref(torch.from_numpy(x),
                                        torch.from_numpy(qw),
                                        torch.from_numpy(s),
                                        slice_k=plan.slice_k)
    close(got, j_int8_ref(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(s)),
          TOL)
    assert math.ceil(K / plan.slice_k) == plan.n_slices
