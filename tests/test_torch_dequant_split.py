"""The int4 dequant-matmul's split of K at decode, on the CPU: the planner
that routes a call and cuts K into slices (`plan_splitk`), and the
per-slice partials and their merge (`dequant_matmul_int4_split_ref`, the
split kernel's arithmetic in plain torch) against the reference's jnp
oracle and its Pallas kernel in interpret mode, f32 at 1e-5."""
import math

import numpy as np
import pytest

from _torch_parity import close, jnp, torch

from repro.kernels.dequant_matmul import (  # noqa: E402
    dequant_matmul_int4_pallas, dequant_matmul_int4_ref as j_int4_ref)
from repro.quant import quantize as jq  # noqa: E402
from repro_torch.kernels.dequant_matmul.split import (  # noqa: E402
    MAX_ROWS, MAX_SLICES, STRIP, TILE_K, WGMMA_GROUPS,
    dequant_matmul_int4_split_ref, padded_rows, plan_splitk)

TOL = 1e-5
#: the card the planner runs on: an H100 SXM's SMs, and the split kernel's
#: occupancy there at chatglm3-6b's decode (32 rows of bf16 x, groups of 32)
N_SM, BLOCKS_PER_SM = 132, 4
#: bf16 x, and every operand on a 16-byte boundary (as torch allocates)
BF16 = dict(is_bf16=True, aligned=True)
#: (K, gs) pairs the quantizer can make (gs divides K), over K of 32, 96,
#: 4096, 13696 rows and groups of 8, 24 and 32
KS_GROUPS = [(K, gs) for K in (32, 96, 4096, 13696) for gs in (8, 24, 32)
             if K % gs == 0]


@pytest.mark.parametrize("M", [1, 16, 32, 64, 65])
@pytest.mark.parametrize("K,gs", KS_GROUPS)
def test_plan_covers_k_with_group_aligned_slices_within_the_workspace(
        M, K, gs):
    for N in (19, 256, 4096, 13696):
        plan = plan_splitk(M, K, N, gs, N_SM, BLOCKS_PER_SM, **BF16)
        if M > MAX_ROWS:
            tma = K % 64 == 0 and N % 16 == 0 and gs in WGMMA_GROUPS
            assert plan.route == ("wgmma" if tma else "tiled")
            continue
        assert plan.route == "split_k"
        assert plan.rows == padded_rows(M) >= M
        assert plan.slice_k % TILE_K == 0 and plan.slice_k % gs == 0
        assert 1 <= plan.n_slices <= MAX_SLICES
        cover = np.zeros(K, np.int64)
        for s in range(plan.n_slices):
            lo, hi = s * plan.slice_k, min(K, (s + 1) * plan.slice_k)
            assert hi > lo, (s, plan)
            cover[lo:hi] += 1
        assert (cover == 1).all(), plan
        assert (plan.n_strips - 1) * STRIP < N <= plan.n_strips * STRIP
        want = (plan.n_strips * plan.n_slices * M * STRIP
                if plan.n_slices > 1 else 0)
        # the partials of at most a wave of blocks and one slice a strip
        assert plan.workspace_floats == want <= \
            (N_SM * BLOCKS_PER_SM + plan.n_strips) * M * STRIP


def test_plan_routes_64_rows_to_the_split_kernel_and_65_to_the_prefill():
    card = (N_SM, BLOCKS_PER_SM)
    for M in (1, 63, 64):
        for is_bf16 in (True, False):
            assert plan_splitk(M, 4096, 4096, 32, *card, is_bf16=is_bf16,
                               aligned=False).route == "split_k"
    for M in (65, 128, 2048):
        assert plan_splitk(M, 4096, 4096, 32, *card, **BF16).route == "wgmma"
        # f32 x, an unaligned operand, rows TMA cannot stride, K past whole
        # 64-row stages, groups that do not tile 64 rows: the tiled kernel
        for kw, K, N, gs in ((dict(is_bf16=False, aligned=True), 4096, 4096,
                              32),
                             (dict(is_bf16=True, aligned=False), 4096, 4096,
                              32),
                             (BF16, 4096, 4100, 32), (BF16, 4128, 4096, 32),
                             (BF16, 4096, 4096, 8), (BF16, 4104, 4096, 24),
                             (BF16, 4096, 4096, 128)):
            assert plan_splitk(M, K, N, gs, *card, **kw).route == "tiled"
    for gs in WGMMA_GROUPS:
        assert plan_splitk(2048, 4096, 13696, gs, *card, **BF16).route == \
            "wgmma"


def test_plan_fills_a_wave_at_the_chatglm_decode_shapes():
    """132 x 4 blocks at 32 rows: the gate / up projection (N = 13696, 107
    strips) takes the 4 slices of 1024 rows that one wave holds (5 would
    leave 7 blocks to a second wave); the down projection (K = 13696, 32
    strips), wq / wo (32 strips) and wk / wv (N = 256, 2 strips) take the
    most, 8."""
    card = (N_SM, BLOCKS_PER_SM)
    p = plan_splitk(32, 4096, 13696, 32, *card, **BF16)
    assert (p.n_strips, p.n_slices, p.slice_k) == (107, 4, 1024)
    assert p.blocks <= N_SM * BLOCKS_PER_SM
    p = plan_splitk(32, 13696, 4096, 32, *card, **BF16)
    assert (p.n_strips, p.n_slices, p.slice_k) == (32, 8, 1792)
    p = plan_splitk(32, 4096, 256, 32, *card, **BF16)
    assert (p.n_strips, p.n_slices, p.slice_k) == (2, 8, 512)
    p = plan_splitk(32, 4096, 4096, 32, *card, **BF16)
    assert (p.n_strips, p.n_slices, p.slice_k) == (32, 8, 512)
    # one block an SM holds 132 blocks: one slice a strip, as does a card
    # of one SM
    assert plan_splitk(32, 4096, 13696, 32, N_SM, 1, **BF16).n_slices == 1
    assert plan_splitk(32, 4096, 13696, 32, 1, 1, **BF16).n_slices == 1


def _quantized(M, K, N, gs, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    qw, s = jq.quantize_int4(jnp.asarray(rng.normal(size=(K, N)) * K ** -0.5,
                                         jnp.float32), gs)
    assert s.shape == (K // gs, N)
    return x, np.array(qw), np.array(s)


SPLIT_CASES = [
    # (M, K, N, gs, slice_k)
    (5, 768, 40, 24, 384),      # groups straddle 16-row steps; 2 slices
    (17, 512, 33, 8, 128),      # sixteen groups a tile; 4 slices
    (3, 256, 130, 32, 128),     # two strips' worth of columns
    (64, 1024, 256, 32, 256),
    (1, 4096, 64, 32, 512),     # chatglm's K, 8 slices
    (32, 400, 48, 8, 256),      # the last slice shorter (144 rows)
]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_partials_and_merge_match_the_oracle(case):
    M, K, N, gs, slice_k = case
    x, qw, s = _quantized(M, K, N, gs, 0)
    got = dequant_matmul_int4_split_ref(torch.from_numpy(x),
                                        torch.from_numpy(qw),
                                        torch.from_numpy(s), slice_k=slice_k)
    close(got, j_int4_ref(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(s)),
          TOL)


@pytest.mark.parametrize("case", [(5, 768, 40, 24, 384),
                                  (17, 512, 33, 8, 128)])
def test_split_partials_and_merge_match_the_interpret_kernel(case):
    M, K, N, gs, slice_k = case
    x, qw, s = _quantized(M, K, N, gs, 1)
    got = dequant_matmul_int4_split_ref(torch.from_numpy(x),
                                        torch.from_numpy(qw),
                                        torch.from_numpy(s), slice_k=slice_k)
    pallas = dequant_matmul_int4_pallas(jnp.asarray(x), jnp.asarray(qw),
                                        jnp.asarray(s), interpret=True)
    close(got, pallas, TOL)


@pytest.mark.parametrize("M,K,N,gs", [(32, 4096, 256, 32), (16, 768, 200, 24),
                                      (64, 13696, 19, 8)])
def test_split_at_the_planners_own_plan_matches_the_oracle(M, K, N, gs):
    plan = plan_splitk(M, K, N, gs, N_SM, BLOCKS_PER_SM, **BF16)
    assert plan.route == "split_k" and plan.n_slices > 1
    x, qw, s = _quantized(M, K, N, gs, 2)
    got = dequant_matmul_int4_split_ref(torch.from_numpy(x),
                                        torch.from_numpy(qw),
                                        torch.from_numpy(s),
                                        slice_k=plan.slice_k)
    close(got, j_int4_ref(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(s)),
          TOL)
    assert math.ceil(K / plan.slice_k) == plan.n_slices


def test_split_refuses_slices_that_split_a_group():
    x, qw, s = _quantized(2, 96, 8, 24, 3)
    with pytest.raises(ValueError, match="split groups"):
        dequant_matmul_int4_split_ref(torch.from_numpy(x),
                                      torch.from_numpy(qw),
                                      torch.from_numpy(s), slice_k=64)
