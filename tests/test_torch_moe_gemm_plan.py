"""The grouped expert GEMM's planner, on the CPU: which kernel each call
takes (`plan_moe_gemm`) and with which tiles, at every serve shape of the
MoE archs (granite-moe-3b-a800m, deepseek-v2-lite-16b, jamba-v0.1-52b; gate
/ up and down, decode and prefill), at the reference's ragged kernel-test
shapes, and in f32."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.moe_gemm.plan import (  # noqa: E402
    DECODE_ROWS, STAGES, plan_moe_gemm)

#: an H100 SXM's SMs, as the wrapper reads them from the card
N_SM = 132

SERVE_PLANS = [
    # (E, C, d, f): (consumer warpgroups, grid (C tiles, f tiles, E))
    # granite-moe-3b-a800m: 40 experts, d 1536, width 512; decode C = 8,
    # paged prefill C = 512, dense prefill C = 2048
    ((40, 8, 1536, 512), (1, (1, 4, 40))),
    ((40, 8, 512, 1536), (1, (1, 12, 40))),
    ((40, 512, 1536, 512), (2, (4, 4, 40))),
    ((40, 512, 512, 1536), (2, (4, 12, 40))),
    ((40, 2048, 1536, 512), (2, (16, 4, 40))),
    ((40, 2048, 512, 1536), (2, (16, 12, 40))),
    # deepseek-v2-lite-16b: 64 experts, d 2048, width 1408 (eleven 128-column
    # tiles); decode C = 6, prefill C = 960 (seven and a half 128-row tiles)
    ((64, 6, 2048, 1408), (1, (1, 11, 64))),
    ((64, 6, 1408, 2048), (1, (1, 16, 64))),
    ((64, 960, 2048, 1408), (2, (8, 11, 64))),
    ((64, 960, 1408, 2048), (2, (8, 16, 64))),
    # jamba-v0.1-52b: 16 experts, d 4096, width 14336; decode C = 5,
    # prefill C = 1280
    ((16, 5, 4096, 14336), (1, (1, 112, 16))),
    ((16, 5, 14336, 4096), (1, (1, 32, 16))),
    ((16, 1280, 4096, 14336), (2, (10, 112, 16))),
    ((16, 1280, 14336, 4096), (2, (10, 32, 16))),
]


@pytest.mark.parametrize("shape,want", SERVE_PLANS)
def test_serve_shapes_take_the_wgmma_kernel(shape, want):
    E, C, d, f = shape
    plan = plan_moe_gemm(E, C, d, f, is_bf16=True, aligned=True, n_sm=N_SM)
    assert plan.route == "wgmma"
    assert (plan.consumers, plan.grid) == want
    assert plan.stages == STAGES[plan.consumers] >= 3
    assert plan.blocks == plan.grid[0] * plan.grid[1] * plan.grid[2]


@pytest.mark.parametrize("C", [1, 63, 64, 65, 128, 129])
def test_decode_is_at_most_64_rows(C):
    plan = plan_moe_gemm(8, C, 256, 256, is_bf16=True, aligned=True,
                         n_sm=N_SM)
    assert plan.route == "wgmma"
    if C <= DECODE_ROWS:
        assert plan.consumers == 1 and plan.grid[0] == 1


def test_prefill_takes_64_row_tiles_when_128_rows_give_under_two_waves():
    # 8 experts x 100 rows: one 128-row tile each, 8 blocks; 64-row tiles
    # double them
    plan = plan_moe_gemm(8, 100, 48, 96, is_bf16=True, aligned=True,
                         n_sm=N_SM)
    assert (plan.route, plan.consumers, plan.grid) == ("wgmma", 1, (2, 1, 8))
    # the same shape on a card of four SMs has its two waves at 128 rows
    plan = plan_moe_gemm(8, 100, 48, 96, is_bf16=True, aligned=True, n_sm=4)
    assert (plan.consumers, plan.grid) == (2, (1, 1, 8))


REFERENCE_SHAPES = [
    # the reference's kernel-test shapes (E, C, d, f) and their route in
    # bf16: TMA needs rows of 16 bytes (d and f multiples of 8)
    ((4, 32, 64, 128), "wgmma"),
    ((8, 100, 48, 96), "wgmma"),
    ((2, 8, 16, 8), "wgmma"),
    ((3, 130, 130, 70), "cp_async"),
    ((2, 5, 33, 17), "cp_async"),
]


@pytest.mark.parametrize("shape,route", REFERENCE_SHAPES)
def test_reference_shapes(shape, route):
    E, C, d, f = shape
    plan = plan_moe_gemm(E, C, d, f, is_bf16=True, aligned=True, n_sm=N_SM)
    assert plan.route == route
    if route == "cp_async":
        assert (plan.consumers, plan.stages) == (0, 0)
        assert plan.grid == (-(-C // 64), -(-f // 64), E)


@pytest.mark.parametrize("shape", [s for s, _ in SERVE_PLANS]
                         + [s for s, _ in REFERENCE_SHAPES])
def test_f32_and_unaligned_bases_take_the_cp_async_kernel(shape):
    E, C, d, f = shape
    for is_bf16, aligned in ((False, True), (False, False), (True, False)):
        plan = plan_moe_gemm(E, C, d, f, is_bf16=is_bf16, aligned=aligned,
                             n_sm=N_SM)
        assert plan.route == "cp_async"
        assert plan.grid == (-(-C // 64), -(-f // 64), E)
