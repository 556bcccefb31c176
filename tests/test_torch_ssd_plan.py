"""The SSD chunk kernel's route planner and its tensor-core decomposition,
on the CPU: the planner (`plan_ssd_chunk`) at every shape `chip_smoke.py`
gives the kernel, and `ssd_chunk_tc_ref` (the raw scores C . B^T once per
head group, the select mask, scores and x * w as bf16 hi + lo, f32 sums in
the kernel's tile order) against the reference's Pallas kernel in interpret
mode and its jnp oracle, at 1e-4.

Inputs are drawn as a Mamba-2 layer makes them (and as `chip_smoke.py`'s
`ssd_case` draws them): x, B and C silu'd conv outputs rounded to bf16, x a
slice of the conv output and B and C one group broadcast over the heads by
a stride-0 view; dt the softplus of a unit normal plus the inverse softplus
of a log-uniform dt in [1e-3, 0.1]; A = -(1..H), scaled where a case says
so, so that the cumulative decay falls to about -3000 over a 256-row chunk,
as at jamba's rates, and exp(cs[q] - cs[s]) overflows above the diagonal.
dA is rounded to a multiple of 2^-10, so that every cumulative sum of it is
exact in f32 whatever its order: the jnp oracle sums dA once more where
the kernels read the given dA_cs.
"""
import numpy as np
import pytest

from _torch_parity import close, jnp, torch

from repro.kernels.ssd_scan.ops import ssd_chunk as jssd_chunk  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_chunk_ref as jssd_ref  # noqa: E402
from repro_torch.kernels.build import MAX_SMEM_PER_BLOCK  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_plan  # noqa: E402
from repro_torch.kernels.ssd_scan.plan import (  # noqa: E402
    MAX_HB, MAX_N, MAX_P, MAX_Q, plan_ssd_chunk, smem_bytes, ssd_chunk_tc_ref)
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref  # noqa: E402
from repro_torch.models.ssm import _pad_rows  # noqa: E402

TOL = 1e-4
#: an H100 SXM's SMs, as the wrapper reads them from the card
N_SM = 132


def _silu(v):
    return v / (1.0 + np.exp(-v))


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _ssd_case(B, L, H, P, N, chunk, seed=0, rate=1.0, per_head=False,
              dtype=torch.bfloat16):
    """The kernel's six model-layout inputs (x, dt, dA, dA_cs, B, C), cut
    into chunks as `ssd_chunked` cuts them, padding included. ``rate``
    scales A = -(1..H); ``per_head`` draws B and C for every head."""
    rng = np.random.default_rng(seed)
    xbc = _bf16(_silu(rng.standard_normal((B, L, H * P + 2 * N)))).to(dtype)
    x = xbc[..., :H * P].reshape(B, L, H, P)
    if per_head:
        Bm = _bf16(_silu(rng.standard_normal((B, L, H, N)))).to(dtype)
        Cm = _bf16(_silu(rng.standard_normal((B, L, H, N)))).to(dtype)
    else:
        Bm = xbc[..., H * P:H * P + N][:, :, None].expand(B, L, H, N)
        Cm = xbc[..., H * P + N:][:, :, None].expand(B, L, H, N)
    lo, hi = np.log(1e-3), np.log(0.1)
    dt0 = np.exp(rng.uniform(size=H) * (hi - lo) + lo)
    dt_bias = dt0 + np.log(-np.expm1(-dt0))
    dt = np.logaddexp(rng.standard_normal((B, L, H)) + dt_bias, 0.0)
    A = -np.arange(1, H + 1) * rate
    pad = (-L) % chunk
    nc = (L + pad) // chunk
    dt = np.pad(dt, ((0, 0), (0, pad), (0, 0))).astype(np.float32)
    dA = np.round(dt * A * 1024) / 1024
    dtc = torch.from_numpy(dt.reshape(B, nc, chunk, H))
    dAc = torch.from_numpy(dA.reshape(B, nc, chunk, H).astype(np.float32))
    cs = torch.cumsum(dAc, dim=2)
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        Bm, Cm = _pad_rows(Bm, pad), _pad_rows(Cm, pad)
    xc, Bc, Cc = (a.reshape((B, nc, chunk) + tuple(a.shape[2:]))
                  for a in (x, Bm, Cm))
    return xc, dtc, dAc, cs, Bc, Cc


def _layout(B, L, H, P, N, chunk, dtype=torch.bfloat16, per_head=False):
    """The kernel's inputs with `_ssd_case`'s shapes and strides, values
    left unset: all the planner reads."""
    xbc = torch.empty((B, L, H * P + 2 * N), dtype=dtype)
    x = xbc[..., :H * P].reshape(B, L, H, P)
    if per_head:
        Bm, Cm = (torch.empty((B, L, H, N), dtype=dtype) for _ in range(2))
    else:
        Bm, Cm = (xbc[..., H * P + i * N:H * P + (i + 1) * N][:, :, None]
                  .expand(B, L, H, N) for i in range(2))
    pad = (-L) % chunk
    nc = (L + pad) // chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        Bm, Cm = _pad_rows(Bm, pad), _pad_rows(Cm, pad)
    f = torch.empty((B, nc, chunk, H))
    return ((x.reshape(B, nc, chunk, H, P), f, f, f)
            + tuple(a.reshape(B, nc, chunk, H, N) for a in (Bm, Cm)))


def _plan(case, **kw):
    return ssd_plan(*case, n_sm=N_SM, **kw)


# ------------------------------------------------------------ the planner

#: (label, B, L, H, P, N, chunk, dtype, route, heads a block, grid): every
#: SSD case of `chip_smoke.py` phase 2 (the mamba2 and jamba serve prefill,
#: 32 rows of 256 tokens; mamba2 heads over four chunks with a padded tail;
#: the reference's kernel-test shapes) and the f32 runs of the main shape
PLANS = [
    ("main", 32, 256, 32, 64, 128, 256, torch.bfloat16, "mma", 4, (5, 8, 32)),
    ("jamba", 32, 256, 128, 64, 128, 256, torch.bfloat16, "mma", 15,
     (5, 9, 32)),
    ("4-chunks-padded", 4, 1000, 32, 64, 128, 256, torch.bfloat16, "mma", 2,
     (5, 16, 16)),
    ("main-f32", 32, 256, 32, 64, 128, 256, torch.float32, "fma", 1,
     (6, 32, 32)),
    ("ragged", 2, 32, 2, 16, 16, 8, torch.bfloat16, "fma", 1, (2, 2, 8)),
    ("ragged", 1, 64, 4, 32, 64, 16, torch.bfloat16, "fma", 1, (2, 4, 4)),
    ("ragged", 2, 24, 3, 8, 16, 8, torch.bfloat16, "fma", 1, (2, 3, 6)),
    ("ragged-f32", 2, 24, 3, 8, 16, 8, torch.float32, "fma", 1, (2, 3, 6)),
]


@pytest.mark.parametrize("row", PLANS, ids=[f"{r[0]}-{str(r[7])[6:]}"
                                             for r in PLANS])
def test_route_and_head_blocks_at_every_chip_smoke_shape(row):
    label, B, L, H, P, N, chunk, dtype, route, hb, grid = row
    plan = _plan(_layout(B, L, H, P, N, chunk, dtype))
    assert plan.route == route, plan
    assert plan.shared, plan
    assert (plan.heads_per_block, plan.grid) == (hb, grid), plan
    if route == "mma":
        # every head of the group in exactly one head block
        assert grid[1] * hb >= H > (grid[1] - 1) * hb


def test_padded_prefill_keeps_the_shared_route():
    """`ssd_chunked`'s padding keeps B and C stride-0 over the heads, so a
    prompt that is not a whole number of chunks builds its raw scores once
    per head block too; a copied (per-head) B and C take one head a
    block."""
    case = _layout(4, 1000, 32, 64, 128, 256)
    assert case[4].stride(3) == 0 and case[5].stride(3) == 0
    plan = _plan(case)
    assert plan.route == "mma" and plan.shared and plan.heads_per_block > 1
    xc, dtc, dA, cs, Bc, Cc = case
    copied = _plan((xc, dtc, dA, cs, Bc.contiguous(), Cc.contiguous()))
    assert copied.route == "mma" and not copied.shared
    assert copied.heads_per_block == 1 and copied.grid == (5, 32, 16)


def test_per_head_b_and_c_take_one_head_a_block():
    plan = _plan(_layout(2, 256, 8, 64, 128, 256, per_head=True))
    assert plan == plan._replace(route="mma", shared=False,
                                 heads_per_block=1, grid=(5, 8, 2))


@pytest.mark.parametrize("change", ["misaligned-x", "q32", "p8", "n24",
                                    "q512", "p128", "n256"])
def test_shapes_the_tensor_cores_do_not_take_go_to_the_fma_kernel(change):
    B, L, H, P, N, Q = 1, 512, 2, 64, 128, 256
    if change == "q32":
        Q = 32
    elif change == "q512":
        Q = 512
    elif change == "p8":
        P = 8
    elif change == "p128":
        P = 128
    elif change == "n24":
        N = 24
    elif change == "n256":
        N = 256
    xc, dtc, dA, cs, Bc, Cc = _layout(B, L, H, P, N, Q)
    if change == "misaligned-x":
        # x one element into a wider buffer: its base is 2 bytes off
        wide = torch.zeros(xc.shape[:-1] + (P + 1,), dtype=xc.dtype)
        xc = wide[..., 1:]
    plan = _plan((xc, dtc, dA, cs, Bc, Cc))
    assert plan.route == "fma", plan


def test_the_largest_tensor_core_block_fits_shared_memory():
    largest = smem_bytes(MAX_Q, MAX_P, MAX_N, MAX_HB)
    assert largest <= MAX_SMEM_PER_BLOCK
    for Q in range(64, MAX_Q + 1, 64):
        for P in range(16, MAX_P + 1, 16):
            for N in range(16, MAX_N + 1, 16):
                assert smem_bytes(Q, P, N, MAX_HB) <= largest
    for H in (1, 7, 16, 17, 128, 1000):
        for BC in (1, 32, 4096):
            plan = plan_ssd_chunk(BC, 256, H, 64, 128, is_bf16=True,
                                  aligned=True, shared=True, n_sm=N_SM)
            assert 1 <= plan.heads_per_block <= MAX_HB


# ------------------------------------------------ the kernel's arithmetic

def _pallas(case):
    """The reference's wrapper (its Pallas kernel in interpret mode) and its
    jnp oracle, moved to the TPU kernel's (B*H, nc, Q, ...) layout."""
    xc, dtc, dA, cs, Bc, Cc = (np.asarray(a.float()) for a in case)
    B, nc, Q, H, P = xc.shape
    N = Bc.shape[-1]
    py, pst = jssd_chunk(*map(jnp.asarray, (xc, dtc, dA, cs, Bc, Cc)))

    def to_bh(a, width):
        return jnp.moveaxis(jnp.asarray(a), 3, 1).reshape((B * H, nc, Q,
                                                            width))
    oy, ost = jssd_ref(to_bh(xc, P), to_bh(dtc[..., None], 1),
                       to_bh(dA[..., None], 1), to_bh(cs[..., None], 1),
                       to_bh(Bc, N), to_bh(Cc, N))
    oy = jnp.moveaxis(oy.reshape(B, H, nc, Q, P), 1, 3)
    ost = ost.reshape(B, H, nc, P, N).transpose(0, 2, 1, 3, 4)
    return (py, pst), (oy, ost)


#: (label, B, L, H, P, N, chunk, rate, per_head): the tensor-core route's
#: shapes cut in width (Q = 64, 128 and 256; a padded tail; per-head B and
#: C), and jamba's decay rates over a 256-row chunk
EMULATED = [
    ("q64", 2, 128, 3, 16, 32, 64, 1.0, False),
    ("q128-padded", 1, 200, 2, 32, 16, 128, 1.0, False),
    ("q256-jamba-decay", 1, 256, 4, 16, 32, 256, 64.0, False),
    ("q64-per-head", 1, 128, 2, 16, 16, 64, 1.0, True),
]


@pytest.mark.parametrize("row", EMULATED, ids=[r[0] for r in EMULATED])
def test_tensor_core_decomposition_matches_the_pallas_kernel_and_oracle(row):
    label, B, L, H, P, N, chunk, rate, per_head = row
    case = _ssd_case(B, L, H, P, N, chunk, seed=3, rate=rate,
                     per_head=per_head)
    assert _plan(case).route == "mma"
    cs = case[3]
    if rate > 1:
        # jamba's decays: the cumulative sum falls to about -3000, and
        # exp(cs[q] - cs[s]) overflows above the diagonal
        assert float(cs.min()) < -2500
        assert bool(torch.isinf(torch.exp(cs[..., :, None, :]
                                          - cs[..., None, :, :])).any())
    y, st = ssd_chunk_tc_ref(*case)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    (py, pst), (oy, ost) = _pallas(case)
    close(y, py, TOL)
    close(st, pst, TOL)
    close(y, oy, TOL)
    close(st, ost, TOL)
    # and the plain version, which the card's phase 2 holds the kernel to
    ry, rst = ssd_chunk_ref(*case)
    close(y, ry, TOL)
    close(st, rst, TOL)


def test_raw_scores_once_per_group_equal_the_per_head_scores():
    """Built once from the group's B and C (a stride-0 head axis) or once
    per head from copies of them: the same bits."""
    case = _ssd_case(1, 128, 3, 16, 32, 64, seed=5)
    xc, dtc, dA, cs, Bc, Cc = case
    shared = ssd_chunk_tc_ref(*case)
    copied = ssd_chunk_tc_ref(xc, dtc, dA, cs, Bc.contiguous(),
                              Cc.contiguous())
    for a, b in zip(shared, copied):
        assert torch.equal(a, b)


def test_scores_as_one_bf16_rounding_would_not_hold_the_tolerance():
    """Why the kernel splits each score and each x * w into bf16 hi + lo:
    a single bf16 rounding of them misses 1e-4 at these inputs."""
    case = _ssd_case(1, 256, 4, 16, 32, 256, seed=3, rate=64.0)
    xc, dtc, dA, cs, Bc, Cc = (a.float() for a in case)
    ry, rst = ssd_chunk_ref(xc, dtc, dA, cs, Bc, Cc)
    csh = cs.movedim(3, 2)
    L = torch.exp(csh[..., :, None] - csh[..., None, :])
    causal = torch.ones((256, 256), dtype=torch.bool).tril()
    raw = torch.einsum("bcqhn,bcshn->bchqs", Cc, Bc)
    scores = torch.where(causal, raw * L * dtc.movedim(3, 2)[..., None, :],
                         torch.zeros(()))
    y1 = torch.einsum("bchqs,bcshp->bcqhp",
                      scores.to(torch.bfloat16).float(), xc)
    err = (y1 - ry).abs()
    assert not bool((err <= TOL + TOL * ry.abs()).all())
