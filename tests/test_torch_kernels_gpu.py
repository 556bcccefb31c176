"""The port's CUDA kernels (attention, dequant-matmul, MoE grouped GEMM, Mamba-2 SSD chunk)
against their plain PyTorch versions, on the card. Marked ``gpu``: they skip without a CUDA device (the kernels have
no CPU mode). Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention_cache, paged_decode_attention,
    paged_decode_attention_prefix)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.kernels.dequant_matmul.ops import (  # noqa: E402
    dequant_matmul, dequant_matmul_int4, dequant_matmul_int8)
from repro_torch.kernels.dequant_matmul.ref import (  # noqa: E402
    dequant_matmul_int4_ref, dequant_matmul_int8_ref)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.moe_gemm.ops import moe_gemm  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_chunk, ssd_plan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref  # noqa: E402
from repro_torch.models.ssm import _pad_rows, ssd_chunked  # noqa: E402
from repro_torch.quant.quantize import quantize_int4, quantize_int8  # noqa: E402

pytestmark = pytest.mark.gpu

# bf16 outputs round to 8 mantissa bits; f32 differs from the plain version
# only in summation order
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dev, dtype)


def _close(out, ref, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


FLASH_SHAPES = [
    # (B, Sq, Sk, H, Hkv, D, Dv, window)
    (1, 64, 64, 4, 4, 32, 32, None),
    (2, 100, 100, 4, 2, 64, 64, None),     # ragged
    (2, 33, 33, 8, 2, 16, 16, None),
    (1, 128, 128, 2, 2, 64, 64, 32),       # sliding window
    (2, 50, 50, 4, 1, 32, 32, 8),
    (1, 70, 70, 4, 2, 48, 32, None),       # Dv != D (MLA prefill)
    (2, 200, 200, 32, 2, 128, 128, None),  # chatglm widths
    # Sq and Sk at the 64-row tile and two-stage ring edges
    (1, 1, 1, 4, 2, 64, 64, None), (2, 63, 63, 4, 2, 64, 64, None),
    (1, 65, 65, 4, 2, 128, 128, None), (1, 127, 127, 8, 2, 128, 128, None),
    (2, 129, 129, 4, 1, 64, 64, None), (1, 257, 257, 32, 2, 128, 128, None),
    (1, 65, 129, 4, 2, 64, 64, None),      # Sq < Sk
    (1, 129, 65, 4, 2, 64, 64, None),      # Sq > Sk: rows past Sk
    (1, 257, 257, 16, 16, 192, 128, None),  # MLA prefill: D 192, Dv 128
    (1, 300, 300, 8, 2, 128, 128, 100),    # a window that crosses kv tiles
    (2, 129, 129, 4, 2, 32, 16, 70),
]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel(cuda, shape, dtype):
    B, Sq, Sk, H, Hkv, D, Dv, window = shape
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, Sq, H, D), dtype, cuda)
    k = _randn(rng, (B, Sk, Hkv, D), dtype, cuda)
    v = _randn(rng, (B, Sk, Hkv, Dv), dtype, cuda)
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    _close(out, flash_attention_ref(q, k, v, window=window), dtype)


DECODE_SHAPES = [
    # (B, W, H, Hkv, D, filled, window)
    (2, 64, 4, 4, 32, 64, None),
    (2, 64, 4, 2, 32, 40, None),
    (1, 100, 8, 2, 64, 77, None),          # W not a multiple of the tile
    (2, 64, 4, 2, 32, 64, 16),             # windowed
    (3, 300, 32, 2, 128, 250, None),       # chatglm widths, ragged
    # chatglm's serve batch (32 sequences, 2 kv heads, g = 16): one tile and
    # one more slot, 160 and 161 slots, the serve's W = 288, and splits that
    # hold no valid slot (the planner's change points on this card: below)
    (32, 32, 32, 2, 128, 32, None), (32, 33, 32, 2, 128, 33, None),
    (32, 160, 32, 2, 128, 160, None), (32, 161, 32, 2, 128, 161, None),
    (32, 288, 32, 2, 128, 272, None), (32, 288, 32, 2, 128, 100, None),
    (32, 2048, 32, 2, 128, 2000, None),
    (32, 288, 24, 8, 64, 272, None),       # granite: g = 3, D = 64
    (32, 288, 32, 8, 128, 272, None),      # jamba: g = 4
    (32, 300, 32, 2, 128, 300, 40),        # a window inside one split
]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel(cuda, shape, dtype):
    B, W, H, Hkv, D, filled, window = shape
    rng = np.random.default_rng(1)
    q = _randn(rng, (B, 1, H, D), dtype, cuda)
    kc = _randn(rng, (B, W, Hkv, D), dtype, cuda)
    vc = _randn(rng, (B, W, Hkv, D), dtype, cuda)
    pos = np.full((B, W), -1, np.int32)
    pos[:, :filled] = np.arange(filled)
    pos[-1] = -1                            # a row with every slot empty
    pos = torch.from_numpy(pos).to(cuda)
    q_pos = torch.full((B,), filled - 1, dtype=torch.int32, device=cuda)
    n0 = decode_attention_cache.launches
    out = decode_attention_cache(q, kc, vc, pos, q_pos, window=window)
    torch.cuda.synchronize()
    assert decode_attention_cache.launches == n0 + 1
    _close(out, decode_attention_ref(q, kc, vc, pos, q_pos, window=window),
           dtype)
    assert torch.all(out[-1] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_where_the_plan_changes(cuda, dtype):
    """Every cache length up to 320 slots at which the wrapper's planner
    (this card's SM count and the kernel's occupancy) changes the split of
    chatglm's decode batch, and the length just before it."""
    from repro_torch.kernels.decode_attention.ops import split_plan
    B, H, Hkv, D = 32, 32, 2, 128
    plans = [split_plan(B, W, H, Hkv, D, D, dtype, cuda)
             for W in range(1, 321)]
    edges = [W for W in range(2, 321) if plans[W - 1] != plans[W - 2]]
    assert len({p[0] for p in plans}) > 1, plans
    rng = np.random.default_rng(13)
    for W in sorted({w for e in edges for w in (e - 1, e)}):
        q = _randn(rng, (B, 1, H, D), dtype, cuda)
        kc = _randn(rng, (B, W, Hkv, D), dtype, cuda)
        vc = _randn(rng, (B, W, Hkv, D), dtype, cuda)
        pos = torch.arange(W, dtype=torch.int32, device=cuda).repeat(B, 1)
        pos[1] = -1                         # a row with every slot empty
        q_pos = torch.full((B,), W - 1, dtype=torch.int32, device=cuda)
        out = decode_attention_cache(q, kc, vc, pos, q_pos)
        torch.cuda.synchronize()
        _close(out, decode_attention_ref(q, kc, vc, pos, q_pos), dtype)
        assert torch.all(out[1] == 0)


def test_decode_split_merge_counters_reset_between_calls(cuda):
    """Calls in a row on different shapes: each launch's last block per
    (sequence, kv head) merges and sets its counter back to 0, so the next
    launch, on another grid, merges right too."""
    from repro_torch.kernels.decode_attention.ops import split_plan
    rng = np.random.default_rng(12)
    shapes = [(32, 288, 32, 2, 128, 272), (3, 1001, 8, 2, 64, 777),
              (32, 288, 32, 2, 128, 100), (8, 97, 24, 8, 64, 97)]
    assert len({split_plan(B, W, H, Hkv, D, D, torch.bfloat16, cuda)
                for B, W, H, Hkv, D, _ in shapes}) > 1
    for B, W, H, Hkv, D, filled in shapes * 2:
        q = _randn(rng, (B, 1, H, D), torch.bfloat16, cuda)
        kc = _randn(rng, (B, W, Hkv, D), torch.bfloat16, cuda)
        vc = _randn(rng, (B, W, Hkv, D), torch.bfloat16, cuda)
        pos = np.full((B, W), -1, np.int32)
        pos[:, :filled] = np.arange(filled)
        pos = torch.from_numpy(pos).to(cuda)
        q_pos = torch.full((B,), filled - 1, dtype=torch.int32, device=cuda)
        out = decode_attention_cache(q, kc, vc, pos, q_pos)
        torch.cuda.synchronize()
        _close(out, decode_attention_ref(q, kc, vc, pos, q_pos),
               torch.bfloat16)


PAGED_SHAPES = [
    # (B, H, Hkv, D, bs, nb, filled)
    (2, 4, 2, 32, 4, 5, 17),
    (3, 8, 2, 64, 16, 3, 33),              # bs < tile: a tile spans blocks
    (2, 32, 2, 128, 16, 9, 130),           # chatglm widths, ragged
    # the split kernel: chatglm's and granite's serve batch (several
    # splits), blocks of 4 and 8 slots, a group of 3 and of 1 (padded mma
    # rows), D = 96 and 48 (a last pair of n8 tiles), blocks of 64 slots
    (32, 32, 2, 128, 16, 18, 272), (32, 24, 8, 64, 16, 18, 272),
    (5, 8, 2, 32, 4, 40, 150), (4, 12, 2, 96, 8, 21, 100),
    (3, 4, 4, 48, 8, 9, 70), (2, 16, 1, 128, 64, 5, 300),
    (3, 40, 1, 64, 16, 6, 90),             # group 40: three head batches
]


@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_attention_kernel(cuda, shape, dtype):
    B, H, Hkv, D, bs, nb, filled = shape
    rng = np.random.default_rng(2)
    P = B * nb + 3
    q = _randn(rng, (B, 1, H, D), dtype, cuda)
    kp = _randn(rng, (P, bs, Hkv, D), dtype, cuda)
    vp = _randn(rng, (P, bs, Hkv, D), dtype, cuda)
    table = rng.permutation(P)[:B * nb].reshape(B, nb).astype(np.int32)
    pos = np.full((P, bs), -1, np.int32)
    for b in range(B - 1):                  # the last row stays empty
        for j in range(filled):
            pos[table[b, j // bs], j % bs] = j
    pos = torch.from_numpy(pos).to(cuda)
    table = torch.from_numpy(table).to(cuda)
    q_pos = torch.full((B,), filled - 1, dtype=torch.int32, device=cuda)
    n0 = paged_decode_attention.launches
    out = paged_decode_attention(q, kp, vp, pos, table, q_pos)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == n0 + 1
    _close(out, paged_decode_attention_ref(q, kp, vp, pos, table, q_pos),
           dtype)
    assert torch.all(out[-1] == 0)


def test_paged_kernel_reads_out_of_range_blocks_as_empty(cuda):
    """A block-table entry outside the pool never sends a load outside it:
    the kernel reads it as an empty block, as its plain version does."""
    B, H, Hkv, D, bs, nb, filled = 3, 8, 2, 32, 4, 4, 12
    rng = np.random.default_rng(3)
    P = B * nb
    q = _randn(rng, (B, 1, H, D), torch.float32, cuda)
    kp = _randn(rng, (P, bs, Hkv, D), torch.float32, cuda)
    vp = _randn(rng, (P, bs, Hkv, D), torch.float32, cuda)
    table = np.arange(P, dtype=np.int32).reshape(B, nb)
    pos = np.full((P, bs), -1, np.int32)
    for b in range(B):
        for j in range(filled):
            pos[table[b, j // bs], j % bs] = j
    pos = torch.from_numpy(pos).to(cuda)
    q_pos = torch.full((B,), filled - 1, dtype=torch.int32, device=cuda)
    good = torch.from_numpy(table).to(cuda)
    bad = good.clone()
    bad[1] = torch.tensor([P, -1, 2 ** 30, P + 7], dtype=torch.int32)
    bad[2, 3] = -5                          # a block with no token: no effect
    out = paged_decode_attention(q, kp, vp, pos, bad, q_pos)
    torch.cuda.synchronize()
    ref = paged_decode_attention_ref(q, kp, vp, pos, good, q_pos)
    assert torch.all(out[1] == 0)
    _close(out[0::2], ref[0::2], torch.float32)
    _close(out, paged_decode_attention_ref(q, kp, vp, pos, bad, q_pos),
           torch.float32)


def _paged_serve(cuda, dtype, B, H, Hkv, D, bs, plen, max_new, samples, last,
                 seed):
    """q, pools and tables as the serving backend lays them out
    (`build_paged_layout`: prompt blocks shared by the samples), filled up
    to position ``last``."""
    from repro_torch.serving.backend import BlockAllocator, build_paged_layout
    lay = build_paged_layout(BlockAllocator(10 ** 6, bs), plen, max_new,
                             [samples] * (B // samples))
    table = np.asarray(lay.decode_table, np.int32)
    P = lay.n_pool_blocks
    pos = np.full((P, bs), -1, np.int32)
    for b in range(B):
        for j in range(min(last + 1, table.shape[1] * bs)):
            pos[table[b, j // bs], j % bs] = j
    rng = np.random.default_rng(seed)
    q = _randn(rng, (B, 1, H, D), dtype, cuda)
    kp = _randn(rng, (P, bs, Hkv, D), dtype, cuda)
    vp = _randn(rng, (P, bs, Hkv, D), dtype, cuda)
    q_pos = torch.full((B,), last, dtype=torch.int32, device=cuda)
    return (q, kp, vp, torch.from_numpy(pos).to(cuda),
            torch.from_numpy(table).to(cuda), q_pos)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_attention_kernel_where_the_plan_changes(cuda, dtype):
    """Every table width of chatglm's paged serve batch (32 sequences of 8
    prompts x 4 samples, blocks of 16) at which the wrapper's planner
    changes the split, the width just before it, and one filled to a
    quarter, so that the later splits hold no valid slot."""
    from repro_torch.kernels.decode_attention.ops import paged_split_plan
    B, H, Hkv, D, bs = 32, 32, 2, 128, 16
    plans = [paged_split_plan(B, nb * bs, H, Hkv, D, D, dtype, cuda)
             for nb in range(1, 41)]
    edges = [nb for nb in range(2, 41) if plans[nb - 1] != plans[nb - 2]]
    assert len({p[0] for p in plans}) > 1, plans
    for nb in sorted({n for e in edges for n in (e - 1, e)}):
        for last in (nb * bs - 1, nb * bs // 4):
            plen = max(1, nb * bs // 2)     # kv length plen + new - 1
            args = _paged_serve(cuda, dtype, B, H, Hkv, D, bs, plen,
                                nb * bs - plen + 1, 4, last, nb)
            assert args[4].shape[1] == nb
            out = paged_decode_attention(*args)
            torch.cuda.synchronize()
            _close(out, paged_decode_attention_ref(*args), dtype)


def test_paged_split_is_bit_equal_from_call_to_call(cuda):
    """The last block of a (sequence, kv head) merges the splits in split
    order and no atomic touches the output: two calls give the same bits,
    and so does a call after calls of other shapes, which shows each launch
    leaves its merge counters at 0."""
    from repro_torch.kernels.decode_attention.ops import paged_split_plan
    bf = torch.bfloat16
    args = _paged_serve(cuda, bf, 32, 32, 2, 128, 16, 256, 32, 4, 271, 20)
    assert paged_split_plan(32, 288, 32, 2, 128, 128, bf, cuda)[0] > 1
    first = paged_decode_attention(*args)
    again = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    for shape in ((32, 24, 8, 64, 16, 256, 32, 4, 200),
                  (6, 32, 2, 128, 16, 101, 30, 2, 110),
                  (8, 8, 2, 32, 4, 60, 20, 2, 70)):
        other = _paged_serve(cuda, bf, *shape, 21)
        _close(paged_decode_attention(*other),
               paged_decode_attention_ref(*other), bf)
        _close(decode_attention_cache(*[a for a in _dense_of(other)]),
               paged_decode_attention_ref(*other), bf)
    later = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, later)


def _dense_of(args):
    """The same cache gathered into a dense ring, for the dense kernel: it
    shares the merge counters with the paged one."""
    q, kp, vp, pos, table, q_pos = args
    bt = table.long()
    B = q.shape[0]
    return (q, kp[bt].reshape(B, -1, *kp.shape[2:]).contiguous(),
            vp[bt].reshape(B, -1, *vp.shape[2:]).contiguous(),
            pos[bt].reshape(B, -1).contiguous(), q_pos)


#: the paged kernel's standing largest errors against its plain version
#: (`chip_smoke.py` phase 2)
PAGED_ERR = {torch.bfloat16: 9.8e-4, torch.float32: 1.2e-6}
#: (atol, rtol) of the grouped launch at the other groupings, set from the
#: errors measured there on an H100: outputs up to about 2 in size, where
#: one bf16 rounding of the output is up to 7.8e-3 of the value. Over three
#: seeds the largest error read 0.85 of this limit in bf16 (3.9e-3 at an
#: output of 1.25) and 0.55 in f32 (1.3e-6)
GROUPED_ERR = {torch.bfloat16: (5e-4, 8e-3), torch.float32: (2e-6, 1e-5)}
#: (name, H, Hkv, D): granite-moe-3b-a800m.longdoc's heads (group 3) and
#: chatglm3-6b's (group 16)
GROUPED = [("granite", 24, 8, 64), ("chatglm", 32, 2, 128)]


def _grouped_serve(cuda, dtype, H, Hkv, D, repeats, plen, max_new, last,
                   seed, bs=16):
    """`_paged_serve` over requests of ``repeats`` samples, with the
    layout's group descriptor on the card."""
    from repro_torch.serving.backend import BlockAllocator, build_paged_layout
    lay = build_paged_layout(BlockAllocator(10 ** 6, bs), plen, max_new,
                             repeats)
    table = np.asarray(lay.decode_table, np.int32)
    B, nb = table.shape
    P = lay.n_pool_blocks
    pos = np.full((P, bs), -1, np.int32)
    j = np.arange(min(last + 1, nb * bs))
    for b in range(B):
        pos[table[b, j // bs], j % bs] = j
    rng = np.random.default_rng(seed)
    q = _randn(rng, (B, 1, H, D), dtype, cuda)
    kp = _randn(rng, (P, bs, Hkv, D), dtype, cuda)
    vp = _randn(rng, (P, bs, Hkv, D), dtype, cuda)
    q_pos = torch.full((B,), last, dtype=torch.int32, device=cuda)
    args = (q, kp, vp, torch.from_numpy(pos).to(cuda),
            torch.from_numpy(table).to(cuda), q_pos)
    return args, torch.from_numpy(lay.prefix_groups).to(cuda)


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("shape", GROUPED, ids=[g[0] for g in GROUPED])
@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_paged_decode_at_longdoc(cuda, shape, dtype):
    """longdoc's batch (160 rows: 8 prompts of 3840 tokens x 20 samples,
    4096 slots a row, 128 tokens decoded): the grouped launch against the
    per-row launch and the plain version, within the paged kernel's
    standing errors; one wrapper call each."""
    _, H, Hkv, D = shape
    args, groups = _grouped_serve(cuda, dtype, H, Hkv, D, [20] * 8, 3840,
                                  256, 3840 + 127, 31)
    assert args[4].shape == (160, 256)
    n0 = paged_decode_attention.launches
    p0 = paged_decode_attention_prefix.launches
    grouped = paged_decode_attention(*args, prefix_groups=groups)
    per_row = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == n0 + 2
    assert paged_decode_attention_prefix.launches == p0 + 1
    plain = paged_decode_attention_ref(*args)
    assert _max_err(grouped, plain) <= PAGED_ERR[dtype]
    assert _max_err(grouped, per_row) <= PAGED_ERR[dtype]
    assert torch.equal(grouped,
                       paged_decode_attention(*args, prefix_groups=groups))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("repeats,plen,last", [
    ([20] * 8, 128, 200),           # the backlog cells' batch
    ([4, 1, 3, 20, 2], 133, 160),   # a CoW partial block, a one-row request
    ([2] * 16, 136, 137),           # tail rows just past the prompt
    ([20, 20], 20, 30),             # a prompt shorter than a tile: no group
])
def test_grouped_paged_decode_at_other_groupings(cuda, dtype, repeats, plen,
                                                 last):
    """The grouped launch against the plain version and the per-row launch
    within `GROUPED_ERR`, at both models' heads (granite's prompts of 8
    blocks or more are grouped; chatglm3-6b's take the per-row kernel)."""
    atol, rtol = GROUPED_ERR[dtype]
    for _, H, Hkv, D in GROUPED:
        args, groups = _grouped_serve(cuda, dtype, H, Hkv, D, repeats, plen,
                                      256, last, 32)
        grouped = paged_decode_attention(*args, prefix_groups=groups)
        torch.cuda.synchronize()
        for ref in (paged_decode_attention_ref(*args),
                    paged_decode_attention(*args)):
            torch.testing.assert_close(grouped.float(), ref.float(),
                                       atol=atol, rtol=rtol)


def test_grouped_rows_with_every_slot_empty_are_zero(cuda):
    """F3 on the grouped path: a row of a group at q_pos -1, and a group
    whose blocks hold no token, come out exactly 0."""
    args, groups = _grouped_serve(cuda, torch.bfloat16, 24, 8, 64,
                                  [20, 20], 128, 64, 150, 33)
    q, kp, vp, pos, table, q_pos = args
    q_pos[3] = -1
    pos[table[20:].long().flatten()] = -1
    out = paged_decode_attention(*args, prefix_groups=groups)
    torch.cuda.synchronize()
    assert torch.all(out[3] == 0) and torch.all(out[20:] == 0)
    _close(out, paged_decode_attention_ref(*args), torch.bfloat16)


@pytest.mark.parametrize("shape", GROUPED, ids=[g[0] for g in GROUPED])
def test_grouped_graph_serves_another_grouping(cuda, shape):
    """One CUDA graph of the grouped call, captured on one batch and
    replayed on a second batch of the same rows and table shape with
    another grouping (and another fill): the outputs equal the eager
    grouped call's bit for bit and the plain version's within the standing
    error. The launch depends on shapes only."""
    from repro_torch.kernels.common import holding_workspaces
    _, H, Hkv, D = shape
    bf = torch.bfloat16
    first, g1 = _grouped_serve(cuda, bf, H, Hkv, D, [20] * 8, 1024, 64,
                               1050, 34)
    second, g2 = _grouped_serve(cuda, bf, H, Hkv, D, [40, 1, 19, 60, 2, 38],
                                1024, 64, 1030, 35)
    assert first[4].shape == second[4].shape and not torch.equal(g1, g2)
    static = [t.clone() for t in first] + [g1.clone()]
    # the pools differ in size: give both the larger pool
    P = max(first[1].shape[0], second[1].shape[0])
    for i in (1, 2, 3):
        grown = torch.zeros((P,) + tuple(static[i].shape[1:]),
                            dtype=static[i].dtype, device=cuda)
        if i == 3:
            grown.fill_(-1)
        grown[:first[i].shape[0]] = first[i]
        static[i] = grown

    def call():
        return paged_decode_attention(*static[:6], prefix_groups=static[6])

    eager_first = call()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with holding_workspaces() as held, torch.cuda.stream(side):
        call()                              # warm the workspace
        side.synchronize()
        graph.capture_begin()
        out = call()
        graph.capture_end()
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager_first)
    for i, t in enumerate(list(second) + [g2]):
        static[i].zero_()
        if i == 3:
            static[i].fill_(-1)
        static[i][:t.shape[0]] = t
    graph.replay()
    torch.cuda.synchronize()
    assert held
    eager = call()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    _close(out, paged_decode_attention_ref(*static[:6]), bf)


def test_paged_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(16)
    for D, Dv in ((40, 40), (128, 256), (64, 24)):
        q = _randn(rng, (2, 1, 4, D), torch.bfloat16, cuda)
        kp = _randn(rng, (4, 8, 2, D), torch.bfloat16, cuda)
        vp = _randn(rng, (4, 8, 2, Dv), torch.bfloat16, cuda)
        pos = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
        table = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
        q_pos = torch.zeros((2,), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="head dims"):
            paged_decode_attention(q, kp, vp, pos, table, q_pos)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 4, 32), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 8, 4, 32), device=cuda)
    k = torch.zeros((1, 32, 8, 2), device=cuda).transpose(1, 3)
    with pytest.raises(ValueError):
        flash_attention(q, k, k)


DQ8_SHAPES = [
    # (M, K, N)
    (5, 48, 19), (1, 32, 130), (9, 64, 64), (17, 96, 33),  # ragged
    (3, 33, 17),                           # odd K: unaligned rows
    (1, 4096, 4096),                       # one row, chatglm wq
    (32, 4096, 256),                       # chatglm wk at decode
    (70, 13696, 200),                      # chatglm down's K, two m tiles
]
DQ4_SHAPES = [
    # (M, K, N, group size)
    (5, 48, 19, 16), (1, 32, 130, 32), (9, 64, 64, 16), (17, 96, 33, 8),
    (4, 48, 40, 24),                       # groups that straddle 16-row steps
    (3, 96, 24, 24), (2, 160, 16, 32), (6, 200, 48, 8),
    (1, 4096, 4096, 32), (32, 4096, 256, 32), (70, 13696, 200, 32),
]


def _weight(rng, K, N, dev, lead=()):
    """A dense weight as the model draws it: normal * K^-1/2, so that the
    outputs of unit-normal rows are of order one."""
    return _randn(rng, lead + (K, N), torch.float32, dev) * K ** -0.5


def _dq_check(cuda, kernel, plain, x, qw, scale, dtype, counter):
    n0 = counter.launches
    out = kernel(x, qw, scale)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1
    assert out.dtype == dtype and out.shape == (x.shape[0], qw.shape[1])
    _close(out, plain(x, qw, scale), dtype)


@pytest.mark.parametrize("shape", DQ8_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dequant_matmul_int8_kernel(cuda, shape, dtype):
    M, K, N = shape
    rng = np.random.default_rng(4)
    x = _randn(rng, (M, K), dtype, cuda)
    qw, scale = quantize_int8(_weight(rng, K, N, cuda))
    _dq_check(cuda, dequant_matmul_int8, dequant_matmul_int8_ref, x, qw,
              scale, dtype, dequant_matmul_int8)


@pytest.mark.parametrize("shape", DQ4_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dequant_matmul_int4_kernel(cuda, shape, dtype):
    M, K, N, gs = shape
    rng = np.random.default_rng(5)
    x = _randn(rng, (M, K), dtype, cuda)
    packed, scale = quantize_int4(_weight(rng, K, N, cuda), gs)
    assert scale.shape == (K // gs, N)
    _dq_check(cuda, dequant_matmul_int4, dequant_matmul_int4_ref, x, packed,
              scale, dtype, dequant_matmul_int4)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dequant_matmul_on_a_layer_view_of_a_stacked_leaf(cuda, fmt, dtype):
    """The model reads ``qw[i]`` / ``scale[i]`` of stacked leaves: views at
    an offset, through the leading-dims dispatch."""
    rng = np.random.default_rng(6)
    w = _weight(rng, 96, 40, cuda, lead=(3,))
    qw, scale = quantize_int8(w) if fmt == "int8" else quantize_int4(w, 24)
    x = _randn(rng, (2, 5, 96), dtype, cuda)
    plain = dequant_matmul_int8_ref if fmt == "int8" else \
        dequant_matmul_int4_ref
    for i in range(3):
        out = dequant_matmul(x, qw[i], scale[i])
        torch.cuda.synchronize()
        assert out.shape == (2, 5, 40)
        _close(out, plain(x, qw[i], scale[i]), dtype)


#: the int4 split-K kernel's decode shapes: x rows about the 16-row steps
#: of its n8 tiles, chatglm's widths, groups of 8 and 32 (K = 4096, 13696)
#: and of 24, which straddle 16-row steps (K = 4104, 13704, the nearest
#: multiples of 24)
DQ4_SPLIT_ROWS = [1, 16, 31, 32, 33, 64]
DQ4_SPLIT_NKG = [(N, K, gs) for N in (256, 4096, 13696)
                 for K, gs in ((4096, 8), (4096, 32), (4104, 24),
                               (13696, 8), (13696, 32), (13704, 24))]
_DQ4_WEIGHTS = {}


def _int4_weight(cuda, K, N, gs):
    """A (K, N) weight drawn on the card as the model draws one, quantized
    with groups of ``gs``; kept across the tests that share it."""
    key = (K, N, gs)
    if key not in _DQ4_WEIGHTS:
        g = torch.Generator(device=cuda).manual_seed(K * 7 + N * 3 + gs)
        w = torch.randn((K, N), generator=g, device=cuda) * K ** -0.5
        _DQ4_WEIGHTS.clear()
        _DQ4_WEIGHTS[key] = quantize_int4(w, gs)
    packed, scale = _DQ4_WEIGHTS[key]
    assert scale.shape == (K // gs, N)
    return packed, scale


@pytest.mark.parametrize("M", DQ4_SPLIT_ROWS)
@pytest.mark.parametrize("N,K,gs", DQ4_SPLIT_NKG)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dequant_matmul_int4_split_kernel(cuda, M, N, K, gs, dtype):
    from repro_torch.kernels.dequant_matmul.ops import int4_plan
    packed, scale = _int4_weight(cuda, K, N, gs)
    rng = np.random.default_rng(M)
    x = _randn(rng, (M, K), dtype, cuda)
    assert int4_plan(x, packed, scale).route == "split_k"
    _dq_check(cuda, dequant_matmul_int4, dequant_matmul_int4_ref, x, packed,
              scale, dtype, dequant_matmul_int4)


def test_dequant_matmul_int4_routes_by_rows(cuda):
    """Up to 64 rows take the split-K kernel; more take the TMA + wgmma
    kernel in bf16 and the tiled one in f32; all agree with the plain
    version."""
    from repro_torch.kernels.dequant_matmul.ops import int4_plan
    packed, scale = _int4_weight(cuda, 4096, 256, 32)
    rng = np.random.default_rng(14)
    for M, dtype, route in ((64, torch.bfloat16, "split_k"),
                            (65, torch.bfloat16, "wgmma"),
                            (64, torch.float32, "split_k"),
                            (65, torch.float32, "tiled")):
        x = _randn(rng, (M, 4096), dtype, cuda)
        assert int4_plan(x, packed, scale).route == route
        _dq_check(cuda, dequant_matmul_int4, dequant_matmul_int4_ref, x,
                  packed, scale, dtype, dequant_matmul_int4)


#: the TMA + wgmma int4 kernel's shapes: rows about its 128-row tile and the
#: paged chatglm prefill's 2048, chatglm's widths, every group it takes, and
#: a last 128-column tile that N fills by half
DQ4_TC_ROWS = [65, 127, 128, 129, 300, 2048]
DQ4_TC_NKG = [(N, K, gs) for N, K in ((256, 4096), (4096, 4096),
                                      (13696, 4096), (4096, 13696))
              for gs in (16, 32, 64)] + [(4160, 4096, 32)]


@pytest.mark.parametrize("M", DQ4_TC_ROWS)
@pytest.mark.parametrize("N,K,gs", DQ4_TC_NKG)
def test_dequant_matmul_int4_wgmma_kernel(cuda, M, N, K, gs):
    from repro_torch.kernels.dequant_matmul.ops import int4_plan
    packed, scale = _int4_weight(cuda, K, N, gs)
    rng = np.random.default_rng(M + 1)
    x = _randn(rng, (M, K), torch.bfloat16, cuda)
    assert int4_plan(x, packed, scale).route == "wgmma"
    _dq_check(cuda, dequant_matmul_int4, dequant_matmul_int4_ref, x, packed,
              scale, torch.bfloat16, dequant_matmul_int4)


def test_dequant_matmul_int4_split_is_bit_equal_from_call_to_call(cuda):
    """The last block of a strip sums the slices in slice order and no
    atomic touches the output: two calls give the same bits, and so does a
    call after calls of other shapes, which shows each launch leaves its
    merge counters at 0."""
    from repro_torch.kernels.dequant_matmul.ops import int4_plan
    rng = np.random.default_rng(15)
    packed, scale = _int4_weight(cuda, 4096, 13696, 32)
    x = _randn(rng, (32, 4096), torch.bfloat16, cuda)
    assert int4_plan(x, packed, scale).n_slices > 1
    first = dequant_matmul_int4(x, packed, scale)
    again = dequant_matmul_int4(x, packed, scale)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    for M, K, N in ((32, 13696, 4096), (5, 96, 40), (16, 4096, 256)):
        p, s = quantize_int4(_weight(rng, K, N, cuda), 32)
        y = _randn(rng, (M, K), torch.bfloat16, cuda)
        assert int4_plan(y, p, s).n_slices > 1 or K == 96
        _close(dequant_matmul_int4(y, p, s), dequant_matmul_int4_ref(y, p, s),
               torch.bfloat16)
    later = dequant_matmul_int4(x, packed, scale)
    torch.cuda.synchronize()
    assert torch.equal(first, later)
    _close(first, dequant_matmul_int4_ref(x, packed, scale), torch.bfloat16)


#: the int8 split-K kernel's decode shapes (bf16 x): x rows about its n8
#: tiles, chatglm's widths and a K of whole 16-byte rows but not whole k
#: tiles; and the TMA + wgmma kernel's prefill rows about its 128-row tile
DQ8_SPLIT_ROWS = [1, 16, 31, 32, 33, 64]
DQ8_SPLIT_NK = [(256, 4096), (4096, 4096), (13696, 4096), (4096, 13696),
                (272, 4104)]
DQ8_TC_ROWS = [65, 127, 128, 129, 300, 2048]
DQ8_TC_NK = [(256, 4096), (4096, 4096), (13696, 4096), (4096, 13696),
             (4160, 4096), (48, 64)]       # (48, 64): one stage
_DQ8_WEIGHTS = {}


def _int8_weight(cuda, K, N):
    """A (K, N) weight drawn on the card as the model draws one, quantized
    to int8; kept across the tests that share it."""
    if (K, N) not in _DQ8_WEIGHTS:
        g = torch.Generator(device=cuda).manual_seed(K * 5 + N)
        w = torch.randn((K, N), generator=g, device=cuda) * K ** -0.5
        _DQ8_WEIGHTS.clear()
        _DQ8_WEIGHTS[(K, N)] = quantize_int8(w)
    return _DQ8_WEIGHTS[(K, N)]


@pytest.mark.parametrize("M", DQ8_SPLIT_ROWS)
@pytest.mark.parametrize("N,K", DQ8_SPLIT_NK)
def test_dequant_matmul_int8_split_kernel(cuda, M, N, K):
    from repro_torch.kernels.dequant_matmul.ops import int8_plan
    qw, scale = _int8_weight(cuda, K, N)
    x = _randn(np.random.default_rng(M), (M, K), torch.bfloat16, cuda)
    assert int8_plan(x, qw, scale).route == "split_k"
    _dq_check(cuda, dequant_matmul_int8, dequant_matmul_int8_ref, x, qw,
              scale, torch.bfloat16, dequant_matmul_int8)


@pytest.mark.parametrize("M", DQ8_TC_ROWS)
@pytest.mark.parametrize("N,K", DQ8_TC_NK)
def test_dequant_matmul_int8_wgmma_kernel(cuda, M, N, K):
    from repro_torch.kernels.dequant_matmul.ops import int8_plan
    qw, scale = _int8_weight(cuda, K, N)
    x = _randn(np.random.default_rng(M + 1), (M, K), torch.bfloat16, cuda)
    assert int8_plan(x, qw, scale).route == "wgmma"
    _dq_check(cuda, dequant_matmul_int8, dequant_matmul_int8_ref, x, qw,
              scale, torch.bfloat16, dequant_matmul_int8)


def test_dequant_matmul_int8_routes(cuda):
    """bf16 x takes the split-K kernel up to 64 rows and the TMA + wgmma
    kernel above; f32 x and ragged shapes (N not whole 16-byte rows, K not
    whole 64-row stages at prefill, x rows not 16-byte aligned at decode)
    take the tiled kernel; all agree with the plain version."""
    from repro_torch.kernels.dequant_matmul.ops import int8_plan
    rng = np.random.default_rng(17)
    bf, f32 = torch.bfloat16, torch.float32
    for M, K, N, dtype, route in ((64, 4096, 256, bf, "split_k"),
                                  (65, 4096, 256, bf, "wgmma"),
                                  (64, 4096, 256, f32, "tiled"),
                                  (65, 4096, 256, f32, "tiled"),
                                  (32, 4096, 200, bf, "tiled"),
                                  (300, 4104, 256, bf, "tiled"),
                                  (32, 4100, 256, bf, "tiled")):
        qw, scale = quantize_int8(_weight(rng, K, N, cuda))
        x = _randn(rng, (M, K), dtype, cuda)
        assert int8_plan(x, qw, scale).route == route, (M, K, N, dtype)
        _dq_check(cuda, dequant_matmul_int8, dequant_matmul_int8_ref, x, qw,
                  scale, dtype, dequant_matmul_int8)


def test_dequant_matmul_int8_split_is_bit_equal_from_call_to_call(cuda):
    """As for int4: slices summed in slice order and the scale applied once
    by the last block of a strip; two calls give the same bits, also after
    calls of other shapes (the merge counters are left at 0)."""
    from repro_torch.kernels.dequant_matmul.ops import int8_plan
    rng = np.random.default_rng(18)
    qw, scale = _int8_weight(cuda, 4096, 13696)
    x = _randn(rng, (32, 4096), torch.bfloat16, cuda)
    assert int8_plan(x, qw, scale).n_slices > 1
    first = dequant_matmul_int8(x, qw, scale)
    again = dequant_matmul_int8(x, qw, scale)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    for M, K, N in ((32, 13696, 4096), (5, 4104, 272), (16, 4096, 256)):
        q, s = quantize_int8(_weight(rng, K, N, cuda))
        y = _randn(rng, (M, K), torch.bfloat16, cuda)
        assert int8_plan(y, q, s).n_slices > 1
        _close(dequant_matmul_int8(y, q, s), dequant_matmul_int8_ref(y, q, s),
               torch.bfloat16)
    later = dequant_matmul_int8(x, qw, scale)
    torch.cuda.synchronize()
    assert torch.equal(first, later)
    _close(first, dequant_matmul_int8_ref(x, qw, scale), torch.bfloat16)


def test_dequant_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rng = np.random.default_rng(7)
    x = _randn(rng, (4, 64), torch.bfloat16, cuda)
    qw, scale = quantize_int8(_weight(rng, 64, 32, cuda))
    with pytest.raises(TypeError, match="scale"):
        dequant_matmul_int8(x, qw, scale.to(torch.bfloat16))
    packed, s4 = quantize_int4(_weight(rng, 64, 32, cuda))
    with pytest.raises(TypeError, match="scale"):
        dequant_matmul_int4(x, packed, s4.to(torch.bfloat16))
    xt = _randn(rng, (64, 4), torch.bfloat16, cuda).t()
    assert not xt.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        dequant_matmul_int8(xt, qw, scale)
    with pytest.raises(ValueError, match="contiguous"):
        dequant_matmul(xt, qw, scale)
    with pytest.raises(TypeError):
        dequant_matmul_int8(x.half(), qw, scale)
    with pytest.raises(ValueError, match="disagree"):
        dequant_matmul_int4(x, packed, s4[:, :16].contiguous())


MOE_SHAPES = [
    # (E, C, d, f): the reference's kernel-test shapes, all but the first
    # ragged somewhere
    (4, 32, 64, 128), (8, 100, 48, 96), (2, 8, 16, 8), (3, 130, 130, 70),
    (2, 5, 33, 17),                        # odd d and f: unaligned rows
    # the serve shapes: granite gate/up at decode, paged and dense prefill,
    # granite down at decode; deepseek gate/up at decode and dense prefill
    (40, 8, 1536, 512), (40, 512, 1536, 512), (40, 2048, 1536, 512),
    (40, 8, 512, 1536), (64, 6, 2048, 1408), (64, 960, 2048, 1408),
]


@pytest.mark.parametrize("shape", MOE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_gemm_kernel(cuda, shape, dtype):
    E, C, D, F = shape
    rng = np.random.default_rng(8)
    x = _randn(rng, (E, C, D), dtype, cuda)
    w = _weight(rng, D, F, cuda, lead=(E,)).to(dtype)
    n0 = moe_gemm.launches
    out = moe_gemm(x, w)
    torch.cuda.synchronize()
    assert moe_gemm.launches == n0 + 1
    assert out.dtype == dtype and out.shape == (E, C, F)
    _close(out, moe_gemm_ref(x, w), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_gemm_on_a_layer_view_of_a_stacked_leaf(cuda, dtype):
    """The model reads ``gate[i]`` of a stacked (layers, E, d, f) leaf: a
    view at an offset."""
    rng = np.random.default_rng(9)
    w = _weight(rng, 96, 40, cuda, lead=(3, 4)).to(dtype)
    x = _randn(rng, (4, 7, 96), dtype, cuda)
    for i in range(3):
        out = moe_gemm(x, w[i])
        torch.cuda.synchronize()
        _close(out, moe_gemm_ref(x, w[i]), dtype)


#: the wgmma kernel's tile edges: capacities about the 64-row decode tile
#: and the 128-row prefill tile, and the deepseek serve's 960 and granite's
#: 2048, at f = 1408 (eleven 128-column tiles, the last partial in a
#: 256-column view)
MOE_TC_ROWS = [1, 6, 8, 63, 64, 65, 127, 128, 129, 960, 2048]


@pytest.mark.parametrize("C", MOE_TC_ROWS)
def test_moe_gemm_wgmma_kernel_at_its_tile_edges(cuda, C):
    from repro_torch.kernels.moe_gemm.ops import moe_plan
    rng = np.random.default_rng(16)
    E, D, F = 3, 2048, 1408
    x = _randn(rng, (E, C, D), torch.bfloat16, cuda)
    w = _weight(rng, D, F, cuda, lead=(E,)).to(torch.bfloat16)
    assert moe_plan(x, w).route == "wgmma"
    n0 = moe_gemm.launches
    out = moe_gemm(x, w)
    torch.cuda.synchronize()
    assert moe_gemm.launches == n0 + 1
    _close(out, moe_gemm_ref(x, w), torch.bfloat16)


@pytest.mark.parametrize("C", [5, 1280])
def test_moe_gemm_wgmma_kernel_at_jamba_widths(cuda, C):
    """jamba-v0.1-52b's experts: d 4096, width 14336, decode C = 5 and
    prefill C = 1280."""
    from repro_torch.kernels.moe_gemm.ops import moe_plan
    g = torch.Generator(device=cuda).manual_seed(17)
    E, D, F = 16, 4096, 14336
    x = torch.randn((E, C, D), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((E, D, F), generator=g, device=cuda)
         * D ** -0.5).to(torch.bfloat16)
    assert moe_plan(x, w).route == "wgmma"
    out = moe_gemm(x, w)
    torch.cuda.synchronize()
    _close(out, moe_gemm_ref(x, w), torch.bfloat16)


def test_moe_gemm_wgmma_kernel_on_a_layer_view_of_a_stacked_leaf(cuda):
    """``gate[i]`` of a stacked (layers, E, d, f) leaf at serve-like widths:
    views at an offset, each 16-byte aligned, through TMA."""
    from repro_torch.kernels.moe_gemm.ops import moe_plan
    rng = np.random.default_rng(18)
    w = _weight(rng, 256, 136, cuda, lead=(3, 4)).to(torch.bfloat16)
    for C in (8, 200):
        x = _randn(rng, (4, C, 256), torch.bfloat16, cuda)
        for i in range(3):
            assert moe_plan(x, w[i]).route == "wgmma"
            out = moe_gemm(x, w[i])
            torch.cuda.synchronize()
            _close(out, moe_gemm_ref(x, w[i]), torch.bfloat16)


def test_moe_gemm_refuses_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(10)
    x = _randn(rng, (2, 4, 32), torch.bfloat16, cuda)
    w = _randn(rng, (2, 32, 16), torch.bfloat16, cuda)
    with pytest.raises(TypeError, match="mixed dtypes"):
        moe_gemm(x, w.float())
    with pytest.raises(TypeError):
        moe_gemm(x.half(), w.half())
    with pytest.raises(ValueError, match="contiguous"):
        moe_gemm(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="disagree"):
        moe_gemm(x, w[:1].contiguous())
    with pytest.raises(ValueError, match="disagree"):
        moe_gemm(x, w[:, :16].contiguous())
    with pytest.raises(ValueError, match="disagree"):
        moe_gemm(x[0], w[0])


# ------------------------------------------------------------ Mamba-2 SSD chunk

SSD_SHAPES = [
    # (B, L, H, P, N, chunk): the reference's kernel-test shapes (the last
    # ragged: three chunks of 8 rows, H = 3, P = 8)
    (2, 32, 2, 16, 16, 8), (1, 64, 4, 32, 64, 16), (2, 24, 3, 8, 16, 8),
    (2, 40, 16, 32, 16, 32),               # reduced mamba2: a padded tail
    (1, 100, 2, 70, 130, 96),              # P, N and Q past one tile
    # the serve shapes: mamba2-370m and jamba-v0.1-52b prefill (32 rows of
    # 256), and mamba2 heads over four chunks, the last padded by 24
    (32, 256, 32, 64, 128, 256), (32, 256, 128, 64, 128, 256),
    (2, 1000, 32, 64, 128, 256),
    # the tensor-core kernel's shorter chunks: Q = 64 and Q = 128, padded
    (4, 300, 8, 64, 128, 64), (4, 300, 8, 32, 64, 128),
]
#: the shapes whose bf16 inputs the planner sends to the tensor-core kernel
SSD_MMA_SHAPES = SSD_SHAPES[5:]


def _ssd_inputs(B, L, H, P, N, chunk, dtype, dev, seed=11, per_head=False):
    """Inputs as a Mamba-2 layer makes them: x, B and C silu'd (x a slice of
    the conv output, B and C one group broadcast over the heads by a stride-0
    view, or with ``per_head`` drawn for every head), dt = softplus(u +
    dt_bias) with dt_bias the inverse softplus of a log-uniform dt in
    [1e-3, 0.1], A = -(1..H); padded and cut into chunks as `ssd_chunked`
    does. Returns the kernel's six model-layout inputs."""
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(seed)
    xbc = F.silu(torch.randn((B, L, H * P + 2 * N), generator=g)).to(dev, dtype)
    x = xbc[..., :H * P].reshape(B, L, H, P)
    Bm = xbc[..., H * P:H * P + N][:, :, None].expand(B, L, H, N)
    Cm = xbc[..., H * P + N:][:, :, None].expand(B, L, H, N)
    if per_head:
        Bm, Cm = (F.silu(torch.randn((B, L, H, N), generator=g)).to(dev, dtype)
                  for _ in range(2))
    dt0 = torch.exp(torch.rand(H, generator=g) * float(np.log(100.0)) + float(np.log(1e-3)))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = torch.logaddexp(torch.randn((B, L, H), generator=g) + dt_bias,
                         torch.zeros(())).to(dev)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    pad = (-L) % chunk
    if pad:
        x, dt = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)) for a in (x, dt))
        Bm, Cm = _pad_rows(Bm, pad), _pad_rows(Cm, pad)
    nc = x.shape[1] // chunk
    xc, dtc, Bc, Cc = (a.reshape((B, nc, chunk) + tuple(a.shape[2:])) for a in (x, dt, Bm, Cm))
    dA = dtc * A
    return xc, dtc, dA, torch.cumsum(dA, dim=2), Bc, Cc


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_chunk_kernel(cuda, shape, dtype):
    """Both outputs are f32 and the kernel's arithmetic after the loads is
    f32, so bf16 inputs are held to the f32 tolerance too."""
    args = _ssd_inputs(*shape, dtype, cuda)
    n0 = ssd_chunk.launches
    y, st = ssd_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == n0 + 1
    y_ref, st_ref = ssd_chunk_ref(*args)
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == y_ref.shape and st.shape == st_ref.shape
    _close(y, y_ref, torch.float32)
    _close(st, st_ref, torch.float32)


@pytest.mark.parametrize("shape", SSD_MMA_SHAPES)
def test_ssd_chunk_tensor_core_route(cuda, shape):
    """bf16 at the serve shapes and at Q = 64, 128 takes the tensor-core
    kernel with B and C shared by a head block: one launch a call, bits
    that repeat from call to call, the f32 tolerance."""
    args = _ssd_inputs(*shape, torch.bfloat16, cuda)
    plan = ssd_plan(*args)
    assert plan.route == "mma" and plan.shared, plan
    n0 = ssd_chunk.launches
    y, st = ssd_chunk(*args)
    y2, st2 = ssd_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == n0 + 2
    assert torch.equal(y, y2) and torch.equal(st, st2)
    y_ref, st_ref = ssd_chunk_ref(*args)
    _close(y, y_ref, torch.float32)
    _close(st, st_ref, torch.float32)


@pytest.mark.parametrize("shape", [(4, 256, 8, 64, 128, 256), (2, 256, 4, 32, 64, 128)])
def test_ssd_chunk_tensor_core_route_per_head_b_and_c(cuda, shape):
    """B and C drawn for every head (one head a block) and x a strided slice
    of the conv output."""
    args = _ssd_inputs(*shape, torch.bfloat16, cuda, per_head=True)
    assert not args[0].is_contiguous()
    plan = ssd_plan(*args)
    assert plan.route == "mma" and not plan.shared and plan.heads_per_block == 1, plan
    n0 = ssd_chunk.launches
    y, st = ssd_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == n0 + 1
    y_ref, st_ref = ssd_chunk_ref(*args)
    _close(y, y_ref, torch.float32)
    _close(st, st_ref, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_chunked_kernel_path_equals_the_plain_path(cuda, dtype):
    """The scan around the kernel: padding, the inter-chunk carry from an
    initial state, and the output cast, over contiguous (copied) inputs and
    over the strided views the model passes; bf16 takes the tensor-core
    route, f32 the scalar-FMA one."""
    B, L, H, P, N, chunk = 2, 300, 8, 64, 128, 256
    xc, dtc, dA, cs, Bc, Cc = _ssd_inputs(B, L, H, P, N, chunk, dtype, cuda)
    want = "mma" if dtype == torch.bfloat16 else "fma"
    assert ssd_plan(xc, dtc, dA, cs, Bc, Cc).route == want
    x = xc.reshape(B, -1, H, P)[:, :L]
    dt = dtc.reshape(B, -1, H)[:, :L].contiguous()
    Bm, Cm = Bc.reshape(B, -1, H, N)[:, :L], Cc.reshape(B, -1, H, N)[:, :L]
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=cuda)
    state = torch.randn((B, H, P, N), device=cuda) * 0.1
    for args in ((x, dt, A, Bm, Cm), (x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous())):
        y0, s0 = ssd_chunked(*args, chunk, state, use_kernel=False)
        n0 = ssd_chunk.launches
        y1, s1 = ssd_chunked(*args, chunk, state, use_kernel=True)
        torch.cuda.synchronize()
        assert ssd_chunk.launches == n0 + 1
        assert y1.dtype == dtype
        _close(y1.float(), y0.float(), dtype)
        _close(s1, s0, torch.float32)


def test_ssd_chunk_refuses_what_the_kernel_does_not_take(cuda):
    xc, dtc, dA, cs, Bc, Cc = _ssd_inputs(1, 16, 2, 8, 16, 8, torch.bfloat16, cuda)
    with pytest.raises(TypeError, match="dt dtype"):
        ssd_chunk(xc, dtc.double(), dA, cs, Bc, Cc)
    with pytest.raises(TypeError, match="B dtype"):
        ssd_chunk(xc, dtc, dA, cs, Bc.float(), Cc)
    with pytest.raises(TypeError, match="unsupported"):
        ssd_chunk(xc.half(), dtc, dA, cs, Bc.half(), Cc.half())
    with pytest.raises(ValueError, match="last axis of x"):
        ssd_chunk(xc.transpose(3, 4).contiguous().transpose(3, 4), dtc, dA, cs, Bc, Cc)
    with pytest.raises(ValueError, match="dA_cs is not contiguous"):
        ssd_chunk(xc, dtc, dA, cs.transpose(2, 3).contiguous().transpose(2, 3), Bc, Cc)
    with pytest.raises(ValueError, match="disagree"):
        ssd_chunk(xc, dtc, dA, cs, Bc[..., :8], Cc)
    with pytest.raises(ValueError, match="shape"):
        ssd_chunk(xc, dtc[:, :, :4], dA, cs, Bc, Cc)
