"""The port's CUDA kernels (attention, dequant-matmul, MoE grouped GEMM) against their plain
PyTorch versions, on the card. Marked ``gpu``: they skip without a CUDA device (the kernels have
no CPU mode). Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention_cache, paged_decode_attention)
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


PAGED_SHAPES = [
    # (B, H, Hkv, D, bs, nb, filled)
    (2, 4, 2, 32, 4, 5, 17),
    (3, 8, 2, 64, 16, 3, 33),              # bs < tile: a tile spans blocks
    (2, 32, 2, 128, 16, 9, 130),           # chatglm widths, ragged
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
