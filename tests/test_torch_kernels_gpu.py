"""The port's CUDA attention kernels against their plain PyTorch versions, on
the card. Marked ``gpu``: they skip without a CUDA device (the kernels have
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
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402

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
