"""The plain PyTorch versions of the port's kernels (what the CUDA kernels
are held to on the card, and what the wrappers run on CPU tensors) against
the reference's jnp oracles, f32 at 1e-4. Shapes mirror
``tests/test_kernels.py``: lengths that are not multiples of a tile, sliding
windows, Dv != D, GQA groups 1, 2 and 4, and rows whose slots are all empty.
For an empty row the jnp oracle's softmax spreads over masked slots; the TPU
kernels (run here in interpret mode) and the port give 0."""
import numpy as np
import pytest

from _torch_parity import close, jnp, torch

from repro.kernels.decode_attention import ref as jref  # noqa: E402
from repro.kernels.decode_attention.decode_attention import (  # noqa: E402
    decode_attention_pallas, paged_decode_attention_pallas)
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jflash  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_chunk as jssd_chunk  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_chunk_ref as jssd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref  # noqa: E402

TOL = 1e-4


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


FLASH_SHAPES = [
    # (B, Sq, Sk, H, Hkv, D, Dv, window)
    (1, 64, 64, 4, 4, 32, 32, None),
    (2, 64, 64, 4, 2, 32, 32, None),       # GQA group 2
    (2, 64, 64, 4, 1, 32, 32, None),       # MQA (group 4)
    (1, 100, 100, 4, 4, 64, 64, None),     # not a multiple of the tile
    (2, 33, 33, 8, 2, 16, 16, None),
    (1, 128, 128, 2, 2, 64, 64, 32),       # sliding window
    (2, 50, 50, 4, 2, 32, 32, 8),
    (1, 70, 70, 4, 2, 48, 32, None),       # Dv != D (MLA prefill)
    (1, 40, 70, 4, 2, 32, 32, None),       # Sq != Sk
]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_plain_matches_oracle(shape):
    B, Sq, Sk, H, Hkv, D, Dv, window = shape
    q, k, v = _inputs(0, (B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, Dv))
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 causal=True, window=window)
    tq, tk, tv = _t(q, k, v)
    close(flash_attention_ref(tq, tk, tv, window=window), ref, TOL)
    n0 = launch_counts()
    close(fa_ops.flash_attention(tq, tk, tv, window=window), ref, TOL)
    assert launch_counts() == n0


DECODE_SHAPES = [
    # (B, W, H, Hkv, D, filled, window)
    (2, 64, 4, 4, 32, 64, None),
    (2, 64, 4, 2, 32, 40, None),           # partially filled cache
    (1, 100, 8, 2, 64, 77, None),          # W not a multiple of the tile
    (2, 64, 4, 2, 32, 64, 16),             # windowed
    (1, 32, 2, 1, 16, 5, None),            # nearly empty cache
    (3, 50, 8, 2, 16, 30, None),           # group 4
]


def _decode_inputs(shape, seed=1):
    B, W, H, Hkv, D, filled, window = shape
    q, kc, vc = _inputs(seed, (B, 1, H, D), (B, W, Hkv, D), (B, W, Hkv, D))
    pos = np.full((B, W), -1, np.int32)
    pos[:, :filled] = np.arange(filled)
    q_pos = np.full((B,), filled, np.int32)
    return q, kc, vc, pos, q_pos


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_attention_plain_matches_oracle(shape):
    window = shape[-1]
    args = _decode_inputs(shape)
    ref = jref.decode_attention_ref(*map(jnp.asarray, args), window=window)
    close(decode_attention_ref(*_t(*args), window=window), ref, TOL)
    close(da_ops.decode_attention_cache(*_t(*args), window=window), ref, TOL)


def test_decode_attention_ring_semantics():
    """Slots hold out-of-order absolute positions after the ring wraps:
    masking follows positions, not slot order."""
    q, kc, vc = _inputs(5, (1, 1, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16))
    pos = np.asarray([[8, 9, 10, 3, 4, 5, 6, 7]], np.int32)
    q_pos = np.asarray([10], np.int32)
    ref = jref.decode_attention_ref(*map(jnp.asarray, (q, kc, vc, pos,
                                                       q_pos)), window=4)
    close(decode_attention_ref(*_t(q, kc, vc, pos, q_pos), window=4), ref,
          TOL)


@pytest.mark.parametrize("window", [None, 3])
def test_decode_attention_empty_row_is_zero_like_the_tpu_kernel(window):
    q, kc, vc, pos, q_pos = _decode_inputs((3, 40, 4, 2, 16, 20, None))
    pos[1] = -1                              # a row with every slot empty
    pos[2] = np.arange(40) + 100             # every slot in the future
    out = decode_attention_ref(*_t(q, kc, vc, pos, q_pos), window=window)
    tpu = decode_attention_pallas(*map(jnp.asarray, (q, kc, vc, pos, q_pos)),
                                  window=window, block_k=16)
    close(out, tpu, TOL)
    assert torch.all(out[1:] == 0)
    full = jref.decode_attention_ref(*map(jnp.asarray, (q, kc, vc, pos,
                                                        q_pos)),
                                     window=window)
    close(out[0], full[0], TOL)


PAGED_SHAPES = [
    # (B, H, Hkv, D, bs, nb, filled)
    (2, 4, 2, 32, 4, 5, 17),
    (3, 8, 2, 64, 16, 3, 33),              # bs smaller than a kernel tile
    (2, 8, 4, 16, 8, 4, 25),
    (2, 4, 4, 16, 5, 7, 31),               # group 1, odd block size
]


def _paged_inputs(shape, seed=2, empty_last=False):
    B, H, Hkv, D, bs, nb, filled = shape
    P = B * nb + 3
    q, kp, vp = _inputs(seed, (B, 1, H, D), (P, bs, Hkv, D), (P, bs, Hkv, D))
    rng = np.random.default_rng(seed)
    table = rng.permutation(P)[:B * nb].reshape(B, nb).astype(np.int32)
    pos = np.full((P, bs), -1, np.int32)
    for b in range(B - 1 if empty_last else B):
        for j in range(filled):
            pos[table[b, j // bs], j % bs] = j
    q_pos = np.full((B,), filled - 1, np.int32)
    return q, kp, vp, pos, table, q_pos


@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_paged_decode_attention_plain_matches_oracle(shape):
    args = _paged_inputs(shape)
    jargs = list(map(jnp.asarray, args))
    ref = jref.paged_decode_attention_ref(*jargs)
    close(paged_decode_attention_ref(*_t(*args)), ref, TOL)
    close(da_ops.paged_decode_attention(*_t(*args)), ref, TOL)
    kv_len = shape[-1] + 2
    close(paged_decode_attention_ref(*_t(*args), kv_len=kv_len),
          jref.paged_decode_attention_ref(*jargs, kv_len=kv_len), TOL)
    # the table-indexed TPU kernel, in interpret mode
    close(paged_decode_attention_ref(*_t(*args)),
          paged_decode_attention_pallas(*jargs), TOL)


def test_paged_decode_attention_empty_row_is_zero_like_the_tpu_kernel():
    args = _paged_inputs((3, 4, 2, 16, 4, 4, 13), empty_last=True)
    out = da_ops.paged_decode_attention(*_t(*args))
    assert torch.all(out[-1] == 0)
    close(out, paged_decode_attention_pallas(*map(jnp.asarray, args)), TOL)


def test_paged_plain_version_reads_out_of_range_blocks_as_empty():
    """As the CUDA kernel does: an entry outside [0, P) is a block whose
    slots are all empty, never an index that wraps or raises."""
    q, kp, vp, pos, table, q_pos = _paged_inputs((3, 4, 2, 16, 4, 4, 13))
    P = pos.shape[0]
    empty = int(np.setdiff1d(np.arange(P), table)[0])   # a block with no token
    bad, want = table.copy(), table.copy()
    bad[1] = [P, -1, 2 ** 30, P + 7]
    want[1] = empty
    bad[2, 3] = -5                           # the block with the last token
    want[2, 3] = empty
    out = da_ops.paged_decode_attention(*_t(q, kp, vp, pos, bad, q_pos))
    assert torch.all(out[1] == 0)
    close(out, paged_decode_attention_ref(*_t(q, kp, vp, pos, want, q_pos)),
          TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_versions_keep_the_input_dtype(dtype):
    q, k, v = _t(*_inputs(3, (1, 9, 4, 8), (1, 9, 2, 8), (1, 9, 2, 8)))
    out = flash_attention_ref(q.to(dtype), k.to(dtype), v.to(dtype))
    assert out.dtype == dtype and out.shape == (1, 9, 4, 8)
    args = _t(*_decode_inputs((2, 16, 4, 2, 8, 9, None)))
    out = decode_attention_ref(args[0].to(dtype), args[1].to(dtype),
                               args[2].to(dtype), args[3], args[4])
    assert out.dtype == dtype and out.shape == (2, 1, 4, 8)


SSD_SHAPES = [
    # (B, L, H, P, N, chunk): tests/test_kernels.py's shapes
    (2, 32, 2, 16, 16, 8),
    (1, 64, 4, 32, 64, 16),
    (2, 24, 3, 8, 16, 8),
]


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_chunk_plain_matches_the_pallas_kernel_and_oracle(shape):
    """Model layout (B, nc, Q, H, ...) against the reference's wrapper (its
    Pallas kernel in interpret mode) and, moved to the TPU kernel's
    (B*H, nc, Q, ...) layout, against its jnp oracle."""
    B, L, H, P, N, chunk = shape
    nc, Q = L // chunk, chunk
    x, dt_raw, a_raw, Bm, Cm = _inputs(11, (B, nc, Q, H, P), (B, nc, Q, H),
                                       (H,), (B, nc, Q, H, N),
                                       (B, nc, Q, H, N))
    dt = np.log1p(np.exp(dt_raw)).astype(np.float32)
    dA = dt * -np.exp(a_raw)
    dAcs = np.cumsum(dA, axis=2, dtype=np.float32)
    args = (x, dt, dA, dAcs, Bm, Cm)
    y, st = ssd_chunk_ref(*_t(*args))
    assert y.shape == (B, nc, Q, H, P) and st.shape == (B, nc, H, P, N)
    jy, jst = jssd_chunk(*map(jnp.asarray, args))
    close(y, jy, TOL)
    close(st, jst, TOL)

    def to_bh(a, width):
        return jnp.moveaxis(jnp.asarray(a), 3, 1).reshape(
            (B * H, nc, Q, width))
    ry, rst = jssd_ref(to_bh(x, P), to_bh(dt[..., None], 1),
                       to_bh(dA[..., None], 1), to_bh(dAcs[..., None], 1),
                       to_bh(Bm, N), to_bh(Cm, N))
    close(y, jnp.moveaxis(ry.reshape(B, H, nc, Q, P), 1, 3), TOL)
    close(st, rst.reshape(B, H, nc, P, N).transpose(0, 2, 1, 3, 4), TOL)
    # the wrapper takes the plain version on CPU tensors, and counts nothing
    n0 = launch_counts()["ssd_scan"]
    for got, ref in zip(ssd_ops.ssd_chunk(*_t(*args)), (y, st)):
        assert torch.equal(got, ref)
    assert launch_counts()["ssd_scan"] == n0
