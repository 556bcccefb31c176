"""The dense decode kernel's split of the slot axis, on the CPU: the planner
that cuts W slots into ranges (`plan_splits`), and the per-split partials
and their merge (`decode_attention_split_ref`, the kernel's arithmetic in
plain torch) against the plain decode (`decode_attention_ref`) and the
reference's Pallas kernel in interpret mode, f32 at 1e-5."""
import numpy as np
import pytest

from _torch_parity import close, jnp, torch

from repro.kernels.decode_attention.decode_attention import \
    decode_attention_pallas  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention.split import (  # noqa: E402
    HEADS_PER_BLOCK, MAX_SPLITS, TILE, decode_attention_split_ref,
    plan_splits)

TOL = 1e-5
#: the card the planner runs on: an H100 SXM's SMs, and the dense kernel's
#: occupancy there at chatglm3-6b's decode (g = 16, bf16, D = 128), as the
#: wrapper reads them from the card
N_SM, BLOCKS_PER_SM = 132, 3
#: (B, Hkv, group) of the serves that reach the dense kernel: chatglm3-6b,
#: granite-moe-3b-a800m, jamba-v0.1-52b, and a few small and odd ones
SERVES = [(32, 2, 16), (32, 8, 3), (32, 8, 4), (1, 1, 1), (5, 2, 16),
          (2, 1, 40), (132, 4, 8)]


@pytest.mark.parametrize("serve", SERVES)
def test_plan_covers_every_slot_once_and_leaves_no_split_empty(serve):
    B, Hkv, g = serve
    seen = set()
    for W in range(1, 2049):
        n_split, slots, n_hb = plan_splits(B, Hkv, W, g, N_SM, BLOCKS_PER_SM)
        assert n_hb == -(-g // HEADS_PER_BLOCK)
        assert slots % TILE == 0 and slots >= TILE
        assert 1 <= n_split <= MAX_SPLITS
        cover = np.zeros(W, np.int64)
        for s in range(n_split):
            lo, hi = s * slots, min(W, (s + 1) * slots)
            assert hi > lo, (W, s, n_split, slots)
            cover[lo:hi] += 1
        assert (cover == 1).all(), W
        seen.add(n_split)
    # more than one split exactly where the one-wave budget allows it
    budget = N_SM * BLOCKS_PER_SM // (B * Hkv * n_hb)
    assert (max(seen) > 1) == (budget > 1)


def test_plan_fills_the_card_in_one_wave_at_the_serve_shapes():
    """As many splits as keep every block in one wave (132 SMs x 3 blocks):
    chatglm's decode (32 x 2 kv heads) takes 5 splits of 64 slots at W =
    288 (six would need splits of 1.5 tiles), granite's (32 x 8) one,
    which merges nothing; at 2 blocks an SM chatglm takes 3 of 96."""
    card = (N_SM, BLOCKS_PER_SM)
    assert plan_splits(32, 2, 288, 16, *card) == (5, 64, 1)
    assert plan_splits(32, 8, 288, 3, *card) == (1, 288, 1)
    assert plan_splits(32, 2, 2048, 16, *card) == (6, 352, 1)
    assert plan_splits(32, 2, 288, 16, N_SM, 2) == (3, 96, 1)
    assert plan_splits(32, 2, 288, 16, N_SM, 0) == (1, 288, 1)
    assert plan_splits(32, 2, 20, 16, *card) == (1, 32, 1)
    assert plan_splits(2, 1, 40, 40, *card) == (2, 32, 3)
    assert plan_splits(1, 1, 0, 1, *card) == (1, 32, 1)
    assert plan_splits(1, 1, 2048, 8, *card) == (32, 64, 1)  # at most 32


def _inputs(B, W, H, Hkv, D, Dv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, W, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, W, Hkv, Dv)).astype(np.float32)
    return q, kc, vc


def _check(q, kc, vc, pos, q_pos, window, n_split=None, slots=None):
    B, _, H, _ = q.shape
    _, W, Hkv, _ = kc.shape
    if n_split is None:
        n_split, slots, _ = plan_splits(B, Hkv, W, H // Hkv, N_SM,
                                        BLOCKS_PER_SM)
    t = [torch.from_numpy(np.asarray(a)) for a in (q, kc, vc, pos, q_pos)]
    out = decode_attention_split_ref(*t, n_split=n_split, split_slots=slots,
                                     window=window)
    close(out, decode_attention_ref(*t, window=window), TOL)
    tpu = decode_attention_pallas(*map(jnp.asarray, (q, kc, vc, pos, q_pos)),
                                  window=window, block_k=16)
    close(out, tpu, TOL)
    return out


@pytest.mark.parametrize("filled", [1, 31, 40, 100, 160])
def test_merge_with_splits_that_hold_no_valid_slot(filled):
    """Ranges past the fill level contribute (NEG_INF, 0, 0) to the merge."""
    B, W, H, Hkv, D = 3, 160, 8, 2, 16
    q, kc, vc = _inputs(B, W, H, Hkv, D, D, 0)
    pos = np.full((B, W), -1, np.int32)
    pos[:, :filled] = np.arange(filled)
    q_pos = np.full((B,), filled - 1, np.int32)
    n_split, slots, _ = plan_splits(B, Hkv, W, H // Hkv, N_SM,
                                    BLOCKS_PER_SM)
    assert n_split == 5 and slots == 32
    _check(q, kc, vc, pos, q_pos, None)


@pytest.mark.parametrize("n_split,slots", [(1, 64), (2, 32), (3, 32),
                                           (5, 32)])
def test_merge_of_a_windowed_ring_whose_valid_slots_lie_in_one_split(
        n_split, slots):
    """A ring that has wrapped: slots hold out-of-order positions, and the
    window keeps only slots 32..47, which one split (or the one range)
    holds."""
    B, W, H, Hkv, D, Dv = 2, 140, 4, 2, 32, 16
    if n_split * slots < W:
        W = n_split * slots
    q, kc, vc = _inputs(B, W, H, Hkv, D, Dv, 1)
    q_pos = np.full((B,), 1000, np.int32)
    pos = np.arange(W, dtype=np.int32)[None].repeat(B, 0) + 100
    pos[:, 32:48] = 1000 - np.arange(16)         # the window's 16 positions
    out = _check(q, kc, vc, pos, q_pos, 16, n_split, slots)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("window", [None, 7])
def test_merge_of_a_row_with_every_slot_empty_is_exactly_zero(window):
    """Fault F3: every split of the row is empty, and the merge gives 0
    exactly, as the Pallas kernel does (the jnp oracle gives mean V)."""
    B, W, H, Hkv, D = 3, 100, 8, 2, 16
    q, kc, vc = _inputs(B, W, H, Hkv, D, D, 2)
    pos = np.full((B, W), -1, np.int32)
    pos[0, :60] = np.arange(60)
    pos[2] = np.arange(W) + 500                 # every slot in the future
    q_pos = np.full((B,), 59, np.int32)
    out = _check(q, kc, vc, pos, q_pos, window)
    assert torch.all(out[1:] == 0)
    assert torch.all(out[0] != 0)


@pytest.mark.parametrize("shape", [(32, 288, 32, 2, 32), (32, 288, 24, 8, 16),
                                   (4, 1001, 8, 2, 16)])
def test_merge_at_the_serve_splits(shape):
    """The planner's own splits at chatglm's and granite's decode batch
    (narrow head dims) and at a ragged W."""
    B, W, H, Hkv, D = shape
    q, kc, vc = _inputs(B, W, H, Hkv, D, D, 3)
    pos = np.full((B, W), -1, np.int32)
    filled = W - 16
    pos[:, :filled] = np.arange(filled)
    q_pos = np.full((B,), filled - 1, np.int32)
    _check(q, kc, vc, pos, q_pos, None)
