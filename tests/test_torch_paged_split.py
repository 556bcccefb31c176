"""The paged decode kernel's split of the logical slot axis, on the CPU: the
planner (`plan_splits` over the nb * bs slots of a block-table row) at the
paged serves' shapes, and the per-split, per-warp partials and their merge
with P as a bf16 high plus low part (`paged_decode_attention_split_ref`,
the kernel's arithmetic in plain torch) against the reference's Pallas
kernel in interpret mode and its jnp oracle, f32 at 1e-5."""
import numpy as np
import pytest

from _torch_parity import close, jnp, torch

from repro.kernels.decode_attention.decode_attention import \
    paged_decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import \
    paged_decode_attention_ref as j_paged_ref  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    paged_decode_attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention.split import (  # noqa: E402
    MAX_SPLITS, TILE, paged_decode_attention_split_ref, plan_splits)
from repro_torch.serving.backend import (  # noqa: E402
    BlockAllocator, build_paged_layout)

TOL = 1e-5
#: the card the planner runs on: an H100 SXM's SMs, and the paged kernel's
#: occupancy there (128 registers a thread: four blocks an SM) at chatglm3-6b's
#: and granite's head dims, as the wrapper reads them from the card
N_SM, BLOCKS_PER_SM = 132, 4
#: (name, B, Hkv, group, bs, prompt, new tokens, samples): the paged serves
#: that reach the kernel (chatglm3-6b, granite-moe-3b-a800m: 8 prompts x 4
#: samples, prompt 256, 32 new tokens, blocks of 16) and `chip_smoke.py`'s
#: long case (32 sequences of 2048 slots)
SERVES = [("chatglm", 32, 2, 16, 16, 256, 32, 4),
          ("granite", 32, 8, 3, 16, 256, 32, 4),
          ("nb128", 32, 2, 16, 16, 2040, 9, 1)]


def _decode_table(bs, plen, max_new, samples, n_req):
    alloc = BlockAllocator(10 ** 6, bs)
    lay = build_paged_layout(alloc, plen, max_new, [samples] * n_req)
    return np.asarray(lay.decode_table, np.int32), lay.n_pool_blocks


@pytest.mark.parametrize("serve", SERVES, ids=[s[0] for s in SERVES])
def test_paged_plan_covers_every_slot_once_in_one_wave(serve):
    """At every table width up to the serve's: each logical slot falls in
    exactly one split, no split is empty of slots, and every block of the
    launch is resident at once."""
    _, B, Hkv, g, bs, plen, new, k = serve
    table, _ = _decode_table(bs, plen, new, k, B // k)
    assert table.shape[0] == B
    for nb in range(1, table.shape[1] + 1):
        W = nb * bs
        n_split, slots, n_hb = plan_splits(B, Hkv, W, g, N_SM,
                                           BLOCKS_PER_SM)
        assert slots % TILE == 0 and 1 <= n_split <= MAX_SPLITS
        cover = np.zeros(W, np.int64)
        for s in range(n_split):
            lo, hi = s * slots, min(W, (s + 1) * slots)
            assert hi > lo, (nb, s)
            cover[lo:hi] += 1
        assert (cover == 1).all(), nb
        assert B * Hkv * n_hb * n_split <= N_SM * BLOCKS_PER_SM


def test_paged_plan_at_the_serve_shapes():
    """chatglm's paged decode (18 blocks of 16 slots, 64 (sequence, kv
    head) pairs) takes 5 splits of two tiles, granite's (256 pairs) 2 of
    five, the 128-block case 8 of eight."""
    card = (N_SM, BLOCKS_PER_SM)
    want = {"chatglm": (5, 64, 1), "granite": (2, 160, 1),
            "nb128": (8, 256, 1)}
    for name, B, Hkv, g, bs, plen, new, k in SERVES:
        table, _ = _decode_table(bs, plen, new, k, B // k)
        W = table.shape[1] * bs
        assert plan_splits(B, Hkv, W, g, *card) == want[name], name


def _pools(P, bs, H, Hkv, D, Dv, B, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, bs, Hkv, Dv)).astype(np.float32)
    return q, kp, vp


def _fill(table, P, bs, filled):
    """Positions 0 .. filled[b]-1 in the blocks of row b, in table order."""
    pos = np.full((P, bs), -1, np.int32)
    for b, n in enumerate(filled):
        for j in range(n):
            pos[table[b, j // bs], j % bs] = j
    return pos


def _split(arrays, n_split, slots, split_p):
    t = [torch.from_numpy(np.asarray(a)) for a in arrays]
    return paged_decode_attention_split_ref(*t, n_split=n_split,
                                            split_slots=slots,
                                            split_p=split_p)


def _check_reference(arrays, n_split, slots, rows=slice(None)):
    """The split version (P split into bf16 parts, and in f32) against the
    port's plain version, the Pallas kernel in interpret mode and the jnp
    oracle, on the rows that have a valid slot (the oracle gives mean V on
    the others)."""
    plain = paged_decode_attention_ref(
        *[torch.from_numpy(np.asarray(a)) for a in arrays])
    pallas = paged_decode_attention_pallas(*map(jnp.asarray, arrays))
    oracle = j_paged_ref(*map(jnp.asarray, arrays))
    for split_p in (True, False):
        out = _split(arrays, n_split, slots, split_p)
        close(out, plain, TOL)
        close(out, pallas, TOL)
        close(out[rows], np.asarray(oracle)[rows], TOL)
    return out


@pytest.mark.parametrize("case", [
    # (B, H, Hkv, D, Dv, bs, nb, filled)
    (3, 8, 2, 16, 16, 4, 12, 40),     # bs < 32: a tile spans 8 blocks
    (2, 4, 1, 32, 16, 16, 5, 70),     # Dv != D, ragged last tile
    (4, 6, 2, 16, 16, 8, 9, 50),      # group 3: padded mma rows
])
def test_split_matches_the_interpret_kernel_and_the_oracle(case):
    B, H, Hkv, D, Dv, bs, nb, filled = case
    P = B * nb + 2
    q, kp, vp = _pools(P, bs, H, Hkv, D, Dv, B, 0)
    rng = np.random.default_rng(1)
    table = rng.permutation(P)[:B * nb].reshape(B, nb).astype(np.int32)
    pos = _fill(table, P, bs, [filled] * B)
    q_pos = np.full((B,), filled - 1, np.int32)
    n_split, slots, _ = plan_splits(B, Hkv, nb * bs, H // Hkv, N_SM,
                                    BLOCKS_PER_SM)
    assert n_split > 1
    for ns, sl in ((n_split, slots), (1, -(-nb * bs // TILE) * TILE)):
        _check_reference((q, kp, vp, pos, table, q_pos), ns, sl)


@pytest.mark.parametrize("n_split,slots", [(2, 32), (4, 32), (3, 64)])
def test_splits_that_hold_only_empty_blocks(n_split, slots):
    """Rows filled to 20 of 128 slots: every split past the first holds
    blocks with no token (NEG_INF, 0, 0), and the merge ignores them."""
    B, H, Hkv, D, bs, nb = 3, 8, 2, 16, 8, 16
    P = B * nb
    q, kp, vp = _pools(P, bs, H, Hkv, D, D, B, 2)
    table = np.arange(P, dtype=np.int32).reshape(B, nb)
    pos = _fill(table, P, bs, [20, 7, 1])
    q_pos = np.array([19, 6, 0], np.int32)
    W = n_split * slots
    args = (q, kp, vp, pos, table[:, :W // bs], q_pos)
    out = _check_reference(args, n_split, slots)
    assert torch.isfinite(out).all()


def test_splits_that_hold_only_out_of_range_blocks():
    """Table entries outside [0, P) read as empty blocks: the splits that
    hold only such entries contribute nothing, as in the port's plain
    version, and the rows equal those of a table that names unfilled
    blocks there."""
    B, H, Hkv, D, bs, nb = 3, 8, 2, 16, 4, 24
    P = B * nb
    q, kp, vp = _pools(P, bs, H, Hkv, D, D, B, 3)
    table = np.arange(P, dtype=np.int32).reshape(B, nb)
    pos = _fill(table, P, bs, [30, 30, 30])
    bad = table.copy()
    bad[:, 8:] = -1                      # slots 32.. : splits 2.. of 32
    bad[1, 12:] = P + 5
    bad[2, 9] = 2 ** 30
    q_pos = np.full((B,), 29, np.int32)
    t = [torch.from_numpy(a) for a in (q, kp, vp, pos, bad, q_pos)]
    plain = paged_decode_attention_ref(*t)
    for split_p in (True, False):
        out = paged_decode_attention_split_ref(*t, n_split=3,
                                               split_slots=32,
                                               split_p=split_p)
        close(out, plain, TOL)
        # the good table over the same filled blocks gives the same rows
        good = _split((q, kp, vp, pos, table, q_pos), 3, 32, split_p)
        close(out, good, TOL)


def test_a_row_with_every_slot_empty_is_exactly_zero():
    """Fault F3: every split of the last row holds no valid slot (blocks
    with no token, a future position, and a table entry past the pool);
    its output is 0 exactly, as the Pallas kernel gives (the jnp oracle
    gives mean V)."""
    B, H, Hkv, D, bs, nb = 3, 8, 2, 16, 8, 10
    P = B * nb
    q, kp, vp = _pools(P, bs, H, Hkv, D, D, B, 4)
    table = np.arange(P, dtype=np.int32).reshape(B, nb)
    pos = _fill(table, P, bs, [50, 50, 0])
    pos[table[2, 0], 0] = 70              # a position after q_pos
    q_pos = np.full((B,), 49, np.int32)
    args = (q, kp, vp, pos, table, q_pos)
    n_split, slots, _ = plan_splits(B, Hkv, nb * bs, H // Hkv, N_SM,
                                    BLOCKS_PER_SM)
    out = _check_reference(args, n_split, slots, rows=slice(0, 2))
    assert torch.all(out[2] == 0) and torch.all(out[:2] != 0)
    table[2, 3] = P + 1
    out = _split((q, kp, vp, pos, table, q_pos), n_split, slots, True)
    assert torch.all(out[2] == 0)


@pytest.mark.parametrize("step", [0, 5, 17])
def test_split_over_the_backends_tables_with_shared_prefix_blocks(step):
    """Tables from the port's own `build_paged_layout`: 2 prompts of 37
    tokens, k = 4 samples each, blocks of 8: the prompt's full blocks are
    shared by the 4 rows, its partial block copied for each, then decode
    blocks of each row's own; filled up to position 37 + step - 1."""
    bs, plen, new, k, n_req = 8, 37, 24, 4, 2
    table, P = _decode_table(bs, plen, new, k, n_req)
    B, nb = table.shape
    assert B == k * n_req
    shared = table[0, 0]
    assert (table[:k, 0] == shared).all()     # the prefix's first block
    H, Hkv, D = 8, 2, 16
    q, kp, vp = _pools(P, bs, H, Hkv, D, D, B, 5)
    last = plen + step - 1
    pos = np.full((P, bs), -1, np.int32)
    for b in range(B):
        for j in range(last + 1):
            pos[table[b, j // bs], j % bs] = j
    q_pos = np.full((B,), last, np.int32)
    n_split, slots, _ = plan_splits(B, Hkv, nb * bs, H // Hkv, N_SM,
                                    BLOCKS_PER_SM)
    _check_reference((q, kp, vp, pos, table, q_pos), n_split, slots)


def test_split_refuses_ranges_that_miss_slots():
    q, kp, vp = _pools(5, 8, 4, 2, 16, 16, 1, 6)
    table = np.arange(5, dtype=np.int32)[None]      # 40 slots
    pos = _fill(table, 5, 8, [10])
    t = [torch.from_numpy(a) for a in (q, kp, vp, pos, table,
                                       np.array([9], np.int32))]
    with pytest.raises(ValueError, match="do not cover"):
        paged_decode_attention_split_ref(*t, n_split=1, split_slots=TILE)
    with pytest.raises(ValueError, match="whole"):
        paged_decode_attention_split_ref(*t, n_split=2, split_slots=16)
