"""The paged decode kernel's split of the logical slot axis, on the CPU: the
planner (`plan_splits` over the nb * bs slots of a block-table row) at the
paged serves' shapes, and the per-split, per-warp partials and their merge
with P as a bf16 high plus low part (`paged_decode_attention_split_ref`,
the kernel's arithmetic in plain torch) against the reference's Pallas
kernel in interpret mode and its jnp oracle, f32 at 1e-5. The grouped path
likewise: the group descriptor `build_paged_layout` returns, the prefix
planner at the bench cells' shapes, and the prefix and tail partials and
their merge (`paged_decode_attention_grouped_ref`)."""
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
    MAX_SPLITS, TILE, group_prefix_splits, grouped_ranges, groups_engage,
    groups_taken, min_prefix_slots, min_shared_blocks,
    paged_decode_attention_grouped_ref,
    paged_decode_attention_split_ref, plan_prefix, plan_splits,
    prefix_groups, prefix_split_count, row_tiles)
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


# ------------------------------------------------------------ grouped path

#: the bench cells' paged decode batches (name, B, Hkv, group, bs, prompt,
#: new tokens, samples): 8 requests x k = 20 (poisson also forms batches of
#: one request), with the (row tile, kv head) pairs and the prefix splits a
#: pair takes in a one-wave grid of four prefix blocks an SM (a 128-token
#: prompt has 4 tiles); 0 pairs where the planner groups no row
CELLS = [("chatglm3-6b.backlog", 160, 2, 16, 16, 128, 256, 20, 0, 0),
         ("granite-moe-3b-a800m.backlog", 160, 8, 3, 16, 128, 256, 20,
          64, 4),
         ("chatglm3-6b.poisson", 20, 2, 16, 16, 128, 256, 20, 0, 0),
         ("granite-moe-3b-a800m.longdoc", 160, 8, 3, 16, 3840, 256, 20,
          64, 8)]


def _layout(bs, plen, max_new, repeats, hit_chains=None, alloc=None):
    alloc = alloc or BlockAllocator(10 ** 6, bs)
    return build_paged_layout(alloc, plen, max_new, repeats,
                              hit_chains=hit_chains)


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_grouped_plan_at_the_cells_shapes(cell):
    """Every cell's descriptor groups each request's rows over its prompt
    blocks. Where the planner takes the groups (granite's: 21 rows a row
    tile from a 4-tile prompt on; not chatglm3-6b's 128-token prompts, at
    four rows a tile, nor a batch of one request's 20 rows x 2 kv heads),
    each row's tail and prefix ranges cover its logical slots exactly once,
    with at most `MAX_SPLITS` partials a row, and the prefix splits fill
    the one-wave grid (longdoc: 8 groups x 8 kv heads, 8 splits of 15
    tiles). Without groups every row walks its table as `plan_splits`
    cuts it."""
    _, B, Hkv, g, bs, plen, new, k, pairs, n_ps = cell
    lay = _layout(bs, plen, new, [k] * (B // k))
    table = lay.decode_table
    nb = table.shape[1]
    assert (lay.prefix_groups[:, 1] == plen // bs).all()
    engaged = groups_engage(g, nb * bs, B * Hkv)
    assert engaged == (g == 3)
    groups = groups_taken(lay.prefix_groups,
                          min_shared_blocks(g, bs) if engaged else nb + 1)
    assert (groups[:, 1] == (plen // bs if pairs else 0)).all()
    n_split, slots, _ = plan_splits(B, Hkv, nb * bs, g, N_SM, BLOCKS_PER_SM)
    grid, p_cap = plan_prefix(n_split, N_SM, BLOCKS_PER_SM)
    tiles = row_tiles(groups, g)
    assert len(tiles) * Hkv == pairs
    assert sum(n for _, n in tiles) == (B if pairs else 0)
    splits, per = group_prefix_splits(
        prefix_split_count(len(tiles), Hkv, grid, p_cap),
        plen if pairs else 0)
    assert splits == n_ps
    for ranges in grouped_ranges(groups, g, Hkv, nb, bs, n_split, slots,
                                 grid, p_cap):
        assert len(ranges) <= MAX_SPLITS
        cover = np.zeros(nb * bs, np.int64)
        for lo, hi in ranges:
            cover[lo:hi] += 1
        assert (cover == 1).all()
    if not pairs:
        assert grouped_ranges(groups, g, Hkv, nb, bs, n_split, slots, grid,
                              p_cap)[0] == \
            [(s * slots, min(nb * bs, (s + 1) * slots))
             for s in range(n_split)]
    if plen == 3840:
        assert per == 15


@pytest.mark.parametrize("plen", [37, 40])
def test_descriptor_matches_the_tables_shared_blocks(plen):
    """Each row's group is its request's rows, which share exactly the
    prompt's full blocks at the head of their tables (a partial last
    block is each row's own copy); one-row requests and prompts with no
    full block form no group. On the resident pool the hit chain and the
    newly shared blocks make the group's prefix alike."""
    bs = 8
    for repeats in ([4, 1, 3], [20], [1, 1]):
        lay = _layout(bs, plen, 24, repeats)
        t, grp = lay.decode_table, lay.prefix_groups
        row = 0
        for k in repeats:
            rows = range(row, row + k)
            shared = plen // bs if k > 1 else 0
            assert grp[row:row + k].tolist() == \
                [[row if k > 1 else r, shared] for r in rows]
            if k > 1:
                assert (t[rows.start:rows.stop, :shared]
                        == t[row, :shared]).all()
                # past the shared blocks every row's table is its own
                nxt = t[rows.start:rows.stop, shared]
                assert len(set(nxt.tolist())) == k
            row += k
    short = _layout(8, 20, 24, [4]).prefix_groups      # 2 blocks: 16 slots
    assert short.tolist() == [[0, 2]] * 4
    none = _layout(8, 7, 24, [4]).prefix_groups        # no full block
    assert (none[:, 1] == 0).all() and (none[:, 0] == np.arange(4)).all()
    # the resident pool: a cached chain of 3 blocks heads the prompt's
    alloc = BlockAllocator(200, bs)
    chain = [alloc.alloc() for _ in range(3)]
    for g_ in chain:
        for _ in range(3):
            alloc.fork(g_)
    lay = _layout(bs, plen, 24, [4], hit_chains=[chain], alloc=alloc)
    assert (lay.prefix_groups == [[0, plen // bs]] * 4).all()
    assert (lay.decode_table[:, :3] == chain).all()
    assert (lay.decode_table[:, :plen // bs]
            == lay.decode_table[0, :plen // bs]).all()


def test_planner_groups_where_a_row_tile_saves_enough_reads():
    """The shortest prefix grouped: 4 tiles at granite's 21 rows a row
    tile, 16 at chatglm3-6b's 4, none past 32 query heads a kv head; and no
    grouped path in a batch of fewer than 128 (row, kv head) pairs, or
    beside a table no longer than the shortest prefix. The kernels take a
    group of fewer blocks as none."""
    assert [min_prefix_slots(g) for g in (1, 3, 16, 32, 33)] == \
        [32, 128, 512, 1024, None]
    assert [min_shared_blocks(g, 16) for g in (1, 3, 16)] == [2, 8, 32]
    assert not groups_engage(16, 1024, 40)               # one request
    assert groups_engage(16, 1024, 160)                  # four requests
    assert not groups_engage(16, 512, 160) and groups_engage(16, 528, 160)
    assert groups_engage(3, 384, 1280) and not groups_engage(40, 4096, 1280)
    four = groups_taken(prefix_groups([20] * 4, 64), 32)
    short = groups_taken(prefix_groups([20] * 8, 8), 32)   # 128 slots
    assert (four[:, 1] == 64).all() and (four[:, 0] == np.repeat(
        np.arange(0, 80, 20), 20)).all()
    assert (short[:, 1] == 0).all() and (short[:, 0] == np.arange(160)).all()


def _grouped_case(repeats, plen, new, step, bs=8, H=6, Hkv=2, D=16, seed=7,
                  hit_chains=None, alloc=None):
    """q, pools, positions, table, q_pos and descriptor of a batch laid out
    by `build_paged_layout`, every row filled to position plen + step - 1."""
    lay = _layout(bs, plen, new, repeats, hit_chains, alloc)
    table = np.asarray(lay.decode_table, np.int32)
    B, nb = table.shape
    P = max(lay.n_pool_blocks, int(table.max()) + 1)
    q, kp, vp = _pools(P, bs, H, Hkv, D, D, B, seed)
    last = plen + step - 1
    pos = _fill(table, P, bs, [last + 1] * B)
    q_pos = np.full((B,), last, np.int32)
    return [q, kp, vp, pos, table, q_pos], lay.prefix_groups


def _check_grouped(arrays, groups, grid=None, rows=slice(None)):
    """The grouped model (P split into bf16 parts, and in f32) against the
    port's plain version, the Pallas kernel in interpret mode, the jnp
    oracle (on the rows with a valid slot) and the per-row split model,
    f32 at 1e-5; with the cells' one-wave grid and with a grid of a few
    blocks (one prefix split a pair); and with groups shorter than the
    kernels take (``min_shared``), the per-row split model's whole rows."""
    q, kp, vp, pos, table, q_pos = arrays
    B, nb = table.shape
    H, Hkv = q.shape[2], kp.shape[2]
    bs = kp.shape[1]
    n_split, slots, _ = plan_splits(B, Hkv, nb * bs, H // Hkv, N_SM,
                                    BLOCKS_PER_SM)
    wave, p_cap = plan_prefix(n_split, N_SM, BLOCKS_PER_SM)
    t = [torch.from_numpy(np.asarray(a)) for a in arrays]
    plain = paged_decode_attention_ref(*t)
    pallas = paged_decode_attention_pallas(*map(jnp.asarray, arrays))
    oracle = np.asarray(j_paged_ref(*map(jnp.asarray, arrays)))
    for grid_ in (grid or wave, 3):
        for split_p in (True, False):
            out = paged_decode_attention_grouped_ref(
                *t, torch.from_numpy(groups), n_split=n_split,
                split_slots=slots, grid=grid_, p_cap=p_cap, split_p=split_p)
            close(out, plain, TOL)
            close(out, pallas, TOL)
            close(out[rows], oracle[rows], TOL)
            close(out, _split(arrays, n_split, slots, split_p), TOL)
    whole = paged_decode_attention_grouped_ref(
        *t, torch.from_numpy(groups), n_split=n_split, split_slots=slots,
        grid=wave, p_cap=p_cap, min_shared=nb + 1)
    close(whole, _split(arrays, n_split, slots, True), TOL)
    return out


@pytest.mark.parametrize("repeats,plen,step", [
    ([1, 1, 1], 40, 3),           # k = 1: no group, whole rows
    ([4, 4], 40, 9),              # k = 4, the prompt in whole blocks
    ([4, 3], 37, 1),              # a CoW partial block: the tail's first
    ([20], 37, 14),               # k = 20: 7 rows a row tile at group 3
    ([4, 1, 20], 64, 30),         # mixed: a one-row request among groups
])
def test_grouped_matches_the_interpret_kernel_and_the_oracle(repeats, plen,
                                                              step):
    arrays, groups = _grouped_case(repeats, plen, 40, step)
    assert (groups[:, 1] > 0).any() == any(k > 1 for k in repeats)
    _check_grouped(arrays, groups)


def test_grouped_at_sixteen_heads_a_kv_head():
    """chatglm3-6b's group of 16: four rows a tile, a group of 20 in five
    tiles."""
    arrays, groups = _grouped_case([20, 2], 70, 40, 5, H=32, Hkv=2)
    assert len(row_tiles(groups, 16)) == 6
    _check_grouped(arrays, groups)


def test_grouped_over_pooled_hit_chains():
    """On the resident pool: global block ids into a pool larger than the
    batch, a cached chain heading the prompt's shared blocks."""
    bs = 8
    alloc = BlockAllocator(120, bs)
    for _ in range(9):                  # ids in use by others
        alloc.alloc()
    chain = [alloc.alloc() for _ in range(2)]
    for g_ in chain:
        for _ in range(4):
            alloc.fork(g_)
    arrays, groups = _grouped_case([5], 45, 30, 6, hit_chains=[chain],
                                   alloc=alloc)
    assert (arrays[4][:, :2] == chain).all() and groups[0, 1] == 5
    _check_grouped(arrays, groups)


def test_grouped_rows_with_every_slot_empty_are_exactly_zero():
    """Fault F3 on the grouped path: a row of a group whose position sees
    no slot (q_pos -1), and a group whose prompt blocks hold no token: the
    prefix and tail partials are all empty and the rows come out 0
    exactly, the other rows of their tiles unchanged."""
    arrays, groups = _grouped_case([4, 4], 40, 24, 4)
    q, kp, vp, pos, table, q_pos = arrays
    q_pos[1] = -1
    for b in range(4, 8):               # the second group: nothing filled
        for j in range(table.shape[1]):
            pos[table[b, j]] = -1
    out = _check_grouped(arrays, groups, rows=[0, 2, 3])
    assert torch.all(out[1] == 0) and torch.all(out[4:] == 0)
    assert torch.all(out[[0, 2, 3]] != 0)


def test_grouped_reads_out_of_range_entries_as_empty():
    """Table entries outside [0, P), in a group's shared blocks (every row
    of the group alike) and in the rows' tails: empty blocks, as in the
    port's plain version and the Pallas kernel."""
    arrays, groups = _grouped_case([4, 4], 48, 24, 10)
    table, P = arrays[4], arrays[1].shape[0]
    table[0:4, 1] = P + 3
    table[4:8, 0] = -1
    table[2, 7] = 2 ** 30
    table[5, 6] = -7
    _check_grouped(arrays, groups)
