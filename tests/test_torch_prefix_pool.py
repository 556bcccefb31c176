"""The port's resident prefix pool, pooled backend, chunked prefill and
``park_batch`` on the CPU, against the reference on the same converted
weights (f32): the 2-layer fixture and reduced chatglm3-6b.

* the trie (`PrefixPool` over `BlockAllocator`) held exactly to the
  reference's on the same operation sequences;
* pooled serving against the reference's pooled mode, greedy and sampled
  (the reference's Gumbel noise injected), cold and warm, with a
  copy-on-write tail (prompt length 7 over blocks of 4) and repeats
  ``[2, 1]``: tokens equal, logprobs within 1e-4 (as
  tests/test_torch_serving.py holds the paged path);
* pooled against per-batch paged and chunked against one-shot inside the
  port: tokens equal, logprobs within 1e-5 (the tail prefill sums over
  other shapes than a one-shot prefill; F1 in ROADMAP.md);
* hit, byte, capacity and marginal-cost accounting, eviction and its
  refusals, the pool metrics, an int8-KV pool and ``park_batch``, equal to
  the reference's;
* F8: a row released early keeps writing its blocks, which a later pooled
  batch may already hold; the port does what the reference does.
"""
import numpy as np
import pytest

from _torch_parity import jax, models, torch
from test_torch_serving import JaxGumbel, _same

from repro.models.cache import prefix_pool_bytes as jpool_bytes  # noqa: E402
from repro.obs import make_observability as jobs  # noqa: E402
from repro.serving import BlockAllocator as JAlloc  # noqa: E402
from repro.serving import ExecutionBackend as JBackend  # noqa: E402
from repro.serving import PrefixPool as JPool  # noqa: E402
from repro_torch.models.cache import \
    prefix_pool_bytes as tpool_bytes  # noqa: E402
from repro_torch.obs import LIFECYCLE  # noqa: E402
from repro_torch.obs import make_observability as tobs  # noqa: E402
from repro_torch.serving import BlockAllocator as TAlloc  # noqa: E402
from repro_torch.serving import ExecutionBackend as TBackend  # noqa: E402
from repro_torch.serving import GumbelNoise  # noqa: E402
from repro_torch.serving import PrefixPool as TPool  # noqa: E402

BS = 4
TOL = 1e-4          # port against the reference
IN_PORT = 1e-5      # pooled vs paged, chunked vs one-shot, inside the port
POOL = dict(kv_blocks=64, kv_block_size=BS, kv_pool=True)


@pytest.fixture(scope="module", params=["fixture", "chatglm3-6b"])
def pair(request):
    return models(request.param, seed=0)


@pytest.fixture(scope="module")
def fixture_pair():
    return models("fixture", seed=0)


def _prompt(n, vocab, mult=1):
    return (np.arange(1, n + 1, dtype=np.int32) * mult) % vocab


def _cow_batches(vocab):
    """Two prompts of 7 tokens sharing their first block of 4: the last
    block is partial, so every repeat copies it (CoW)."""
    shared = _prompt(BS, vocab)
    return [np.concatenate([shared, _prompt(3, vocab, 5)]),
            np.concatenate([shared, _prompt(3, vocab, 7)])]


def _drain(be, h):
    while be.decode_step(h):
        pass
    return be.finalize(h)


def _both(pair, kw, batches, n_samples, max_new, temperature, seed=3):
    """Run ``batches`` one after another through a reference backend and a
    port backend built with ``kw``, each batch on the noise of
    ``jax.random.key(seed)``; returns [(ref results, ref handle, port
    results, port handle)] and the two backends."""
    jm, jp, tm, tp = pair
    jb, tb = JBackend(jm, jp, **kw), TBackend(tm, tp, **kw)
    out = []
    for prompts in batches:
        key = jax.random.key(seed)
        jh = jb.start_batch(prompts, n_samples, max_new, temperature, key)
        th = tb.start_batch(prompts, n_samples, max_new, temperature,
                            JaxGumbel(key))
        out.append((_drain(jb, jh), jh, _drain(tb, th), th))
    return out, jb, tb


def _port_runs(tm, tp, kw, batches, n_samples, max_new, temperature,
               seed=5):
    """The port alone: per-step tokens and logprobs and the results of
    each batch, each on `GumbelNoise` seeded ``seed``."""
    be = TBackend(tm, tp, **kw)
    out = []
    for prompts in batches:
        noise = GumbelNoise(torch.Generator().manual_seed(seed))
        h = be.start_batch(prompts, n_samples, max_new, temperature, noise)
        steps = 0
        while be.decode_step(h):
            steps += 1
        out.append((np.stack(h.out_toks), np.stack(h.out_lps),
                    be.finalize(h), steps))
    return out, be


# ============================================== the trie, against the ref

def _chunked(bits):
    """A prompt of ``len(bits)`` full blocks; chunk i is ``2*i + bits[i]``
    repeated: equal bit prefixes share token prefixes and nothing else."""
    return np.concatenate([np.full(BS, 2 * i + b, np.int32)
                           for i, b in enumerate(bits)])


def _admit(pool, prompt, n_blocks):
    """What a pooled batch does for one holder: pin the cached chain,
    allocate the rest, index it. Returns the holder's block ids, or None
    when the budget does not fit."""
    a = pool.allocator
    chain = pool.acquire(prompt, n_blocks, holders=1)
    need = n_blocks - len(chain)
    pool.ensure_free(need)
    if need > a.blocks_free:
        for g in chain:
            a.free(g)
        return None
    gids = list(chain) + [a.alloc() for _ in range(need)]
    pool.insert(prompt, gids)
    return gids


def _state(pool, prompts):
    a = pool.allocator
    return dict(free=a.blocks_free, used=a.blocks_in_use,
                ref=dict(sorted(a._ref.items())),
                resident=pool.blocks_resident,
                evictable=pool.evictable_blocks, evictions=pool.evictions,
                owners={b: pool.owner_of(b) for b in range(a.n_blocks)},
                lookups=[pool.lookup(p, len(p) // BS, touch=False)
                         for p in prompts])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_trie_follows_the_reference(seed):
    """Random admit / release / evict interleavings (and, for seed 3, the
    ``off`` policy) on both pools: the same block ids, refcounts, residency,
    evictions, owners and lookups after every operation."""
    rng = np.random.default_rng(seed)
    n_blocks = int(rng.integers(3, 13))
    evict = "off" if seed == 3 else "lru"
    pools = [cls_p(cls_a(n_blocks, BS), evict=evict)
             for cls_a, cls_p in ((JAlloc, JPool), (TAlloc, TPool))]
    holders = [[], []]
    seen = []
    for _ in range(40):
        kind = rng.choice(["admit", "admit", "release", "evict"])
        bits = list(rng.integers(0, 2, int(rng.integers(1, 4))))
        arg = int(rng.integers(0, 13))
        prompt = _chunked(bits)
        for pool, held in zip(pools, holders):
            if kind == "admit":
                gids = _admit(pool, prompt, len(bits))
                if gids is not None:
                    held.append(gids)
            elif kind == "release" and held:
                for g in held.pop(arg % len(held)):
                    pool.allocator.free(g)
            elif kind == "evict":
                pool.ensure_free(arg % (n_blocks + 1))
        seen.append(prompt)
        assert holders[0] == holders[1]
        assert _state(pools[1], seen) == _state(pools[0], seen)


def test_trie_refusals_follow_the_reference():
    for cls_a, cls_p in ((JAlloc, JPool), (TAlloc, TPool)):
        a = cls_a(8, BS)
        pool = cls_p(a)
        root, leaf = _admit(pool, _chunked([0, 0]), 2)
        with pytest.raises(RuntimeError, match="live holder"):
            pool.evict(leaf)
        a.free(leaf)
        a.free(root)
        with pytest.raises(RuntimeError, match="orphan"):
            pool.evict(root)
        with pytest.raises(RuntimeError, match=r"trie-resident block \d+ "
                           r"\(owning prefix: depth 2"):
            a.free(leaf)
        assert pool.owner_of(leaf) == a.protected_owner(leaf)
        pool.evict(leaf)
        with pytest.raises(KeyError, match="not resident"):
            pool.evict(leaf)
        with pytest.raises(ValueError, match="eviction policy"):
            cls_p(a, evict="fifo")


# ==================================== pooled serving, against the reference

@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("n_samples", [1, [2, 1]], ids=["k1", "k21"])
def test_pooled_matches_the_reference(pair, temperature, n_samples):
    """Cold (the whole prompt through the tail path, then indexed) and warm
    (one hit block a prompt, the 3-token tail prefilled): the reference's
    tokens, logprobs within 1e-4, and its hit and byte accounting."""
    vocab = pair[0].cfg.vocab_size
    out, jb, tb = _both(pair, POOL, [_cow_batches(vocab)] * 2, n_samples, 4,
                        temperature)
    for jr, jh, tr, th in out:
        _same(jr, tr)
        assert th.pool_hit_blocks == jh.pool_hit_blocks
        assert th.prefill_bytes_saved == jh.prefill_bytes_saved
        assert th.paged.hit_counts == jh.paged.hit_counts
        np.testing.assert_array_equal(th.paged.decode_table,
                                      jh.paged.decode_table)
    assert [o[3].pool_hit_blocks for o in out] == [0, 2]
    assert tb.blocks_in_use == jb.blocks_in_use == \
        tb.prefix_pool.blocks_resident
    assert tb.pool_blocks_resident == jb.pool_blocks_resident == 64


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_pooled_equals_per_batch_paged_inside_the_port(pair, temperature):
    _, _, tm, tp = pair
    batches = [_cow_batches(tm.cfg.vocab_size)] * 2
    paged, _ = _port_runs(tm, tp, dict(kv_blocks=64, kv_block_size=BS),
                          batches, [2, 1], 5, temperature)
    pooled, be = _port_runs(tm, tp, POOL, batches, [2, 1], 5, temperature)
    for (pt, pl, pr, _), (qt, ql, qr, _) in zip(paged, pooled):
        np.testing.assert_array_equal(qt, pt)
        np.testing.assert_allclose(ql, pl, rtol=IN_PORT, atol=IN_PORT)
        _same(pr, qr, IN_PORT)
    assert be.blocks_in_use == be.prefix_pool.blocks_resident == 1


def test_accounting_follows_the_reference(fixture_pair):
    """Hits, prefill bytes saved, `capacity_free`, request and marginal
    costs (cold, pinned by a live batch, idle again) and the pool's byte
    count, step by step."""
    jm, jp, tm, tp = fixture_pair
    kw = dict(kv_blocks=32, kv_block_size=BS, kv_pool=True)
    jb, tb = JBackend(jm, jp, **kw), TBackend(tm, tp, **kw)
    p = _prompt(16, 64)

    def costs():
        return [(be.capacity_free, be.blocks_in_use, be.pool_blocks_resident,
                 be.marginal_request_cost(p, 3, 2),
                 be.request_cost(16, 3, 2, prompt=p),
                 be.request_blocks(16, 3, 2)) for be in (jb, tb)]

    seen = [costs()]
    for _ in range(2):
        key = jax.random.key(0)
        jh = jb.start_batch([p], 2, 3, 0.0, key)
        th = tb.start_batch([p], 2, 3, 0.0, JaxGumbel(key))
        seen.append(costs())          # in flight: the hits are pinned
        _same(_drain(jb, jh), _drain(tb, th))
        assert (th.pool_hit_blocks, th.prefill_bytes_saved) == \
            (jh.pool_hit_blocks, jh.prefill_bytes_saved)
        seen.append(costs())
    for ref, port in seen:
        assert port == ref
    # warm: (16 - 1) // 4 = 3 of the 4 full blocks hit
    assert th.pool_hit_blocks == 3
    assert th.prefill_bytes_saved == (2 * 16 - 4) * tb.kv_token_bytes
    n = tb.prefix_pool.blocks_resident
    assert tpool_bytes(tm.cfg, n, BS, 4) == jpool_bytes(jm.cfg, n, BS, 4)


def test_eviction_and_refusals_follow_the_reference(fixture_pair):
    """LRU eviction under pressure, a start refused (and unwound) while
    live refs pin every chain, ``pool_evict="off"`` refusing when full,
    and the constructor's ValueErrors: the reference's, each."""
    jm, jp, tm, tp = fixture_pair
    pa, pb = _prompt(8, 64), _prompt(8, 64, 3)
    res = []
    for be_cls, m, p, noise in ((JBackend, jm, jp, jax.random.key(0)),
                                (TBackend, tm, tp, None)):
        tight = be_cls(m, p, kv_blocks=4, kv_block_size=BS, kv_pool=True)
        _drain(tight, tight.start_batch([pa], 1, 4, 0.0, noise))
        cap = tight.capacity_free
        hb = tight.start_batch([pb], 1, 4, 0.0, noise)
        _drain(tight, hb)
        row = [cap, hb.pool_evictions,
               tight.prefix_pool.lookup(pa, 2, touch=False),
               tight.blocks_in_use, tight.prefix_pool.blocks_resident]
        live = be_cls(m, p, kv_blocks=5, kv_block_size=BS, kv_pool=True)
        h = live.start_batch([pa], 1, 4, 0.0, noise)
        free = live.blocks_free
        with pytest.raises(RuntimeError, match="KV block budget exceeded"):
            live.start_batch([pb], 1, 4, 0.0, noise)
        row += [live.prefix_pool.evictable_blocks, live.blocks_free == free,
                [r.samples[0].tolist() for r in _drain(live, h)],
                live.capacity_free]
        off = be_cls(m, p, kv_blocks=5, kv_block_size=BS, kv_pool=True,
                     pool_evict="off")
        _drain(off, off.start_batch([pa], 1, 4, 0.0, noise))
        row += [off.capacity_free, off.marginal_request_cost(pa, 4, 1)]
        _drain(off, off.start_batch([pa], 1, 4, 0.0, noise))
        with pytest.raises(RuntimeError, match="KV block budget exceeded"):
            off.start_batch([pb], 2, 4, 0.0, noise)
        for kw, msg in ((dict(kv_pool=True), "kv_pool requires the paged"),
                        (dict(prefill_chunk=4), "prefill_chunk requires"),
                        (dict(kv_blocks=8, prefill_chunk=0), "must be >= 1"),
                        (dict(kv_blocks=8, kv_pool=True, pool_evict="fifo"),
                         "eviction policy")):
            with pytest.raises(ValueError, match=msg):
                be_cls(m, p, **kw)
        res.append(row)
    assert res[1] == res[0]
    assert res[1][1] >= 1 and res[1][5] == 0


def test_pool_metrics_match_the_reference(fixture_pair):
    jm, jp, tm, tp = fixture_pair
    p = _prompt(16, 64)
    values = []
    for be_cls, m, prm, noise, make in (
            (JBackend, jm, jp, jax.random.key(0), jobs),
            (TBackend, tm, tp, None, tobs)):
        obs = make()
        be = be_cls(m, prm, obs=obs, **POOL)
        for _ in range(2):
            _drain(be, be.start_batch([p], 1, 3, 0.0, noise))
        reg = obs.metrics
        h = reg.histogram("serving_prefix_pool_hit_ratio")
        values.append(dict(
            {n: reg.counter(f"serving_prefix_pool_{n}_total").value()
             for n in ("hits", "misses", "evictions")},
            resident=reg.gauge("serving_prefix_pool_blocks_resident").value(),
            ratio=(h.sum_value(), h.bucket_counts()),
            tokens_in=reg.counter("serving_tokens_in_total").value(),
            tokens_out=reg.counter("serving_tokens_out_total").value(),
            # the lifecycle's spans; the port adds wall-clock children
            spans=[s.name for s in obs.tracer.spans
                   if s.name in LIFECYCLE]))
    assert values[1] == values[0]
    assert (values[1]["hits"], values[1]["misses"]) == (3, 5)


def test_int8_kv_pool_matches_the_reference(pair):
    vocab = pair[0].cfg.vocab_size
    out, jb, tb = _both(pair, dict(POOL, kv_format="int8"),
                        [_cow_batches(vocab)] * 2, [2, 1], 4, 0.8)
    for jr, jh, tr, th in out:
        _same(jr, tr)
        assert (th.pool_hit_blocks, th.prefill_bytes_saved) == \
            (jh.pool_hit_blocks, jh.prefill_bytes_saved)
    assert tb.kv_token_bytes == jb.kv_token_bytes
    assert tb._pool_cache["blocks"]["l0"]["k"].dtype == torch.int8


# ============================================================ chunked prefill

@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("chunk", [3, 4, 16])
@pytest.mark.parametrize("pooled", [False, True], ids=["paged", "pooled"])
def test_chunked_equals_one_shot(fixture_pair, pooled, chunk, temperature):
    """Prompts of 13 tokens (warm on the pool: 3 hit blocks, a 1-token
    tail): the same tokens, logprobs within 1e-5, and one ``decode_step``
    call a slice before the first decode step, with ``step == 0`` and no
    token until the last slice lands."""
    _, _, tm, tp = fixture_pair
    base = dict(kv_blocks=64, kv_block_size=BS, kv_pool=pooled)
    batches = [[_prompt(13, 64), _prompt(13, 64, 3)]] * 2
    one, _ = _port_runs(tm, tp, base, batches, [2, 1], 4, temperature)
    chunked, _ = _port_runs(tm, tp, dict(base, prefill_chunk=chunk),
                            batches, [2, 1], 4, temperature)
    for i, ((ot, ol, orr, os_), (ct, cl, cr, cs)) in enumerate(
            zip(one, chunked)):
        np.testing.assert_array_equal(ct, ot)
        np.testing.assert_allclose(cl, ol, rtol=IN_PORT, atol=IN_PORT)
        tail = 13 - (3 * BS if pooled and i else 0)
        assert cs == os_ + -(-tail // chunk)
    be = TBackend(tm, tp, **dict(base, prefill_chunk=chunk))
    h = be.start_batch(batches[0], 1, 4, temperature,
                       GumbelNoise(torch.Generator().manual_seed(0)))
    assert (h.step, h.tok, len(h.out_toks)) == (0, None, 0)
    for _ in range(-(-13 // chunk) - 1):
        assert be.decode_step(h) and h.step == 0 and h.tok is None
    assert be.decode_step(h) and h.step == 1 and h.pending_prefill is None
    be.release(h)


@pytest.mark.parametrize("pooled", [False, True], ids=["paged", "pooled"])
def test_chunked_matches_the_reference(pair, pooled):
    vocab = pair[0].cfg.vocab_size
    kw = dict(kv_blocks=64, kv_block_size=BS, kv_pool=pooled,
              prefill_chunk=3)
    out, _, _ = _both(pair, kw, [_cow_batches(vocab)] * 2, [2, 1], 4, 0.8)
    for jr, jh, tr, th in out:
        _same(jr, tr)
        assert th.pool_hit_blocks == jh.pool_hit_blocks


# ============================================================== park_batch

def test_park_batch_matches_the_reference(fixture_pair):
    """A pooled batch parked after 3 decode steps indexes each row's
    filled blocks; resuming a row's history hits them. Parking without a
    pool, or in the middle of a chunked prefill, releases."""
    jm, jp, tm, tp = fixture_pair
    prompt = _prompt(9, 64, 5)
    res = []
    for be_cls, m, p, noise in ((JBackend, jm, jp, jax.random.key(1)),
                                (TBackend, tm, tp, None)):
        be = be_cls(m, p, **POOL)
        h = be.start_batch([prompt], 2, 8, 0.0, noise)
        for _ in range(3):
            be.decode_step(h)
        toks = np.stack([np.asarray(t) for t in h.out_toks], axis=1)
        hists = [np.concatenate([prompt, row]).astype(np.int32)
                 for row in toks]
        parked = be.park_batch(h, hists)
        resumed = be.start_batch([hists[0]], 1, 4, 0.0, noise)
        r = _drain(be, resumed)
        plain = be_cls(m, p, kv_blocks=64, kv_block_size=BS)
        ph = plain.start_batch([prompt], 1, 4, 0.0, noise)
        chunk = be_cls(m, p, prefill_chunk=2, **POOL)
        ch = chunk.start_batch([prompt], 1, 4, 0.0, noise)
        chunk.decode_step(ch)
        res.append([parked, resumed.pool_hit_blocks, r[0].samples[0].tolist(),
                    be.blocks_in_use, be.prefix_pool.blocks_resident,
                    plain.park_batch(ph, [prompt]), plain.blocks_in_use,
                    chunk.park_batch(ch, [prompt]), chunk.blocks_in_use,
                    toks.tolist()])
        with pytest.raises(RuntimeError, match="already-released"):
            be.release(h)
    assert res[1] == res[0]
    assert res[1][0] == 2 * 3 and res[1][1] == 3     # (9 + 4 - 1) // 4


# ================================================= F8: early release on a pool

def test_an_early_released_row_writes_into_a_later_batch_as_in_the_reference(
        fixture_pair):
    """F8 (ROADMAP.md): `release_sequences` frees a row's private blocks
    while the row goes on decoding through its table. On the resident pool
    a batch started after the release takes those blocks (here as prefix
    blocks), and the freed row's writes replace its KV with positions its
    mask admits: its tokens change. The reference does this; the port
    does the same, token for token."""
    jm, jp, tm, tp = fixture_pair
    rng = np.random.default_rng(0)
    pa, pb = (rng.integers(0, 64, 8).astype(np.int32) for _ in range(2))
    got = []
    for be_cls, m, p, noise in ((JBackend, jm, jp, jax.random.key(0)),
                                (TBackend, tm, tp, None)):
        runs = []
        for interfere in (False, True):
            be = be_cls(m, p, kv_blocks=32, kv_block_size=BS, kv_pool=True)
            ha = None
            if interfere:
                ha = be.start_batch([pa], 2, 6, 0.0, noise)
                assert be.release_sequences(ha, [1]) == 2
            hb = be.start_batch([pb], 1, 6, 0.0, noise)
            if interfere:
                freed = set(ha.paged.seq_gids[1][2:])
                assert freed <= set(hb.paged.prefill_table[0].tolist())
            while True:
                if ha is not None and not ha.done:
                    be.decode_step(ha)
                if not be.decode_step(hb):
                    break
            runs.append(be.finalize(hb))
        got.append(runs)
    for ref, port in zip(got[0], got[1]):
        _same(ref, port)
    clean, dirty = got[1]
    assert not np.array_equal(clean[0].samples[0], dirty[0].samples[0])
