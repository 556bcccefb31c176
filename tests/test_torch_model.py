"""`repro_torch.models.Model.forward` against `repro.models.Model.forward`,
f32 on the CPU, same weights (converted) and tokens, logits at 1e-4, in the
five modes the serving path uses: train, prefill, dense decode, paged decode,
and S > 1 with ``decode=True``. The port runs with ``use_kernel`` off and on
(on CPU tensors the kernel wrappers take their plain versions)."""
import numpy as np
import pytest

from _torch_parity import close, f32, jnp, models, torch

TOL = 1e-4
B, PLEN, STEPS, BS = 2, 6, 3, 4
NAMES = ["fixture", "chatglm3-6b"]


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _batch(toks, pos=None, table=None):
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}
    if pos is not None:
        jb["positions"] = jnp.asarray(pos)
        tb["positions"] = torch.from_numpy(pos)
    if table is not None:
        jb["block_table"] = jnp.asarray(table)
        tb["block_table"] = torch.from_numpy(table)
    return jb, tb


def _close_caches(tc, jc):
    jblocks, tblocks = jc["blocks"], tc["blocks"]
    assert set(jblocks) == set(tblocks)
    for name in jblocks:
        for leaf in ("k", "v", "pos"):
            np.testing.assert_allclose(f32(tblocks[name][leaf]),
                                       f32(jblocks[name][leaf]),
                                       rtol=TOL, atol=TOL, err_msg=leaf)


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    """(reference model, params, [port model with kernels off, on], params)"""
    jm, jp, tm, tp = models(request.param, seed=1)
    tk = type(tm)(tm.cfg, dtype=tm.dtype, device="cpu", use_kernel=True)
    return jm, jp, [tm, tk], tp


def _run(model, params, steps, cache, side):
    """Run ``steps`` [(tokens, positions, table, kv_len, decode)] through the
    reference's model (side 0) or a port's (side 1); returns each step's
    logits and the final cache."""
    out = []
    for toks, pos, table, kv_len, decode in steps:
        batch = _batch(toks, pos, table)[side]
        logits, cache, _ = model.forward(params, batch, cache, kv_len=kv_len,
                                         decode=decode)
        out.append(logits)
    return out, cache


def _check(pair, steps, make_caches):
    jm, jp, ports, tp = pair
    jc = make_caches(jm)
    jl, jc = _run(jm, jp, steps, jc, 0)
    for tm in ports:
        tc0 = make_caches(tm)
        tl, tc = _run(tm, tp, steps, tc0, 1)
        if tc0 is not None:
            assert tc is tc0             # the port fills its cache in place
            _close_caches(tc, jc)
        for a, b in zip(tl, jl):
            assert a.shape == b.shape
            close(a, b, TOL)


def test_train_mode(pair):
    jm, _, ports, tp = pair
    toks = _tokens(jm.cfg.vocab_size, (B, 11))
    _check(pair, [(toks, None, None, None, False)], lambda m: None)
    # padded vocab columns are masked out of every softmax
    tl, cache, aux = ports[0].forward(tp, {"tokens": torch.from_numpy(toks)})
    assert cache is None and float(aux) == 0.0
    assert tl.shape == (B, 11, jm.cfg.padded_vocab)
    if jm.cfg.padded_vocab != jm.cfg.vocab_size:
        assert torch.all(tl[..., jm.cfg.vocab_size:] == -1e9)


def _decode_steps(V, table=None, kv_len=None, seed=10):
    return [(_tokens(V, (B, 1), seed=seed + i),
             np.full((B, 1), PLEN + i, np.int32), table, kv_len, False)
            for i in range(STEPS)]


def test_prefill_then_dense_decode(pair):
    V = pair[0].cfg.vocab_size
    steps = [(_tokens(V, (B, PLEN)), None, None, None, False)]
    steps += _decode_steps(V)
    _check(pair, steps, lambda m: m.init_cache(B, PLEN + STEPS))


def _tables(n_blocks):
    nb = -(-(PLEN + STEPS) // BS)
    ids = np.random.default_rng(7).permutation(n_blocks)[:B * nb]
    return ids.reshape(B, nb).astype(np.int32)


def test_prefill_then_paged_decode(pair):
    V = pair[0].cfg.vocab_size
    table = _tables(9)
    steps = [(_tokens(V, (B, PLEN)), None, table[:, :-(-PLEN // BS)], None,
              False)]
    steps += _decode_steps(V, table, PLEN + STEPS, seed=20)
    _check(pair, steps, lambda m: m.init_paged_cache(9, BS))


@pytest.mark.parametrize("paged", [False, True])
def test_multi_token_decode_against_the_cache(pair, paged):
    """S > 1 with ``decode=True`` (speculative verify, tail prefill): the S
    queries scatter into the cache and attend by position. Always the plain
    path: the kernels take S == 1 only."""
    V = pair[0].cfg.vocab_size
    S = STEPS
    pos = np.broadcast_to(np.arange(PLEN, PLEN + S, dtype=np.int32),
                          (B, S)).copy()
    table = _tables(9) if paged else None
    kv_len = PLEN + S if paged else None
    steps = [(_tokens(V, (B, PLEN)), None, table, None, False),
             (_tokens(V, (B, S), seed=30), pos, table, kv_len, True)]
    if paged:
        _check(pair, steps, lambda m: m.init_paged_cache(9, BS))
    else:
        _check(pair, steps, lambda m: m.init_cache(B, PLEN + S))


@pytest.mark.parametrize("overrides", [
    dict(tie_embeddings=True),
    dict(rope_variant="none"),
    dict(rope_variant="sinusoidal", mlp_variant="gelu"),
    dict(vocab_size=256),                  # no padded columns
], ids=["tied", "norope", "sinusoidal-gelu", "unpadded"])
def test_model_variants_train_and_decode(overrides):
    jm, jp, tm, tp = models("fixture", seed=2, **overrides)
    toks = _tokens(jm.cfg.vocab_size, (B, PLEN))
    jb, tb = _batch(toks)
    jl, _, _ = jm.forward(jp, jb)
    tl, _, _ = tm.forward(tp, tb)
    close(tl, jl, TOL)
    jc, tc = jm.init_cache(B, PLEN + 1), tm.init_cache(B, PLEN + 1)
    _, jc, _ = jm.forward(jp, jb, jc)
    tm.forward(tp, tb, tc)
    nxt = _tokens(jm.cfg.vocab_size, (B, 1), seed=3)
    jb, tb = _batch(nxt, np.full((B, 1), PLEN, np.int32))
    jl, _, _ = jm.forward(jp, jb, jc)
    tl, _, _ = tm.forward(tp, tb, tc)
    close(tl, jl, TOL)


def test_unported_archs_say_which_slice_brings_them():
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cross = ("cross-attention arrives with the remaining-arch-features "
             "slice of the port")
    cfg = get_config("musicgen-medium").reduced()
    with pytest.raises(NotImplementedError, match=cross):
        Model(cfg, dtype=torch.float32, device="cpu").init(
            torch.Generator().manual_seed(0))


def test_port_init_serves_its_own_weights():
    """`Model.init` draws the port's own weights from a generator: same seed,
    same weights; the forward pass runs on them."""
    _, _, tm, _ = models("chatglm3-6b")
    p1 = tm.init(torch.Generator().manual_seed(5))
    p2 = tm.init(torch.Generator().manual_seed(5))
    assert torch.equal(p1["blocks"]["l0"]["mlp"]["up"]["w"],
                       p2["blocks"]["l0"]["mlp"]["up"]["w"])
    toks = torch.from_numpy(_tokens(tm.cfg.vocab_size, (1, 5)))
    logits, _, _ = tm.forward(p1, {"tokens": toks})
    assert torch.isfinite(logits[..., :tm.cfg.vocab_size]).all()
