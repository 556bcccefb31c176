"""The port's Mamba-2 slice against the reference, f32 on the CPU: the SSD
primitives and the Mamba-2 block (`repro_torch.models.ssm`), mamba2-370m and
jamba-v0.1-52b (reduced; jamba at one 8-layer super-block) through
`Model.forward`, `ServingEngine.generate` and the launcher, and the SSM cache.
Weights come from the reference's `Model.init`, converted; inputs are numpy
arrays from a seed. Module and logit parity at f32 1e-4, greedy tokens
exact. Prompts of 40 tokens cross the reduced configs' 32-row chunk and pad
a tail."""
import numpy as np
import pytest

from _torch_parity import (check_forward, close, configs, jax, jnp, models,
                           tokens, torch)
from test_torch_serving import JaxGumbel, _prompts, _same

from repro.models import ssm as jssm  # noqa: E402
from repro.models.cache import cache_bytes as jcache_bytes  # noqa: E402
from repro.serving import ExecutionBackend as JBackend  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.cache import PagedLayout, cache_bytes, make_cache  # noqa: E402
from repro_torch.serving import ExecutionBackend as TBackend  # noqa: E402
from repro_torch.serving import ServingEngine as TEngine  # noqa: E402

TOL = 1e-4
MAMBA, JAMBA = "mamba2-370m", "jamba-v0.1-52b"
#: jamba at one super-block: 7 Mamba layers, 1 attention layer, 4 MoE
ARCHS = {MAMBA: {}, JAMBA: dict(n_layers=8)}


def _rng(seed):
    return np.random.default_rng(seed)


def _both(*arrays):
    """numpy arrays -> (jax arrays, torch tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.asarray(a)) for a in arrays])


def _ssd_inputs(B, L, H, P, N, seed=0):
    """x, dt (softplus of normals), A (negative), B, C as numpy f32."""
    r = _rng(seed)
    x = r.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.exp(r.standard_normal(H)).astype(np.float32)
    Bm = r.standard_normal((B, L, H, N)).astype(np.float32)
    Cm = r.standard_normal((B, L, H, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


# ---------------------------------------------------------------- primitives

def test_segsum_matches_the_reference():
    x = _rng(0).standard_normal((2, 3, 10)).astype(np.float32)
    got, ref = tssm.segsum(torch.from_numpy(x)), jssm.segsum(jnp.asarray(x))
    assert np.isneginf(np.asarray(ref)).sum() == 2 * 3 * 45
    close(got, ref, TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_the_reference(with_state):
    r = _rng(1)
    xbc = r.standard_normal((2, 5, 12)).astype(np.float32)
    w = r.standard_normal((4, 12)).astype(np.float32)
    b = r.standard_normal((12,)).astype(np.float32)
    state = r.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    (jx, jw, jb), (tx, tw, tb) = _both(xbc, w, b)
    jy, jst = jssm._causal_conv(jx, jw, jb,
                                None if state is None else jnp.asarray(state))
    ty, tst = tssm._causal_conv(
        tx, tw, tb, None if state is None else torch.from_numpy(state))
    close(ty, jy, TOL)
    close(tst, jst, TOL)


def test_ssd_decode_step_matches_the_reference():
    x, dt, A, Bm, Cm = _ssd_inputs(2, 1, 3, 8, 16, seed=2)
    state = _rng(3).standard_normal((2, 3, 8, 16)).astype(np.float32)
    jargs, targs = _both(x, dt, A, Bm, Cm, state)
    for got, ref in zip(tssm.ssd_decode_step(*targs),
                        jssm.ssd_decode_step(*jargs)):
        close(got, ref, TOL)


@pytest.mark.parametrize("shape", [(2, 32, 2, 16, 16, 8),
                                   (2, 40, 4, 8, 16, 32),   # padded tail
                                   (1, 70, 3, 8, 16, 32)])  # 3 chunks
@pytest.mark.parametrize("init_state", [False, True])
def test_ssd_chunked_matches_the_reference(shape, init_state):
    """Both paths of the port (``use_kernel`` True takes the wrapper, whose
    CPU path is the plain version and counts no launch) against the
    reference's jnp path."""
    B, L, H, P, N, chunk = shape
    args = _ssd_inputs(B, L, H, P, N, seed=4)
    st = (_rng(5).standard_normal((B, H, P, N)).astype(np.float32)
          if init_state else None)
    jargs, targs = _both(*args)
    jy, jst = jssm.ssd_chunked(*jargs, chunk, None if st is None
                               else jnp.asarray(st), use_kernel=False)
    n0 = ssd_chunk.launches
    for use_kernel in (False, True):
        ty, tst = tssm.ssd_chunked(*targs, chunk, None if st is None
                                   else torch.from_numpy(st),
                                   use_kernel=use_kernel)
        assert ty.shape == (B, L, H, P) and tst.shape == (B, H, P, N)
        close(ty, jy, TOL)
        close(tst, jst, TOL)
    assert ssd_chunk.launches == n0


@pytest.mark.parametrize("L", [40, 70])
def test_ssd_chunked_padding_keeps_b_and_c_shared_over_the_heads(
        monkeypatch, L):
    """B and C one group broadcast over the heads (a stride-0 head axis, as
    the model passes them): a prompt that is not a whole number of chunks
    pads the group row and expands it again, so the chunk function still
    sees a stride-0 head axis; outputs equal those over padded copies (the
    padding's former result) to f32 rounding and match the reference."""
    B, H, P, N, chunk = 2, 4, 8, 16, 32
    x, dt, A, Bm, Cm = _ssd_inputs(B, L, H, P, N, seed=6)
    Bg, Cg = Bm[:, :, :1], Cm[:, :, :1]
    jy, jst = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A)),
                               jnp.asarray(np.repeat(Bg, H, 2)),
                               jnp.asarray(np.repeat(Cg, H, 2)), chunk)
    tx, tdt, tA = (torch.from_numpy(a) for a in (x, dt, A))
    Bv, Cv = (torch.from_numpy(a).expand(B, L, H, N) for a in (Bg, Cg))
    padded = tssm._pad_rows(Bv, 8)
    assert padded.shape == (B, L + 8, H, N) and padded.stride(2) == 0
    assert torch.equal(padded, torch.nn.functional.pad(Bv, (0, 0, 0, 0, 0, 8)))
    seen = []

    def chunk_fn(*args):
        seen.append((args[4].stride(3), args[5].stride(3)))
        return tssm.ssd_chunk_ref(*args)

    monkeypatch.setattr(tssm.ssd_ops, "ssd_chunk", chunk_fn)
    y, st = tssm.ssd_chunked(tx, tdt, tA, Bv, Cv, chunk, use_kernel=True)
    assert seen == [(0, 0)]
    y0, st0 = tssm.ssd_chunked(tx, tdt, tA, Bv.contiguous(), Cv.contiguous(),
                               chunk, use_kernel=True)
    assert seen[1] != (0, 0)
    close(y, y0, 1e-6)
    close(st, st0, 1e-6)
    close(y, jy, TOL)
    close(st, jst, TOL)


def _layer(name, **overrides):
    """(reference cfg, layer-0 SSM params), (port cfg, converted params)."""
    jm, jp, tm, tp = models(name, seed=0, **overrides)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["l0"]["ssm"])
    tl = jax.tree.map(lambda a: a[0], tp["blocks"]["l0"]["ssm"])
    return (jm.cfg, jl), (tm.cfg, tl)


def _ssm_cache(cfg, B, lib):
    s = cfg.ssm
    ch = cfg.d_inner + 2 * s.n_groups * s.d_state
    shapes = {"ssm": (B, cfg.ssm_heads, s.headdim, s.d_state),
              "conv": (B, s.d_conv - 1, ch)}
    if lib == "jax":
        return {k: jnp.zeros(v, jnp.float32) for k, v in shapes.items()}
    return {k: torch.zeros(v) for k, v in shapes.items()}


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_forward_with_and_without_a_cache(split, use_kernel):
    """Train (no cache); prefill of 40 tokens into a fresh cache, then two
    one-token decode steps: the outputs and the cache, which the port writes
    in place."""
    (jc, jl), (tc, tl) = _layer(MAMBA, ssm_split_proj=split)
    assert ("in_proj_z" in tl) == split
    B = 2
    u = _rng(6).standard_normal((B, 40, tc.d_model)).astype(np.float32)
    (ju,), (tu,) = _both(u)
    jy, jcache = jssm.ssm_forward(jl, jc, ju)
    ty, tcache = tssm.ssm_forward(tl, tc, tu, use_kernel=use_kernel)
    assert jcache is None and tcache is None
    close(ty, jy, TOL)
    jcache, tcache = _ssm_cache(jc, B, "jax"), _ssm_cache(tc, B, "torch")
    entry = dict(tcache)
    for step in range(3):
        s = u if step == 0 else _rng(7 + step).standard_normal(
            (B, 1, tc.d_model)).astype(np.float32)
        (ju,), (tu,) = _both(s)
        jy, jcache = jssm.ssm_forward(jl, jc, ju, jcache)
        ty, tcache = tssm.ssm_forward(tl, tc, tu, tcache,
                                      use_kernel=use_kernel)
        close(ty, jy, TOL)
        for k in ("ssm", "conv"):
            assert tcache[k] is entry[k]         # written in place
            close(tcache[k], jcache[k], TOL)


def test_ssm_init_keeps_its_f32_leaves_and_the_reference_distributions():
    from repro_torch.configs import get_config
    cfg = get_config(MAMBA).reduced()
    p = tssm.ssm_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                      "cpu", stack=(2,))
    H = cfg.ssm_heads
    for k in tssm.F32_KEYS:
        assert p[k].dtype == torch.float32 and p[k].shape == (2, H)
    assert p["in_proj"]["w"].dtype == torch.bfloat16
    assert torch.equal(p["A_log"][1], torch.log(torch.arange(1, H + 1.0)))
    assert torch.equal(p["D"], torch.ones(2, H))
    dt = torch.nn.functional.softplus(p["dt_bias"])     # back to dt
    assert (dt >= cfg.ssm.dt_min * 0.999).all()
    assert (dt <= cfg.ssm.dt_max * 1.001).all()
    assert tssm.ssm_shapes(cfg)["in_proj"]["w"] == tuple(
        p["in_proj"]["w"].shape[1:])


# ---------------------------------------------------------------- the model

B, PLEN, STEPS = 2, 40, 3


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    """(reference model, params, [port model kernels off, on], params)"""
    jm, jp, tm, tp = models(request.param, seed=1, **ARCHS[request.param])
    tk = type(tm)(tm.cfg, dtype=tm.dtype, device="cpu", use_kernel=True)
    return jm, jp, [tm, tk], tp


def test_model_train_mode(pair):
    V = pair[0].cfg.vocab_size
    check_forward(pair, [(tokens(V, (B, PLEN)), None, None, None)],
                  lambda m: None, TOL)


def test_model_prefill_then_dense_decode(pair):
    """The SSM state and conv tail (and jamba's attention KV) after prefill
    and each decode step match the reference's."""
    V = pair[0].cfg.vocab_size
    steps = [(tokens(V, (B, PLEN)), None, None, None)] + [
        (tokens(V, (B, 1), seed=10 + i), np.full((B, 1), PLEN + i, np.int32),
         None, None) for i in range(STEPS)]
    check_forward(pair, steps, lambda m: m.init_cache(B, PLEN + STEPS), TOL)


def _port_config(case):
    """The reference's ``ssm`` and ``hybrid`` decode-equivalence configs
    (tests/test_decode_equivalence.py), as port configs."""
    from repro_torch.models.config import ArchConfig, MoEConfig, SSMConfig
    common = dict(d_model=64, vocab_size=97,
                  ssm=SSMConfig(d_state=16, headdim=16, chunk=8))
    if case == "ssm":
        return ArchConfig(name="s", arch_type="ssm", n_layers=2, n_heads=1,
                          n_kv_heads=1, d_ff=0, rope_variant="none",
                          layer_pattern=("m",), **common)
    return ArchConfig(name="h", arch_type="hybrid", n_layers=8, n_heads=4,
                      n_kv_heads=2, d_ff=128,
                      moe=MoEConfig(n_experts=4, top_k=2, moe_period=2,
                                    capacity_factor=8.0),
                      layer_pattern=("m", "m", "m", "a"), **common)


@pytest.mark.parametrize("case", ["ssm", "hybrid"])
def test_prefill_then_decode_equals_the_full_forward(case):
    """Inside the port, on its own weights: the recurrent decode after a
    chunked prefill gives the logits of the full chunked forward, at the
    reference's own tolerance for this check (1e-3: the chunked scan and
    the recurrence sum in different orders)."""
    from repro_torch.models import Model
    cfg = _port_config(case)
    model = Model(cfg, dtype=torch.float32, device="cpu", use_kernel=True)
    params = model.init(torch.Generator().manual_seed(0))
    S, steps = 16, 3
    toks = torch.from_numpy(tokens(cfg.vocab_size, (B, S)))
    cache = model.init_cache(B, S + steps)
    model.forward(params, {"tokens": toks}, cache)
    cur = toks
    for step in range(steps):
        nt = torch.from_numpy(tokens(cfg.vocab_size, (B, 1), seed=10 + step))
        pos = torch.full((B, 1), S + step, dtype=torch.int32)
        ld, _, _ = model.forward(params, {"tokens": nt, "positions": pos},
                                 cache)
        cur = torch.cat([cur, nt], 1)
        lf, _, _ = model.forward(params, {"tokens": cur})
        np.testing.assert_allclose(ld[:, 0].numpy(), lf[:, -1].numpy(),
                                   rtol=1e-3, atol=1e-3,
                                   err_msg=f"{case} step {step}")


# ---------------------------------------------------------------- the cache

@pytest.mark.parametrize("name", [MAMBA, JAMBA])
@pytest.mark.parametrize("reduced", [True, False])
def test_cache_bytes_count_the_f32_state_at_4_bytes(name, reduced):
    jc, tc = configs(name)
    if not reduced:
        from repro.configs import get_config as jget
        from repro_torch.configs import get_config as tget
        jc, tc = jget(name), tget(name)
    for batch, length in ((1, 8), (3, 40)):
        assert cache_bytes(tc, batch, length) == \
            jcache_bytes(jc, batch, length)


def test_ssm_cache_layout_and_no_paging():
    _, tc = configs(JAMBA, n_layers=8)
    cache = make_cache(tc, 3, 20, torch.bfloat16, device="cpu")
    s = tc.ssm
    ssm, attn = cache["blocks"]["l0"], cache["blocks"]["l3"]
    assert ssm["ssm"].shape == (1, 3, tc.ssm_heads, s.headdim, s.d_state)
    assert ssm["ssm"].dtype == torch.float32
    assert ssm["conv"].shape == (1, 3, s.d_conv - 1,
                                 tc.d_inner + 2 * s.n_groups * s.d_state)
    assert ssm["conv"].dtype == torch.bfloat16
    assert not ssm["ssm"].any() and not ssm["conv"].any()
    assert set(attn) == {"k", "v", "pos"}
    with pytest.raises(ValueError, match="paged KV cache unsupported"):
        make_cache(tc, 0, 0, device="cpu", paged=PagedLayout(8, 4))


# -------------------------------------------------------------- the serving

def test_backend_refuses_paging_and_prices_kv_as_the_reference(pair):
    jm, jp, ports, tp = pair
    name = jm.cfg.name
    with pytest.raises(ValueError, match=f"paged KV cache unsupported for "
                       f"arch '{name}'"):
        TBackend(ports[0], tp, kv_blocks=16)
    with pytest.raises(ValueError, match="paged KV cache unsupported"):
        JBackend(jm, jp, kv_blocks=16)
    # mamba2 has no attention layer: no KV bytes a token
    assert TBackend(ports[0], tp).kv_token_bytes == \
        JBackend(jm, jp).kv_token_bytes
    assert (TBackend(ports[0], tp).kv_token_bytes == 0) == (name == MAMBA)


def test_greedy_generate_matches_the_reference(pair):
    jm, jp, ports, tp = pair
    prompts = _prompts(jm.cfg.vocab_size, lens=(40, 40, 13))
    jr = JEngine(jm, jp, max_new_tokens=5, temperature=0.0).generate(
        prompts, 2)
    for tm in ports:
        tr = TEngine(tm, tp, max_new_tokens=5, temperature=0.0).generate(
            prompts, 2)
        _same(jr, tr)


def test_sampling_with_the_reference_gumbel_noise(pair):
    jm, jp, ports, tp = pair
    prompts = _prompts(jm.cfg.vocab_size, lens=(40, 40))
    key = jax.random.key(7)
    jb, tb = JBackend(jm, jp), TBackend(ports[1], tp)
    jh = jb.start_batch(prompts, 3, 4, 0.8, key)
    th = tb.start_batch(prompts, 3, 4, 0.8, JaxGumbel(key))
    while jb.decode_step(jh):
        assert tb.decode_step(th)
    assert not tb.decode_step(th)
    tr = tb.finalize(th)
    _same(jb.finalize(jh), tr)
    assert any(not np.array_equal(r.samples[0], r.samples[1]) for r in tr)


def test_launcher_serves_mamba2_and_refuses_paging(capsys):
    from repro_torch.launch.serve import main
    argv = ["--arch", MAMBA, "--smoke", "--device", "cpu",
            "--requests", "2", "--samples", "2", "--prompt-len", "40",
            "--max-new", "3"]
    main(argv)
    out = capsys.readouterr().out
    assert f"[model] {MAMBA}" in out and "kernels=off" in out
    assert "[serve] 2 requests x 2 samples, 12 tokens" in out
    for name in (MAMBA, JAMBA):
        with pytest.raises(SystemExit, match="--kv-blocks"):
            main(["--arch", name, "--smoke", "--device", "cpu",
                  "--kv-blocks", "32"])
