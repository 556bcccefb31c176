"""The port's MLA slice against the reference, f32 on the CPU: latent
attention (`repro_torch.models.attention.mla_forward`) and its cache, and
deepseek-v2-lite-16b (reduced: MLA, a leading dense layer, MoE with a shared
expert) through `Model.forward`, `ServingEngine.generate`, the converter,
the quantizer and the launcher. Weights come from the reference's
`Model.init`, converted; inputs are numpy arrays from a seed."""
import numpy as np
import pytest

from _torch_parity import (check_forward, close, close_trees, configs, f32,
                           jax, jnp, models, params_to_numpy, to_numpy,
                           tokens, torch)
from test_torch_serving import JaxGumbel, _prompts, _same

from repro.models import Model as JModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.serving import ExecutionBackend as JBackend  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.serving import ExecutionBackend as TBackend  # noqa: E402
from repro_torch.serving import ServingEngine as TEngine  # noqa: E402

TOL = 1e-4
DEEPSEEK = "deepseek-v2-lite-16b"
B, PLEN, STEPS = 2, 6, 3


# ------------------------------------------------------------- the layer

@pytest.fixture(scope="module")
def layer():
    """The prefix (dense) layer's MLA params of reduced deepseek, both
    sides, and the two configs."""
    jm, jp, tm, tp = models(DEEPSEEK, seed=2)
    return jm.cfg, jp["prefix"][0]["attn"], tm.cfg, tp["prefix"][0]["attn"]


@pytest.mark.parametrize("absorbed", [True, False])
def test_mla_prefill_then_decode_matches_the_reference(layer, absorbed):
    """Prefill fills the latent cache (in place in the port); each decode
    step writes its slot and attends, absorbed or decompressed. The port
    runs with ``use_kernel`` off and on (the flash wrapper's plain version
    at D = nope + rope, Dv = v_head_dim)."""
    jc, jl, tc, tl = layer
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, PLEN, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(PLEN, dtype=np.int32), (B, PLEN)).copy()
    jcache0 = jcache.make_cache(jc, B, PLEN + STEPS, jnp.float32)["prefix"][0]
    jy, jcc = jattn.mla_forward(jl, jc, jnp.asarray(x), jnp.asarray(pos),
                                jcache0, absorbed_decode=absorbed)
    steps = []
    for i in range(STEPS):
        xs = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
        ps = np.full((B, 1), PLEN + i, np.int32)
        jys, jcc = jattn.mla_forward(jl, jc, jnp.asarray(xs), jnp.asarray(ps),
                                     jcc, absorbed_decode=absorbed)
        steps.append((xs, ps, jys))
    for use_kernel in (False, True):
        tcache0 = tcache.make_cache(tc, B, PLEN + STEPS, torch.float32,
                                    device="cpu")["prefix"][0]
        ty, tcc = tattn.mla_forward(tl, tc, torch.from_numpy(x),
                                    torch.from_numpy(pos), tcache0,
                                    absorbed_decode=absorbed,
                                    use_kernel=use_kernel)
        assert tcc is tcache0
        close(ty, jy, TOL)
        for xs, ps, jys in steps:
            tys, tcc = tattn.mla_forward(tl, tc, torch.from_numpy(xs),
                                         torch.from_numpy(ps), tcc,
                                         absorbed_decode=absorbed,
                                         use_kernel=use_kernel)
            close(tys, jys, TOL)
        close_trees(tcc, jcc, TOL)


def test_absorbed_and_decompressed_decode_agree(layer):
    """Folding W_uk into q and W_uv after the softmax is the same function
    as attending over the decompressed keys and values."""
    _, _, tc, tl = layer
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((B, PLEN, tc.d_model))
                         .astype(np.float32))
    xs = torch.from_numpy(rng.standard_normal((B, 1, tc.d_model))
                          .astype(np.float32))
    pos = torch.arange(PLEN, dtype=torch.int32)[None].expand(B, PLEN)
    ys = []
    for absorbed in (True, False):
        c = tcache.make_cache(tc, B, PLEN + 1, torch.float32,
                              device="cpu")["prefix"][0]
        tattn.mla_forward(tl, tc, x, pos, c)
        y, _ = tattn.mla_forward(tl, tc, xs, torch.full((B, 1), PLEN,
                                                        dtype=torch.int32),
                                 c, absorbed_decode=absorbed)
        ys.append(y)
    close(ys[0], ys[1], TOL)


def test_mla_cache_layout_and_no_paging():
    jc, tc = configs(DEEPSEEK)
    m = tc.mla
    got = tcache.make_cache(tc, 3, 10, torch.float32, device="cpu")
    want = jcache.make_cache(jc, 3, 10, jnp.float32)
    assert jax.tree.structure(jax.tree.map(f32, got)) == \
        jax.tree.structure(to_numpy(want))
    entry = got["prefix"][0]
    assert entry["c_kv"].shape == (3, 10, m.kv_lora_rank)
    assert entry["k_rope"].shape == (3, 10, m.qk_rope_head_dim)
    assert (entry["pos"] == -1).all() and entry["pos"].dtype == torch.int32
    n_super = tcache.n_scanned_super_blocks(tc)
    assert got["blocks"]["l0"]["c_kv"].shape == (n_super, 3, 10,
                                                 m.kv_lora_rank)
    assert tcache.cache_bytes(tc, 3, 10) == jcache.cache_bytes(jc, 3, 10)
    assert not tcache.paged_supported(tc)
    with pytest.raises(ValueError, match="paged KV cache unsupported"):
        tcache.make_cache(tc, 0, 0, torch.float32, device="cpu",
                          paged=tcache.PagedLayout(4, 4))


# ------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def deepseek():
    jm, jp, tm, tp = models(DEEPSEEK, seed=1)
    tk = type(tm)(tm.cfg, dtype=tm.dtype, device="cpu", use_kernel=True)
    return jm, jp, [tm, tk], tp


def test_deepseek_has_a_dense_prefix_layer_and_moe_blocks(deepseek):
    _, jp, ports, tp = deepseek
    assert len(tp["prefix"]) == 1
    assert "mlp" in tp["prefix"][0] and "moe" not in tp["prefix"][0]
    assert "moe" in tp["blocks"]["l0"] and "shared" in tp["blocks"]["l0"]["moe"]
    assert set(tp["prefix"][0]["attn"]) == set(jp["prefix"][0]["attn"]) == {
        "wq", "w_dkv", "w_krope", "w_uk", "w_uv", "wo"}


def test_deepseek_train_mode(deepseek):
    V = deepseek[0].cfg.vocab_size
    check_forward(deepseek, [(tokens(V, (B, 11)), None, None, None)],
                  lambda m: None, TOL)


def test_deepseek_prefill_then_dense_decode(deepseek):
    V = deepseek[0].cfg.vocab_size
    steps = [(tokens(V, (B, PLEN)), None, None, None)]
    steps += [(tokens(V, (B, 1), seed=10 + i),
               np.full((B, 1), PLEN + i, np.int32), None, None)
              for i in range(STEPS)]
    check_forward(deepseek, steps, lambda m: m.init_cache(B, PLEN + STEPS),
                  TOL)


def test_converter_round_trips_every_mla_and_moe_leaf():
    jc, tc = configs(DEEPSEEK)
    jp = to_numpy(JModel(jc, dtype=jnp.float32).init(jax.random.key(3)))
    tp = params_from_jax(jp, tc, device="cpu")
    assert jax.tree.structure(params_to_numpy(tp)) == jax.tree.structure(jp)
    for ref, got in zip(jax.tree.leaves(jp),
                        jax.tree.leaves(params_to_numpy(tp))):
        np.testing.assert_array_equal(got, ref)
    m = tc.mla
    n_super = tcache.n_scanned_super_blocks(tc)
    attn = tp["blocks"]["l0"]["attn"]
    assert attn["w_uk"]["w"].shape == (n_super, m.kv_lora_rank,
                                       tc.n_heads * m.qk_nope_head_dim)
    assert tp["prefix"][0]["attn"]["wq"]["w"].shape == (
        tc.d_model, tc.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim))


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantized_tree_keeps_the_raw_weights_and_matches(fmt):
    """The reference's quantized tree loads, equals the port's own
    quantization of the same weights, keeps the MLA latent weights and the
    expert stacks in full precision, and gives the reference's logits."""
    from repro.quant.quantize import quantize_model as jquant
    from repro_torch.quant.quantize import quantize_model as tquant
    jm, jp, tm, tp = models(DEEPSEEK, seed=6)
    jq = jquant(jp, fmt, 16)
    tq = params_from_jax(to_numpy(jq), tm.cfg, device="cpu", group_size=16)
    mine = tquant(tp, fmt, 16)
    assert jax.tree.structure(params_to_numpy(mine)) == \
        jax.tree.structure(params_to_numpy(tq))
    for a, b in zip(jax.tree.leaves(params_to_numpy(mine)),
                    jax.tree.leaves(params_to_numpy(tq))):
        np.testing.assert_array_equal(a, b)
    for layer in (tq["prefix"][0], tq["blocks"]["l0"]):
        assert set(layer["attn"]["w_uk"]) == {"w"}
        assert set(layer["attn"]["w_uv"]) == {"w"}
        assert "qw" in layer["attn"]["wq"]
    moe = tq["blocks"]["l0"]["moe"]
    assert all(moe[k].dtype == torch.float32 for k in ("gate", "up", "down"))
    assert "qw" in moe["router"] and "qw" in moe["shared"]["gate"]
    toks = tokens(jm.cfg.vocab_size, (B, PLEN))
    jl, _, _ = jm.forward(jq, {"tokens": jnp.asarray(toks)})
    tl, _, _ = tm.forward(tq, {"tokens": torch.from_numpy(toks)})
    close(tl, jl, TOL)


# ----------------------------------------------------------- the serving

def test_deepseek_greedy_generate_matches_the_reference(deepseek):
    jm, jp, ports, tp = deepseek
    prompts = _prompts(jm.cfg.vocab_size)
    jr = JEngine(jm, jp, max_new_tokens=5, temperature=0.0,
                 backend=JBackend(jm, jp)).generate(prompts, 2)
    for tm in ports:
        eng = TEngine(tm, tp, max_new_tokens=5, temperature=0.0,
                      backend=TBackend(tm, tp))
        _same(jr, eng.generate(prompts, 2))
    with pytest.raises(ValueError, match="paged KV cache unsupported"):
        TBackend(ports[0], tp, kv_blocks=32, kv_block_size=4)


def test_deepseek_sampling_with_the_reference_gumbel_noise(deepseek):
    jm, jp, ports, tp = deepseek
    prompts = _prompts(jm.cfg.vocab_size, lens=(10, 10))
    key = jax.random.key(7)
    jb, tb = JBackend(jm, jp), TBackend(ports[0], tp)
    jh = jb.start_batch(prompts, 3, 4, 0.8, key)
    th = tb.start_batch(prompts, 3, 4, 0.8, JaxGumbel(key))
    while jb.decode_step(jh):
        assert tb.decode_step(th)
    assert not tb.decode_step(th)
    tr = tb.finalize(th)
    _same(jb.finalize(jh), tr)
    assert any(not np.array_equal(r.samples[0], r.samples[1]) for r in tr)


def test_launcher_serves_deepseek_dense_and_refuses_paging(capsys):
    from repro_torch.launch.serve import main
    argv = ["--arch", DEEPSEEK, "--smoke", "--device", "cpu",
            "--requests", "2", "--samples", "2", "--prompt-len", "7",
            "--max-new", "3"]
    main(argv)
    out = capsys.readouterr().out
    assert f"[model] {DEEPSEEK}" in out and "kernels=off" in out
    assert "[serve] 2 requests x 2 samples, 12 tokens" in out
    with pytest.raises(SystemExit, match="--kv-blocks"):
        main(argv + ["--kv-blocks", "32"])
