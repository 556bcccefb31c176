"""The port's weight-only quantization and int8 KV against the reference:
the quantizer (`repro_torch.quant`), the dequant-matmul plain versions (held
to the jnp oracles and to the Pallas kernels in interpret mode), the model
walk and the converter on quantized trees, quantized serving on the fixture
model, and int8 paged KV from the fill to greedy generate."""
import numpy as np
import pytest

from _torch_parity import configs, jax, jnp, models, params_to_numpy, \
    to_numpy, torch

from repro.kernels.dequant_matmul import (  # noqa: E402
    dequant_matmul as j_dequant_matmul, dequant_matmul_int4_pallas,
    dequant_matmul_int4_ref as j_int4_ref, dequant_matmul_int8_pallas,
    dequant_matmul_int8_ref as j_int8_ref, unpack_int4 as j_unpack_int4)
from repro.models import attention as jattn  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.quant import quantize as jq  # noqa: E402
from repro.serving import ExecutionBackend as JBackend  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.dequant_matmul import ops as dq_ops  # noqa: E402
from repro_torch.kernels.dequant_matmul.ref import (  # noqa: E402
    dequant_matmul_int4_ref, dequant_matmul_int8_ref, unpack_int4)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.quant import quantize as tq  # noqa: E402
from repro_torch.serving import ExecutionBackend as TBackend  # noqa: E402
from repro_torch.serving import ServingEngine as TEngine  # noqa: E402

# the reference's whole-tree and attention functions, jitted: compiled once
# instead of op by op. Under jit XLA turns ``/ 127.0`` and ``/ 7.0`` into a
# product with the rounded reciprocal, so jitted scales can differ from the
# eager reference (and from the port) in the last bit: the bit-equality
# tests call the reference eagerly, as it is written.
j_quantize_model = jax.jit(jq.quantize_model, static_argnums=(1, 2))
j_dequantize_model = jax.jit(jq.dequantize_model)
j_gqa_forward = jax.jit(jattn.gqa_forward, static_argnums=(1,),
                        static_argnames=("kv_len",))

TOL = 1e-5          # plain matmul vs oracle / interpret kernel (f32 sums)
SERVE_TOL = 1e-4    # logprobs of generate, as in tests/test_torch_serving.py
GS = 16
KERNEL_SHAPES_INT8 = [(5, 48, 19), (1, 32, 130), (9, 64, 64), (17, 96, 33)]
KERNEL_SHAPES_INT4 = [(5, 48, 19, 16), (1, 32, 130, 32), (9, 64, 64, 16),
                      (17, 96, 33, 8)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    return models("fixture", seed=0)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _same_trees(a, b):
    """Leaf for leaf: same paths, dtypes and values (numpy or torch)."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, p
        np.testing.assert_array_equal(x, y, err_msg=p)


# ================================================================ quantizer

@pytest.mark.parametrize("shape", [(10, 7), (3, 6, 5)])
def test_pack_unpack_round_trip_matches_the_reference(shape):
    q = np.random.default_rng(0).integers(-8, 8, size=shape).astype(np.int8)
    packed = tq.pack_int4(_t(q))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(unpack_int4(packed).numpy(), q)
    np.testing.assert_array_equal(
        unpack_int4(packed).numpy(),
        np.asarray(j_unpack_int4(jnp.asarray(packed.numpy()))))


def test_group_size_for_matches_the_reference():
    for d_in in range(2, 130, 2):
        for gs in (2, 3, 4, 8, 16, 24, 32, 64, 200):
            assert tq.group_size_for(d_in, gs) == jq.group_size_for(d_in, gs)
    for d_in in (1, 7, 33):
        with pytest.raises(ValueError, match="even"):
            tq.group_size_for(d_in, 4)


@pytest.mark.parametrize("shape", [(48, 19), (2, 64, 33), (96, 130)])
def test_quantize_int8_is_bit_equal_to_the_reference(shape):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    qw, s = tq.quantize_int8(_t(w))
    jqw, js = jq.quantize_int8(jnp.asarray(w))
    assert qw.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(qw.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape,gs", [((48, 19), 32), ((2, 64, 33), 16),
                                      ((96, 130), 8), ((3, 40, 5), 32)])
def test_quantize_int4_is_bit_equal_to_the_reference(shape, gs):
    w = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    qw, s = tq.quantize_int4(_t(w), gs)
    jqw, js = jq.quantize_int4(jnp.asarray(w), gs)
    assert qw.dtype == torch.uint8 and s.dtype == torch.float32
    np.testing.assert_array_equal(qw.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_bf16_weights_quantize_with_f32_scales():
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 32, 8))
                         .astype(np.float32)).to(torch.bfloat16)
    for fmt in ("int8", "int4"):
        p = tq.quantize_dense({"w": w, "b": torch.zeros(2, 8,
                                                        dtype=torch.bfloat16)},
                              fmt, 16)
        assert p["scale"].dtype == torch.float32
        assert p["b"].dtype == torch.bfloat16 and "w" not in p
        back = tq.dequantize_dense(p, torch.bfloat16)["w"]
        assert back.dtype == torch.bfloat16 and back.shape == w.shape


# ============================================================ plain kernels

@pytest.mark.parametrize("M,K,N", KERNEL_SHAPES_INT8)
def test_int8_plain_matches_oracle_and_interpret_kernel(M, K, N):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(M, K)).astype(np.float32)
    jqw, js = jq.quantize_int8(jnp.asarray(rng.normal(size=(K, N)),
                                           jnp.float32))
    got = dequant_matmul_int8_ref(_t(x), _t(jqw), _t(js)).numpy()
    want = np.asarray(j_int8_ref(jnp.asarray(x), jqw, js))
    pallas = np.asarray(dequant_matmul_int8_pallas(jnp.asarray(x), jqw, js,
                                                   interpret=True))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("M,K,N,gs", KERNEL_SHAPES_INT4)
def test_int4_plain_matches_oracle_and_interpret_kernel(M, K, N, gs):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(M, K)).astype(np.float32)
    jqw, js = jq.quantize_int4(jnp.asarray(rng.normal(size=(K, N)),
                                           jnp.float32), gs)
    assert js.shape == (K // gs, N)
    got = dequant_matmul_int4_ref(_t(x), _t(jqw), _t(js)).numpy()
    want = np.asarray(j_int4_ref(jnp.asarray(x), jqw, js))
    pallas = np.asarray(dequant_matmul_int4_pallas(jnp.asarray(x), jqw, js,
                                                   interpret=True))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)


def test_dispatch_discriminates_by_dtype_and_keeps_leading_dims():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    for qw, s in (tq.quantize_int8(_t(w)), tq.quantize_int4(_t(w), 16)):
        y = dq_ops.dequant_matmul(_t(x), qw, s)
        assert y.shape == (2, 3, 16) and y.dtype == torch.float32
        want = j_dequant_matmul(jnp.asarray(x), jnp.asarray(qw.numpy()),
                                jnp.asarray(s.numpy()))
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    qw8, s8 = tq.quantize_int8(_t(w))
    np.testing.assert_array_equal(
        dq_ops.dequant_matmul(_t(x), qw8, s8).numpy(),
        dequant_matmul_int8_ref(_t(x), qw8, s8).numpy())
    # the 2-D wrappers take the plain version on CPU tensors, uncounted
    n8, n4 = dq_ops.dequant_matmul_int8.launches, \
        dq_ops.dequant_matmul_int4.launches
    qw4, s4 = tq.quantize_int4(_t(w), 8)
    xb = _t(x[0]).to(torch.bfloat16)
    y4 = dq_ops.dequant_matmul_int4(xb, qw4, s4)
    assert y4.dtype == torch.bfloat16
    assert torch.equal(y4, dequant_matmul_int4_ref(xb, qw4, s4))
    assert (dq_ops.dequant_matmul_int8.launches,
            dq_ops.dequant_matmul_int4.launches) == (n8, n4)


# =========================================================== model walk

@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantize_model_equals_the_reference_leaf_for_leaf(pair, fmt):
    _, jp, tm, tp = pair
    tqp = tq.quantize_model(tp, fmt, GS)
    jqp = jq.quantize_model(jp, fmt, GS)
    want = params_from_jax(to_numpy(jqp), tm.cfg, device="cpu",
                           group_size=GS)
    _same_trees(tqp, want)
    for key in ("embed", "lm_head", "final_norm"):
        assert tqp[key] is tp[key]                 # the keep-list untouched
    assert tq.params_quant_format(tqp) == fmt
    assert tq.param_bytes(tqp) < tq.param_bytes(tp)
    # the reconstruction matches the reference's, in f32
    _same_trees(params_to_numpy(tq.dequantize_model(tqp)),
                to_numpy(j_dequantize_model(jqp)))


def test_quantize_model_bf16_and_unknown_formats(pair):
    _, _, _, tp = pair
    assert tq.params_quant_format(tp) == "bf16"
    assert tq.quantize_model(tp, "bf16") is tp
    with pytest.raises(ValueError, match="supported"):
        tq.quantize_model(tp, "fp4")


def test_odd_input_dims_stay_dense_under_int4():
    p = {"proj": {"w": torch.ones(2, 7, 4)}, "w_uk": {"w": torch.ones(8, 4)},
         "mlp": {"w": torch.ones(2, 8, 4), "b": torch.zeros(2, 4)}}
    qp = tq._walk(p, "int4", 32)
    assert set(qp["proj"]) == {"w"}               # unpackable odd K
    assert set(qp["w_uk"]) == {"w"}               # read raw by MLA decode
    assert set(qp["mlp"]) == {"qw", "scale", "b"}
    assert qp["mlp"]["qw"].shape == (2, 4, 4)


def test_params_from_jax_keeps_quantized_dtypes(pair):
    jm, jp, tm, _ = pair
    for fmt, qdt in (("int8", torch.int8), ("int4", torch.uint8)):
        tree = to_numpy(j_quantize_model(jp, fmt, GS))
        tp = params_from_jax(tree, tm.cfg, device="cpu", dtype=torch.bfloat16,
                             group_size=GS)
        wq = tp["blocks"]["l0"]["attn"]["wq"]
        assert wq["qw"].dtype == qdt and wq["scale"].dtype == torch.float32
        assert tp["embed"]["table"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            wq["scale"].numpy(),
            tree["blocks"]["l0"]["attn"]["wq"]["scale"])
    # the group size decides the int4 scale shape
    tree = to_numpy(j_quantize_model(jp, "int4", GS))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, tm.cfg, device="cpu", group_size=32)


# ======================================================= quantized serving

def _prompts(vocab, lens=(13, 13, 9)):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _generate(engine_cls, backend_cls, model, params, prompts, **kw):
    eng = engine_cls(model, params, max_new_tokens=5, temperature=0.0,
                     backend=backend_cls(model, params, **kw))
    return eng.generate(prompts, n_samples=2)


def _same(jr, tr, tol=SERVE_TOL):
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        assert len(a.samples) == len(b.samples)
        for sa, sb in zip(a.samples, b.samples):
            np.testing.assert_array_equal(sb, sa)
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=tol, atol=tol)


PAGED = dict(kv_blocks=96, kv_block_size=4)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_quantized_greedy_generate_matches_the_reference(pair, fmt, mode):
    jm, jp, tm, tp = pair
    kw = PAGED if mode == "paged" else {}
    prompts = _prompts(jm.cfg.vocab_size)
    jqp = j_quantize_model(jp, fmt, GS)
    tqp = tq.quantize_model(tp, fmt, GS)
    _same(_generate(JEngine, JBackend, jm, jqp, prompts, **kw),
          _generate(TEngine, TBackend, tm, tqp, prompts, **kw))


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantized_generate_bit_identical_to_dequantized(pair, fmt):
    """Inside the port, serving the quantized tree == serving its
    dequantized reconstruction, bit for bit: the plain path computes
    exactly ``x @ (qw * scale)``."""
    _, _, tm, tp = pair
    qp = tq.quantize_model(tp, fmt, GS)
    dq = tq.dequantize_model(qp, torch.float32)
    prompts = _prompts(tm.cfg.vocab_size)
    for kw in ({}, PAGED):
        want = _generate(TEngine, TBackend, tm, dq, prompts, **kw)
        got = _generate(TEngine, TBackend, tm, qp, prompts, **kw)
        for a, b in zip(want, got):
            for s1, s2 in zip(a.samples, b.samples):
                np.testing.assert_array_equal(s1, s2)
            assert a.logprobs == b.logprobs


# ============================================================== int8 KV

def test_make_cache_int8_paged_shapes_and_dense_rejection():
    _, tc = configs("fixture")
    cache = tcache.make_cache(tc, 0, 0, torch.float32, device="cpu",
                              paged=tcache.PagedLayout(6, 4),
                              kv_dtype=torch.int8)
    entry = cache["blocks"]["l0"]
    n_super = entry["k"].shape[0]
    assert entry["k"].dtype == entry["v"].dtype == torch.int8
    for key in ("k_scale", "v_scale"):
        assert entry[key].shape == (n_super, 6, 4, tc.n_kv_heads)
        assert entry[key].dtype == torch.float32
    jc_, _ = configs("fixture")
    want = jcache.make_cache(jc_, 0, 0, jnp.float32,
                             paged=jcache.PagedLayout(6, 4),
                             kv_dtype=jnp.int8)["blocks"]["l0"]
    assert {k: tuple(v.shape) for k, v in entry.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    with pytest.raises(ValueError, match="paged"):
        tcache.make_cache(tc, 2, 16, torch.float32, device="cpu",
                          kv_dtype=torch.int8)


def _layer_caches(jc, tc, kv_dtype):
    """One layer's int8 (or f32) pools, reference and port."""
    jd, td = (jnp.int8, torch.int8) if kv_dtype else (None, None)
    jcache_l = jax.tree.map(lambda a: a[0], jcache.make_cache(
        jc, 0, 0, jnp.float32, paged=jcache.PagedLayout(8, 4),
        kv_dtype=jd)["blocks"]["l0"])
    tcache_l = {k: v[0] for k, v in tcache.make_cache(
        tc, 0, 0, torch.float32, device="cpu",
        paged=tcache.PagedLayout(8, 4), kv_dtype=td)["blocks"]["l0"].items()}
    return jcache_l, tcache_l


def test_int8_fill_equals_the_reference():
    jc, tc = configs("fixture")
    rng = np.random.default_rng(5)
    B, S = 2, 7
    k = rng.normal(size=(B, S, tc.n_kv_heads, tc.hd)).astype(np.float32)
    v = rng.normal(size=(B, S, tc.n_kv_heads, tc.hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    table = np.asarray([[0, 1], [3, 4]], np.int32)
    jc_l, tc_l = _layer_caches(jc, tc, True)
    want = jattn._fill_cache_paged(jc_l, jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(pos), jnp.asarray(table))
    got = tattn._fill_cache_paged(tc_l, _t(k), _t(v), _t(pos), _t(table))
    assert got is tc_l                                  # written in place
    for key in ("k", "v", "pos", "k_scale", "v_scale"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)


def test_int8_gqa_prefill_and_decode_match_the_reference(pair):
    jm, jp, tm, tp = pair
    jc, tc = jm.cfg, tm.cfg
    jpl = jax.tree.map(lambda a: a[0], jp["blocks"]["l0"]["attn"])
    tpl = {k: {kk: vv[0] for kk, vv in d.items()}
           for k, d in tp["blocks"]["l0"]["attn"].items()}
    B, S = 2, 8
    rng = np.random.default_rng(13)
    x = (rng.normal(size=(B, S, tc.d_model)) * 0.3).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    table = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    jc_l, tc_l = _layer_caches(jc, tc, True)
    jy, jcache_l = j_gqa_forward(jpl, jc, jnp.asarray(x), jnp.asarray(pos),
                                     cache=jc_l, block_table=jnp.asarray(table),
                                     kv_len=12)
    ty, tcache_l = tattn.gqa_forward(tpl, tc, _t(x), _t(pos), cache=tc_l,
                                     block_table=_t(table), kv_len=12)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    xd, pd = x[:, -1:], pos[:, -1:] + 1
    jyd, _ = j_gqa_forward(jpl, jc, jnp.asarray(xd), jnp.asarray(pd),
                               cache=jcache_l, block_table=jnp.asarray(table),
                               kv_len=12)
    tyd, _ = tattn.gqa_forward(tpl, tc, _t(xd), _t(pd), cache=tcache_l,
                               block_table=_t(table), kv_len=12)
    np.testing.assert_allclose(tyd.numpy(), np.asarray(jyd), rtol=TOL,
                               atol=TOL)
    # the kernel switch changes nothing: int8 pools bypass the paged kernel
    jc_l, tc_l = _layer_caches(jc, tc, True)
    tattn.gqa_forward(tpl, tc, _t(x), _t(pos), cache=tc_l,
                      block_table=_t(table), kv_len=12)
    tyk, _ = tattn.gqa_forward(tpl, tc, _t(xd), _t(pd), cache=tc_l,
                               use_kernel=True, block_table=_t(table),
                               kv_len=12)
    assert torch.equal(tyk, tyd)


def test_copy_cache_blocks_moves_the_scales():
    _, tc = configs("fixture")
    cache = tcache.make_cache(tc, 0, 0, torch.float32, device="cpu",
                              paged=tcache.PagedLayout(6, 4),
                              kv_dtype=torch.int8)
    entry = cache["blocks"]["l0"]
    entry["k_scale"][:, 0] = 3.5
    entry["v_scale"][:, 0] = -2.0
    entry["k"][:, 0] = 7
    out = tcache.copy_cache_blocks(cache, torch.tensor([0]),
                                   torch.tensor([5]))
    assert out is cache
    assert float(entry["k_scale"][0, 5, 0, 0]) == 3.5
    assert float(entry["v_scale"][0, 5, 1, 0]) == -2.0
    assert int(entry["k"][0, 5, 3, 0, 0]) == 7


def test_kv_token_bytes_and_backend_checks_follow_the_reference(pair):
    jm, jp, tm, tp = pair
    for kw in ({}, dict(kv_blocks=8, kv_block_size=4),
               dict(kv_blocks=8, kv_block_size=4, kv_format="int8")):
        assert TBackend(tm, tp, **kw).kv_token_bytes == \
            JBackend(jm, jp, **kw).kv_token_bytes
    # fault F5 of the reference, copied for parity: int8 KV leaves out its
    # f32 scale rows (2 x n_kv x 4 B per layer)
    cfg = tm.cfg
    assert TBackend(tm, tp, kv_blocks=8, kv_format="int8").kv_token_bytes \
        == cfg.n_layers * (2 * cfg.n_kv_heads * cfg.hd + 4)
    with pytest.raises(ValueError, match="kv_blocks"):
        TBackend(tm, tp, kv_format="int8")
    with pytest.raises(ValueError, match="kv_format"):
        TBackend(tm, tp, kv_blocks=8, kv_format="fp8")


def test_int8_kv_greedy_generate_matches_the_reference(pair):
    jm, jp, tm, tp = pair
    prompts = _prompts(jm.cfg.vocab_size)
    kw = dict(PAGED, kv_format="int8")
    _same(_generate(JEngine, JBackend, jm, jp, prompts, **kw),
          _generate(TEngine, TBackend, tm, tp, prompts, **kw))
    # int4 weights over int8 KV, the chip_smoke run (c)
    jqp, tqp = j_quantize_model(jp, "int4", GS), tq.quantize_model(
        tp, "int4", GS)
    _same(_generate(JEngine, JBackend, jm, jqp, prompts, **kw),
          _generate(TEngine, TBackend, tm, tqp, prompts, **kw))
