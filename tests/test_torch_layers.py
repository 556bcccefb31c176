"""`repro_torch.models.layers` against `repro.models.layers`, f32 on the CPU,
same inputs from a numpy seed, at atol = rtol = 1e-5."""
import numpy as np
import pytest

from _torch_parity import close, jnp, torch

from repro.models import layers as J  # noqa: E402
from repro_torch.models import layers as T  # noqa: E402

TOL = 1e-5


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(tree):
    """numpy tree -> (jnp tree, torch tree)"""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: b for k, (_, b) in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(tree)


def test_dense_with_and_without_bias():
    x, w, b = _arrays(0, (2, 5, 16), (16, 24), (24,))
    for p in ({"w": w}, {"w": w, "b": b}):
        jp, tp = _both(p)
        close(T.dense(tp, torch.from_numpy(x)), J.dense(jp, jnp.asarray(x)),
              TOL)
    # quantized dense dicts (int8, packed int4) dispatch on "qw", bias kept
    from repro.quant import quantize_dense
    for fmt in ("int8", "int4"):
        qp = {k: np.array(v) for k, v in
              quantize_dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                             fmt, 8).items()}
        jp, tp = _both(qp)
        close(T.dense(tp, torch.from_numpy(x)), J.dense(jp, jnp.asarray(x)),
              TOL)


def test_rmsnorm():
    x, s = _arrays(1, (3, 7, 32), (32,))
    x = x * 3.0 + 1.0
    jp, tp = _both({"scale": s})
    close(T.rmsnorm(tp, torch.from_numpy(x), 1e-5),
          J.rmsnorm(jp, jnp.asarray(x), 1e-5), TOL)


@pytest.mark.parametrize("variant", ["swiglu", "gelu"])
def test_mlp(variant):
    x, = _arrays(2, (2, 6, 16))
    rng = np.random.default_rng(3)
    if variant == "swiglu":
        p = {k: {"w": rng.standard_normal(s).astype(np.float32) * 0.2}
             for k, s in [("gate", (16, 40)), ("up", (16, 40)),
                          ("down", (40, 16))]}
    else:
        p = {k: {"w": rng.standard_normal(s).astype(np.float32) * 0.2,
                 "b": rng.standard_normal(s[1:]).astype(np.float32)}
             for k, s in [("fc_in", (16, 40)), ("fc_out", (40, 16))]}
    jp, tp = _both(p)
    close(T.mlp(tp, torch.from_numpy(x), variant),
          J.mlp(jp, jnp.asarray(x), variant), TOL)


@pytest.mark.parametrize("fraction,sections,pos_shape", [
    (1.0, (), (2, 9)),              # full rotary
    (0.5, (), (2, 9)),              # chatglm's partial rope
    (1.0, (4, 2, 2), (2, 9, 3)),    # qwen2-vl's M-RoPE (t/h/w sections)
])
def test_apply_rope(fraction, sections, pos_shape):
    x, = _arrays(4, (2, 9, 4, 16))
    pos = np.random.default_rng(5).integers(0, 500, pos_shape).astype(
        np.int32)
    close(T.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                       fraction, sections),
          J.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, fraction,
                       sections), TOL)
    close(T.rope_freqs(16, 1e4), J.rope_freqs(16, 1e4), TOL)


def test_apply_rope_refuses_bad_mrope_sections():
    x, = _arrays(6, (1, 3, 2, 16))
    pos = torch.zeros((1, 3, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="mrope"):
        T.apply_rope(torch.from_numpy(x), pos, 1e4, 1.0, (4, 4, 4))


@pytest.mark.parametrize("codebooks", [1, 3])
def test_embed_and_lm_head(codebooks):
    V, D = 50, 16
    lead = (codebooks,) if codebooks > 1 else ()
    table, w, h = _arrays(7, lead + (V, D), lead + (D, V), (2, 5, D))
    rng = np.random.default_rng(8)
    toks = rng.integers(0, V, (2, 5) + ((codebooks,) if codebooks > 1
                                        else ())).astype(np.int32)
    jp, tp = _both({"table": table})
    close(T.embed(tp, torch.from_numpy(toks)),
          J.embed(jp, jnp.asarray(toks)), TOL)
    jp, tp = _both({"w": w})
    close(T.lm_head(tp, torch.from_numpy(h)),
          J.lm_head(jp, jnp.asarray(h)), TOL)


def test_init_distributions_follow_the_reference():
    """The port draws its own weights (the bits differ from JAX's) with the
    reference's scales: normal * d_in^-1/2 for dense, 0.02 for embeddings,
    ones for norms, zeros for biases."""
    g = torch.Generator().manual_seed(0)
    p = T.dense_init(g, 256, 512, torch.float32, "cpu", bias=True,
                     stack=(3,))
    assert p["w"].shape == (3, 256, 512) and p["b"].shape == (3, 512)
    assert abs(p["w"].std().item() - 256 ** -0.5) < 2e-3
    assert torch.all(p["b"] == 0)
    e = T.embed_init(g, 1000, 64, torch.bfloat16, "cpu")["table"]
    assert e.dtype == torch.bfloat16
    assert abs(e.float().std().item() - 0.02) < 1e-3
    assert torch.all(T.rmsnorm_init(8, torch.float32, "cpu")["scale"] == 1)
    h = T.lm_head_init(g, 64, 300, torch.float32, "cpu")["w"]
    assert abs(h.std().item() - 64 ** -0.5) < 5e-3
