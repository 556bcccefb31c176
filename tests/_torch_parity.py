"""Shared set-up of the port's parity tests: the same configs, weights and
inputs in the JAX reference (`repro`) and the PyTorch port (`repro_torch`),
both on the CPU. Weights are initialised by the reference and converted;
inputs are numpy arrays from a seed, handed to both."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import ArchConfig as JArchConfig, Model as JModel  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import ArchConfig as TArchConfig, Model as TModel  # noqa: E402

#: the 2-layer dense GQA model every serving test of the reference uses
FIXTURE = dict(name="fixture", arch_type="dense", n_layers=2, d_model=64,
               n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64)
#: the dense GQA archs of the main path (``paged_supported``)
DENSE_GQA = ["chatglm3-6b", "qwen2-72b", "yi-34b", "deepseek-coder-33b"]


def configs(name: str, **overrides):
    """(reference config, port config): the fixture, or an arch's reduced
    config; ``overrides`` replace fields of both (a dict replaces fields of
    a nested config, as ``moe=dict(capacity_factor=0.5)``)."""
    if name == "fixture":
        kw = {**FIXTURE, **overrides}
        return JArchConfig(**kw), TArchConfig(**kw)
    jc, tc = jget(name).reduced(), tget(name).reduced()

    def replace(cfg):
        kw = {k: dataclasses.replace(getattr(cfg, k), **v)
              if isinstance(v, dict) else v for k, v in overrides.items()}
        return dataclasses.replace(cfg, **kw)

    return replace(jc), replace(tc)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def models(name: str, seed: int = 0, use_kernel: bool = False, **overrides):
    """f32 reference model + params, and the port's model with the same
    params converted, on the CPU."""
    jc, tc = configs(name, **overrides)
    jm = JModel(jc, dtype=jnp.float32)
    jp = jm.init(jax.random.key(seed))
    tm = TModel(tc, dtype=torch.float32, device="cpu", use_kernel=use_kernel)
    tp = params_from_jax(to_numpy(jp), tc, device="cpu")
    return jm, jp, tm, tp


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def params_to_numpy(tree):
    """The port's params as numpy arrays, in the same nesting: the inverse
    of `params_from_jax`. Floating leaves become f32; integer leaves (the
    int8 / uint8 weights of a quantized tree) keep their dtype."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor) and not tree.is_floating_point():
        return tree.detach().cpu().numpy()
    return f32(tree)


def close(a, b, tol: float) -> None:
    np.testing.assert_allclose(f32(a), f32(b), rtol=tol, atol=tol)


def close_trees(port_tree, ref_tree, tol: float) -> None:
    """Every leaf of a port tree (tensors) against the same leaf of a
    reference tree (jax or numpy arrays), in flattening order."""
    ref = jax.tree.leaves(to_numpy(ref_tree))
    got = jax.tree.leaves(jax.tree.map(f32, port_tree))
    assert len(ref) == len(got)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, f32(b), rtol=tol, atol=tol)


def tokens(vocab: int, shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def check_forward(pair, steps, make_cache, tol: float) -> None:
    """Run ``steps`` [(tokens, positions, block_table, kv_len)] through the
    reference's `Model.forward` and each port model of ``pair`` =
    (reference model, params, [port models], port params): every step's
    logits and aux loss match, and so does the cache, which the port fills
    in place (``make_cache(model)`` gives a fresh one, or None)."""
    jm, jp, ports, tp = pair

    def batch(toks, pos, table, lib):
        b = {"tokens": toks, "positions": pos, "block_table": table}
        conv = jnp.asarray if lib == "jax" else torch.from_numpy
        return {k: conv(v) for k, v in b.items() if v is not None}

    jc = make_cache(jm)
    jout = []
    for toks, pos, table, kv_len in steps:
        jl, jc, ja = jm.forward(jp, batch(toks, pos, table, "jax"), jc,
                                kv_len=kv_len)
        jout.append((jl, ja))
    for tm in ports:
        tc0 = tc = make_cache(tm)
        for (toks, pos, table, kv_len), (jl, ja) in zip(steps, jout):
            tl, tc, ta = tm.forward(tp, batch(toks, pos, table, "torch"), tc,
                                    kv_len=kv_len)
            assert tl.shape == jl.shape
            close(tl, jl, tol)
            close(ta, ja, tol)
        assert tc is tc0
        if tc is not None:
            close_trees(tc, jc, tol)
