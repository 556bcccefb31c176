"""`repro_torch.launch.specs` against `repro.launch.specs`: for each of the
40 (arch x input shape) pairs, ``input_specs`` gives meta tensors of the
reference's ``ShapeDtypeStruct`` shapes and dtypes (batch entries and every
cache leaf, by path; the fp8 cache variant too), ``adapt_config`` applies
the same long_500k window, and `param_specs` gives the dtypes of the
reference's parameter specs."""
import pytest

import _torch_parity  # noqa: F401,E402  (skips without jax / torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch.specs import (LONG_CONTEXT_WINDOW as J_WINDOW,  # noqa: E402
                                adapt_config as jadapt,
                                input_specs as jinput_specs)
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.launch.specs import (LONG_CONTEXT_WINDOW,  # noqa: E402
                                      adapt_config, get_shape, has_attention,
                                      input_specs, param_specs)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES  # noqa: E402
from repro_torch.training.tree import flatten  # noqa: E402

PAIRS = [(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def jflat(tree):
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def same_tree(port, ref, where):
    ref = jflat(ref)
    port = flatten(port)
    assert [p for p, _ in port] == [p for p, _ in ref], where
    for (path, t), (_, s) in zip(port, ref):
        assert isinstance(t, torch.Tensor) and t.device.type == "meta", path
        assert tuple(t.shape) == tuple(s.shape), (where, path)
        assert dtype_name(t.dtype) == str(s.dtype), (where, path)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_equal_the_reference(arch, shape):
    cfg, jcfg, sh = get_config(arch), jget(arch), get_shape(shape)
    batch, cache = input_specs(cfg, sh)
    jbatch, jcache = jinput_specs(jcfg, INPUT_SHAPES[shape])
    assert sorted(batch) == sorted(jbatch)
    same_tree(batch, jbatch, (arch, shape, "batch"))
    same_tree(cache, jcache, (arch, shape, "cache"))
    assert "tokens" in batch
    if sh.kind == "train":
        assert cache == {}
    else:
        assert cache, (arch, shape)
    if sh.kind == "decode":
        assert batch["tokens"].shape[1] == 1


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_fp8_cache_and_adapt_config_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    assert LONG_CONTEXT_WINDOW == J_WINDOW == 4096
    for name, sh in INPUT_SHAPES.items():
        a, ja = adapt_config(cfg, sh), jadapt(jcfg, sh)
        assert a.attn_window == ja.attn_window, (arch, name)
        if name == "long_500k" and has_attention(cfg):
            assert a.attn_window == (cfg.attn_window or 4096)
        if sh.kind == "train":
            continue
        _, cache = input_specs(cfg, sh, torch.bfloat16,
                               cache_dtype=torch.float8_e4m3fn)
        _, jcache = jinput_specs(jcfg, sh, jnp.bfloat16,
                                 cache_dtype=jnp.float8_e4m3fn)
        same_tree(cache, jcache, (arch, name, "fp8"))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_equal_the_reference(arch):
    same_tree(param_specs(Model(get_config(arch), dtype=torch.bfloat16,
                                device="meta")),
              JModel(jget(arch), dtype=jnp.bfloat16).param_specs(),
              (arch, "params"))


def test_meta_is_taken_only_by_name():
    from repro_torch.device import resolve_device
    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xla")
