"""`repro_torch.convert`: the reference's params become the port's tensors
leaf for leaf, in the reference's layout."""
import numpy as np
import pytest

from _torch_parity import (DENSE_GQA, configs, jax, jnp, params_to_numpy,
                           to_numpy, torch)

from repro.configs import ASSIGNED_ARCHS, get_config as jget  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402


def _leaves_with_paths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("name", ["fixture"] + DENSE_GQA +
                         ["granite-moe-3b-a800m", "mamba2-370m",
                          "jamba-v0.1-52b", "qwen2-vl-7b", "musicgen-medium"])
def test_every_leaf_round_trips(name):
    jc, tc = configs(name)
    jp = to_numpy(JModel(jc, dtype=jnp.float32).init(jax.random.key(3)))
    tp = params_from_jax(jp, tc, device="cpu")
    # the layout the port's model expects, stacked blocks and all
    assert jax.tree.structure(params_to_numpy(tp)) == jax.tree.structure(jp)
    shapes = TModel(tc, device="cpu").param_shapes()
    back = params_to_numpy(tp)
    for (path, ref), (_, got) in zip(_leaves_with_paths(jp),
                                     _leaves_with_paths(back)):
        assert got.dtype == np.float32, path
        np.testing.assert_array_equal(got, ref, err_msg=str(path))
    n_super = tc.n_layers // len(tc.pattern)
    if tc.ssm is not None:        # mamba2: every layer; jamba: l0 of 8
        assert tp["blocks"]["l0"]["ssm"]["A_log"].shape == \
            (n_super, tc.ssm_heads)
        assert shapes["blocks"]["l0"]["ssm"]["in_proj"]["w"] == \
            tuple(tp["blocks"]["l0"]["ssm"]["in_proj"]["w"].shape)
        return
    assert tp["blocks"]["l0"]["attn"]["wq"]["w"].shape == \
        (n_super, tc.d_model, tc.n_heads * tc.hd)
    assert shapes["blocks"]["l0"]["attn"]["wq"]["w"] == \
        tuple(tp["blocks"]["l0"]["attn"]["wq"]["w"].shape)
    if tc.qkv_bias:
        assert tp["blocks"]["l0"]["attn"]["wq"]["b"].shape == \
            (n_super, tc.n_heads * tc.hd)
    if tc.cross_attention:        # musicgen: the cross-attention sublayer
        assert tp["blocks"]["l0"]["cross"]["wk"]["w"].shape == \
            (n_super, tc.d_model, tc.n_heads * tc.hd)
        assert tp["blocks"]["l0"]["ln_x"]["scale"].shape == \
            (n_super, tc.d_model)
    if tc.n_codebooks > 1:        # one embedding table and head a codebook
        assert tp["embed"]["table"].shape == \
            (tc.n_codebooks, tc.padded_vocab, tc.d_model)
        assert tp["lm_head"]["w"].shape == \
            (tc.n_codebooks, tc.d_model, tc.padded_vocab)


def test_bf16_leaves_convert_exactly():
    jc, tc = configs("chatglm3-6b")
    jp = to_numpy(JModel(jc, dtype=jnp.bfloat16).init(jax.random.key(4)))
    tp = params_from_jax(jp, tc, device="cpu", dtype=torch.bfloat16)
    assert tp["embed"]["table"].dtype == torch.bfloat16
    for (path, ref), (_, got) in zip(_leaves_with_paths(jp),
                                     _leaves_with_paths(params_to_numpy(tp))):
        np.testing.assert_array_equal(got, ref.astype(np.float32),
                                      err_msg=str(path))


@pytest.mark.parametrize("name", ["mamba2-370m", "jamba-v0.1-52b"])
def test_bf16_conversion_keeps_the_ssm_f32_leaves(name):
    """``A_log``, ``dt_bias`` and ``D`` stay f32 under ``dtype=bf16``, as
    the reference keeps them in a bf16 model; the other leaves are bf16."""
    jc, tc = configs(name)
    jp = to_numpy(JModel(jc, dtype=jnp.bfloat16).init(jax.random.key(4)))
    tp = params_from_jax(jp, tc, device="cpu", dtype=torch.bfloat16)
    ssm = tp["blocks"]["l0"]["ssm"]
    for k in ("A_log", "dt_bias", "D"):
        assert jp["blocks"]["l0"]["ssm"][k].dtype == np.float32
        assert ssm[k].dtype == torch.float32, k
        np.testing.assert_array_equal(ssm[k].numpy(),
                                      jp["blocks"]["l0"]["ssm"][k])
    assert ssm["in_proj"]["w"].dtype == ssm["conv_w"].dtype == \
        tp["embed"]["table"].dtype == torch.bfloat16


def test_tied_embeddings_have_no_lm_head():
    jc, tc = configs("fixture", tie_embeddings=True)
    jp = to_numpy(JModel(jc, dtype=jnp.float32).init(jax.random.key(5)))
    assert "lm_head" not in jp
    tp = params_from_jax(jp, tc, device="cpu")
    assert "lm_head" not in tp and set(tp) == set(jp)


def test_prefix_list_and_foreign_trees():
    jc, tc = configs("fixture")
    jp = to_numpy(JModel(jc, dtype=jnp.float32).init(jax.random.key(6)))
    assert params_from_jax(jp, tc, device="cpu")["prefix"] == []
    # a tree with a prefix layer the port's config does not have
    bad = dict(jp, prefix=[jp["blocks"]["l0"]])
    with pytest.raises(ValueError, match="entries"):
        params_from_jax(bad, tc, device="cpu")
    # a leaf of another shape
    wq = jp["blocks"]["l0"]["attn"]["wq"]
    bad = jax.tree.map(lambda x: x, jp)
    bad["blocks"]["l0"]["attn"]["wq"] = {"w": wq["w"][:, :, :-1]}
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, tc, device="cpu")
    # a quantized dense dict whose scale is not the weight's (N,) columns
    bad = jax.tree.map(lambda x: x, jp)
    bad["blocks"]["l0"]["attn"]["wq"] = {"qw": wq["w"].astype(np.int8),
                                         "scale": np.ones(4, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, tc, device="cpu")


@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_param_count_matches_the_reference(name):
    """`ArchConfig.param_count` goes through the port's `Model`: same count
    as the reference for every arch, at full size, from shapes alone."""
    assert tget(name).param_count() == jget(name).param_count()
    assert TModel(tget(name)).param_count() == \
        JModel(jget(name)).param_count()
