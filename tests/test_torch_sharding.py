"""The port's sharding policy (`repro_torch.distributed.sharding`) against
the reference's (`repro.distributed.sharding`) on shape-only meshes: every
parameter leaf of every assigned arch, the optimizer state, ``auto``, and
the batch, cache and logits specs of the 40 (arch x shape) input pairs, on
the (16, 16) and (2, 16, 16) production meshes; the reference's own policy
cases (``tests/test_distributed.py``); specs as DTensor placements on a
fake-process-group mesh (local shard shapes); and `hints.constrain`."""
import numpy as np
import pytest

import _torch_parity  # noqa: F401,E402  (skips without jax / torch)

import jax  # noqa: E402
import torch  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.distributed.sharding import ShardingPolicy as JPolicy  # noqa: E402
from repro.launch.specs import input_specs as jinput_specs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.distributed import MeshShape, ShardingPolicy  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES  # noqa: E402
from repro_torch.training.tree import flatten  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


class FakeMesh:
    """The reference's shape-only stand-in (tests/test_distributed.py)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, object)


def policies(mesh: str, **kw):
    shape, names = MESHES[mesh]
    return (ShardingPolicy(MeshShape(names, shape), **kw),
            JPolicy(FakeMesh(shape, names), **kw))


def jflat(tree):
    """[(port-style path, leaf, jax path)] in the reference's order."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        out.append(("/".join(keys), leaf, path))
    return out


def jspec(spec) -> tuple:
    return tuple(spec)


# ----------------------------------------------------------------- params

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    cfg = get_config(arch)
    pol, jpol = policies(mesh)
    ref = jflat(JModel(jget(arch)).param_specs())
    port = flatten(Model(cfg).param_shapes())
    assert [p for p, _, _ in ref] == [p for p, _ in port]
    for (path, leaf, jpath), (_, shape) in zip(ref, port):
        assert tuple(leaf.shape) == tuple(shape), path
        want = jspec(jpol.param_spec(jpath, leaf))
        assert pol.param_spec(path, shape) == want, (arch, path, want)
    # the optimizer state: both moments in the params' placements, the
    # step replicated
    opt = pol.opt_state_shardings(Model(cfg).param_shapes())
    assert set(opt) == {"m", "v", "step"}
    named = [pol.named(jspec(jpol.param_spec(jp, leaf)))
             for _, leaf, jp in ref]
    for key in ("m", "v"):
        assert [pl for _, pl in flatten(opt[key])] == named
    assert opt["step"] == (Replicate(),) * len(MESHES[mesh][0])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_auto_equals_the_reference(arch, mesh):
    cfg = get_config(arch)
    shape, names = MESHES[mesh]
    for batch in sorted({s.global_batch for s in INPUT_SHAPES.values()}
                        | {512, 1024}):
        pol = ShardingPolicy.auto(MeshShape(names, shape), cfg, batch)
        jpol = JPolicy.auto(FakeMesh(shape, names), jget(arch), batch)
        assert (pol.tensor_axis, pol.dp_axes) == (jpol.tensor_axis,
                                                  jpol.dp_axes), batch


# ----------------------------------------------------------------- inputs

@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_batch_cache_and_logits_specs_equal_the_reference(arch):
    cfg = get_config(arch)
    for mesh in MESHES:
        for kw in ({}, {"tensor_enabled": False}):
            pol, jpol = policies(mesh, **kw)
            for shape in INPUT_SHAPES.values():
                batch, cache = input_specs(cfg, shape)
                jbatch, jcache = jinput_specs(jget(arch), shape)
                assert sorted(batch) == sorted(jbatch)
                for k, v in batch.items():
                    assert pol.data_spec(k, v) == jspec(
                        jpol.data_spec((jax.tree_util.DictKey(k),),
                                       jbatch[k])), (shape.name, k)
                jc = jflat(jcache)
                pc = flatten(cache)
                assert [p for p, _, _ in jc] == [p for p, _ in pc]
                for (path, leaf, jpath), (_, c) in zip(jc, pc):
                    assert pol.cache_spec(path, c) == jspec(
                        jpol.cache_spec(jpath, leaf)), (shape.name, path)
                B = shape.global_batch
                assert pol.batch_axes(B) == jpol.batch_axes(B)
                for extra in (0, 1):
                    assert pol.logits_spec(B, cfg.vocab_size, extra) == \
                        jspec(jpol.logits_spec(B, cfg.vocab_size, extra))


# ------------------------------------------- the reference's policy cases

def _policy(multi=False):
    return policies("multi" if multi else "single")[0]


@pytest.mark.parametrize("arch", ["qwen2-72b", "mamba2-370m",
                                  "granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b", "jamba-v0.1-52b",
                                  "musicgen-medium"])
def test_param_specs_divisible_everywhere(arch):
    pol = _policy()
    for path, shape in flatten(Model(get_config(arch)).param_shapes()):
        spec = pol.param_spec(path, shape)
        for dim, ax in zip(shape, spec):
            if ax is not None:
                assert dim % pol._size(ax) == 0, (arch, path, shape, spec)
        used = [a for ax in spec if ax is not None
                for a in (ax if isinstance(ax, tuple) else (ax,))]
        assert len(used) == len(set(used)), (arch, path, spec)


def test_moe_experts_shard_on_model_axis():
    pol = _policy()
    shapes = Model(get_config("deepseek-v2-lite-16b")).param_shapes()
    gate = shapes["blocks"]["l0"]["moe"]["gate"]       # (L, E, d, ff)
    assert pol.param_spec("blocks/l0/moe/gate", gate)[1] == "model"


def test_granite_experts_fall_back_to_ff_sharding():
    pol = _policy()
    shapes = Model(get_config("granite-moe-3b-a800m")).param_shapes()
    gate = shapes["blocks"]["l0"]["moe"]["gate"]       # 40 experts
    spec = pol.param_spec("blocks/l0/moe/gate", gate)
    assert spec[1] is None
    assert spec[2] == "data" or spec[3] == "model", spec


def test_batch_axes_divisibility():
    pol = _policy(multi=True)
    assert pol.batch_axes(256) == ("pod", "data")
    assert pol.batch_axes(32) == ("pod", "data")
    assert pol.batch_axes(1) is None
    assert pol.batch_axes(24) == "pod"


def _check_param_spec(d_in, d_out, stacked):
    pol, jpol = policies("single")
    shape = (4, d_in, d_out) if stacked else (d_in, d_out)
    keys = ["blocks", "l0", "attn", "wq"] if stacked else ["lm_head", "w"]
    spec = pol.param_spec("/".join(keys), shape)
    for dim, ax in zip(shape, spec):
        if ax is not None:
            assert dim % pol._size(ax) == 0
    jpath = tuple(jax.tree_util.DictKey(k) for k in keys)
    assert spec == jspec(jpol.param_spec(
        jpath, jax.ShapeDtypeStruct(shape, "float32")))


def _check_batch_axes(batch):
    pol, jpol = policies("multi")
    axes = pol.batch_axes(batch)
    assert axes == jpol.batch_axes(batch)
    if axes is not None:
        assert batch % pol._size(axes) == 0 and batch >= pol._size(axes)


@given(d_in=st.integers(8, 4096), d_out=st.integers(8, 4096),
       stacked=st.booleans())
@settings(max_examples=150, deadline=None)
def test_param_spec_divisibility_property(d_in, d_out, stacked):
    _check_param_spec(d_in, d_out, stacked)


@given(batch=st.integers(1, 1024))
@settings(max_examples=100, deadline=None)
def test_batch_axes_divisibility_property(batch):
    _check_batch_axes(batch)


@pytest.mark.parametrize("stacked", [False, True])
def test_param_spec_divisibility_grid(stacked):
    """The property above on a fixed grid (it runs without hypothesis)."""
    dims = [8, 12, 16, 24, 40, 48, 100, 128, 250, 256, 1000, 1536, 4095,
            4096]
    for d_in in dims:
        for d_out in dims:
            _check_param_spec(d_in, d_out, stacked)


def test_batch_axes_divisibility_grid():
    for batch in range(1, 1025):
        _check_batch_axes(batch)


# ----------------------------------------------------- specs as placements

def test_named_maps_specs_to_placements():
    pol = _policy(multi=True)
    assert pol.named((("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert pol.named((None, "data")) == (Replicate(), Shard(1), Replicate())
    assert pol.named(()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        pol.named((("data", "pod"),))


@pytest.fixture(params=[("single", 0), ("single", 255), ("multi", 0),
                        ("multi", 511)], ids=lambda p: f"{p[0]}-{p[1]}")
def fake_mesh(request):
    """A production DeviceMesh over a fake process group, as one of its
    ranks (torn down after the test)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh
    kind, rank = request.param
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=512 if kind == "multi" else 256)
    try:
        yield make_production_mesh(multi_pod=kind == "multi", device="cpu")
    finally:
        dist.destroy_process_group()


def _local_shape(pol, spec, shape):
    return tuple(d // (pol._size(ax) if ax is not None else 1)
                 for d, ax in zip(shape, spec))


def test_local_shards_are_the_global_shape_over_the_axis_sizes(fake_mesh):
    from repro_torch.distributed.step import to_dtensor
    pol = ShardingPolicy(fake_mesh)
    n = 0
    for arch in ("chatglm3-6b", "granite-moe-3b-a800m", "musicgen-medium"):
        cfg = get_config(arch)
        trees = [(pol.param_spec, Model(cfg).param_shapes())]
        for shape in INPUT_SHAPES.values():
            batch, cache = input_specs(cfg, shape)
            trees += [(pol.data_spec, batch), (pol.cache_spec, cache)]
        for spec_of, tree in trees:
            for path, leaf in flatten(tree):
                shape = tuple(leaf.shape) if hasattr(leaf, "shape") else leaf
                spec = spec_of(path, shape)
                full = torch.empty(shape, device="meta")
                d = to_dtensor(full, fake_mesh, pol.named(spec))
                assert tuple(d.shape) == shape
                assert tuple(d.to_local().shape) == _local_shape(
                    pol, spec, shape), (arch, path, spec)
                n += 1
    assert n > 50


def test_a_tuple_axis_splits_outer_axis_major(fake_mesh):
    """("pod", "data") on dim 0: rank (p, d, m) holds block p * 16 + d, the
    order of the reference's PartitionSpec."""
    from repro_torch.distributed.step import local_shard
    pol = ShardingPolicy(fake_mesh)
    if "pod" not in pol.axis_sizes:
        pytest.skip("single-pod mesh")
    full = torch.arange(64)
    p, d, _ = fake_mesh.get_coordinate()
    local = local_shard(full, fake_mesh, pol.named((("pod", "data"),)))
    assert local.tolist() == [2 * (p * 16 + d), 2 * (p * 16 + d) + 1]


def test_hints_constrain(fake_mesh):
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import hints
    pol = ShardingPolicy(fake_mesh)
    rep = (Replicate(),) * len(pol.axis_sizes)
    x = DTensor.from_local(torch.empty((2, 8, 32, 64), device="meta"),
                           fake_mesh, rep)
    odd = DTensor.from_local(torch.empty((2, 8, 24, 64), device="meta"),
                             fake_mesh, rep)
    plain = torch.empty((2, 8, 32, 64))
    dims = (None, None, "tensor", None)
    assert not hints.enabled()
    assert hints.constrain(x, dims, divisible_dim=2) is x     # off
    hints.enable()
    try:
        assert hints.enabled()
        y = hints.constrain(x, dims, divisible_dim=2)
        model = list(pol.axis_sizes).index("model")
        assert y.placements[model] == Shard(2)
        assert all(pl == Replicate() for i, pl in enumerate(y.placements)
                   if i != model)
        assert tuple(y.to_local().shape) == (2, 8, 2, 64)
        assert hints.constrain(odd, dims, divisible_dim=2) is odd
        assert hints.constrain(plain, dims, divisible_dim=2) is plain
    finally:
        hints.disable()
    assert not hints.enabled()
