"""The tensor-parallel mixers of the sharded step (`ssm_forward_tp`,
`mla_forward_tp`, `cross_forward_tp`) on a spawned 2-rank gloo world (the
tensor axis of a 1 x 2 mesh), each held to its whole counterpart
(`ssm_forward`, `mla_forward`, `cross_forward`) on one process.

Every rank draws the same weights and inputs from one seed. A training
case runs the mixer on the rank's d_model shard of the input, its leaves
taken from the policy's at-rest shards, and backpropagates ``sum(y * w)``
over the rank's shard of a fixed ``w``; the output, the input's gradient
and every leaf's gradient (at its at-rest placement) are held to the
whole function's on the same arithmetic. A forward case prefills 12
tokens into a cache in the policy's placements and decodes two tokens;
outputs and the cache (gathered) are held to the whole function's on a
whole cache. Uneven heads (3 over 2 ranks), several SSD groups,
``ssm_split_proj``, absorbed and naive MLA decode and a write to the cross
K/V cache (through `blocks.sublayer_forward`) are covered; the Mamba-2
case runs with `hints.enable()` on and off (the same result). On a 2 x 1
mesh (one tensor rank) every case is bit-equal to the whole function.
Rank 0 writes each case's largest differences to a JSON file the tests
read.
"""
import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

TOL = 1e-5                  # relative to the largest value compared
B, S, W = 4, 12, 16         # rows, prefill tokens, cache slots


def _configs():
    from repro_torch.configs import get_config
    mamba = get_config("mamba2-370m").reduced()
    ssm = dataclasses.replace(mamba.ssm, chunk=8)
    mla = get_config("deepseek-v2-lite-16b").reduced().with_overrides(
        d_model=48, n_heads=3, n_kv_heads=3, moe=None, d_ff=64)
    music = get_config("musicgen-medium").reduced().with_overrides(
        d_model=48, n_heads=3, n_kv_heads=3, head_dim=16, d_ff=64,
        n_cond_tokens=10, cross_kv_cache=True)
    return {
        # 3 heads of one group; 6 heads of 3 groups (ranks split groups);
        # 8 heads of 4 groups (whole groups a rank); split projections
        "ssm-3heads": ("ssm", mamba.with_overrides(d_model=48, ssm=ssm)),
        "ssm-groups": ("ssm", mamba.with_overrides(
            d_model=96, ssm=dataclasses.replace(ssm, n_groups=3))),
        "ssm-whole-groups": ("ssm", mamba.with_overrides(
            d_model=128, ssm=dataclasses.replace(ssm, n_groups=4))),
        "ssm-split": ("ssm", mamba.with_overrides(
            d_model=48, ssm=ssm, ssm_split_proj=True)),
        "mla-3heads": ("mla", mla),
        "mla-4heads": ("mla", mla.with_overrides(n_heads=4, n_kv_heads=4)),
        "mla-naive": ("mla", mla.with_overrides(mla_absorbed=False)),
        "cross": ("cross", music),
    }


def _diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _scale(t) -> float:
    return float(t.float().abs().max()) if t.numel() else 0.0


def _params(kind, cfg):
    from repro_torch.models import attention as attn
    from repro_torch.models import blocks as blk
    from repro_torch.models import ssm as ssm_mod
    g = torch.Generator().manual_seed(0)
    if kind == "ssm":
        return ssm_mod.ssm_init(g, cfg, torch.float32, "cpu")
    if kind == "mla":
        return attn.attn_init(g, cfg, torch.float32, "cpu")
    return blk.sublayer_init(g, cfg, "a", "mlp", torch.float32, "cpu")


def _fns(kind, cfg):
    """(whole(p, x, positions, cache, memory), sharded(p, x, positions,
    cache, memory, tp)) -> y: the mixer (for cross-attention, the whole
    sublayer, whose cache write is the blocks')."""
    from repro_torch.models import attention as attn
    from repro_torch.models import blocks as blk
    from repro_torch.models import ssm as ssm_mod
    if kind == "ssm":
        return (lambda p, x, pos, c, m: ssm_mod.ssm_forward(p, cfg, x, c)[0],
                lambda p, x, pos, c, m, tp: ssm_mod.ssm_forward_tp(
                    p, cfg, x, c, tp)[0])
    if kind == "mla":
        return (lambda p, x, pos, c, m: attn.mla_forward(
                    p, cfg, x, pos, c,
                    absorbed_decode=cfg.mla_absorbed)[0],
                lambda p, x, pos, c, m, tp: attn.mla_forward_tp(
                    p, cfg, x, pos, c, tp,
                    absorbed_decode=cfg.mla_absorbed)[0])

    return (lambda p, x, pos, c, m: blk.sublayer_forward(
                p, cfg, x, pos, "a", c, m, use_kernel=False)[0],
            lambda p, x, pos, c, m, tp: blk.sublayer_forward(
                p, cfg, x, pos, "a", c, m, use_kernel=False, tp=tp)[0])


def _cross_train_fns(cfg):
    from repro_torch.models import attention as attn
    return (lambda p, x, pos, c, m: attn.cross_forward(p["cross"], cfg, x,
                                                       m)[0],
            lambda p, x, pos, c, m, tp: attn.cross_forward_tp(
                p["cross"], cfg, x, m, tp)[0])


def _train(mesh, kind, cfg, whole_fn, tp_fn, x, positions, memory) -> dict:
    """Output, input gradient and leaf gradients of the sharded mixer
    against the whole one."""
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.distributed.step import (BatchAxes, leaf_tree,
                                              local_shard, shard_params,
                                              tensor_parallel)
    from repro_torch.training.tree import flatten, leaves, unflatten
    params = _params(kind, cfg)
    policy = ShardingPolicy(mesh)
    sp = shard_params({"prefix": [params]}, policy)
    tree, inputs = leaf_tree(sp, grad=True)
    ax = BatchAxes(policy, B)
    tp = tensor_parallel(policy, ax)
    tp.registry.params = {t.untyped_storage()._cdata
                          for xs in inputs for t in xs}

    wp = unflatten(params, [t.detach().clone().requires_grad_()
                            for t in leaves(params)])
    xw = x.clone().requires_grad_()
    yw = whole_fn(wp, xw, positions, None, memory)
    w = torch.randn(yw.shape, generator=torch.Generator().manual_seed(9))
    (yw * w).sum().backward()

    own = tp.own(cfg.d_model)
    xs = x[..., own.start:own.stop].clone().requires_grad_()
    with tp.saving():
        ys = tp_fn(tree["prefix"][0], xs, positions, None, memory, tp)
    # each batch-axis rank runs the same rows: the leaves' gradients sum
    # over them, so the loss is scaled as the step scales it
    ((ys * w[..., own.start:own.stop]).sum() / ax.size).backward()

    # (leaves the case does not use have no gradient on either side)
    grads = [(t[0].grad, local_shard(g.grad, mesh, p.placements))
             for (_, p), t, g in zip(flatten(sp), inputs, leaves(wp))
             if g.grad is not None or t[0].grad is not None]
    return dict(
        out=_diff(ys, yw[..., own.start:own.stop]),
        out_scale=_scale(yw),
        x_grad=_diff(xs.grad * ax.size, xw.grad[..., own.start:own.stop]),
        x_grad_scale=_scale(xw.grad),
        w_grad=max(_diff(a, b) for a, b in grads),
        w_grad_scale=max(_scale(b) for _, b in grads),
        out_tensor=ys.detach())


def _forward(mesh, kind, cfg, whole_fn, tp_fn, xs_all, positions,
             memory) -> dict:
    """A prefill then two decode steps against a cache in the policy's
    placements (each rank its rows of the batch), against the whole
    function on a whole cache. The decode steps read the cross K/V cache,
    with no memory."""
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.distributed.step import (BatchAxes, leaf_tree,
                                              shard_params, sharded_cache,
                                              tensor_parallel)
    from torch.distributed.tensor import Shard
    from repro_torch.models.cache import _entry_shapes
    from repro_torch.training.tree import flatten, unflatten
    params = _params(kind, cfg)
    policy = ShardingPolicy(mesh)
    tree, _ = leaf_tree(shard_params({"prefix": [params]}, policy),
                        grad=False)
    ax = BatchAxes(policy, B)
    tp = tensor_parallel(policy, ax)
    mixer = "m" if kind == "ssm" else "a"
    entry = {k: (torch.full(s, -1, dtype=d) if k == "pos"
                 else torch.zeros(s, dtype=d))
             for k, (s, d) in _entry_shapes(cfg, mixer, B, W, torch.float32,
                                            None, None).items()}
    whole = {"prefix": [entry]}
    sc = sharded_cache({"prefix": [{k: v.clone() for k, v in
                                    entry.items()}]}, policy)
    for path, c in flatten(sc):
        pl = c.placements[tp.tensor_dim]
        tp.cache_dims[path.rsplit("/", 1)[-1]] = (
            pl.dim if isinstance(pl, Shard) else None)
    local = unflatten(sc, [c.to_local() for _, c in flatten(sc)])
    own = tp.own(cfg.d_model)
    out, scale = 0.0, 0.0
    n = B // ax.size

    def rows(t, i):                 # batch-axis rank i's rows (a view)
        return None if t is None else t[i * n:(i + 1) * n]
    with torch.no_grad():
        for step, (x, pos) in enumerate(zip(xs_all, positions)):
            mem = memory if step == 0 else None
            # the whole function on each batch-axis rank's rows, as the
            # sharded forward splits them
            yw = [whole_fn(params, rows(x, i), rows(pos, i),
                           {k: rows(v, i) for k, v in entry.items()},
                           rows(mem, i)) for i in range(ax.size)]
            ys = tp_fn(tree["prefix"][0],
                       ax.local(x)[..., own.start:own.stop], ax.local(pos),
                       local["prefix"][0], ax.local(mem)
                       if mem is not None else None, tp)
            yw = yw[ax.index]
            out = max(out, _diff(ys, yw[..., own.start:own.stop]))
            scale = max(scale, _scale(yw))
    cache = max(_diff(c.full_tensor(), b) for (_, c), (_, b) in
                zip(flatten(sc), flatten(whole)))
    return dict(fwd_out=out, fwd_out_scale=scale, cache=cache,
                cache_scale=max(_scale(b) for _, b in flatten(whole)))


def _inputs(cfg):
    g = torch.Generator().manual_seed(5)
    d = cfg.d_model
    x = torch.randn(B, S, d, generator=g)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    steps = [torch.randn(B, 1, d, generator=g) for _ in range(2)]
    step_pos = [torch.full((B, 1), S + i, dtype=torch.int32)
                for i in range(2)]
    memory = torch.randn(B, cfg.n_cond_tokens, d, generator=g)
    return x, pos, [x] + steps, [pos] + step_pos, memory


def _cases(mesh) -> dict:
    from repro_torch.distributed import hints
    out = {}
    for name, (kind, cfg) in _configs().items():
        x, pos, xs_all, pos_all, memory = _inputs(cfg)
        fns = _fns(kind, cfg)
        train_fns = _cross_train_fns(cfg) if kind == "cross" else fns
        r = _train(mesh, kind, cfg, *train_fns, x, pos, memory)
        if kind == "ssm":
            hints.enable()
            try:
                on = _train(mesh, kind, cfg, *fns, x, pos, memory)
            finally:
                hints.disable()
            r["hints_diff"] = _diff(on["out_tensor"], r["out_tensor"])
        r.pop("out_tensor")
        r.update(_forward(mesh, kind, cfg, *fns, xs_all, pos_all, memory))
        out[name] = r
    return out


def _world(rank, mesh, out_path):
    from repro_torch.launch.mesh import make_debug_mesh
    torch.set_num_threads(1)
    results = {"tp2": _cases(mesh),
               "tp1": _cases(make_debug_mesh(2, 1, device="cpu"))}
    if rank == 0:
        Path(out_path).write_text(json.dumps(results))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch.launch.mesh import run_debug_world
    out = tmp_path_factory.mktemp("tp_mixers") / "results.json"
    run_debug_world(_world, (str(out),), n_data=1, n_model=2, device="cpu")
    return json.loads(out.read_text())


CASES = ["ssm-3heads", "ssm-groups", "ssm-whole-groups", "ssm-split",
         "mla-3heads", "mla-4heads", "mla-naive", "cross"]


@pytest.mark.parametrize("case", CASES)
def test_sharded_mixer_output_and_gradients(world, case):
    r = world["tp2"][case]
    assert r["out"] <= TOL * r["out_scale"], (case, r)
    assert r["x_grad"] <= TOL * r["x_grad_scale"], (case, r)
    assert r["w_grad"] <= TOL * r["w_grad_scale"], (case, r)


@pytest.mark.parametrize("case", CASES)
def test_sharded_mixer_prefill_and_decode(world, case):
    r = world["tp2"][case]
    assert r["fwd_out"] <= TOL * r["fwd_out_scale"], (case, r)
    assert r["cache"] <= TOL * r["cache_scale"], (case, r)


@pytest.mark.parametrize("case", CASES)
def test_one_tensor_rank_is_bit_equal(world, case):
    r = world["tp1"][case]
    for key in ("out", "x_grad", "w_grad", "fwd_out", "cache"):
        assert r[key] == 0.0, (case, key, r)


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("ssm")])
def test_hints_change_nothing(world, case):
    assert world["tp2"][case]["hints_diff"] == 0.0
    assert world["tp1"][case]["hints_diff"] == 0.0
