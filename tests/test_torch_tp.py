"""The sharded step's tensor-parallel compute (`repro_torch.distributed.tp`,
`repro_torch.distributed.step`) on one spawned 2 x 2 gloo world on the CPU
whose tensor axis computes: GQA heads, the MLP's hidden dim, experts (E on
the tensor axis, 40 / 2) or their hidden dim (5 experts: the policy's
fallback), the vocabulary, and tied embeddings taking their gradient from
both uses.

Each training case holds the sharded step's gates of
``tests/test_torch_sharded_train.py`` against the unsharded port step
(three steps at lr 1e-4: loss within 1e-5 relative, params within 1e-5,
grad norm within 1e-5 relative), and on every rank, against the unsharded
step on that rank's rows:

  * matmul FLOPs (``mm``/``addmm``/``bmm`` under ``FlopCounterMode``,
    forward and backward) at most 0.6x;
  * bytes saved for backward (one count a storage, parameters excepted) at
    most 0.6x;
  * the gathered parameter bytes alive at once within the largest
    super-block's compute-layout share plus the embedding's and the head's;
  * the gradient the step holds is the local shards (no whole-model
    gradient).

A remat case (the block gathers again in its recompute) holds the parity
and the gathered-bytes bound. The forward cases (a prefill of 12 tokens,
then a decode step) hold the
logits and the cache to the unsharded forward and the same FLOP and
gathered-bytes bounds. The MoE router's decisions are checked equal across
the tensor ranks (``tp.CHECK_REPLICATED``). Rank 0 writes the numbers, the
worst rank's for the bounds, to a JSON file the tests read.
"""
import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

LOSS_TOL = 1e-5          # relative
PARAM_TOL = 1e-5         # absolute, after three steps at lr 1e-4
RATIO = 0.6              # FLOPs and saved bytes, sharded / unsharded
STEPS = 3
BATCH, SEQ = 8, 16

# case -> (arch, config overrides, microbatches)
CASES = {
    "chatglm": ("chatglm3-6b", {}, 1),
    "granite-experts": ("granite-moe-3b-a800m", {"n_experts": 40}, 1),
    "granite-ff": ("granite-moe-3b-a800m", {"n_experts": 5}, 1),
    "granite-mb2": ("granite-moe-3b-a800m", {}, 2),
    "chatglm-tied": ("chatglm3-6b", {"tie_embeddings": True}, 1),
}
# remat: the block gathers again in its recompute (parity and the
# gathered-bytes bound)
REMAT_CASES = {"granite-remat": ("granite-moe-3b-a800m", {}, 1)}
# the other archs (parity): MLA with a dense prefix layer and shared
# experts, Mamba-2 with tied embeddings, Mamba-2 + attention + MoE,
# cross-attention with 4 codebooks, sinusoidal positions and the gelu MLP,
# M-RoPE with vision embeddings. MLA, Mamba-2 and cross-attention compute
# on their heads' shards, so the first four also hold the FLOP, saved-bytes
# and gathered-bytes bounds.
ARCH_CASES = {"deepseek-v2-lite": ("deepseek-v2-lite-16b", {}, 1),
              "mamba2": ("mamba2-370m", {}, 1),
              "jamba": ("jamba-v0.1-52b", {}, 1),
              "musicgen": ("musicgen-medium", {}, 1),
              "qwen2-vl": ("qwen2-vl-7b", {}, 1)}
SHARE_CASES = list(CASES) + ["deepseek-v2-lite", "mamba2", "jamba",
                             "musicgen"]
FORWARD_CASES = {"chatglm-forward": ("chatglm3-6b", {}),
                 "granite-forward": ("granite-moe-3b-a800m", {}),
                 "musicgen-cross-forward": ("musicgen-medium",
                                            {"cross_kv_cache": True}),
                 "mamba2-forward": ("mamba2-370m", {})}
# MLA and the Mamba-2 + attention hybrid over 16 layers (parity, relative)
ARCH_FORWARD_CASES = {"deepseek-v2-lite-forward": ("deepseek-v2-lite-16b",
                                                   {}),
                      "jamba-forward": ("jamba-v0.1-52b", {})}


def _cfg(arch, over):
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    over = dict(over)
    if "n_experts" in over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=over.pop("n_experts")))
    return dataclasses.replace(cfg, **over)


def _batches(cfg):
    from repro_torch.data import DataConfig, data_iterator
    it = data_iterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  batch_size=BATCH, kind="markov",
                                  n_codebooks=cfg.n_codebooks), device="cpu")
    g = torch.Generator().manual_seed(3)
    out = []
    for _ in range(STEPS):
        b = next(it)
        if cfg.cross_attention:
            b["cond_memory"] = torch.randn(BATCH, cfg.n_cond_tokens,
                                           cfg.d_model, generator=g)
        if cfg.frontend == "vision":
            b["vision_embeds"] = torch.randn(BATCH, 4, cfg.d_model,
                                             generator=g)
        out.append(b)
    return out


def _mm_flops(counter) -> int:
    return sum(n for op, n in counter.get_flop_counts()["Global"].items()
               if str(op).rsplit(".", 1)[-1] in ("mm", "addmm", "bmm"))


def _bound(by_path, tied) -> int:
    """The largest block's gathered bytes plus the embedding's and the
    head's (the table twice when it is the head too)."""
    blocks, extra = {}, 0
    for path, nbytes in by_path.items():
        parts = path.split("/")
        if parts[0] in ("blocks", "prefix"):
            key = (parts[0], parts[-1] if parts[0] == "blocks" else parts[1])
            blocks[key] = blocks.get(key, 0) + nbytes
        else:
            extra += nbytes
    if tied:
        extra += by_path.get("embed/table", 0)
    return max(blocks.values()) + extra


def _unsharded_saved(model, params, batch) -> int:
    """Bytes the unsharded loss saves for backward (parameters excepted)."""
    from repro_torch.distributed.tp import Registry
    from repro_torch.training.tree import unflatten, leaves
    tree = unflatten(params, [p.detach().requires_grad_()
                              for p in leaves(params)])
    reg = Registry()
    reg.params = {p.untyped_storage()._cdata for p in leaves(tree)}
    with reg.hooks():
        model.loss(tree, batch)
    return reg.saved


def _worst(rank, numbers):
    import torch.distributed as dist
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, numbers)
    return {k: max(r[k] for r in every) for k in numbers}


def _case(rank, mesh, arch, over, mb, remat=False) -> dict:
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.distributed.step import (
        BatchAxes, init_sharded_opt_state, make_sharded_train_step,
        shard_batch, shard_params)
    from repro_torch.models import Model
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.training.tree import flatten, leaves, unflatten
    cfg = _cfg(arch, over)
    model = Model(cfg, dtype=torch.float32, device="cpu", remat=remat)
    opt_cfg = AdamWConfig(lr=1e-4, warmup_steps=5, total_steps=STEPS)
    params = model.init(torch.Generator().manual_seed(0))
    batches = _batches(cfg)
    policy = ShardingPolicy(mesh)

    sp = shard_params(params, policy)
    so = init_sharded_opt_state(sp)
    step = make_sharded_train_step(model, opt_cfg, policy, microbatches=mb)
    s_losses, s_norms = [], []
    for i, b in enumerate(batches):
        with FlopCounterMode(display=False) as counter:
            sp, so, m = step(sp, so, shard_batch(b, policy))
        if i == 0:
            flops, stats = _mm_flops(counter), dict(step.stats)
        s_losses.append(float(m["loss"]))
        s_norms.append(float(m["grad_norm"]))
    local = sum(p.to_local().numel() * p.to_local().element_size()
                for p in leaves(sp))
    whole = sum(p.numel() * p.element_size() for p in leaves(sp))
    full = [(path, p.full_tensor()) for path, p in flatten(sp)]

    # the unsharded step on this rank's rows (each microbatch's share)
    n = BATCH // mb
    ax = BatchAxes(policy, n)
    rows = {k: torch.cat([ax.local(v[i * n:(i + 1) * n])
                          for i in range(mb)]) for k, v in batches[0].items()}
    copy = unflatten(params, [p.clone() for p in leaves(params)])
    with FlopCounterMode(display=False) as counter:
        make_train_step(model, opt_cfg, microbatches=mb)(
            copy, init_opt_state(copy), rows)
    u_saved = _unsharded_saved(
        model, params, {k: v[:v.shape[0] // mb] for k, v in rows.items()})
    grad_want = local * (2 if mb > 1 else 1)        # + f32 accumulators
    worst = _worst(rank, {
        "flops_ratio": flops / _mm_flops(counter),
        "saved_ratio": stats["saved_bytes"] / u_saved,
        "gathered_over_bound": stats["gathered_bytes"] / _bound(
            stats["gathered_by_path"], cfg.tie_embeddings),
        "grad_bytes_off": abs(stats["grad_bytes"] - grad_want),
        "grad_over_whole": stats["grad_bytes"] / whole})
    if rank != 0:
        return {}

    u_step = make_train_step(model, opt_cfg, microbatches=mb)
    up, uo = params, init_opt_state(params)
    u_losses, u_norms = [], []
    for b in batches:
        up, uo, m = u_step(up, uo, b)
        u_losses.append(float(m["loss"]))
        u_norms.append(float(m["grad_norm"]))
    diff = max(float((p - q).abs().max())
               for (_, p), (_, q) in zip(full, flatten(up)))
    return dict(worst, sharded=s_losses, unsharded=u_losses, s_norms=s_norms,
                u_norms=u_norms, param_diff=diff,
                tensor_placed=policy.param_spec(
                    "blocks/l0/moe/gate", (2, cfg.moe.n_experts, cfg.d_model,
                                           cfg.expert_ff()))
                if cfg.moe else None)


def _forward_case(rank, mesh, arch, over) -> dict:
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.distributed.step import (BatchAxes, make_sharded_forward,
                                              shard_batch, shard_params,
                                              sharded_cache)
    from repro_torch.models import Model
    from repro_torch.training.tree import flatten
    cfg = _cfg(arch, over)
    model = Model(cfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, 12) + books,
                                      generator=g, dtype=torch.int32)}
    if cfg.cross_attention:     # the decode step reads the cross K/V cache
        prompt["cond_memory"] = torch.randn(BATCH, cfg.n_cond_tokens,
                                            cfg.d_model, generator=g)
    step = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, 1) + books,
                                    generator=g, dtype=torch.int32),
            "positions": torch.full((BATCH, 1), 12, dtype=torch.int32)}
    policy = ShardingPolicy(mesh)
    sp = shard_params(params, policy)
    cache = model.init_cache(BATCH, 16)
    sc = sharded_cache(cache, policy)
    prefill = make_sharded_forward(model, policy, -1)
    decode = make_sharded_forward(model, policy, 0)
    with FlopCounterMode(display=False) as counter:
        p_logits, sc = prefill(sp, shard_batch(prompt, policy), sc)
        peak = prefill.stats["gathered_bytes"]
        d_logits, sc = decode(sp, shard_batch(step, policy), sc)
    flops = _mm_flops(counter)
    peak = max(peak, decode.stats["gathered_bytes"])
    by_path = dict(prefill.stats["gathered_by_path"])
    for k, v in decode.stats["gathered_by_path"].items():
        by_path[k] = max(by_path.get(k, 0), v)
    s_cache = [c.full_tensor() for _, c in flatten(sc)]
    s_logits = [p_logits.full_tensor(), d_logits.full_tensor()]

    ax = BatchAxes(policy, BATCH)
    u_cache = model.init_cache(BATCH // ax.size, 16)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.forward(params, {k: ax.local(v) for k, v in prompt.items()},
                      u_cache, logits_at=11)
        model.forward(params, {k: ax.local(v) for k, v in step.items()},
                      u_cache)
    worst = _worst(rank, {"flops_ratio": flops / _mm_flops(counter),
                          "gathered_over_bound": peak / _bound(by_path,
                                                               False)})
    if rank != 0:
        return {}
    with torch.no_grad():
        u1 = model.forward(params, prompt, cache)[0][:, -1]
        u2 = model.forward(params, step, cache)[0][:, 0]
    return dict(
        worst,
        logits_diff=max(float((a - b).abs().max())
                        for a, b in zip(s_logits, (u1, u2))),
        cache_diff=max(float((a.float() - b.float()).abs().max())
                       for a, (_, b) in zip(s_cache, flatten(cache))),
        logits_scale=max(float(b.abs().max()) for b in (u1, u2)),
        cache_scale=max(float(b.float().abs().max())
                        for _, b in flatten(cache)))


def _world(rank, mesh, out_path):
    from repro_torch.distributed import tp
    torch.set_num_threads(1)
    tp.CHECK_REPLICATED = True
    results = {name: _case(rank, mesh, *case) for name, case in CASES.items()}
    results.update({name: _case(rank, mesh, *case, remat=True)
                    for name, case in REMAT_CASES.items()})
    results.update({name: _case(rank, mesh, *case)
                    for name, case in ARCH_CASES.items()})
    results.update({name: _forward_case(rank, mesh, *case)
                    for name, case in {**FORWARD_CASES,
                                       **ARCH_FORWARD_CASES}.items()})
    if rank == 0:
        Path(out_path).write_text(json.dumps(results))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch.launch.mesh import run_debug_world
    out = tmp_path_factory.mktemp("tp") / "results.json"
    run_debug_world(_world, (str(out),), device="cpu")
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", list(CASES) + list(REMAT_CASES) +
                         list(ARCH_CASES))
def test_tensor_parallel_steps_equal_unsharded(world, case):
    r = world[case]
    for s, u in zip(r["sharded"], r["unsharded"]):
        assert abs(s - u) <= LOSS_TOL * abs(u), (case, r)
    assert r["param_diff"] <= PARAM_TOL, (case, r)
    for s, u in zip(r["s_norms"], r["u_norms"]):
        assert abs(s - u) <= 1e-5 * abs(u), (case, r)


@pytest.mark.parametrize("case", SHARE_CASES)
def test_a_rank_computes_and_saves_its_share(world, case):
    r = world[case]
    assert r["flops_ratio"] <= RATIO, (case, r)
    assert r["saved_ratio"] <= RATIO, (case, r)


@pytest.mark.parametrize("case", SHARE_CASES + list(REMAT_CASES))
def test_gathered_bytes_stay_within_a_block(world, case):
    r = world[case]
    assert r["gathered_over_bound"] <= 1.0, (case, r)


@pytest.mark.parametrize("case", list(CASES))
def test_no_whole_model_gradient(world, case):
    r = world[case]
    assert r["grad_bytes_off"] == 0, (case, r)
    assert r["grad_over_whole"] < 1.0, (case, r)


def test_the_moe_cases_cover_both_expert_layouts(world):
    """40 experts go on the tensor axis; 5 fall back to their hidden
    dim."""
    assert world["granite-experts"]["tensor_placed"][1] == "model"
    ff = world["granite-ff"]["tensor_placed"]
    assert ff[1] is None and ff[-1] == "model"


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_tensor_parallel_prefill_and_decode(world, case):
    r = world[case]
    assert r["logits_diff"] <= PARAM_TOL, (case, r)
    assert r["cache_diff"] <= PARAM_TOL, (case, r)
    assert r["flops_ratio"] <= RATIO, (case, r)
    assert r["gathered_over_bound"] <= 1.0, (case, r)


@pytest.mark.parametrize("case", list(ARCH_FORWARD_CASES))
def test_whole_mixers_prefill_and_decode(world, case):
    """MLA reads and writes its latent cache's chunk, the Mamba-2 mixer its
    heads' SSM state (and the conv tail, gathered for the layer): prefill
    and decode equal the unsharded forward, the cache in its placements.
    Relative to the largest value: jamba's 16 layers of f32 scans grow the
    two sides' rounding (1-2 ulps at its first layer, about 1e-5 of values
    near 4 at its last)."""
    r = world[case]
    assert r["logits_diff"] <= PARAM_TOL * r["logits_scale"], (case, r)
    assert r["cache_diff"] <= PARAM_TOL * r["cache_scale"], (case, r)
