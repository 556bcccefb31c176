"""The sharded train step (`repro_torch.distributed.step`) on spawned 2 x 2
gloo worlds on the CPU: three sharded steps equal three unsharded port
steps on the same weights and batches (loss within 1e-5 relative, params
within 1e-5), and params and moments stay in the policy's placements.

The reference's own sharded run fails on this CPU (F2,
``tests/test_distributed.py::test_real_spmd_execution_small_mesh``), so the
port is held to itself. One world runs every case (a world costs four
process starts) and rank 0 writes each case's numbers to a JSON file that
the tests read. The MoE cases show the global batch's semantics: with a
capacity factor of 0.5 at most half the token-expert assignments fit, so
tokens drop, and which ones depends on the whole batch's (expert, token)
order, which a rank-local dispatch would not keep.

The steps run at lr 1e-4 (5 warmup steps). An Adam step moves an element
whose gradient lies below its rounding noise (near eps, 1e-8, or zero in
exact arithmetic, as chatglm's key bias: a softmax ignores a shift common
to all keys) by up to the lr, in the direction of that noise. The sharded
step sums gradients across ranks in another order, so such elements move
apart by up to twice the lr a step: at the launcher's lr of 1e-3 the two
runs' params were 2.6e-5 apart after three steps (chatglm's ``wk/b``;
yi-34b's embedding 1.6e-5), while loss and grad norm agreed to 1e-7. At
1e-4 the 1e-5 gate sits above that noise and below the 1.2e-4 the three
steps move an element.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5          # relative
PARAM_TOL = 1e-5         # absolute, after three steps
STEPS = 3
BATCH, SEQ = 8, 16

# case -> (arch, capacity factor or None, tensor_enabled, microbatches)
CASES = {
    "granite-dp2": ("granite-moe-3b-a800m", 0.5, True, 1),
    "granite-dp4": ("granite-moe-3b-a800m", 0.5, False, 1),
    "granite-cf125": ("granite-moe-3b-a800m", None, True, 1),
    "granite-mb2": ("granite-moe-3b-a800m", 0.5, True, 2),
    "chatglm-dense": ("chatglm3-6b", None, True, 1),
    "mamba2-no-tp": ("mamba2-370m", None, False, 1),
}


def _cfg(arch, cf):
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    if cf is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def _batches(cfg):
    from repro_torch.data import DataConfig, data_iterator
    it = data_iterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  batch_size=BATCH, kind="markov",
                                  n_codebooks=cfg.n_codebooks), device="cpu")
    return [next(it) for _ in range(STEPS)]


def _case(rank, mesh, arch, cf, tensor, mb) -> dict:
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.distributed.step import (
        init_sharded_opt_state, make_sharded_train_step, placements_of,
        shard_batch, shard_params)
    from repro_torch.models import Model
    from repro_torch.models.moe import capacity
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.training.tree import flatten
    cfg = _cfg(arch, cf)
    model = Model(cfg, dtype=torch.float32, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-4, warmup_steps=5, total_steps=STEPS)
    params = model.init(torch.Generator().manual_seed(0))
    batches = _batches(cfg)
    policy = ShardingPolicy(mesh, tensor_enabled=tensor)

    sp = shard_params(params, policy)
    so = init_sharded_opt_state(sp)
    step = make_sharded_train_step(model, opt_cfg, policy, microbatches=mb)
    s_losses, s_norms = [], []
    for b in batches:
        sp, so, m = step(sp, so, shard_batch(b, policy))
        s_losses.append(float(m["loss"]))
        s_norms.append(float(m["grad_norm"]))
    want = policy.param_shardings(params)
    held = (placements_of(sp) == want and placements_of(so["m"]) == want
            and placements_of(so["v"]) == want
            and tuple(so["step"].placements) == policy.scalar()
            and int(so["step"].full_tensor()) == STEPS)
    full = [(path, p.full_tensor()) for path, p in flatten(sp)]
    local_bytes = sum(p.to_local().numel() for _, p in flatten(sp))
    if rank != 0:
        return {}

    u_step = make_train_step(model, opt_cfg, microbatches=mb)
    up, uo = params, init_opt_state(params)
    u_losses, u_norms = [], []
    with torch.no_grad():
        aux = float(model.forward(params, batches[0])[2])
    for b in batches:
        up, uo, m = u_step(up, uo, b)
        u_losses.append(float(m["loss"]))
        u_norms.append(float(m["grad_norm"]))
    diff = max(float((p - q).abs().max())
               for (_, p), (_, q) in zip(full, flatten(up)))
    out = dict(sharded=s_losses, unsharded=u_losses, s_norms=s_norms,
               u_norms=u_norms, param_diff=diff, placements_held=held,
               aux=aux, batch_axes=policy.batch_axes(BATCH // mb),
               local_elements=local_bytes,
               elements=sum(p.numel() for _, p in flatten(up)))
    if cfg.moe is not None:
        T = BATCH // mb * SEQ
        out["kept_bound"] = (cfg.moe.n_experts * capacity(cfg, T)
                             / (T * cfg.moe.top_k))
    return out


def _forward_case(rank, mesh, arch, cf) -> dict:
    """A sharded prefill of 8 prompts then one decode step
    (`make_sharded_forward`) against the unsharded forward: the logits at
    the read position and every cache leaf."""
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.distributed.step import (make_sharded_forward,
                                              shard_batch, shard_params,
                                              sharded_cache)
    from repro_torch.models import Model
    from repro_torch.training.tree import flatten
    cfg = _cfg(arch, cf)
    model = Model(cfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, 12), generator=g,
                           dtype=torch.int32)
    step = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, 1),
                                    generator=g, dtype=torch.int32),
            "positions": torch.full((BATCH, 1), 12, dtype=torch.int32)}
    policy = ShardingPolicy(mesh)
    sp = shard_params(params, policy)
    cache = model.init_cache(BATCH, 16)
    sc = sharded_cache(cache, policy)
    p_logits, sc = make_sharded_forward(model, policy, -1)(
        sp, shard_batch({"tokens": prompt}, policy), sc)
    d_logits, sc = make_sharded_forward(model, policy, 0)(
        sp, shard_batch(step, policy), sc)
    s_cache = [c.full_tensor() for _, c in flatten(sc)]
    s_logits = [p_logits.full_tensor(), d_logits.full_tensor()]
    if rank != 0:
        return {}
    with torch.no_grad():
        u1 = model.forward(params, {"tokens": prompt}, cache)[0][:, -1]
        u2 = model.forward(params, step, cache)[0][:, 0]
    return dict(
        logits_diff=max(float((a - b).abs().max())
                        for a, b in zip(s_logits, (u1, u2))),
        cache_diff=max(float((a.float() - b.float()).abs().max())
                       for a, (_, b) in zip(s_cache, flatten(cache))),
        logits_placements=[str(p) for p in d_logits.placements])


FORWARD_CASES = {"chatglm-forward": ("chatglm3-6b", None),
                 "granite-forward": ("granite-moe-3b-a800m", 0.5)}


def _world(rank, mesh, out_path):
    torch.set_num_threads(1)
    results = {name: _case(rank, mesh, *case) for name, case in CASES.items()}
    results.update({name: _forward_case(rank, mesh, *case)
                    for name, case in FORWARD_CASES.items()})
    if rank == 0:
        Path(out_path).write_text(json.dumps(results))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch.launch.mesh import run_debug_world
    out = tmp_path_factory.mktemp("sharded") / "results.json"
    run_debug_world(_world, (str(out),), device="cpu")
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_steps_equal_unsharded(world, case):
    r = world[case]
    for s, u in zip(r["sharded"], r["unsharded"]):
        assert abs(s - u) <= LOSS_TOL * abs(u), (case, r)
    assert r["param_diff"] <= PARAM_TOL, (case, r)
    for s, u in zip(r["s_norms"], r["u_norms"]):
        assert abs(s - u) <= 1e-5 * abs(u), (case, r)


@pytest.mark.parametrize("case", list(CASES))
def test_params_and_moments_keep_the_policy_placements(world, case):
    r = world[case]
    assert r["placements_held"], case
    # 2-D weights are sharded: a rank holds less than the whole model
    assert r["local_elements"] < r["elements"], (case, r)


def test_moe_cases_drop_tokens_and_have_an_aux_loss(world):
    for case in ("granite-dp2", "granite-dp4", "granite-mb2"):
        r = world[case]
        assert r["kept_bound"] < 1, (case, r)       # tokens must drop
        assert r["aux"] > 0, (case, r)
    assert world["granite-dp2"]["batch_axes"] == "data"
    assert world["granite-dp4"]["batch_axes"] == ["data", "model"]
    assert world["mamba2-no-tp"]["batch_axes"] == ["data", "model"]


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_sharded_prefill_and_decode_equal_unsharded(world, case):
    """The dry-run's prefill and decode step over DTensors: logits leave
    batch- and vocab-sharded, the cache in its placements, and both equal
    the unsharded forward's."""
    r = world[case]
    assert r["logits_diff"] <= PARAM_TOL, (case, r)
    assert r["cache_diff"] <= PARAM_TOL, (case, r)
    assert r["logits_placements"][0].startswith("S(0)"), r


def test_launcher_mesh_debug_on_the_cpu(tmp_path):
    """``launch/train.py --mesh debug --device cpu --smoke`` runs four gloo
    ranks: rank 0 prints the step lines and writes a checkpoint of full
    tensors that `restore_checkpoint` reads."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.training import restore_checkpoint
    from repro_torch.training.tree import leaves
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-370m", "--smoke", "--steps", "3", "--mesh", "debug",
         "--device", "cpu", "--checkpoint-dir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert [s.split()[1] for s in steps] == ["0", "2"], res.stdout
    path = lines[-1].split("checkpoint: ")[1]
    model = Model(get_config("mamba2-370m").reduced(), device="cpu")
    step, params, _ = restore_checkpoint(path, model.param_shapes(),
                                         device="cpu")
    assert step == 3
    assert all(bool(torch.isfinite(t).all()) for t in leaves(params))


def test_launcher_refuses_a_cuda_world_without_its_cards():
    from repro_torch.launch.mesh import check_cards
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this machine has four cards")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            check_cards(4, "cuda")
    else:
        with pytest.raises(RuntimeError, match="4 ranks needs 4 cards"):
            check_cards(4, "cuda")


def test_the_four_rank_script_on_the_cpu(tmp_path):
    """``scripts/port_sharded_nccl.py --device cpu --smoke``: the four-card
    script's parity gates pass on four gloo processes, granite in both
    layouts, then deepseek-v2-lite (MLA) and mamba2 (the SSD) with the
    tensor axis on."""
    out = tmp_path / "nccl.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "port_sharded_nccl.py"),
         "--device", "cpu", "--smoke", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert records[-1]["ok"] and records[-1]["ranks"] == 4
    parity = [r for r in records if r.get("part") == "parity-f32"]
    assert [(r["arch"], r["tensor_enabled"]) for r in parity] == [
        ("granite-moe-3b-a800m", True), ("granite-moe-3b-a800m", False),
        ("deepseek-v2-lite-16b", True), ("mamba2-370m", True)]
    assert all(r["weights_agree"] for r in parity)
