"""Sharded training on the reference's 2 x 2 debug mesh: four ranks, one a
card (NCCL), or four gloo processes on the CPU.

    PYTHONPATH=src python scripts/port_sharded_nccl.py [--device cuda|cpu] \
        [--smoke] [--out FILE]

Needs four cards on ``cuda`` (the default); ``--device cpu`` runs the same
on four gloo processes, ``--smoke`` at granite's reduced config (the CPU
rehearsal). Every rank draws the same weights (on the CPU, from seed 0)
and the launcher's markov batches (8 x 64 tokens); rank 0 checks that the
ranks' weights agree before anything runs.

1. f32 parity: granite-moe-3b-a800m at full width and 2 MoE layers, three
   sharded steps (`make_sharded_train_step`) against three unsharded steps
   on rank 0 (`make_train_step`), at lr 1e-4 with 5 warmup steps (the
   gate of ``tests/test_torch_sharded_train.py``), for the default layout
   (batch over "data", 2-D weights) and ``tensor_enabled=False`` (batch
   over both axes through a flattened process group). Each loss within
   1e-5 relative, the params within 1e-5, params and moments in the
   policy's placements; the MoE's capacity factor is 0.5, so tokens drop.
   The same for deepseek-v2-lite-16b (MLA, its heads over the tensor axis)
   and mamba2-370m (the SSD's heads over the tensor axis) at 2 layers, in
   the default layout.
2. bf16 at full depth: granite-moe-3b-a800m's 8 steps at the launcher's
   recipe (lr 1e-3, 5 warmup steps), sharded, with each step synchronised
   and timed and each rank's peak memory; then rank 0 runs the same 8
   steps unsharded, timed, with its peak. Their losses are printed side by
   side (information: in bf16 the cross-rank gradient sum rounds
   otherwise), and so are the matmul FLOPs of step 1 (``mm``, ``addmm``,
   ``bmm`` under ``FlopCounterMode``, forward and backward; step 1 is not
   in the median): each rank's sharded step, the unsharded step on the
   whole batch, and that divided by the batch axes' size (the unsharded
   step on a rank's rows).

Rank 0 prints one JSON line a part and, last, ``{"ok": ...}``; the script
exits non-zero if a gate fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, data_iterator
from repro_torch.distributed import ShardingPolicy
from repro_torch.distributed.step import (full_tree, init_sharded_opt_state,
                                          make_sharded_train_step,
                                          placements_of, shard_batch,
                                          shard_params)
from repro_torch.launch.mesh import run_debug_world
from repro_torch.models import Model
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training.tree import leaves, tree_map

ARCH = "granite-moe-3b-a800m"
BATCH, SEQ = 8, 64
PARITY = dict(layers=2, steps=3, lr=1e-4, capacity_factor=0.5, tol=1e-5)
# (arch, tensor_enabled) of each f32 parity case
PARITY_CASES = ((ARCH, True), (ARCH, False),
                ("deepseek-v2-lite-16b", True), ("mamba2-370m", True))
BF16 = dict(steps=8, lr=1e-3)


def _device(mesh, rank: int) -> torch.device:
    return (torch.device("cuda", rank) if mesh.device_type == "cuda"
            else torch.device("cpu"))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _setup(cfg, dtype, dev, lr: float, steps: int):
    """A plain-path model on ``dev``, weights drawn on the CPU from seed 0
    (alike on every rank), the launcher's batches and optimizer."""
    params = Model(cfg, dtype=dtype, device="cpu").init(
        torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.to(dev), params)
    it = data_iterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  batch_size=BATCH, kind="markov",
                                  n_codebooks=cfg.n_codebooks), device=dev)
    batches = [next(it) for _ in range(steps)]
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=5, total_steps=steps)
    return Model(cfg, dtype=dtype, device=dev), params, batches, opt_cfg


def _same_on_every_rank(params) -> bool:
    total = torch.stack([t.double().sum() for t in leaves(params)]).sum()
    every = [torch.empty_like(total) for _ in range(dist.get_world_size())]
    dist.all_gather(every, total)
    return all(bool(x == every[0]) for x in every)


def _parity_cfg(arch: str, smoke: bool):
    base = get_config(arch).reduced() if smoke else get_config(arch)
    cfg = dataclasses.replace(base, n_layers=PARITY["layers"])
    if arch == ARCH:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            base.moe, capacity_factor=PARITY["capacity_factor"]))
    return cfg


def parity(rank: int, mesh, smoke: bool) -> List[Dict]:
    dev = _device(mesh, rank)
    out = []
    for arch, tensor in PARITY_CASES:
        cfg = _parity_cfg(arch, smoke)
        model, params, batches, opt_cfg = _setup(
            cfg, torch.float32, dev, PARITY["lr"], PARITY["steps"])
        agree = _same_on_every_rank(params)
        policy = ShardingPolicy(mesh, tensor_enabled=tensor)
        sp = shard_params(params, policy)
        so = init_sharded_opt_state(sp)
        step = make_sharded_train_step(model, opt_cfg, policy)
        s_loss = []
        for b in batches:
            sp, so, m = step(sp, so, shard_batch(b, policy))
            s_loss.append(float(m["loss"]))
        want = policy.param_shardings(params)
        held = (placements_of(sp) == want and placements_of(so["m"]) == want
                and placements_of(so["v"]) == want)
        whole = full_tree(sp)
        if rank == 0:
            u_step = make_train_step(model, opt_cfg)
            up, uo = params, init_opt_state(params)
            u_loss = []
            for b in batches:
                up, uo, m = u_step(up, uo, b)
                u_loss.append(float(m["loss"]))
            diff = max(float((a - b).abs().max())
                       for a, b in zip(leaves(whole), leaves(up)))
            out.append(dict(
                part="parity-f32", arch=cfg.name, tensor_enabled=tensor,
                batch_axes=policy.batch_axes(BATCH), layers=cfg.n_layers,
                weights_agree=agree, sharded_losses=s_loss,
                unsharded_losses=u_loss,
                loss_rel_diff=max(abs(a - b) / abs(b)
                                  for a, b in zip(s_loss, u_loss)),
                param_max_diff=diff, placements_held=held))
        del sp, so, whole, params, model
    return out


def _mm_flops(counter) -> int:
    return sum(n for op, n in counter.get_flop_counts()["Global"].items()
               if str(op).rsplit(".", 1)[-1] in ("mm", "addmm", "bmm"))


def _timed(step, state, batches, dev):
    """Run ``step`` over the batches, each synchronised and timed; step 1
    under a FLOP counter. Returns the state, losses, ms and step 1's matmul
    FLOPs."""
    losses, ms, flops = [], [], 0
    for i, b in enumerate(batches):
        _sync(dev)
        t = time.perf_counter()
        if i == 0:
            with FlopCounterMode(display=False) as counter:
                state = step(*state, b)
            flops = _mm_flops(counter)
        else:
            state = step(*state, b)
        _sync(dev)
        ms.append(1e3 * (time.perf_counter() - t))
        losses.append(float(state[2]["loss"]))
    return state, losses, ms, flops


def bf16_run(rank: int, mesh, smoke: bool) -> Dict:
    dev = _device(mesh, rank)
    cfg = get_config(ARCH).reduced() if smoke else get_config(ARCH)
    model, params, batches, opt_cfg = _setup(
        cfg, torch.bfloat16, dev, BF16["lr"], BF16["steps"])
    policy = ShardingPolicy(mesh)
    sp = shard_params(params, policy)
    so = init_sharded_opt_state(sp)
    step = make_sharded_train_step(model, opt_cfg, policy)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    (sp, so, _), s_loss, step_ms, flops = _timed(
        lambda p, o, m, b: step(p, o, shard_batch(b, policy)),
        (sp, so, {}), batches, dev)
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    flops_by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(flops_by_rank, flops)
    n_batch = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                        for a in _axes(policy.batch_axes(BATCH)))
    rec = {}
    if rank == 0:
        del sp, so
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        u_step = make_train_step(model, opt_cfg)
        up, uo = params, init_opt_state(params)
        _, u_loss, u_ms, u_flops = _timed(
            lambda p, o, m, b: u_step(p, o, b), (up, uo, {}), batches, dev)
        u_peak = (torch.cuda.max_memory_allocated(dev) / 1e9
                  if dev.type == "cuda" else None)
        rec = dict(part="train-bf16", arch=cfg.name, layers=cfg.n_layers,
                   steps=BF16["steps"], batch=BATCH, seq=SEQ,
                   sharded_step_ms=step_ms,
                   sharded_step_ms_median_2_8=float(np.median(step_ms[1:])),
                   unsharded_step_ms=u_ms,
                   unsharded_step_ms_median_2_8=float(np.median(u_ms[1:])),
                   sharded_peak_gb_by_rank=peaks, unsharded_peak_gb=u_peak,
                   sharded_mm_flops_by_rank=flops_by_rank,
                   unsharded_mm_flops=u_flops,
                   unsharded_mm_flops_per_batch_rank=u_flops / n_batch,
                   sharded_over_unsharded_rows=max(flops_by_rank) / (
                       u_flops / n_batch),
                   sharded_losses=s_loss, unsharded_losses=u_loss,
                   finite=all(np.isfinite(s_loss + u_loss)))
    dist.barrier()
    return rec


def _axes(axes) -> tuple:
    return () if axes is None else (axes if isinstance(axes, tuple)
                                    else (axes,))


def _world(rank: int, mesh, smoke: bool, out: str) -> None:
    if mesh.device_type != "cuda":
        torch.set_num_threads(2)
    t0 = time.perf_counter()
    records = parity(rank, mesh, smoke)
    records.append(bf16_run(rank, mesh, smoke))
    if rank != 0:
        return
    bad = [r for r in records[:-1]
           if not (r["weights_agree"] and r["placements_held"]
                   and r["loss_rel_diff"] <= PARITY["tol"]
                   and r["param_max_diff"] <= PARITY["tol"])]
    if not records[-1]["finite"]:
        bad.append(records[-1])
    device = (torch.cuda.get_device_name(0) if mesh.device_type == "cuda"
              else "cpu")
    verdict = dict(ok=not bad, device=device, ranks=dist.get_world_size(),
                   mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                   wall_s=time.perf_counter() - t0)
    lines = [json.dumps(r) for r in records] + [json.dumps(verdict)]
    print("\n".join(lines), flush=True)
    if out:
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="granite's reduced config")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    run_debug_world(_world, (args.smoke, args.out), device=args.device)
    if args.out:
        with open(args.out) as f:
            verdict = json.loads(f.read().splitlines()[-1])
        return 0 if verdict["ok"] else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
