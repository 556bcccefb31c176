"""Training launcher, ported from ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
        [--smoke] [--steps 20] [--batch 8] [--seq 64] [--lr 1e-3] \
        [--mesh none|debug|single|multi] [--checkpoint-dir DIR] \
        [--device cuda|cpu]

Random weights from seed 0 train on the markov corpus
(`repro_torch.data`): the arch's full config in bf16, or with ``--smoke``
its reduced config in f32; AdamW with ``--lr``, 5 warmup steps and a
cosine decay over ``--steps``. A vision arch gets zero ``vision_embeds``
(B, 4, d) and a cross-attention arch a zero ``cond_memory`` (B,
n_cond_tokens, d), as the reference's launcher feeds them. Every 5th step
(and the last) prints its loss, grad norm, lr and the seconds since the
first step; ``--checkpoint-dir`` saves the final params in the reference's
checkpoint format.

``--mesh none`` runs `repro_torch.training.make_train_step` on one device.
Any other mesh runs `repro_torch.distributed.step.make_sharded_train_step`
over a `ShardingPolicy` on that mesh: ``debug`` is the reference's 2 x 2
("data", "model") mesh, four ranks started here (`run_debug_world`): gloo
processes with ``--device cpu``, NCCL ranks one a card on ``cuda`` (four
cards, or it exits naming the counts); ``single`` (16 x 16) and ``multi``
(2 x 16 x 16) need 256 and 512 ranks started by a launcher that sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
``MASTER_PORT`` (``torchrun``), and exit naming the counts otherwise. Every
rank draws the same weights and batches and keeps its shards; rank 0
prints the step lines and writes the checkpoint, gathered to full tensors.

The model trains on its plain PyTorch path (``use_kernel=False``): the
hand-written kernels have no backward, as the reference's Pallas kernels
have none. ``--device`` defaults to ``cuda`` and raises without a card;
``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.data import DataConfig, data_iterator
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  make_train_step, save_checkpoint)

#: ranks of each production mesh
MESH_RANKS = {"single": 256, "multi": 512}


def _run(args, dev: torch.device, mesh=None, rank: int = 0) -> None:
    """The training loop on one device, or on this rank of ``mesh``."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = Model(cfg, dtype=torch.float32 if args.smoke else torch.bfloat16,
                  device=dev)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps)

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    batch_size=args.batch, kind="markov",
                    n_codebooks=cfg.n_codebooks)
    data = data_iterator(dc, device=dev)

    params = model.init(torch.Generator(device=dev).manual_seed(0))
    if mesh is None:
        opt_state = init_opt_state(params)
        step_fn = make_train_step(model, opt_cfg)

        def place(batch):
            return batch
    else:
        from repro_torch.distributed import ShardingPolicy
        from repro_torch.distributed.step import (init_sharded_opt_state,
                                                  make_sharded_train_step,
                                                  shard_batch, shard_params)
        policy = ShardingPolicy(mesh)
        params = shard_params(params, policy)
        opt_state = init_sharded_opt_state(params)
        step_fn = make_sharded_train_step(model, opt_cfg, policy)

        def place(batch):
            return shard_batch(batch, policy)

    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = next(data)
        if cfg.frontend == "vision":
            batch["vision_embeds"] = torch.zeros(
                (args.batch, 4, cfg.d_model), dtype=model.dtype, device=dev)
        if cfg.cross_attention:
            batch["cond_memory"] = torch.zeros(
                (args.batch, cfg.n_cond_tokens, cfg.d_model),
                dtype=model.dtype, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, place(batch))
        if rank == 0 and (step % 5 == 0 or step == args.steps - 1):
            dt = time.perf_counter() - t0
            print(f"step {step:4d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  {dt:.1f}s", flush=True)

    if args.checkpoint_dir:
        if mesh is not None:
            from repro_torch.distributed.step import full_tree
            params = full_tree(params)
        if rank == 0:
            path = save_checkpoint(args.checkpoint_dir, args.steps, params)
            print("checkpoint:", path, flush=True)


def _debug_rank(rank: int, mesh, args) -> None:
    dev = (torch.device("cuda", rank) if mesh.device_type == "cuda"
           else torch.device("cpu"))
    _run(args, dev, mesh, rank)


def _production(args) -> None:
    """``--mesh single|multi`` under a launcher that started the ranks."""
    from repro_torch.launch.mesh import make_production_mesh
    need = MESH_RANKS[args.mesh]
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != need:
        raise SystemExit(f"--mesh {args.mesh} needs {need} ranks, one a "
                         f"device; this launch has {world} (start {need} "
                         "ranks with torchrun, or use --mesh debug)")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=dev)
        _run(args, dev, mesh, dist.get_rank())
    finally:
        dist.destroy_process_group()


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ASSIGNED_ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config in f32")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="none", choices=["none", "debug",
                                                       "single", "multi"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.mesh == "none":
        _run(args, resolve_device(args.device))
    elif args.mesh == "debug":
        from repro_torch.launch.mesh import check_cards, run_debug_world
        try:
            check_cards(4, args.device)
        except RuntimeError as e:       # no card, or fewer than the ranks
            raise SystemExit(f"--mesh debug: {e}") from e
        run_debug_world(_debug_rank, (args,), device=args.device)
    else:
        _production(args)


if __name__ == "__main__":
    main()
