"""Training launcher: the reference's ``repro.launch.train`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
        [--smoke] [--steps 20] [--batch 8] [--seq 64] [--lr 1e-3] \
        [--checkpoint-dir DIR] [--device cuda|cpu]

Random weights from seed 0 train on the markov corpus
(`repro_torch.data`) through `repro_torch.training.make_train_step`: the
arch's full config in bf16, or with ``--smoke`` its reduced config in f32;
AdamW with ``--lr``, 5 warmup steps and a cosine decay over ``--steps``.
A vision arch gets zero ``vision_embeds`` (B, 4, d) and a cross-attention
arch a zero ``cond_memory`` (B, n_cond_tokens, d), as the reference's
launcher feeds them. Every 5th step (and the last) prints its loss, grad
norm, lr and the seconds since the first step; ``--checkpoint-dir`` saves
the final params in the reference's checkpoint format.

The model trains on its plain PyTorch path (``use_kernel=False``): the
hand-written kernels have no backward, as the reference's Pallas kernels
have none. ``--device`` defaults to ``cuda`` and raises without a card;
``--device cpu`` runs on the CPU. ``--mesh`` other than ``none`` exits
non-zero: the distributed slice (ROADMAP.md, queue 1, item 16) is not
ported yet.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.data import DataConfig, data_iterator
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  make_train_step, save_checkpoint)


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
    if args.mesh != "none":
        raise SystemExit(f"--mesh {args.mesh}: sharded training is not "
                         "ported yet (ROADMAP.md, queue 1, item 16: "
                         "distributed); use --mesh none")

    dev = resolve_device(args.device)
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
    opt_state = init_opt_state(params)
    step_fn = make_train_step(model, opt_cfg)

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
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % 5 == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {step:4d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  {dt:.1f}s", flush=True)

    if args.checkpoint_dir:
        path = save_checkpoint(args.checkpoint_dir, args.steps, params)
        print("checkpoint:", path)


if __name__ == "__main__":
    main()
