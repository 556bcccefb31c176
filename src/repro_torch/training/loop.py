"""Training loop: the train step factory and the host loop, ported from
``repro.training.loop``.

``make_train_step(model, opt_cfg, microbatches)`` gives
``step(params, opt_state, batch) -> (params, opt_state, metrics)``: the
loss and its gradients by autograd through the model's plain path, then one
AdamW update in place (`repro_torch.training.optimizer`). With
``microbatches > 1`` the batch's leading axis splits into that many slices,
run one after another; each slice's gradients are cast to f32, divided by
the count and summed in f32 buffers, as the reference's ``lax.scan`` sums
them. A model with ``use_kernel=True`` is refused: the hand-written kernels
have no backward, and neither have the reference's Pallas kernels.

Where the port departs from a line-by-line copy, and why: the stacked
``blocks`` leaves are handed to the model as lists of per-layer views,
each its own autograd leaf, so each layer's gradient lands in its own
slice (a stacked leaf's ``select`` would add a zero-padded copy of the
whole leaf per layer); the slices are stacked back, a leaf at a time.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)
from repro_torch.training.tree import flatten, unflatten


def make_loss_fn(model: Model) -> Callable:
    def loss_fn(params, batch):
        return model.loss(params, batch)
    return loss_fn


def value_and_grad(loss_fn: Callable, params: Dict, batch: Dict
                   ) -> Tuple[torch.Tensor, Dict]:
    """The loss and its gradients, a tree in the params' layout and dtypes
    (a leaf the loss does not reach gets zeros)."""
    flat = flatten(params)
    inputs = [[p[i].detach().requires_grad_() for i in range(p.shape[0])]
              if path.startswith("blocks/") else [p.detach().requires_grad_()]
              for path, p in flat]
    tree = unflatten(params, [xs if path.startswith("blocks/") else xs[0]
                              for (path, _), xs in zip(flat, inputs)])
    loss = loss_fn(tree, batch)
    grads = list(torch.autograd.grad(loss, [x for xs in inputs for x in xs],
                                     allow_unused=True))
    out = []
    for (path, p), xs in zip(flat, inputs):
        gs = [torch.zeros_like(x) if g is None else g
              for x, g in zip(xs, grads[:len(xs)])]
        del grads[:len(xs)]      # a leaf is held twice only while stacked
        out.append(torch.stack(gs) if path.startswith("blocks/") else gs[0])
    return loss.detach(), unflatten(params, out)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatches: int = 1) -> Callable:
    """microbatches > 1: gradient accumulation — the global batch splits
    into `microbatches` slices processed one after another, dividing peak
    activation memory by the same factor at the cost of `microbatches`
    weight passes. The step updates params and opt_state in place."""
    if model.use_kernel:
        raise ValueError(
            "cannot train a model with use_kernel=True: the hand-written "
            "CUDA kernels have no backward; build the model with "
            "use_kernel=False to train on the plain path")
    loss_fn = make_loss_fn(model)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            sums = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for _, p in flatten(params)]
            loss = 0.0
            for i in range(microbatches):
                mb = {k: _micro(v, i, microbatches) for k, v in batch.items()}
                mloss, g = value_and_grad(loss_fn, params, mb)
                loss = loss + mloss / microbatches
                with torch.no_grad():
                    for acc, (_, gi) in zip(sums, flatten(g)):
                        acc += gi.float() / microbatches
                del g
            grads = unflatten(params, sums)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _micro(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} rows does not split into {n} "
                         "microbatches")
    return x[i * (b // n):(i + 1) * (b // n)]


def train(model: Model, opt_cfg: AdamWConfig, data_iter, n_steps: int,
          params=None, generator: Optional[torch.Generator] = None,
          log_every: int = 10, checkpoint_fn: Optional[Callable] = None,
          checkpoint_every: int = 0) -> Tuple[Any, Dict]:
    """Single-device training loop. Without ``params`` the model is
    initialised from ``generator`` (default: seed 0 on the model's
    device); the params passed in are updated in place."""
    if params is None:
        if generator is None:
            generator = torch.Generator(
                device=resolve_device(model.device)).manual_seed(0)
        params = model.init(generator)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(model, opt_cfg)

    history = []
    t0 = time.perf_counter()
    for step in range(n_steps):
        batch = next(data_iter)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
        if checkpoint_fn and checkpoint_every and \
                (step + 1) % checkpoint_every == 0:
            checkpoint_fn(step + 1, params, opt_state)
    return params, {"history": history,
                    "final_loss": history[-1]["loss"] if history else None}
