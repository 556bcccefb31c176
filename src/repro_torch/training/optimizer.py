"""AdamW + learning-rate schedule, ported from ``repro.training.optimizer``.

The optimizer state mirrors params: ``m`` and ``v`` moments in f32 whatever
the param dtype (the standard mixed-precision recipe), plus an int32 step
counter, all on the params' device. The arithmetic is the reference's, in
f32 on the device with no host sync: the lr is taken at ``step + 1``,
gradients are scaled by ``min(1, clip / (norm + 1e-9))`` over the f32 norm
of every leaf, the bias corrections are ``1 - b ** step``, and a leaf is
decayed when the stored leaf has two or more dimensions, so the stacked
``blocks`` norm scales ``(n_super_blocks, d)`` are decayed as in the
reference.

Where the port departs from a line-by-line copy, and why: `adamw_update`
writes params, ``m`` and ``v`` in place, a slice of rows at a time, so no
f32 copy of a whole leaf is made (one chatglm3-6b MLP leaf of 28 layers is
6.3 GB in f32); the values are the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch

from repro_torch.training.tree import leaves, tree_map

#: the most elements an f32 temporary of the update holds (256 MB)
CHUNK_ELEMENTS = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig,
                step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * lr (f32)."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decay)


def init_opt_state(params: Any) -> Dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_shapes(param_shapes: Any) -> Dict:
    """The state's shapes from the params' shapes (``Model.param_shapes``):
    ``m`` and ``v`` (f32) mirror them, ``step`` (int32) is a scalar."""
    return {"m": tree_map(tuple, param_shapes),
            "v": tree_map(tuple, param_shapes), "step": ()}


def row_chunks(t: torch.Tensor) -> Iterator[Any]:
    """Slices of ``t``'s leading axis of at most `CHUNK_ELEMENTS` elements
    each (at least one row): a stacked leaf goes a layer, or a few, at a
    time. A scalar is one chunk."""
    if t.dim() == 0:
        yield ...
        return
    per_row = max(t[0].numel(), 1)
    rows = max(1, CHUNK_ELEMENTS // per_row)
    for i in range(0, t.shape[0], rows):
        yield slice(i, i + rows)


def global_norm(tree: Any) -> torch.Tensor:
    """The f32 norm of every leaf together."""
    total = None
    for x in leaves(tree):
        s = sum(torch.sum(torch.square(x[sl].float())) for sl in row_chunks(x))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: Dict, grad_norm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, Dict, Dict]:
    """One AdamW step, in place. Returns (params, state, metrics): the
    params and moments passed in, updated, the new step, and the metrics
    ``lr``, ``grad_norm`` and ``step`` as tensors on the device.
    ``grad_norm``: the norm to clip by, where ``grads`` are shards of a
    larger gradient (`repro_torch.distributed.step`); default, theirs."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)

    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        decay = p.dim() >= 2           # matrices only, as stored
        for sl in row_chunks(p):
            g32 = g[sl].float() * scale
            m[sl] = cfg.b1 * m[sl] + (1 - cfg.b1) * g32
            v[sl] = cfg.b2 * v[sl] + (1 - cfg.b2) * g32 * g32
            mh = m[sl] / b1c
            vh = v[sl] / b2c
            delta = mh / (torch.sqrt(vh) + cfg.eps)
            p32 = p[sl].float()
            if decay:
                delta = delta + cfg.weight_decay * p32
            p[sl] = (p32 - lr * delta).to(p.dtype)
    metrics = {"lr": lr, "grad_norm": gnorm, "step": step}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
