"""The sharded train step and forward: the port's counterpart of
``jax.jit(step, in_shardings=..., out_shardings=...)`` over a
`ShardingPolicy` (``src/repro/launch/train.py`` and ``launch/dryrun.py`` of
the reference).

Parameters and AdamW moments are DTensors in the policy's placements
(`shard_params`, `init_sharded_opt_state`); a batch is DTensors in its
``data_spec`` placements (`shard_batch`). The step keeps the boundary's
contract and computes between them as follows:

1. every parameter leaf is all-gathered (``Shard -> Replicate``) to a
   plain tensor;
2. each rank runs the port's plain-path loss and gradients
   (`repro_torch.training.loop.value_and_grad`) on its own rows of the
   batch, the rows of its coordinate on the batch axes; the MoE FFN gets
   the batch axes' process group, so its capacity, slots and aux loss stay
   those of the whole batch (`repro_torch.models.moe`);
3. the gradients, ``Partial(sum)`` over the batch axes (each rank's loss
   scaled by 1 / the batch axes' size: the global loss is the mean of
   equal local token means), are reduce-scattered to each parameter's
   placements, explicitly: DTensor's propagation is not left to choose the
   layout;
4. the gradient norm is the square root of one all-reduced sum of local
   squared sums, each element counted once (a leaf replicated over a mesh
   dim counts only on that dim's coordinate 0), and AdamW
   (`repro_torch.training.optimizer.adamw_update`) updates each local
   shard in place with it.

Ranks along the tensor axis therefore compute the same rows: the tensor
axis shards storage, not compute (ROADMAP.md §3, F13). Sharding changes no
result: a sharded step equals the unsharded port step to f32 rounding.
Metrics (``loss``, ``grad_norm``, ``lr``, ``step``) come back as plain
tensors, equal on every rank.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.models.model import Model
from repro_torch.training.loop import value_and_grad
from repro_torch.training.optimizer import AdamWConfig, adamw_update
from repro_torch.training.tree import flatten, leaves, unflatten


# ------------------------------------------------------------------ layouts

def local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placements`` (mesh dims in
    order, so a dim sharded on two mesh dims splits outer dim major). A
    view where the layout allows; no communication."""
    coord = mesh.get_coordinate()
    out = full
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            out = out.tensor_split(mesh.size(i), dim=pl.dim)[coord[i]]
    return out


def to_dtensor(full: torch.Tensor, mesh, placements) -> DTensor:
    """``full``, which every rank holds alike, as a DTensor in
    ``placements``: each rank keeps a copy of its own shard, so the full
    tensor can be freed (and is never written through the DTensor)."""
    return DTensor.from_local(
        local_shard(full, mesh, placements).clone(
            memory_format=torch.contiguous_format), mesh,
        tuple(placements), run_check=False, shape=full.shape,
        stride=full.stride())


def shard_params(params: Any, policy: ShardingPolicy) -> Any:
    """A params tree (the same full tensors on every rank) as DTensors in
    the policy's placements."""
    return unflatten(params, [
        to_dtensor(p, policy.mesh, policy.named(policy.param_spec(path, p)))
        for path, p in flatten(params)])


def init_sharded_opt_state(params: Any) -> Dict:
    """AdamW's state for sharded params: f32 moments in each param's
    placements (zero shards) and a replicated int32 step."""
    def zeros(p: DTensor) -> DTensor:
        return DTensor.from_local(
            torch.zeros(p.to_local().shape, dtype=torch.float32,
                        device=p.to_local().device), p.device_mesh,
            p.placements, run_check=False, shape=p.shape, stride=p.stride())

    mesh = leaves(params)[0].device_mesh
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].to_local().device)
    return {"m": unflatten(params, [zeros(p) for p in leaves(params)]),
            "v": unflatten(params, [zeros(p) for p in leaves(params)]),
            "step": DTensor.from_local(step, mesh,
                                       (Replicate(),) * mesh.ndim,
                                       run_check=False)}


def shard_batch(batch: Dict, policy: ShardingPolicy) -> Dict:
    """A batch (the same global tensors on every rank) as DTensors in the
    policy's ``data_spec`` placements."""
    return {k: to_dtensor(v, policy.mesh,
                          policy.named(policy.data_spec(k, v)))
            for k, v in batch.items()}


def gather(x: DTensor) -> torch.Tensor:
    """The whole of ``x`` as a plain tensor on every rank."""
    return x.redistribute(x.device_mesh,
                          (Replicate(),) * x.device_mesh.ndim).to_local()


def full_tree(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` gathered (`gather`)."""
    return unflatten(tree, [gather(x) for x in leaves(tree)])


# ------------------------------------------------------------------ batch axes

class BatchAxes:
    """The mesh dims that split a batch of ``rows`` rows, this rank's share
    of the rows, and the process group of the ranks that split them (None
    when the batch replicates)."""

    def __init__(self, policy: ShardingPolicy, rows: int):
        mesh = policy.mesh
        axes = policy.batch_axes(rows)
        self.names = () if axes is None else (
            axes if isinstance(axes, tuple) else (axes,))
        names = list(policy.axis_sizes)
        self.dims = [names.index(a) for a in self.names]
        self.size = math.prod(mesh.size(i) for i in self.dims)
        coord = mesh.get_coordinate()
        self.index = 0
        for i in self.dims:             # rank order: outer axis major
            self.index = self.index * mesh.size(i) + coord[i]
        self.group = None
        if len(self.dims) == 1:
            self.group = mesh.get_group(self.dims[0])
        elif self.dims:
            self.group = mesh[tuple(self.names)]._flatten().get_group()
        self.rows = rows // self.size
        self.partial = tuple(Partial() if i in self.dims else Replicate()
                             for i in range(mesh.ndim))

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor every rank holds whole."""
        return x[self.index * self.rows:(self.index + 1) * self.rows]

    def rows_only(self, placements) -> tuple:
        """``placements`` with only the batch axes' dims kept sharded."""
        return tuple(pl if i in self.dims else Replicate()
                     for i, pl in enumerate(placements))

    def rows_of(self, x: DTensor) -> torch.Tensor:
        """This rank's rows of a DTensor whose batch dim is split on the
        batch axes (its other sharded dims gathered), as a plain tensor."""
        return x.redistribute(x.device_mesh,
                              self.rows_only(x.placements)).to_local()


# ------------------------------------------------------------------ the step

def _norm_share(local: torch.Tensor, placements, coord) -> torch.Tensor:
    """This rank's part of a leaf's squared sum: its shard's, or zero where
    a mesh dim replicates the leaf and this rank is not its coordinate 0."""
    if any(isinstance(pl, Replicate) and c != 0
           for pl, c in zip(placements, coord)):
        return torch.zeros((), dtype=torch.float32, device=local.device)
    return torch.sum(torch.square(local.float()))


def sharded_grad_norm(grads: List[torch.Tensor], placements: List[tuple],
                      mesh) -> torch.Tensor:
    """The f32 norm of the whole gradient from local shards: one
    all-reduce of the local squared sums, each element counted once."""
    coord = mesh.get_coordinate()
    total = sum(_norm_share(g, pl, coord) for g, pl in zip(grads, placements))
    dist.all_reduce(total)
    return torch.sqrt(total)


def make_sharded_train_step(model: Model, opt_cfg: AdamWConfig,
                            policy: ShardingPolicy,
                            microbatches: int = 1) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    over DTensor params, moments and batch (module docstring); params and
    moments are updated in place. ``microbatches > 1`` splits the global
    batch into that many slices, run one after another with the gradients
    summed in f32 as `repro_torch.training.make_train_step` sums them; each
    slice is the global one, split over the batch axes, so the MoE FFN
    drops the tokens the unsharded step drops."""
    if model.use_kernel:
        raise ValueError("cannot train a model with use_kernel=True: the "
                         "hand-written CUDA kernels have no backward")
    mesh = policy.mesh

    def step(params, opt_state, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % microbatches:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{microbatches} microbatches")
        ax = BatchAxes(policy, rows // microbatches)

        def loss_fn(tree, b):
            return model.loss(tree, b, dp=ax.group) / ax.size

        flat = flatten(params)
        full = unflatten(params, [gather(p) for _, p in flat])
        if microbatches == 1:
            loss, grads = value_and_grad(
                loss_fn, full, {k: ax.rows_of(v) for k, v in batch.items()})
            grads = leaves(grads)
        else:
            whole = {k: gather(v) for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.to_local().device)
                     for _, p in flat]
            loss = 0.0
            n = rows // microbatches
            for i in range(microbatches):
                mb = {k: ax.local(v[i * n:(i + 1) * n])
                      for k, v in whole.items()}
                mloss, g = value_and_grad(loss_fn, full, mb)
                loss = loss + mloss / microbatches
                with torch.no_grad():
                    for acc, gi in zip(grads, leaves(g)):
                        acc += gi.float() / microbatches
                del g
        del full

        # gradients to the params' placements; AdamW on the local shards
        placements = [p.placements for _, p in flat]
        local_grads = [
            DTensor.from_local(g, mesh, ax.partial, run_check=False)
            .redistribute(mesh, pl).to_local()
            for g, pl in zip(grads, placements)]
        del grads
        gnorm = sharded_grad_norm(local_grads, placements, mesh)

        def local(tree):
            return unflatten(tree, [x.to_local() for x in leaves(tree)])

        state = {"m": local(opt_state["m"]), "v": local(opt_state["v"]),
                 "step": opt_state["step"].to_local()}
        _, new_state, metrics = adamw_update(
            opt_cfg, local(params), unflatten(params, local_grads), state,
            grad_norm=gnorm)
        loss = loss.detach().clone()
        if ax.group is not None:
            dist.all_reduce(loss, group=ax.group)
        metrics["loss"] = loss
        opt_state = {"m": opt_state["m"], "v": opt_state["v"],
                     "step": DTensor.from_local(
                         new_state["step"], mesh, (Replicate(),) * mesh.ndim,
                         run_check=False)}
        return params, opt_state, metrics

    return step


# ------------------------------------------------------------------ forward

def make_sharded_forward(model: Model, policy: ShardingPolicy,
                         position: int) -> Callable:
    """``fwd(params, batch, cache) -> (logits, cache)`` over DTensors: the
    prefill (``position=-1``) or decode (``position=0``) step of the
    reference's dry-run. Each rank gathers the params and runs the plain
    forward on its rows of the batch and of the cache (tensor-sharded cache
    dims gathered); the logits at ``position`` leave in the policy's
    ``logits_spec`` placements and the cache in its ``cache_spec`` ones
    (each rank keeps its shard of what it wrote)."""
    mesh, cfg = policy.mesh, model.cfg

    @torch.no_grad()
    def fwd(params, batch, cache):
        rows = batch["tokens"].shape[0]
        ax = BatchAxes(policy, rows)
        local_cache = unflatten(cache, [ax.rows_of(c)
                                        for c in leaves(cache)])
        logits, local_cache, _ = model.forward(
            full_tree(params), {k: ax.rows_of(v) for k, v in batch.items()},
            local_cache, dp=ax.group)
        logits = logits[:, position]
        spec = policy.logits_spec(rows, cfg.vocab_size,
                                  extra_dims=logits.dim() - 2)
        out = DTensor.from_local(
            logits, mesh, ax.rows_only(policy.named(spec)),
            run_check=False).redistribute(mesh, policy.named(spec))
        for c, new in zip(leaves(cache), leaves(local_cache)):
            c.to_local().copy_(DTensor.from_local(
                new, mesh, ax.rows_only(c.placements),
                run_check=False).redistribute(mesh, c.placements).to_local())
        return out, cache

    return fwd


def sharded_cache(cache: Any, policy: ShardingPolicy) -> Any:
    """A cache tree (the same full tensors on every rank) as DTensors in the
    policy's ``cache_spec`` placements."""
    return unflatten(cache, [
        to_dtensor(c, policy.mesh, policy.named(policy.cache_spec(path, c)))
        for path, c in flatten(cache)])


def placements_of(tree: Any) -> Any:
    """The placements of every DTensor leaf (for checks)."""
    return unflatten(tree, [tuple(x.placements) for x in leaves(tree)])


def sharded_bytes(tree: Any) -> Tuple[int, int]:
    """(bytes of this rank's shards, bytes of the largest whole leaf)."""
    local = sum(x.to_local().numel() * x.element_size()
                for x in leaves(tree))
    largest = max((x.numel() * x.element_size() for x in leaves(tree)),
                  default=0)
    return local, largest
