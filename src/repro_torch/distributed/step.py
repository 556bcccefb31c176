"""The sharded train step and forward: the port's counterpart of
``jax.jit(step, in_shardings=..., out_shardings=...)`` over a
`ShardingPolicy` (``src/repro/launch/train.py`` and ``launch/dryrun.py`` of
the reference).

Parameters and AdamW moments are DTensors in the policy's placements
(`shard_params`, `init_sharded_opt_state`); a batch is DTensors in its
``data_spec`` placements (`shard_batch`). The step keeps the boundary's
contract and computes between them as follows (`repro_torch.distributed.
tp` has the collectives and the gather):

1. each rank runs the model on its own rows of the batch (its coordinate
   on the batch axes), with the params tree as `Leaf` objects over its
   shards (`leaf_tree`); the MoE FFN gets the batch axes' process group, so
   its capacity, slots and aux loss stay the whole batch's
   (`repro_torch.models.moe`);
2. a layer asks for a leaf when it runs (`TensorParallel.take`): the FSDP
   axis ("data") is all-gathered and the tensor axis ("model") kept as the
   layer computes on it, so the block's compute splits over the tensor
   ranks (attention's and the SSD's heads, the MLP's hidden dim, experts
   or their hidden dim, the vocabulary) and the residual stream between
   layers is sharded on
   d_model; a leaf's backward reduce-scatters its gradient straight to its
   at-rest placement (summed over the batch axes: each rank's loss is
   scaled by 1 / their size), and the gathered tensors are saved for
   backward as tokens and gathered again (`TensorParallel.saving`), so a
   block's gathered weights live while it runs; under remat the block
   gathers again in its recompute;
3. the gradient norm is the square root of one all-reduced sum of local
   squared sums, each element counted once (a leaf replicated over a mesh
   dim counts only on that dim's coordinate 0), and AdamW
   (`repro_torch.training.optimizer.adamw_update`) updates each local
   shard in place with it. No rank holds a whole-model gradient.

Every mixer computes on its share: GQA, MLA and cross-attention by head,
the Mamba-2 mixer by SSD head (`repro_torch.models.blocks._sublayer_tp`).
Sharding changes no result: a sharded step equals the unsharded port step
to f32 rounding.
Metrics (``loss``, ``grad_norm``, ``lr``, ``step``) come back as plain
tensors, equal on every rank.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.distributed.tp import Leaf, Registry, TensorParallel
from repro_torch.models import blocks as blk
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            row_chunks)
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


# ------------------------------------------------------------------ compute


def tensor_parallel(policy: ShardingPolicy, ax: BatchAxes) -> TensorParallel:
    """The rank's tensor-parallel context: the policy's tensor axis (none
    when it has none) and the batch axes."""
    names = list(policy.axis_sizes)
    t = policy.tensor_axis
    dim = names.index(t) if t in names and names.index(t) not in ax.dims \
        else None
    return TensorParallel(policy.mesh, dim, ax.dims)


def _unstacked(placements) -> tuple:
    return tuple(Shard(pl.dim - 1) if isinstance(pl, Shard) else pl
                 for pl in placements)


def leaf_tree(params: Any, grad: bool) -> Tuple[Any, List]:
    """The params tree as `Leaf` objects over this rank's shards: a stacked
    ``blocks`` leaf as a list of per-layer leaves (one autograd leaf a
    layer, so each layer's gradient lands in its own slice, as
    `repro_torch.training.loop.value_and_grad` does). Returns the tree and,
    per params leaf, the list of its autograd inputs."""
    out, inputs = [], []
    for path, p in flatten(params):
        local = p.to_local()
        if path.startswith("blocks/"):
            xs = [local[i].detach().requires_grad_(grad)
                  for i in range(local.shape[0])]
            pls = _unstacked(p.placements)
            out.append([Leaf(x, pls, p.shape[1:], f"{path}/{i}")
                        for i, x in enumerate(xs)])
        else:
            xs = [local.detach().requires_grad_(grad)]
            out.append(Leaf(xs[0], p.placements, p.shape, path))
        inputs.append(xs)
    return unflatten(params, out), inputs


def _registry_params(tp: TensorParallel, inputs: List) -> None:
    tp.registry.params = {x.untyped_storage()._cdata
                          for xs in inputs for x in xs}


def _norm_share(local: torch.Tensor, placements, coord) -> torch.Tensor:
    """This rank's part of a leaf's squared sum: its shard's, or zero where
    a mesh dim replicates the leaf and this rank is not its coordinate 0.
    A few rows at a time, as `global_norm` sums (an f32 copy of a whole
    stacked leaf would be the step's peak)."""
    if any(isinstance(pl, Replicate) and c != 0
           for pl, c in zip(placements, coord)):
        return torch.zeros((), dtype=torch.float32, device=local.device)
    return sum(torch.sum(torch.square(local[sl].float()))
               for sl in row_chunks(local))


def sharded_grad_norm(grads: List[torch.Tensor], placements: List[tuple],
                      mesh) -> torch.Tensor:
    """The f32 norm of the whole gradient from local shards: one
    all-reduce of the local squared sums, each element counted once."""
    coord = mesh.get_coordinate()
    total = sum(_norm_share(g, pl, coord) for g, pl in zip(grads, placements))
    dist.all_reduce(total)
    return torch.sqrt(total)


# ------------------------------------------------------------------ the step

def make_sharded_train_step(model: Model, opt_cfg: AdamWConfig,
                            policy: ShardingPolicy,
                            microbatches: int = 1) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    over DTensor params, moments and batch (module docstring); params and
    moments are updated in place. ``microbatches > 1`` splits the global
    batch into that many slices, run one after another with the local
    gradient shards summed in f32 as `repro_torch.training.make_train_step`
    sums whole ones; each slice is the global one, split over the batch
    axes, so the MoE FFN drops the tokens the unsharded step drops.

    After each call ``step.stats`` holds what the step held on this rank:
    ``grad_bytes`` (the local gradient shards, and the f32 accumulators
    with microbatches), ``gathered_bytes`` (the most gathered parameter
    bytes alive at once), ``gathered_by_path`` (each gathered leaf's
    compute-layout bytes) and ``saved_bytes`` (the bytes saved for
    backward, one count a storage; under remat the blocks' inputs, not
    what a block's recompute saves, `block_saved_bytes`)."""
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
        tp = tensor_parallel(policy, ax)
        flat = flatten(params)
        tree, inputs = leaf_tree(params, grad=True)
        stats = {"gathered_bytes": 0, "saved_bytes": 0,
                 "gathered_by_path": {}}

        def run(b):
            tp.registry = Registry()
            _registry_params(tp, inputs)
            with tp.saving():
                loss = model.loss(tree, b, dp=ax.group, tp=tp) / ax.size
            gs = list(torch.autograd.grad(
                loss, [x for xs in inputs for x in xs], allow_unused=True))
            out = []
            for (path, _), xs in zip(flat, inputs):
                g = [torch.zeros_like(x) if gi is None else gi
                     for x, gi in zip(xs, gs[:len(xs)])]
                del gs[:len(xs)]
                out.append(torch.stack(g) if path.startswith("blocks/")
                           else g[0])
            reg = tp.registry
            stats["gathered_bytes"] = max(stats["gathered_bytes"], reg.peak)
            stats["saved_bytes"] = max(stats["saved_bytes"], reg.saved)
            stats["gathered_by_path"].update(reg.by_path)
            return loss.detach(), out

        if microbatches == 1:
            loss, grads = run({k: ax.rows_of(v) for k, v in batch.items()})
            stats["grad_bytes"] = sum(g.numel() * g.element_size()
                                      for g in grads)
        else:
            whole = {k: gather(v) for k, v in batch.items()}
            grads = [torch.zeros(p.to_local().shape, dtype=torch.float32,
                                 device=p.to_local().device)
                     for _, p in flat]
            loss = 0.0
            n = rows // microbatches
            for i in range(microbatches):
                mb = {k: ax.local(v[i * n:(i + 1) * n])
                      for k, v in whole.items()}
                mloss, g = run(mb)
                loss = loss + mloss / microbatches
                with torch.no_grad():
                    for acc, gi in zip(grads, g):
                        acc += gi.float() / microbatches
                stats["grad_bytes"] = sum(
                    t.numel() * t.element_size() for t in grads + g)
                del g
        step.stats = stats

        # local gradient shards in the params' placements: AdamW on them
        placements = [p.placements for _, p in flat]
        gnorm = sharded_grad_norm(grads, placements, mesh)

        def local(tree):
            return unflatten(tree, [x.to_local() for x in leaves(tree)])

        state = {"m": local(opt_state["m"]), "v": local(opt_state["v"]),
                 "step": opt_state["step"].to_local()}
        _, new_state, metrics = adamw_update(
            opt_cfg, local(params), unflatten(params, grads), state,
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

    step.stats = {}
    return step


def block_saved_bytes(model: Model, policy: ShardingPolicy, params: Any,
                      batch: Dict) -> int:
    """The bytes one stacked super-block saves for backward on this rank:
    what a block's recompute holds under remat. The first stacked block,
    run with gradients under the counting hooks on a residual shard of this
    rank's rows of ``batch``."""
    cfg = model.cfg
    tokens = batch["tokens"]
    ax = BatchAxes(policy, tokens.shape[0])
    tp = tensor_parallel(policy, ax)
    tree, inputs = leaf_tree(params, grad=True)
    _registry_params(tp, inputs)
    b = {k: ax.rows_of(v) for k, v in batch.items()}
    rows, S = b["tokens"].shape[:2]
    local = next(x for xs in inputs for x in xs)
    x = torch.zeros((rows, S, cfg.d_model // tp.n), dtype=model.dtype,
                    device=local.device, requires_grad=True)
    positions = b.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=local.device)[None].expand(rows, S)
        if cfg.mrope_sections:
            positions = positions[..., None].expand(rows, S, 3)
    memory = b.get("cond_memory") if cfg.cross_attention else None
    with tp.saving():
        blk.super_block_forward(_first(tree["blocks"]), cfg, x, positions,
                                None, memory, use_kernel=False, dp=ax.group,
                                tp=tp)
    return tp.registry.saved


def _first(tree):
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]


# ------------------------------------------------------------------ forward

def make_sharded_forward(model: Model, policy: ShardingPolicy,
                         position: int) -> Callable:
    """``fwd(params, batch, cache) -> (logits, cache)`` over DTensors: the
    prefill (``position=-1``) or decode (``position=0``) step of the
    reference's dry-run. Each rank runs the tensor-parallel forward on its
    rows of the batch and on its shards of the cache, in place (the cache
    stays in the policy's ``cache_spec`` placements: GQA attention reads
    and writes its head-dim chunk, MLA its latent chunk, the Mamba-2 mixer
    its heads' SSM state; only the Mamba-2 conv tail, and MLA's latent
    window in a naive decode, are gathered for the layer); the logits at
    ``position`` leave in the policy's ``logits_spec`` placements.
    ``fwd.stats`` holds ``gathered_bytes`` and ``gathered_by_path`` (as
    `make_sharded_train_step`'s) after each call."""
    mesh, cfg = policy.mesh, model.cfg

    @torch.no_grad()
    def fwd(params, batch, cache):
        rows, S = batch["tokens"].shape[:2]
        ax = BatchAxes(policy, rows)
        tp = tensor_parallel(policy, ax)
        tree, _ = leaf_tree(params, grad=False)
        for path, c in flatten(cache):
            name = path.rsplit("/", 1)[-1]
            lead = 1 if path.startswith("blocks/") else 0
            pl = (c.placements[tp.tensor_dim] if tp.tensor_dim is not None
                  else None)
            tp.cache_dims[name] = (pl.dim - lead if isinstance(pl, Shard)
                                   else None)
        local_cache = unflatten(cache, [c.to_local() for c in leaves(cache)])
        at = position % S
        logits, _, _ = model.forward(
            tree, {k: ax.rows_of(v) for k, v in batch.items()}, local_cache,
            logits_at=at, dp=ax.group, tp=tp)
        fwd.stats = {"gathered_bytes": tp.registry.peak,
                     "gathered_by_path": dict(tp.registry.by_path)}
        logits = logits[:, 0]
        V = cfg.padded_vocab
        spec = policy.logits_spec(rows, cfg.vocab_size,
                                  extra_dims=logits.dim() - 2)
        placements = list(ax.rows_only(policy.named(spec)))
        if tp.n > 1 and V % tp.n == 0:
            placements[tp.tensor_dim] = Shard(logits.dim() - 1)
        elif tp.n > 1:
            logits = tp.gather_sets(logits, -1, tp.ranges(V), V)
        shape = (rows,) + tuple(logits.shape[1:-1]) + (V,)
        out = DTensor.from_local(
            logits.contiguous(), mesh, tuple(placements), run_check=False,
            shape=shape, stride=torch.empty(shape, device="meta").stride()
        ).redistribute(mesh, policy.named(spec))
        return out, cache

    fwd.stats = {}
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
