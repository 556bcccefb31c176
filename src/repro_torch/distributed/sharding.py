"""Divisibility-aware sharding policy, ported from
``repro.distributed.sharding``.

Strategy: constrain only the step's boundary (parameters, AdamW moments,
batches, caches, logits) and let the step choose how it computes between
them (`repro_torch.distributed.step`). Every spec this policy emits divides
its tensor dim, so no placement is ever uneven (mamba2's vocab 50280 or
granite's 49155 simply stay unsharded on that dim).

Parameter rules:
  * stacked decoder blocks lead with a layer axis (never sharded);
  * the last dim goes to the tensor axis ("model"), the second-to-last to
    the FSDP axis ("data"): 2-D sharded weights;
  * MoE expert stacks (..., E, d, ff) put E on "model" (expert parallelism)
    when divisible, falling back to tensor-parallel ff;
  * 1-D params (norm scales, biases) replicate.

Batch rules: batch dim over ("pod", "data") when divisible (pods are pure
data parallel), else over ("data",), else replicated (long_500k's batch of
1). Cache rules: batch -> data axes, per-head/feature dim -> "model" when
divisible.

A *spec* is a tuple with one entry per tensor dim: None, a mesh axis name,
or a tuple of names (the contents of the reference's ``PartitionSpec``).
`ShardingPolicy.named` maps a spec onto the mesh as DTensor placements. The
mesh is a `torch.distributed.device_mesh.DeviceMesh` or a shape-only
`MeshShape`, so the rules can be used with no process group. A path is the
`repro_torch.training.tree.flatten` path of a leaf (``blocks/l0/moe/gate``,
``prefix/0/attn/wq/w``); a leaf is a tensor or a shape tuple.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
from torch.distributed.tensor import Replicate, Shard

from repro_torch.training.tree import flatten, unflatten

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or a process group."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, of a DeviceMesh or a MeshShape."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _keys(path: Union[str, Sequence]) -> list:
    return path.split("/") if isinstance(path, str) else [str(k)
                                                         for k in path]


class ShardingPolicy:
    @classmethod
    def auto(cls, mesh, cfg, global_batch: int,
             tp_threshold_params: float = 2e9) -> "ShardingPolicy":
        """Size-aware layout selection: a model under
        ``tp_threshold_params`` whose global batch fills the whole mesh
        takes the pure data-parallel layout (a 16-wide tensor axis makes
        every small matmul collective-bound)."""
        from repro_torch.models.model import Model
        n_params = Model(cfg).param_count()
        n_dev = int(np.prod(list(mesh_axes(mesh).values())))
        tensor = not (n_params < tp_threshold_params and
                      global_batch % n_dev == 0 and global_batch >= n_dev)
        return cls(mesh, tensor_enabled=tensor)

    def __init__(self, mesh, fsdp_axis: str = "data",
                 tensor_axis: str = "model",
                 dp_axes: Optional[Tuple[str, ...]] = None,
                 fsdp_enabled: bool = True,
                 tensor_enabled: bool = True):
        """tensor_enabled=False: pure data-parallel layout — the "model"
        axis joins the batch axes and weights shard over FSDP only."""
        self.mesh = mesh
        self.fsdp_axis = fsdp_axis
        self.tensor_axis = tensor_axis if tensor_enabled else None
        self.axis_sizes = mesh_axes(mesh)
        if dp_axes is None:
            dp_axes = tuple(a for a in ("pod", "data") if a in self.axis_sizes)
            if not tensor_enabled and "model" in self.axis_sizes:
                dp_axes = dp_axes + ("model",)
        self.dp_axes = dp_axes
        self.fsdp_enabled = fsdp_enabled

    # ------------------------------------------------------------- helpers
    def _size(self, axis: Axis) -> int:
        if isinstance(axis, tuple):
            return int(np.prod([self.axis_sizes[a] for a in axis]))
        return self.axis_sizes[axis]

    def _fits(self, dim: int, axis: Axis) -> bool:
        if axis is None:
            return True
        n = self._size(axis)
        return dim % n == 0 and dim >= n

    def _maybe(self, dim: int, axis: Axis) -> Axis:
        return axis if self._fits(dim, axis) else None

    def named(self, spec: Spec) -> tuple:
        """The spec as DTensor placements, one a mesh dim in mesh order:
        ``Shard(d)`` for the tensor dim ``d`` that names the mesh dim (a
        tuple such as ``("pod", "data")`` shards dim d on both, outer axis
        major), else ``Replicate()``."""
        names = list(self.axis_sizes)
        out = [Replicate()] * len(names)
        for d, axis in enumerate(spec):
            if axis is None:
                continue
            group = axis if isinstance(axis, tuple) else (axis,)
            idx = [names.index(a) for a in group]
            if idx != sorted(idx):
                raise ValueError(f"spec {spec}: the axes {group} of dim {d} "
                                 "are not in mesh order")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def _tree(self, fn, tree: Any) -> Any:
        return unflatten(tree, [self.named(fn(path, leaf))
                                for path, leaf in flatten(tree)])

    # ------------------------------------------------------------- params
    def param_spec(self, path, leaf) -> Spec:
        """The spec of one parameter, from its path and shape."""
        keys = _keys(path)
        shape = _shape(leaf)
        nd = len(shape)
        stacked = "blocks" in keys          # leading layer-stack axis
        lead = 1 if stacked else 0
        fsdp = self.fsdp_axis if self.fsdp_enabled else None

        if nd - lead <= 1:                  # scales, biases, A_log, ...
            return (None,) * nd

        # MoE expert stacks: (..., E, d_model, d_ff) under gate/up/down
        if any(k in ("gate", "up", "down") for k in keys) and nd - lead == 3:
            E, d_in, d_out = shape[lead:]
            e_ax = self._maybe(E, self.tensor_axis)
            if e_ax is not None:            # expert parallelism
                spec = [None] * lead + [e_ax, self._maybe(d_in, fsdp), None]
            else:                           # fallback: tensor-parallel ff
                ff_ax = self._maybe(d_out, self.tensor_axis)
                spec = [None] * lead + [None, self._maybe(d_in, fsdp), ff_ax]
            return tuple(spec)

        # generic >=2-D weights: last dim -> tensor, second-to-last -> fsdp
        spec = [None] * nd
        spec[-1] = self._maybe(shape[-1], self.tensor_axis)
        fs = self._maybe(shape[-2], fsdp)
        if fs != spec[-1]:                  # never the same axis twice
            spec[-2] = fs
        return tuple(spec)

    def param_shardings(self, params: Any) -> Any:
        """Placements of every leaf of a params tree (tensors or shapes)."""
        return self._tree(self.param_spec, params)

    # ------------------------------------------------------------- batch
    def batch_axes(self, batch_size: int) -> Axis:
        """Largest prefix of dp axes that divides the batch."""
        for axes in (self.dp_axes, self.dp_axes[:1], ()):
            if not axes:
                return None
            n = self._size(tuple(axes))
            if batch_size % n == 0 and batch_size >= n:
                return tuple(axes) if len(axes) > 1 else axes[0]
        return None

    def data_spec(self, path, leaf) -> Spec:
        """The spec of a batch entry (tokens, labels, positions, ...)."""
        shape = _shape(leaf)
        ba = self.batch_axes(shape[0]) if shape else None
        spec = [ba] + [None] * (len(shape) - 1)
        # embeddings-like entries (B, T, d_model): shard the feature dim too
        if len(shape) == 3 and shape[-1] >= 128:
            spec[-1] = self._maybe(shape[-1], self.tensor_axis)
        return tuple(spec)

    def batch_shardings(self, batch: Dict) -> Dict:
        return self._tree(self.data_spec, batch)

    # ------------------------------------------------------------- cache
    def cache_spec(self, path, leaf) -> Spec:
        keys = _keys(path)
        shape = _shape(leaf)
        lead = 1 if "blocks" in keys else 0
        rest = shape[lead:]
        spec = [None] * len(shape)
        if not rest:
            return tuple(spec)
        spec[lead] = self.batch_axes(rest[0])
        name = keys[-1]
        if name in ("k", "v"):              # (B, W, kv, hd): shard hd
            spec[lead + 3] = self._maybe(rest[3], self.tensor_axis)
        elif name in ("c_kv", "k_rope"):    # (B, W, r): shard latent dim
            spec[lead + 2] = self._maybe(rest[2], self.tensor_axis)
        elif name == "ssm":                 # (B, H, P, N): shard heads
            spec[lead + 1] = self._maybe(rest[1], self.tensor_axis)
        elif name == "conv":                # (B, K-1, Ch): shard channels
            spec[lead + 2] = self._maybe(rest[2], self.tensor_axis)
        # "pos": batch-sharded only
        return tuple(spec)

    def cache_shardings(self, cache: Any) -> Any:
        return self._tree(self.cache_spec, cache)

    # ------------------------------------------------------------- outputs
    def logits_spec(self, batch_size: int, vocab: int,
                    extra_dims: int = 1) -> Spec:
        ba = self.batch_axes(batch_size)
        return tuple([ba] + [None] * extra_dims +
                     [self._maybe(vocab, self.tensor_axis)])

    def opt_state_shardings(self, params: Any) -> Dict:
        ps = self.param_shardings(params)
        return {"m": ps, "v": ps, "step": self.scalar()}

    def scalar(self) -> tuple:
        return self.named(())
