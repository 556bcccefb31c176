"""Activation sharding hints (off by default), ported from
``repro.distributed.hints``.

In the reference, GSPMD infers most internal shardings from the boundary,
but the Mamba-2 SSD block defeats it: B/C come from slicing a
tensor-sharded projection at non-shard-aligned offsets, so propagation
replicates the chunked scan over the "model" axis. ``constrain(x,
dim_axes)`` pins the dims named ``"tensor"`` to the tensor axis and leaves
the rest as they are. Enabled process-wide by `enable` (the dry-run's
``--hints``) so the baseline stays measurable.

In the port the hint acts on a DTensor: its dims marked ``"tensor"`` are
redistributed to ``Shard`` on the tensor axis of its mesh when they divide
the axis. A plain tensor or a dim that does not divide comes back
unchanged, as the reference skips a hint it cannot apply. The sharded step
(`repro_torch.distributed.step`) needs no hint: its Mamba-2 mixer
(`repro_torch.models.ssm.ssm_forward_tp`) splits the SSD's heads over the
tensor ranks with or without `enable`, on plain tensors, which pass
through the hint unchanged.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard

_ENABLED = False
_TENSOR_AXIS = "model"


def enable(tensor_axis: str = "model") -> None:
    global _ENABLED, _TENSOR_AXIS
    _ENABLED = True
    _TENSOR_AXIS = tensor_axis


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def constrain(x: torch.Tensor, dim_axes: Tuple[Optional[str], ...],
              divisible_dim: Optional[int] = None) -> torch.Tensor:
    """Pin dims named "tensor" to the tensor axis; None dims unchanged.

    divisible_dim: index whose size must divide the axis (skip hint if not).
    """
    if not _ENABLED or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names or ())
    if _TENSOR_AXIS not in names:
        return x
    i_mesh = names.index(_TENSOR_AXIS)
    n = mesh.size(i_mesh)
    dims = [i for i, a in enumerate(dim_axes) if a == "tensor"]
    if not dims or any(x.shape[i] % n for i in dims):
        return x            # not divisible: skip the hint entirely
    placements = list(x.placements)
    placements[i_mesh] = Shard(dims[0])
    return x.redistribute(mesh, placements)
