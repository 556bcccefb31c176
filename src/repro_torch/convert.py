"""Convert the reference's parameters into the port's tensors.

`params_from_jax` takes the params pytree of ``repro.models.model.Model``
with every leaf already turned into a numpy array (``jax.tree.map(np.asarray,
params)``; the port never imports JAX) and returns the same nesting with
torch tensors: stacked ``blocks`` leaves keep their leading super-block axis
and ``l{i}`` keys, the ``prefix`` list stays a list, ``{"w","b"}`` dense
dicts keep the ``(d_in, d_out)`` layout, and a tied-embedding model simply
has no ``lm_head``. Every leaf is checked against `Model.param_shapes` of
the port, so a tree of another arch or layout raises instead of loading.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import Model


def _to_tensor(a: Any, device: torch.device, dtype) -> torch.Tensor:
    a = np.array(a)                         # a private, writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16 from a jax array
        a = a.astype(np.float32)
    t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(np_tree: Dict, cfg: ArchConfig, device: DeviceLike = "cuda",
                    dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference's params (numpy leaves) as the port's params. Floating
    leaves are cast to ``dtype`` when given."""
    dev = resolve_device(device)
    shapes = Model(cfg, device="cpu").param_shapes()

    def walk(node, shape, path: str):
        if isinstance(node, dict):
            if "qw" in node:
                raise NotImplementedError(
                    f"{path}: quantized dense dicts ({{'qw','scale'}}) arrive "
                    "with the quantization slice of the port")
            if not isinstance(shape, dict) or set(node) != set(shape):
                raise ValueError(f"{path}: keys {sorted(node)} do not match "
                                 f"the port's {sorted(shape) if isinstance(shape, dict) else shape}")
            return {k: walk(v, shape[k], f"{path}/{k}")
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            if not isinstance(shape, list) or len(node) != len(shape):
                raise ValueError(f"{path}: {len(node)} entries, the port "
                                 f"expects {shape}")
            return [walk(v, s, f"{path}[{i}]")
                    for i, (v, s) in enumerate(zip(node, shape))]
        t = _to_tensor(node, dev, dtype)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, the port "
                             f"expects {tuple(shape)}")
        return t

    return walk(np_tree, shapes, "params")

