"""Convert the reference's parameters into the port's tensors.

`params_from_jax` takes the params pytree of ``repro.models.model.Model``
with every leaf already turned into a numpy array (``jax.tree.map(np.asarray,
params)``; the port never imports JAX) and returns the same nesting with
torch tensors: stacked ``blocks`` leaves keep their leading super-block axis
and ``l{i}`` keys, the ``prefix`` list stays a list, ``{"w","b"}`` dense
dicts keep the ``(d_in, d_out)`` layout, and a tied-embedding model simply
has no ``lm_head``. Every leaf is checked against `Model.param_shapes` of
the port, so a tree of another arch or layout raises instead of loading.

Weight-only quantized dense dicts (``{"qw","scale"[,"b"]}``, from the
reference's ``quantize_model``) load too: int8 and uint8 weights keep their
dtype and the scales stay f32 whatever ``dtype`` says; their shapes are
derived from the dense shape ``(..., K, N)``: int8 ``qw (..., K, N)``,
``scale (..., N)``; int4 ``qw (..., K//2, N)``, ``scale (..., G, N)`` with
``G = K // group_size_for(K, group_size)``.

The Mamba-2 leaves ``A_log``, ``dt_bias`` and ``D`` stay f32 whatever
``dtype`` says, as the reference keeps them in every model dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import Model
from repro_torch.models.ssm import F32_KEYS
from repro_torch.quant.quantize import DEFAULT_GROUP_SIZE, group_size_for


def _to_tensor(a: Any, device: torch.device, dtype) -> torch.Tensor:
    a = np.array(a)                         # a private, writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16 from a jax array
        a = a.astype(np.float32)
    t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _quantized_shapes(node: Dict, shape: Dict, group_size: int,
                      path: str) -> Dict:
    """The shapes a quantized dict must have, from its dense shapes; the
    format is the weight's dtype (int8, or uint8 for packed int4)."""
    if not isinstance(shape, dict) or "w" not in shape:
        raise ValueError(f"{path}: a quantized dict where the port expects "
                         f"{shape}")
    *lead, K, N = shape["w"]
    lead = tuple(lead)
    dt = np.asarray(node["qw"]).dtype
    if dt == np.int8:
        qshape = {"qw": lead + (K, N), "scale": lead + (N,)}
    elif dt == np.uint8:
        G = K // group_size_for(K, group_size)
        qshape = {"qw": lead + (K // 2, N), "scale": lead + (G, N)}
    else:
        raise ValueError(f"{path}: quantized weight dtype {dt} (want int8 or "
                         "uint8)")
    return {**{k: v for k, v in shape.items() if k != "w"}, **qshape}


def params_from_jax(np_tree: Dict, cfg: ArchConfig, device: DeviceLike = "cuda",
                    dtype: Optional[torch.dtype] = None,
                    group_size: int = DEFAULT_GROUP_SIZE) -> Dict:
    """The reference's params (numpy leaves) as the port's params. Floating
    leaves are cast to ``dtype`` when given, except quantization scales and
    the SSM's f32 leaves (`repro_torch.models.ssm.F32_KEYS`), which stay
    f32. ``group_size`` is the int4 group size the tree was quantized
    with."""
    dev = resolve_device(device)
    shapes = Model(cfg, device="cpu").param_shapes()

    def walk(node, shape, path: str, dt):
        if isinstance(node, dict):
            if "qw" in node:
                shape = _quantized_shapes(node, shape, group_size, path)
            if not isinstance(shape, dict) or set(node) != set(shape):
                raise ValueError(f"{path}: keys {sorted(node)} do not match "
                                 f"the port's {sorted(shape) if isinstance(shape, dict) else shape}")
            return {k: walk(v, shape[k], f"{path}/{k}",
                            None if ("qw" in node and k == "scale")
                            or k in F32_KEYS else dt)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            if not isinstance(shape, list) or len(node) != len(shape):
                raise ValueError(f"{path}: {len(node)} entries, the port "
                                 f"expects {shape}")
            return [walk(v, s, f"{path}[{i}]", dt)
                    for i, (v, s) in enumerate(zip(node, shape))]
        t = _to_tensor(node, dev, dt)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, the port "
                             f"expects {tuple(shape)}")
        return t

    return walk(np_tree, shapes, "params", dtype)
