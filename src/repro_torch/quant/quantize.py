"""Serving-format accounting of a params tree, and quantized workload
pricing for the planning layer.

The weight-only int8 / int4 quantization itself (pack/unpack, the
``quantize_model`` walk and the fused dequant-matmul kernels) arrives with
the quantization slice of the port; until then `params_quant_format` reads
"bf16" for every tree the port can build.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import torch

from repro_torch.core.decomposition import Workload

BYTES_PER_PARAM = {"fp32": 4.0, "fp16": 2.0, "bf16": 2.0, "fp8": 1.0,
                   "int8": 1.0, "int4": 0.5}


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def params_quant_format(params: Dict) -> str:
    """Recover the serving format from a params tree ("bf16" when no leaf is
    quantized): uint8 leaves are packed int4, int8 leaves int8."""
    fmt = "bf16"
    for leaf in _leaves(params):
        if leaf.dtype == torch.uint8:
            return "int4"
        if leaf.dtype == torch.int8:
            fmt = "int8"
    return fmt


def param_bytes(params: Dict) -> int:
    """Actual resident weight bytes of a params tree."""
    return sum(leaf.numel() * leaf.element_size() for leaf in _leaves(params))


def bytes_per_param_for(fmt: str) -> float:
    try:
        return BYTES_PER_PARAM[fmt.lower()]
    except KeyError:
        raise ValueError(f"unknown quant format {fmt!r} "
                         f"(supported: {', '.join(sorted(BYTES_PER_PARAM))})")


def quant_workload(w: Workload, fmt: str,
                   kv_format: str = "bf16") -> Workload:
    """Re-price a `Workload` for a quantized serving variant: weight bytes
    from the weight format, KV-cache bytes from the cache format."""
    return dataclasses.replace(
        w, bytes_per_param=bytes_per_param_for(fmt),
        bytes_per_kv=1.0 if kv_format == "int8" else None)
