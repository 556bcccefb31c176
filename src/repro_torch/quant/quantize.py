"""Weight-only quantization: symmetric per-channel int8 + group-wise int4,
ported from ``repro.quant.quantize``.

* **int8**: symmetric per output column: ``scale[n] = absmax(w[:, n]) / 127``,
  ``qw = round(w / scale)`` stored as int8 ``(K, N)`` + f32 ``(N,)`` scales.
* **int4**: symmetric group-wise along the input dim: groups of
  ``group_size`` consecutive rows share ``scale[g, n] = absmax / 7``; values
  in [-7, 7] pack two to a byte into uint8 ``(K//2, N)`` + f32 ``(G, N)``
  scales (packing convention in `repro_torch.kernels.dequant_matmul.ref`).

The math is the reference's, in f32: ``torch.round`` rounds half to even as
``jnp.round`` does, and scales stay f32 whatever the model dtype. A quantized
dense dict replaces ``"w"`` with ``"qw"`` + ``"scale"`` (the bias rides along
in the model dtype); the format is recoverable from ``qw.dtype`` alone (int8
vs uint8). Stacked super-block leaves keep their leading axis: every routine
works on the trailing two dims, and a stacked leaf is quantized one
``(K, N)`` slice at a time, which gives the same numbers as the whole leaf at
once while bounding the f32 temporaries (a full-depth chatglm3-6b gate/up
leaf is 6.3 GB in f32).

`repro_torch.models.layers.dense` dispatches on the ``"qw"`` key, so every
linear layer serves through the dequant-matmul kernels
(`repro_torch.kernels.dequant_matmul`) with no call-site changes. The
accounting half (`params_quant_format`, `param_bytes`, `quant_workload`)
prices a tree for the planning layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Tuple

import torch

from repro_torch.core.decomposition import Workload

# a quantized Model params tree: same nesting as Model.init's, with every
# quantized dense dict carrying "qw" + "scale" instead of "w"
QuantizedParams = Dict[str, Any]

EPS = 1e-8
DEFAULT_GROUP_SIZE = 32
QUANT_FORMATS = ("bf16", "int8", "int4")       # serving-path formats
BYTES_PER_PARAM = {"fp32": 4.0, "fp16": 2.0, "bf16": 2.0, "fp8": 1.0,
                   "int8": 1.0, "int4": 0.5}
# dense dicts whose raw "w" is read outside `dense` (MLA absorbed decode
# reshapes these directly): they stay full-precision
RAW_WEIGHT_KEYS = frozenset({"w_uk", "w_uv"})


def _check_format(fmt: str) -> str:
    if fmt not in QUANT_FORMATS:
        raise ValueError(f"unknown quant format {fmt!r} "
                         f"(supported: {', '.join(QUANT_FORMATS)})")
    return fmt


def _slicewise(fn: Callable[[torch.Tensor], Tuple[torch.Tensor, ...]],
               w: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``fn`` over the leading (stack) axes of ``w``, one trailing ``(K, N)``
    slice at a time, into outputs allocated once."""
    if w.dim() <= 2:
        return fn(w)
    first = _slicewise(fn, w[0])
    outs = tuple(torch.empty((w.shape[0],) + tuple(o.shape), dtype=o.dtype,
                             device=o.device) for o in first)
    for o, f in zip(outs, first):
        o[0] = f
    for i in range(1, w.shape[0]):
        for o, r in zip(outs, _slicewise(fn, w[i])):
            o[i] = r
    return outs


# ============================================================== pack / unpack

def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., K, N) ints in [-8, 7] -> (..., K//2, N) uint8; row ``r`` packs
    original row ``2r`` (low nibble) and ``2r + 1`` (high nibble)."""
    nib = q.to(torch.int32) & 0xF
    return (nib[..., 0::2, :] | (nib[..., 1::2, :] << 4)).to(torch.uint8)


def group_size_for(d_in: int, group_size: int) -> int:
    """Largest even divisor of ``d_in`` that is <= ``group_size``: the group
    the int4 quantizer actually uses (packing needs pairs of rows)."""
    if d_in % 2:
        raise ValueError(f"int4 packing needs an even input dim (got {d_in})")
    gs = min(group_size, d_in)
    while d_in % gs or gs % 2:
        gs -= 1
    return gs


# ================================================================== quantize

def _quantize_int8_2d(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    wf = w.float()
    scale = torch.clamp_min(wf.abs().amax(dim=-2), EPS) / 127.0
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127)
    return q.to(torch.int8), scale


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K, N) float -> (qw int8 (..., K, N), scale f32 (..., N))."""
    return _slicewise(_quantize_int8_2d, w)


def quantize_int4(w: torch.Tensor,
                  group_size: int = DEFAULT_GROUP_SIZE
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K, N) float -> (packed uint8 (..., K//2, N),
    scale f32 (..., G, N)) with G = K // adjusted group size."""
    K, N = w.shape[-2], w.shape[-1]
    gs = group_size_for(K, group_size)

    def one(w2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        grouped = w2.float().reshape(K // gs, gs, N)
        scale = torch.clamp_min(grouped.abs().amax(dim=-2), EPS) / 7.0
        q = torch.clamp(torch.round(grouped / scale[:, None, :]), -7, 7)
        return pack_int4(q.reshape(K, N)), scale

    return _slicewise(one, w)


def quantize_dense(p: Dict, fmt: str,
                   group_size: int = DEFAULT_GROUP_SIZE) -> Dict:
    """Quantize one dense param dict: ``{"w", ["b"]}`` -> ``{"qw", "scale",
    ["b"]}``. The bias stays in the model dtype."""
    _check_format(fmt)
    out = {k: v for k, v in p.items() if k != "w"}
    if fmt == "int8":
        out["qw"], out["scale"] = quantize_int8(p["w"])
    elif fmt == "int4":
        out["qw"], out["scale"] = quantize_int4(p["w"], group_size)
    else:
        return dict(p)                       # bf16: identity
    return out


def dequantize_dense(p: Dict, dtype=torch.float32) -> Dict:
    """Inverse of `quantize_dense` (lossy): ``{"qw", "scale"}`` -> ``{"w"}``.
    The reconstruction uses the dequantize math of the plain matmul, so
    ``dense(dequantize_dense(qp), x)`` == ``qdense(qp, x)`` bit for bit on
    the plain (CPU) path."""
    from repro_torch.kernels.dequant_matmul.ref import (dequantize_int4,
                                                        dequantize_int8)
    w = (dequantize_int4(p["qw"], p["scale"]) if p["qw"].dtype == torch.uint8
         else dequantize_int8(p["qw"], p["scale"]))
    out = {k: v for k, v in p.items() if k not in ("qw", "scale")}
    out["w"] = w.to(dtype)
    return out


def is_quantized_dense(p: Any) -> bool:
    return isinstance(p, dict) and "qw" in p


def qdense(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Quantized counterpart of `repro_torch.models.layers.dense`: the
    dequant-matmul (kernel on the card, plain version on the CPU) plus the
    full-precision bias."""
    from repro_torch.kernels.dequant_matmul.ops import dequant_matmul
    y = dequant_matmul(x, p["qw"], p["scale"])
    if "b" in p:
        y = y + p["b"]
    return y


# ============================================================ whole-model API

def _walk(node: Any, fmt: str, group_size: int) -> Any:
    if isinstance(node, dict):
        if "w" in node and getattr(node["w"], "ndim", 0) >= 2:
            if fmt == "int4" and node["w"].shape[-2] % 2:
                return dict(node)            # unpackable odd input dim
            return quantize_dense(node, fmt, group_size)
        return {k: (dict(v) if isinstance(v, dict) and k in RAW_WEIGHT_KEYS
                    else _walk(v, fmt, group_size))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, fmt, group_size) for v in node)
    return node


def quantize_model(params: Dict, fmt: str = "int8",
                   group_size: int = DEFAULT_GROUP_SIZE) -> QuantizedParams:
    """Quantize every dense weight in a Model params tree.

    Embedding table, lm_head and norms stay full-precision (standard
    weight-only practice: they are small and quantization-sensitive), as do
    the MLA latent decompression weights the absorbed-decode path reads raw
    (`RAW_WEIGHT_KEYS`). The keep-list leaves are shared with ``params``,
    not copied. Stacked super-blocks keep their leading axis.
    """
    if _check_format(fmt) == "bf16":
        return params
    keep = {"embed", "lm_head", "final_norm"}
    return {k: (v if k in keep else _walk(v, fmt, group_size))
            for k, v in params.items()}


def dequantize_model(params: QuantizedParams, dtype=torch.float32) -> Dict:
    """Reconstruct a full-precision params tree (lossy: the quantization
    error is baked in). Used by the bit-parity tests and the f32 parity
    phase of ``chip_smoke.py``."""
    def walk(node: Any) -> Any:
        if is_quantized_dense(node):
            return dequantize_dense(node, dtype)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node
    return walk(params)


# ======================================================= accounting / routing

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
    """Actual resident weight bytes of a (possibly quantized) params tree."""
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
