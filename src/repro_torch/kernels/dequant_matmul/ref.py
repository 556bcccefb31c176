"""Plain PyTorch versions of the dequant-matmul kernels, ported from
``repro.kernels.dequant_matmul.ref``.

Contract: **dequantize, then matmul, in f32, then cast to ``x.dtype``**. The
order matters: ``(x @ qw) * scale`` rounds differently from
``x @ (qw * scale)``, and the serving bit-parity test (quantized generate vs
generate over the dequantized f32 params) pins the latter. The CUDA kernels
in ``repro_torch/csrc/dequant_matmul.cu`` are held to tolerance against
these, not bitwise.

Packing convention (shared with `repro_torch.quant.quantize.pack_int4`): two
consecutive input rows per byte: packed row ``r`` holds original row ``2r``
in the low nibble and row ``2r + 1`` in the high nibble, values
sign-extended from [-8, 7] two's complement.
"""
from __future__ import annotations

import torch


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., K//2, N) uint8 -> (..., K, N) int8 in [-8, 7]."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = ((p >> 4) ^ 8) - 8
    q = torch.stack([lo, hi], dim=-2)            # (..., K//2, 2, N)
    return q.reshape(*packed.shape[:-2], 2 * packed.shape[-2],
                     packed.shape[-1]).to(torch.int8)


def dequantize_int8(qw: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-output-column int8 -> f32: ``w[k, n] = qw[k, n] * scale[n]``."""
    return qw.float() * scale[..., None, :].float()


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Group-wise packed int4 -> f32. ``scale`` (..., G, N) covers groups of
    ``K // G`` consecutive input rows."""
    q = unpack_int4(packed).float()              # (..., K, N)
    K, N = q.shape[-2], q.shape[-1]
    G = scale.shape[-2]
    grouped = q.reshape(*q.shape[:-2], G, K // G, N)
    w = grouped * scale[..., :, None, :].float()
    return w.reshape(q.shape)


def dequant_matmul_int8_ref(x: torch.Tensor, qw: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ dequantize_int8(qw (K, N), scale (N,)) -> (..., N)."""
    w = dequantize_int8(qw, scale)
    return (x.float() @ w).to(x.dtype)


def dequant_matmul_int4_ref(x: torch.Tensor, packed: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ dequantize_int4(packed (K//2, N), scale (G, N))."""
    w = dequantize_int4(packed, scale)
    return (x.float() @ w).to(x.dtype)
