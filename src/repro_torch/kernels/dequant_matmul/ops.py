"""Dequant-matmul wrappers: the Hopper kernels for CUDA tensors, the plain
versions for CPU tensors.

The kernels (``repro_torch/csrc/dequant_matmul.cu``) replace the TPU kernels
`dequant_matmul_int8_pallas` and `dequant_matmul_int4_pallas` in
``src/repro/kernels/dequant_matmul/dequant_matmul.py``. The format is told by
the quantized weight's dtype alone: ``int8`` is per-column int8, ``uint8``
nibble-packed group-wise int4. Calls of at most 64 rows (decode) take a
split-K kernel, which merges its slices of K in the same launch through a
per-device workspace; longer ones a TMA + wgmma kernel (bf16 x, shapes TMA
can read); the rest, int8 over f32 x among them, the tiled kernel
(`split.plan_splitk` and `split.plan_int8` decide before the launch). Each
wrapper's ``launches`` attribute counts its kernels' launches, one a call;
the CPU path does not count.
"""
from __future__ import annotations

import ctypes
import functools
import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (INT32_MAX, check_launch,
                                        check_tensors, stream_of, workspace)
from repro_torch.kernels.dequant_matmul.ref import (dequant_matmul_int4_ref,
                                                    dequant_matmul_int8_ref,
                                                    dequantize_int4,
                                                    dequantize_int8,
                                                    unpack_int4)
from repro_torch.kernels.dequant_matmul.split import (SplitPlan, padded_rows,
                                                      plan_int8, plan_splitk)
from repro_torch.obs.profiling import kernel_scope

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("dequant_matmul")
    lib.dequant_matmul_int8_fwd.argtypes = [_P] * 4 + [_I] * 4 + [_P]
    lib.dequant_matmul_int8_fwd.restype = _I
    lib.dequant_matmul_int4_fwd.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    lib.dequant_matmul_int4_fwd.restype = _I
    lib.dequant_matmul_int4_splitk_fwd.argtypes = [_P] * 6 + [_I] * 7 + [_P]
    lib.dequant_matmul_int4_splitk_fwd.restype = _I
    lib.dequant_matmul_int4_splitk_blocks_per_sm.argtypes = [_I] * 3
    lib.dequant_matmul_int4_splitk_blocks_per_sm.restype = _I
    lib.dequant_matmul_int4_tc_fwd.argtypes = [_P] * 4 + [_I] * 4 + [_P]
    lib.dequant_matmul_int4_tc_fwd.restype = _I
    lib.dequant_matmul_int8_splitk_fwd.argtypes = [_P] * 6 + [_I] * 5 + [_P]
    lib.dequant_matmul_int8_splitk_fwd.restype = _I
    lib.dequant_matmul_int8_splitk_blocks_per_sm.argtypes = [_I]
    lib.dequant_matmul_int8_splitk_blocks_per_sm.restype = _I
    lib.dequant_matmul_int8_tc_fwd.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    lib.dequant_matmul_int8_tc_fwd.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _plan(M: int, K: int, N: int, gs: int, is_bf16: bool, aligned: bool,
          device: torch.device) -> SplitPlan:
    bps = _lib().dequant_matmul_int4_splitk_blocks_per_sm(
        int(is_bf16), padded_rows(M), gs)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return plan_splitk(M, K, N, gs, n_sm, max(1, bps), is_bf16=is_bf16,
                       aligned=aligned)


@functools.lru_cache(maxsize=None)
def _plan8(M: int, K: int, N: int, is_bf16: bool, aligned: bool,
           device: torch.device) -> SplitPlan:
    bps = _lib().dequant_matmul_int8_splitk_blocks_per_sm(padded_rows(M))
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return plan_int8(M, K, N, n_sm, max(1, bps), is_bf16=is_bf16,
                     aligned=aligned)


def int8_plan(x: torch.Tensor, qw: torch.Tensor,
              scale: torch.Tensor) -> SplitPlan:
    """`plan_int8` as the int8 wrapper calls it on x's CUDA device: with the
    card's SM count and the split kernel's occupancy at these rows (kept
    per shape: the wrapper asks on every call)."""
    M, K = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, qw, scale))
    return _plan8(M, K, qw.shape[1], x.dtype == torch.bfloat16, aligned,
                  x.device)


def int4_plan(x: torch.Tensor, packed: torch.Tensor,
              scale: torch.Tensor) -> SplitPlan:
    """`plan_splitk` as the int4 wrapper calls it on x's CUDA device: with
    the card's SM count and the split kernel's occupancy at these rows
    (kept per shape: the wrapper asks on every call)."""
    M, K = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, packed, scale))
    return _plan(M, K, packed.shape[1], K // scale.shape[0],
                 x.dtype == torch.bfloat16, aligned, x.device)



def _check(op: str, x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
           qdtype: torch.dtype) -> None:
    """x (M, K) bf16/f32, the weight of ``qdtype`` and an f32 scale, all on
    x's CUDA device and contiguous; a scale of another dtype is refused,
    never cast."""
    check_tensors(op, [x])
    if x.dim() != 2 or qw.dim() != 2:
        raise ValueError(f"{op}: x {tuple(x.shape)} and the weight "
                         f"{tuple(qw.shape)} must be 2-D")
    for name, t, dt in (("weight", qw, qdtype), ("scale", scale,
                                                 torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{op}: {name} dtype {t.dtype} (want {dt})")
        if t.device != x.device:
            raise ValueError(f"{op}: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} of shape {tuple(t.shape)} is not "
                             "contiguous")
        if t.numel() > INT32_MAX:
            raise ValueError(f"{op}: {name} of {t.numel()} elements exceeds "
                             "the kernel's int32 shape arguments")


def dequant_matmul_int8(x: torch.Tensor, qw: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequantize_int8(qw (K, N) int8, scale (N,) f32) ->
    (M, N) in x.dtype."""
    op = "dequant_matmul_int8"
    if x.device.type == "cpu":
        with kernel_scope(op):
            return dequant_matmul_int8_ref(x, qw, scale)
    if x.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {x.device}")
    _check(op, x, qw, scale, torch.int8)
    M, K = x.shape
    N = qw.shape[1]
    if qw.shape[0] != K or tuple(scale.shape) != (N,):
        raise ValueError(f"{op}: shapes x {tuple(x.shape)}, qw "
                         f"{tuple(qw.shape)}, scale {tuple(scale.shape)} "
                         "disagree")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    plan = int8_plan(x, qw, scale)
    with kernel_scope(op, cuda=True):
        if plan.route == "split_k":
            counters, part = workspace("dequant_matmul", x.device,
                                       plan.n_strips, plan.workspace_floats)
            err = _lib().dequant_matmul_int8_splitk_fwd(
                x.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                out.data_ptr(), part.data_ptr(), counters.data_ptr(),
                M, N, K, plan.slice_k, plan.n_slices, stream_of(x))
        elif plan.route == "wgmma":
            err = _lib().dequant_matmul_int8_tc_fwd(
                x.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                out.data_ptr(), M, N, K, stream_of(x))
        else:
            err = _lib().dequant_matmul_int8_fwd(
                x.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                out.data_ptr(), M, N, K, int(x.dtype == torch.bfloat16),
                stream_of(x))
    check_launch(op, err)
    dequant_matmul_int8.launches += 1
    return out


dequant_matmul_int8.launches = 0


def dequant_matmul_int4(x: torch.Tensor, packed: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequantize_int4(packed (K//2, N) uint8, scale (G, N) f32)
    -> (M, N) in x.dtype. The group size ``K // G`` is implied by the
    shapes and must be even (two rows pack per byte)."""
    op = "dequant_matmul_int4"
    if x.device.type == "cpu":
        with kernel_scope(op):
            return dequant_matmul_int4_ref(x, packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {x.device}")
    _check(op, x, packed, scale, torch.uint8)
    M, K = x.shape
    N = packed.shape[1]
    G = scale.shape[0] if scale.dim() == 2 else 0
    if packed.shape[0] * 2 != K or scale.dim() != 2 or scale.shape[1] != N \
            or G == 0 or K % G or (K // G) % 2:
        raise ValueError(f"{op}: shapes x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scale "
                         f"{tuple(scale.shape)} disagree (want packed "
                         "(K//2, N) and scale (G, N) with an even K // G)")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    is_bf16 = int(x.dtype == torch.bfloat16)
    plan = int4_plan(x, packed, scale)
    with kernel_scope(op, cuda=True):
        if plan.route == "split_k":
            counters, part = workspace("dequant_matmul", x.device,
                                       plan.n_strips, plan.workspace_floats)
            err = _lib().dequant_matmul_int4_splitk_fwd(
                x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                out.data_ptr(), part.data_ptr(), counters.data_ptr(),
                M, N, K, K // G, plan.slice_k, plan.n_slices, is_bf16,
                stream_of(x))
        elif plan.route == "wgmma":
            err = _lib().dequant_matmul_int4_tc_fwd(
                x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                out.data_ptr(), M, N, K, K // G, stream_of(x))
        else:
            err = _lib().dequant_matmul_int4_fwd(
                x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                out.data_ptr(), M, N, K, K // G, is_bf16, stream_of(x))
    check_launch(op, err)
    dequant_matmul_int4.launches += 1
    return out


dequant_matmul_int4.launches = 0


def dequant_matmul(x: torch.Tensor, qw: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ dequantize(qw, scale) -> (..., N)`` in x.dtype, by the
    weight's dtype: uint8 is packed int4, anything else per-column int8."""
    fn = dequant_matmul_int4 if qw.dtype == torch.uint8 else \
        dequant_matmul_int8
    if x.device.type != "cuda":
        return fn(x, qw, scale)        # the plain version keeps leading dims
    if not x.is_contiguous():
        # a reshape would copy quietly; the kernel takes contiguous rows only
        raise ValueError(f"dequant_matmul: x of shape {tuple(x.shape)} is "
                         "not contiguous")
    y = fn(x.reshape(-1, x.shape[-1]), qw, scale)
    return y.reshape(*x.shape[:-1], y.shape[-1])


__all__ = ["dequant_matmul", "dequant_matmul_int8", "dequant_matmul_int4",
           "int4_plan", "int8_plan",
           "dequant_matmul_int8_ref", "dequant_matmul_int4_ref",
           "dequantize_int8", "dequantize_int4", "unpack_int4"]
