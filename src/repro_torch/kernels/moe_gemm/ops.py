"""Grouped expert GEMM wrapper: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

The kernels (``repro_torch/csrc/moe_gemm.cu``) replace the TPU kernel
`moe_gemm_pallas` in ``src/repro/kernels/moe_gemm/moe_gemm.py``: the gate,
up and down products of every MoE layer, all experts in one launch. The
planner (`plan.plan_moe_gemm`) picks the TMA + wgmma kernel or the cp.async
one before the launch. ``moe_gemm.launches`` counts the launches of either;
the CPU path does not count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_launch, check_tensors, stream_of
from repro_torch.kernels.moe_gemm.plan import MoePlan, plan_moe_gemm
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.obs.profiling import kernel_scope

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("moe_gemm")
    lib.moe_gemm_fwd.argtypes = [_P] * 3 + [_I] * 5 + [_P]
    lib.moe_gemm_fwd.restype = _I
    lib.moe_gemm_tc_fwd.argtypes = [_P] * 3 + [_I] * 6 + [_P]
    lib.moe_gemm_tc_fwd.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _plan(E: int, C: int, D: int, F: int, is_bf16: bool, aligned: bool,
          device: torch.device) -> MoePlan:
    return plan_moe_gemm(E, C, D, F, is_bf16=is_bf16, aligned=aligned,
                         n_sm=torch.cuda.get_device_properties(
                             device).multi_processor_count)


def moe_plan(x: torch.Tensor, w: torch.Tensor) -> MoePlan:
    """The plan the wrapper launches for ``x (E, C, d) @ w (E, d, f)`` on
    their CUDA device (kept per shape: the wrapper asks on every call)."""
    E, C, D = x.shape
    return _plan(E, C, D, w.shape[2], x.dtype == torch.bfloat16,
                 x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0, x.device)


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[e] = x[e] @ w[e]: x (E, C, d), w (E, d, f) -> (E, C, f) in x's
    dtype, accumulated in f32. x and w share one dtype (bf16 or f32)."""
    op = "moe_gemm"
    if x.device.type == "cpu":
        with kernel_scope(op):
            return moe_gemm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {x.device}")
    check_tensors(op, [x, w])
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"{op}: shapes x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} disagree (want (E, C, d) and "
                         "(E, d, f))")
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or D == 0:
        return out.zero_()
    plan = moe_plan(x, w)
    with kernel_scope(op, cuda=True):
        if plan.route == "wgmma":
            err = _lib().moe_gemm_tc_fwd(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, F, D,
                plan.consumers, plan.stages, stream_of(x))
        else:
            err = _lib().moe_gemm_fwd(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, F, D,
                int(x.dtype == torch.bfloat16), stream_of(x))
    check_launch(op, err)
    moe_gemm.launches += 1
    return out


moe_gemm.launches = 0

__all__ = ["moe_gemm", "moe_gemm_ref", "moe_plan"]
