"""Grouped expert GEMM wrapper: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

The kernel (``repro_torch/csrc/moe_gemm.cu``) replaces the TPU kernel
`moe_gemm_pallas` in ``src/repro/kernels/moe_gemm/moe_gemm.py``: the gate,
up and down products of every MoE layer, all experts in one launch.
``moe_gemm.launches`` counts the kernel's launches; the CPU path does not
count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_launch, check_tensors, stream_of
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.obs.profiling import kernel_scope

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("moe_gemm")
    lib.moe_gemm_fwd.argtypes = [_P] * 3 + [_I] * 5 + [_P]
    lib.moe_gemm_fwd.restype = _I
    return lib


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
    with kernel_scope(op, cuda=True):
        err = _lib().moe_gemm_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, F, D,
            int(x.dtype == torch.bfloat16), stream_of(x))
    check_launch(op, err)
    moe_gemm.launches += 1
    return out


moe_gemm.launches = 0

__all__ = ["moe_gemm", "moe_gemm_ref"]
