"""Mamba-2 SSD chunk wrapper: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

The kernels (``repro_torch/csrc/ssd_scan.cu``) replace the TPU kernel
`ssd_chunk_pallas` in ``src/repro/kernels/ssd_scan/ssd_scan.py``: the
intra-chunk half of every Mamba layer's prefill. They read the model layout
through strides, so the head axis of B and C may be a stride-0 broadcast of
their groups and x may be a strided slice of the conv output; nothing is
moved into the reference's ``(B*H, nc, Q, ...)`` layout. The planner
(`plan.plan_ssd_chunk`) picks the tensor-core kernel or the scalar-FMA one
before the launch. ``ssd_chunk.launches`` counts the launches of either;
the CPU path does not count.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import KERNEL_DTYPES, check_launch, stream_of
from repro_torch.kernels.ssd_scan.plan import SsdPlan, plan_ssd_chunk
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
from repro_torch.obs.profiling import kernel_scope

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
GRID_Z_MAX = 65535


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    lib.ssd_scan_fwd.argtypes = [_P] * 7 + [_I] * 6 + [_L] * 12 + [_I, _P]
    lib.ssd_scan_fwd.restype = _I
    lib.ssd_scan_tc_fwd.argtypes = [_P] * 7 + [_I] * 6 + [_L] * 12 + [_I, _P]
    lib.ssd_scan_tc_fwd.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _plan(BC: int, Q: int, H: int, P: int, N: int, is_bf16: bool,
          aligned: bool, shared: bool, n_sm: Optional[int],
          device: torch.device) -> SsdPlan:
    if n_sm is None:
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return plan_ssd_chunk(BC, Q, H, P, N, is_bf16=is_bf16, aligned=aligned,
                          shared=shared, n_sm=n_sm)


def _aligned(*ts: torch.Tensor) -> bool:
    """Base pointers and the batch, chunk, row and head strides 16-byte
    aligned (a stride 0 is)."""
    return all(t.data_ptr() % 16 == 0
               and all(s * t.element_size() % 16 == 0 for s in t.stride()[:4])
               for t in ts)


def ssd_plan(xc: torch.Tensor, dtc: torch.Tensor, dA: torch.Tensor,
             dA_cs: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
             n_sm: Optional[int] = None) -> SsdPlan:
    """The plan the wrapper launches for these model-layout inputs on their
    CUDA device (``n_sm``: that card's SM count, read from it by default;
    kept per shape: the wrapper asks on every call)."""
    Bsz, nc, Q, H, P = xc.shape
    return _plan(Bsz * nc, Q, H, P, Bc.shape[-1], xc.dtype == torch.bfloat16,
                 _aligned(xc, Bc, Cc), Bc.stride(3) == 0 and Cc.stride(3) == 0,
                 n_sm, xc.device)


def _check(xc, dtc, dA, dA_cs, Bc, Cc) -> None:
    op = "ssd_scan"
    if xc.dim() != 5 or Bc.dim() != 5 or Cc.dim() != 5:
        raise ValueError(f"{op}: x, B, C must be 5-D (B, nc, Q, H, width)")
    lead = tuple(xc.shape[:4])
    for name, t in (("dt", dtc), ("dA", dA), ("dA_cs", dA_cs)):
        if tuple(t.shape) != lead:
            raise ValueError(f"{op}: {name} shape {tuple(t.shape)}, want "
                             f"{lead}")
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: {name} dtype {t.dtype} (want float32)")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")
    if tuple(Bc.shape[:4]) != lead or Cc.shape != Bc.shape:
        raise ValueError(f"{op}: shapes x {tuple(xc.shape)}, B "
                         f"{tuple(Bc.shape)}, C {tuple(Cc.shape)} disagree")
    if xc.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{op}: dtype {xc.dtype} unsupported (bf16 or f32)")
    for name, t in (("B", Bc), ("C", Cc)):
        if t.dtype != xc.dtype:
            raise TypeError(f"{op}: {name} dtype {t.dtype}, x {xc.dtype}")
    for name, t in (("x", xc), ("B", Bc), ("C", Cc)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{op}: the last axis of {name} must be "
                             "contiguous")
    for t in (dtc, dA, dA_cs, Bc, Cc):
        if t.device != xc.device:
            raise ValueError(f"{op}: tensors on {t.device} and {xc.device}")
    if xc.shape[0] * xc.shape[1] > GRID_Z_MAX:
        raise ValueError(f"{op}: batch x chunks {xc.shape[0] * xc.shape[1]} "
                         f"exceeds the grid's {GRID_Z_MAX}")


def ssd_chunk(xc: torch.Tensor, dtc: torch.Tensor, dA: torch.Tensor,
              dA_cs: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout: xc (B,nc,Q,H,P); dtc, dA, dA_cs (B,nc,Q,H) f32;
    Bc, Cc (B,nc,Q,H,N) in x's dtype (bf16 or f32). Returns
    (Y_diag (B,nc,Q,H,P), states (B,nc,H,P,N)) in f32. The kernel reads
    ``dA`` only through its cumulative sum ``dA_cs``."""
    op = "ssd_scan"
    if xc.device.type == "cpu":
        with kernel_scope(op):
            return ssd_chunk_ref(xc, dtc, dA, dA_cs, Bc, Cc)
    if xc.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {xc.device}")
    _check(xc, dtc, dA, dA_cs, Bc, Cc)
    Bsz, nc, Q, H, P = xc.shape
    N = Bc.shape[-1]
    y = torch.empty((Bsz, nc, Q, H, P), dtype=torch.float32,
                    device=xc.device)
    st = torch.empty((Bsz, nc, H, P, N), dtype=torch.float32,
                     device=xc.device)
    if y.numel() == 0 or st.numel() == 0:
        return y.zero_(), st.zero_()
    plan = ssd_plan(xc, dtc, dA, dA_cs, Bc, Cc)
    args = (xc.data_ptr(), dtc.data_ptr(), dA_cs.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), y.data_ptr(), st.data_ptr(), Bsz, nc, Q, H, P, N,
            *xc.stride()[:4], *Bc.stride()[:4], *Cc.stride()[:4])
    with kernel_scope(op, cuda=True):
        if plan.route == "mma":
            err = _lib().ssd_scan_tc_fwd(*args, plan.heads_per_block,
                                         stream_of(xc))
        else:
            err = _lib().ssd_scan_fwd(*args, int(xc.dtype == torch.bfloat16),
                                      stream_of(xc))
    check_launch(op, err)
    ssd_chunk.launches += 1
    return y, st


ssd_chunk.launches = 0

__all__ = ["ssd_chunk", "ssd_chunk_ref", "ssd_plan"]
