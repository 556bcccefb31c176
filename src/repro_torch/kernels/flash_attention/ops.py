"""Flash attention wrapper: the Hopper kernels for CUDA tensors, the plain
version for CPU tensors.

The kernels (``repro_torch/csrc/flash_attention.cu``) replace the TPU kernel
`flash_attention_pallas` in ``src/repro/kernels/flash_attention/
flash_attention.py``. The wrapper dispatches on the dtype to two
hand-written kernels: bf16 runs on the tensor cores (wgmma, K/V by TMA),
f32 on scalar f32 FMAs, since the f32 path is held to its plain version at
1e-4 and TF32 tensor cores keep about three decimal digits. A CUDA tensor
launches one of them or raises. ``flash_attention.launches`` counts the
launches; the CPU path does not count.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_launch, check_tensors, stream_of
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.obs.profiling import kernel_scope

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [_P, _P, _P, _P] + [_I] * 7 + [
        ctypes.c_float, _I, _I, _I, _P]
    lib.flash_attention_fwd.restype = _I
    lib.flash_attention_smem_bytes.argtypes = [_I, _I, _I]
    lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check_tc_shapes(q, k, v, D: int, Dv: int) -> None:
    """What the bf16 tensor-core kernel takes: TMA rows of a multiple of 16
    bytes from 16-byte aligned bases, and an output accumulator of at most
    128 columns."""
    if D % 8 or Dv % 8:
        raise ValueError(f"flash_attention: bf16 head dims D={D}, Dv={Dv} "
                         "must be multiples of 8")
    if Dv > 128:
        raise ValueError(f"flash_attention: bf16 value head dim {Dv} > 128")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention: bf16 inputs must start on a "
                             "16-byte boundary")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention: q (B,Sq,H,D), k (B,Sk,Hkv,D), v (B,Sk,Hkv,Dv) ->
    (B,Sq,H,Dv), with positions an iota from 0 (fresh prefill)."""
    if q.device.type == "cpu":
        with kernel_scope("flash_attention"):
            return flash_attention_ref(q, k, v, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    check_tensors("flash_attention", [q, k, v])
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, S, H, D)")
    B, Sq, H, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if (Bk, Sk, Hkv) != tuple(v.shape[:3]) or Bk != B or Dk != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: {H} heads not a multiple of "
                         f"{Hkv} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    Dv = v.shape[3]
    is_bf16 = q.dtype == torch.bfloat16
    if is_bf16:
        _check_tc_shapes(q, k, v, D, Dv)
    lib = _lib()
    smem = lib.flash_attention_smem_bytes(D, Dv, int(is_bf16))
    if smem > build.MAX_SMEM_PER_BLOCK:
        raise ValueError(f"flash_attention: head dims D={D}, Dv={Dv} need "
                         f"{smem} B of shared memory per block "
                         f"(> {build.MAX_SMEM_PER_BLOCK})")
    if scale is None:
        scale = D ** -0.5
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    with kernel_scope("flash_attention", cuda=True):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, Hkv, D, Dv, float(scale),
            int(window is not None), int(window or 0),
            int(is_bf16), stream_of(q))
    check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

__all__ = ["flash_attention", "flash_attention_ref"]
