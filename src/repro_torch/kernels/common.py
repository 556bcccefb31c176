"""Checks shared by the kernel wrappers before a pointer reaches CUDA, and
the split kernels' workspaces."""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
INT32_MAX = 2 ** 31 - 1


def check_tensors(op: str, float_tensors: Sequence[torch.Tensor],
                  int_tensors: Sequence[torch.Tensor] = ()) -> None:
    """Every tensor on one CUDA device and contiguous; the float ones share
    one dtype the kernels take (bf16 or f32); the index ones are int32."""
    dev = float_tensors[0].device
    dtype = float_tensors[0].dtype
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{op}: dtype {dtype} unsupported (bf16 or f32)")
    for t in list(float_tensors) + list(int_tensors):
        if t.device != dev:
            raise ValueError(f"{op}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: tensor of shape {tuple(t.shape)} is not "
                             "contiguous")
        if t.numel() > INT32_MAX:
            raise ValueError(f"{op}: tensor of {t.numel()} elements exceeds "
                             "the kernel's int32 shape arguments")
    for t in float_tensors:
        if t.dtype != dtype:
            raise TypeError(f"{op}: mixed dtypes {t.dtype} and {dtype}")
    for t in int_tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{op}: index tensor dtype {t.dtype} (want int32)")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_launch(op: str, err: int) -> None:
    """A launch the card refused never runs and no synchronize reports it:
    the C entry point returns ``cudaGetLastError()`` and this raises on it."""
    if err != 0:
        raise RuntimeError(f"{op}: CUDA kernel launch failed (cudaError {err})")


_workspaces: Dict[Tuple[str, torch.device],
                  Tuple[torch.Tensor, torch.Tensor]] = {}
_holders: List[Dict[int, torch.Tensor]] = []


def workspace(owner: str, device: torch.device, n_counters: int,
              n_part: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scratch of ``owner``'s split kernels on ``device``, allocated once
    and grown when a call needs more: int32 merge counters, zero between
    launches (each launch leaves them 0), and f32 partials. Kernels on one
    stream share it; calls on two streams at once would race.

    Growth drops the cached pair. A CUDA graph keeps the raw pointers it
    captured, so a capture runs inside `holding_workspaces`, and the graph's
    owner keeps every pair handed out there alive as long as the graph."""
    counters, part = _workspaces.get((owner, device), (None, None))
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(max(n_counters, 1024), dtype=torch.int32,
                               device=device)
    if part is None or part.numel() < n_part:
        part = torch.empty(max(n_part, 1 << 16), dtype=torch.float32,
                           device=device)
    _workspaces[(owner, device)] = (counters, part)
    for held in _holders:
        held[id(counters)], held[id(part)] = counters, part
    return counters, part


@contextlib.contextmanager
def holding_workspaces() -> Iterator[Dict[int, torch.Tensor]]:
    """Collect every workspace tensor `workspace` hands out inside the
    block; the caller keeps the collection (and so the tensors) alive."""
    held: Dict[int, torch.Tensor] = {}
    _holders.append(held)
    try:
        yield held
    finally:
        _holders.remove(held)
