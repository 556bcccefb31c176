"""Kernel profiling hooks: named ranges around the kernel call sites.

`kernel_scope(name, cuda=...)` wraps one kernel call in
``torch.profiler.record_function`` (a host range that `torch.profiler`
traces tie to the device kernels launched inside it) and, for a call on the
card, an NVTX range of the same name. `annotate(name)` is the profiler
range alone, for timing loops around the calls (the
`repro_torch.launch.profile` rep timer). All cost next to nothing when no
profiler is attached.

`gpu_roofline_us` prices a kernel call's flops and bytes against the
modeled H100 (`repro_torch.core.devices.CLOUD_GPU`) as the reference's
``tpu_roofline_us`` prices them against its TPU: the ceiling the
calibration fitter fits each kernel's duty factor eta against.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

#: prefix of every instrumented kernel call site
SCOPE_PREFIX = "repro_torch.kernels"


@contextlib.contextmanager
def kernel_scope(name: str, cuda: bool = False) -> Iterator[None]:
    """Annotate one kernel call site: a profiler range, plus an NVTX range
    when the call runs on the card."""
    label = f"{SCOPE_PREFIX}/{name}"
    with torch.profiler.record_function(label):
        if not cuda:
            yield
            return
        torch.cuda.nvtx.range_push(label)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A profiler range alone (no NVTX), for timing loops around the
    kernel calls."""
    with torch.profiler.record_function(f"{SCOPE_PREFIX}/{name}"):
        yield


def gpu_roofline_us(flops: float, bytes_moved: float) -> float:
    """Modeled roofline time of one kernel invocation on `CLOUD_GPU`, in us:
    the larger of flops over ``peak_flops * util`` and bytes over ``mem_bw *
    util``."""
    from repro_torch.core.devices import CLOUD_GPU
    t = max(flops / (CLOUD_GPU.peak_flops * CLOUD_GPU.util),
            bytes_moved / (CLOUD_GPU.mem_bw * CLOUD_GPU.util))
    return t * 1e6
