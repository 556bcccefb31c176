"""Kernel profiling hooks: named ranges around the kernel call sites.

`scoped_range(label, nvtx)` is the one way the port opens a named range:
a ``torch.profiler.record_function`` range while a profiler records (a host
range that `torch.profiler` traces tie to the device work launched inside
it) and, with ``nvtx``, an NVTX range of the same name. With neither it
returns a shared no-op, so an instrumented site costs one query of the
profiler's state when nothing records. `kernel_scope(name, cuda=...)` opens
one around a kernel call (NVTX for a call on the card); `annotate(name)`
opens the profiler range alone, for timing loops around the calls (the
`repro_torch.launch.profile` rep timer); the tracer's wall-clock spans
(`repro_torch.obs.tracer.Tracer.span`) open theirs through it too.

`gpu_roofline_us` prices a kernel call's flops and bytes against the
modeled H100 (`repro_torch.core.devices.CLOUD_GPU`) as the reference's
``tpu_roofline_us`` prices them against its TPU: the ceiling the
calibration fitter fits each kernel's duty factor eta against.
"""
from __future__ import annotations

import torch

#: prefix of every instrumented kernel call site
SCOPE_PREFIX = "repro_torch.kernels"


class _NoRange:
    """The shared range that opens nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoRange":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_RANGE = _NoRange()


class _Range:
    """A profiler range (when one records), and an NVTX range (``nvtx``)."""

    __slots__ = ("label", "recorded", "nvtx")

    def __init__(self, label: str, recording: bool, nvtx: bool):
        self.label = label
        self.recorded = (torch.profiler.record_function(label)
                         if recording else None)
        self.nvtx = nvtx

    def __enter__(self) -> "_Range":
        if self.recorded is not None:
            self.recorded.__enter__()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.label)
        return self

    def __exit__(self, *exc) -> bool:
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        if self.recorded is not None:
            self.recorded.__exit__(*exc)
        return False


def scoped_range(label: str, nvtx: bool = False):
    """A context manager that opens the range ``label``: a profiler range
    while a profiler records, and an NVTX range when ``nvtx``; the shared
    no-op when neither."""
    recording = torch.autograd._profiler_enabled()
    if not (recording or nvtx):
        return NO_RANGE
    return _Range(label, recording, nvtx)


def kernel_scope(name: str, cuda: bool = False):
    """Annotate one kernel call site: a profiler range while one records,
    plus an NVTX range when the call runs on the card."""
    return scoped_range(f"{SCOPE_PREFIX}/{name}", cuda)


def annotate(name: str):
    """A profiler range alone (no NVTX), for timing loops around the
    kernel calls."""
    return scoped_range(f"{SCOPE_PREFIX}/{name}")


def gpu_roofline_us(flops: float, bytes_moved: float) -> float:
    """Modeled roofline time of one kernel invocation on `CLOUD_GPU`, in us:
    the larger of flops over ``peak_flops * util`` and bytes over ``mem_bw *
    util``."""
    from repro_torch.core.devices import CLOUD_GPU
    t = max(flops / (CLOUD_GPU.peak_flops * CLOUD_GPU.util),
            bytes_moved / (CLOUD_GPU.mem_bw * CLOUD_GPU.util))
    return t * 1e6
