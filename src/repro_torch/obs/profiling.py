"""Kernel profiling hooks: named ranges around the kernel call sites.

`kernel_scope(name, cuda=...)` wraps one kernel call in
``torch.profiler.record_function`` (a host range that `torch.profiler`
traces tie to the device kernels launched inside it) and, for a call on the
card, an NVTX range of the same name. Both cost next to nothing when no
profiler is attached.
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
