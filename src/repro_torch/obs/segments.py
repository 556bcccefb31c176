"""Device time by model segment, from CUDA timing events captured in a
decode graph.

A graph replay runs no Python, so no profiler or NVTX range can split its
device time. Instead the model marks where each segment of a forward
begins (`mark`), and a timing capture (`SegmentTimer.recording`, which
`repro_torch.serving.graphs.DecodeGraph.capture` enters when the tracer is
on) turns each mark into a timing event recorded on the capturing stream:
``torch.cuda.Event(enable_timing=True, external=True)``, an event-record
node of the graph. Every replay records every event again; `read`, after
the replay's synchronisation, returns the milliseconds between each mark
and the next, summed by segment over the layers, and ``total_ms``, first
event to last. Outside a timing capture a mark reads one context variable
and records nothing, so the graphs captured with tracing off are the
graphs of before.

The segments, in a forward's order (`SEGMENTS`): ``embed``; per layer
``attn.norm``, ``attn.qkv``, ``attn.rope_kv`` (rotary and the KV-cache
write), ``attn.core`` (the attention kernel), ``attn.out`` (the output
projection), ``attn.residual``, ``ffn.norm``, then the dense FFN's
``mlp.up``, ``mlp.act``, ``mlp.down`` or the MoE FFN's ``moe.route`` (the
router's product through the dispatch), ``moe.gemm``, ``moe.combine``, and
``ffn.residual``; then ``head.norm``, ``head.vocab`` and ``head.sample``
(the decode step's sampling and its token write). A Mamba-2 or MLA mixer
is one segment, ``mixer``, in place of ``attn.qkv`` to ``attn.out``, and a
cross-attention sublayer one, ``cross``, after ``attn.residual``.
`GEMM_FREE` names the segments that run no matrix product.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

SEGMENTS = ("embed", "attn.norm", "attn.qkv", "attn.rope_kv", "attn.core",
            "attn.out", "mixer", "attn.residual", "cross", "ffn.norm",
            "mlp.up", "mlp.act", "mlp.down", "moe.route", "moe.gemm",
            "moe.combine", "ffn.residual", "head.norm", "head.vocab",
            "head.sample")
#: the segments that run no matrix product
GEMM_FREE = ("attn.norm", "attn.rope_kv", "attn.residual", "ffn.norm",
             "mlp.act", "ffn.residual", "head.norm", "head.sample")

_TIMER: ContextVar[Optional["SegmentTimer"]] = ContextVar(
    "repro_torch_segment_timer", default=None)


def mark(name: str) -> None:
    """Begin segment ``name`` here (one of `SEGMENTS`); a no-op unless a
    timing capture is active."""
    timer = _TIMER.get()
    if timer is not None:
        timer.mark(name)


def _timing_event():
    return torch.cuda.Event(enable_timing=True, external=True)


class SegmentTimer:
    """The timing events of one captured step: one a mark, and one at the
    step's end. ``event`` makes an event (``record()``, and
    ``elapsed_time(later)`` in ms); on the card a CUDA timing event."""

    def __init__(self, event: Callable[[], object] = _timing_event):
        self._event = event
        self.marks: List[Tuple[str, object]] = []
        self.end = None

    def mark(self, name: str) -> None:
        ev = self._event()
        ev.record()
        self.marks.append((name, ev))

    @contextlib.contextmanager
    def recording(self) -> Iterator["SegmentTimer"]:
        """Turn the marks of the ``with`` block into this timer's events,
        and record the closing event at its end."""
        token = _TIMER.set(self)
        try:
            yield self
        finally:
            _TIMER.reset(token)
        self.end = self._event()
        self.end.record()

    def read(self) -> Dict[str, float]:
        """Milliseconds by segment, summed over its marks, and
        ``total_ms`` from the first event to the last. Call once the
        events' work has finished (after the step's synchronisation)."""
        if not self.marks or self.end is None:
            return {}
        out: Dict[str, float] = {}
        events = [ev for _, ev in self.marks] + [self.end]
        for (name, a), b in zip(self.marks, events[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        out["total_ms"] = events[0].elapsed_time(self.end)
        return out


__all__ = ["GEMM_FREE", "SEGMENTS", "SegmentTimer", "mark"]
