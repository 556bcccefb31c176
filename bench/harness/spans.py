"""The program's wall-clock spans in a traced run, for the readers of
``program_span`` metrics.

`Run.spans` holds the program's wall spans that lie inside the window
(`repro_torch.obs.tracer`): the scheduler's ``step`` and its phases, the
backend's ``prefill`` and ``decode`` with their ``enqueue`` and ``sync``
children, ``readout`` and ``device_time`` after a timed replay, one
``queued`` a request. Readers take the spans outside the profiled slice
(`untraced`): the profiler slows what runs under it. A program without the
spans a reader asks for yields none, and the reader returns None.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional

#: the spans of one forward on the device
FORWARDS = ("prefill", "decode")


def untraced(run, name: str) -> List:
    """The spans named ``name`` that do not overlap the profiled slice."""
    a, b = run.slice_wall
    return [s for s in run.spans
            if s.name == name and (s.t1_s <= a or s.t0_s >= b)]


def children(run) -> Dict[int, List]:
    """Span id -> its child spans."""
    out: Dict[int, List] = defaultdict(list)
    for s in run.spans:
        if s.parent_id is not None:
            out[s.parent_id].append(s)
    return out


def descendants(span, kids: Dict[int, List]) -> Iterable:
    todo = list(kids.get(span.span_id, ()))
    while todo:
        s = todo.pop()
        yield s
        todo.extend(kids.get(s.span_id, ()))


def window(forward, kids: Dict[int, List]) -> Optional[tuple]:
    """When a forward's work is on the device: from the start of its
    first ``enqueue`` to the end of its ``sync``."""
    mine = kids.get(forward.span_id, ())
    enq = [c.t0_s for c in mine if c.name == "enqueue"]
    syn = [c.t1_s for c in mine if c.name == "sync"]
    if not enq or not syn:
        return None
    return min(enq), max(syn)


def covered_s(intervals, lo: float, hi: float) -> float:
    """The length of the union of ``(start, end)`` intervals within
    ``[lo, hi]``."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def host_gap_ms(run) -> Optional[float]:
    """Mean milliseconds, over the untraced ``step`` spans, of the step's
    wall less the union, within it, of its forwards' device-outstanding
    windows and the ``readout`` spans of its decodes (a timed replay's
    readout runs at the next decode step, inside that step's window): the
    host time of a step in which the device holds no work of the
    program."""
    steps = untraced(run, "step")
    if not steps:
        return None
    kids = children(run)
    gaps = []
    for st in steps:
        held = []
        for s in descendants(st, kids):
            if s.name in FORWARDS:
                w = window(s, kids)
                if w is None:
                    return None
                held.append(w)
            elif s.name == "readout":
                held.append((s.t0_s, s.t1_s))
        gaps.append(st.t1_s - st.t0_s - covered_s(held, st.t0_s, st.t1_s))
    return 1e3 * sum(gaps) / len(gaps)


def device_ms(run, segments) -> Optional[float]:
    """Mean, over the untraced ``device_time`` spans, of the summed
    milliseconds of ``segments``; None where no span holds one of them."""
    spans = untraced(run, "device_time")
    if not spans or not any(k in s.attrs for s in spans for k in segments):
        return None
    return sum(sum(s.attrs.get(k, 0.0) for k in segments)
               for s in spans) / len(spans)
