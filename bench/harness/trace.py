"""The device's side of a traced slice, from `torch.profiler`'s trace.

`read_profile` takes a finished profiler that covered a ``bench/slice``
range of whole scheduler steps (synchronised at its end) and returns:

* ``kernels``: every device operation in the range (kernels, copies,
  memsets) as (name, start_s, seconds);
* ``window_s``: the range's wall length; ``busy_s``: the length of the union
  of the device operations' intervals inside it;
* ``device_ops``: the ten kernel names with the most device time;
* ``idle_gaps``: the stretches with no device operation, summed by what
  the host was doing (the innermost host range open at each gap's middle),
  the ten longest sums;
* ``steps``: the runner's step records of the slice.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from collections import defaultdict
from typing import Any, Dict, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: idle stretches shorter than this are launch gaps between kernels
SHORT_GAP_US = 10.0


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def _union(intervals, lo: float, hi: float):
    merged = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read_profile(prof, steps) -> Dict[str, Any]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in ("bench/slice", "bench/step")]
    if not marks:
        raise RuntimeError("the profiler's trace holds no bench/step range")
    lo = min(float(e["ts"]) for e in marks)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in marks)
    main = (marks[0].get("pid"), marks[0].get("tid"))
    n_dev = sum(e.get("cat") in DEVICE_CATS for e in events)
    print(f"[bench] trace: {len(events)} events, {n_dev} on the device; "
          + "; ".join(f"{e['name']} ts {e['ts']} dur {e['dur']}"
                      for e in marks[:3] + marks[-2:]), file=sys.stderr)
    kernels, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            if ts < hi and ts + dur > lo:
                kernels.append((e.get("name", ""), ts, dur))
        elif cat in HOST_CATS and (e.get("pid"), e.get("tid")) == main:
            host.append((ts, ts + dur, e.get("name", "")))
    busy = _union([(t, t + d) for _, t, d in kernels], lo, hi)
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = defaultdict(float)
    for name, _, dur in kernels:
        by_name[_short(name)] += dur
    gaps: Dict[str, float] = defaultdict(float)
    host.sort()
    active: List[tuple] = []
    nxt = 0
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < SHORT_GAP_US:
            gaps["(between kernels, under 10 us)"] += b - a
            continue
        mid = 0.5 * (a + b)
        while nxt < len(host) and host[nxt][0] <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] >= mid]
        inner = [h for h in active if h[2] != "bench/slice"]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else \
            "(no host range)"
        gaps[_short(name)] += b - a
    top = lambda d: [[k, v * 1e-6] for k, v in            # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"kernels": [(n, t * 1e-6, d * 1e-6) for n, t, d in kernels],
            "window_s": (hi - lo) * 1e-6, "busy_s": busy_us * 1e-6,
            "device_ops": top(by_name), "idle_gaps": top(gaps),
            "steps": list(steps)}


def kernel_seconds(profile: Dict[str, Any], patterns: List[str]) -> float:
    """Device seconds of the slice's kernels whose names contain one of
    ``patterns``."""
    return sum(d for n, _, d in profile["kernels"]
               if any(p in n for p in patterns))
