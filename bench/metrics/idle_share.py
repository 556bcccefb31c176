"""The share of the device's time in which no operation runs, in percent:
one less the device's busy time in the profiled slice (the union of its
kernel, copy and memset intervals) over the wall that the same steps take
untraced. The slice's own wall is not the denominator: under the profiler
each CUDA-graph launch takes milliseconds of host time, which would read as
idle device time. A slice step's untraced wall is the mean length of the
window's untraced steps that ran the same forwards (a prefill's step is
longer than a decode's), scaled by the untraced window's seconds over its
steps' summed lengths (the host's time between steps)."""
from collections import defaultdict


def _kind(step):
    return tuple(sorted(e.kind for e in step.events))


def read(run):
    p = run.profile
    outside = run.steps_untraced()
    if p is None or not p["steps"] or not outside:
        return None
    by_kind = defaultdict(list)
    for s in outside:
        by_kind[_kind(s)].append(s.t1 - s.t0)
    total = sum(s.t1 - s.t0 for s in outside)
    mean = total / len(outside)
    wall = sum(sum(by_kind[k]) / len(by_kind[k]) if by_kind[k] else mean
               for k in map(_kind, p["steps"]))
    wall *= run.untraced_s / total
    return 100.0 * (1.0 - p["busy_s"] / wall)
