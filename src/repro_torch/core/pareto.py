"""Pareto-front utilities for multi-objective orchestration (v2 title).

All objectives are minimized; negate maximization objectives before calling.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """a dominates b: <= in every objective, < in at least one.

    Single-pass with early exit — this sits on the annealer's per-candidate
    archive path, so generator-pair elegance costs real wall-clock.
    """
    lt = False
    for x, y in zip(a, b):
        if x > y:
            return False
        if x < y:
            lt = True
    return lt


def pareto_front(points: Sequence[Sequence[float]]) -> List[int]:
    """Indices of the non-dominated points (O(n^2), fine for config sweeps)."""
    n = len(points)
    out = []
    for i in range(n):
        if not any(dominates(points[j], points[i])
                   for j in range(n) if j != i):
            out.append(i)
    return out


def hypervolume_2d(points: Sequence[Tuple[float, float]],
                   ref: Tuple[float, float]) -> float:
    """2-D hypervolume (minimization) w.r.t. reference point — the scalar
    'did the frontier move' metric used in EXPERIMENTS.md §Perf.

    The 2-D non-dominated subset falls out of one sort + sweep (ascending x,
    keep strictly-improving y) in O(n log n) — PGSAM calls this on every
    convergence check, where the generic O(n^2) `pareto_front` dominated the
    anneal's profile.
    """
    pts = sorted({(x, y) for x, y in points if x < ref[0] and y < ref[1]})
    front = []
    best_y = float("inf")
    for x, y in pts:
        if y < best_y:
            front.append((x, y))
            best_y = y
    hv = 0.0
    for i, (x, y) in enumerate(front):
        next_x = front[i + 1][0] if i + 1 < len(front) else ref[0]
        hv += (next_x - x) * (ref[1] - y)
    return hv
