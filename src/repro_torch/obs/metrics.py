"""Metrics registry: counters / gauges / bucketed histograms with Prometheus
text exposition and a JSON snapshot.

Design constraints, in order:

* **Zero-cost-when-off.** Components resolve their metric handles once at
  construction (``registry.counter(...)`` is get-or-create) and guard hot
  paths on ``registry.enabled``; the `NullRegistry` hands back one shared
  no-op metric so an uninstrumented server pays a single attribute load per
  guarded site. A pinned test asserts serving output is bit-identical with
  metrics on vs. off — metrics are pure observers and never touch the rng
  stream.
* **No background machinery.** Nothing here spawns threads or reads clocks;
  the `PeriodicReporter` is driven by the serving loop (`launch/serve
  --metrics-out/--metrics-interval`) and writes both the JSON snapshot and
  the Prometheus text file (``<out>.prom``) whenever the caller's clock says
  the interval elapsed.
* **Prometheus-compatible exposition.** `MetricsRegistry.to_prometheus`
  renders the standard text format: ``# HELP`` / ``# TYPE`` headers,
  ``name{label="v"} value`` samples, histogram ``_bucket``/``_sum``/
  ``_count`` series with *cumulative* bucket counts and a ``+Inf`` bucket.
  Output is sorted (names, then label values) so two snapshots of the same
  state are byte-identical — the formatting tests pin exact text.

Histograms use fixed bucket edges chosen at creation (`DEFAULT_BUCKETS`
mirrors the Prometheus client default). ``quantile(q)`` interpolates within
the owning bucket, so estimates are always bounded by the bucket's edges —
the hypothesis invariant tests in ``tests/test_obs.py`` pin bucket-count
conservation, cumulative monotonicity and that bound.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

# prometheus client defaults: latency-flavored edges in seconds
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# edges for ratio-valued observations in [0, 1] (e.g. speculative-decode
# accept rates, per-batch prefix-pool hit ratios): uniform tenths, with the
# 1.0 edge catching exact unity
RATIO_BUCKETS: Tuple[float, ...] = (
    0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


def _escape_label(value: str) -> str:
    return (value.replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integers render bare (``3`` not ``3.0``)."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Metric:
    """Shared label plumbing: one child value per label-value tuple."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def label_sets(self) -> List[Tuple[str, ...]]:
        return sorted(self._children)

    def _labels_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.labelnames, key))


class Counter(_Metric):
    """Monotonically increasing count. ``inc`` rejects negative amounts —
    a counter that can go down is a gauge wearing the wrong type."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc({amount}))")
        k = self._key(labels)
        self._children[k] = self._children.get(k, 0.0) + float(amount)

    def value(self, **labels) -> float:
        return self._children.get(self._key(labels), 0.0)


class Gauge(_Metric):
    """Point-in-time value. ``set_max`` is the high-water helper (KV block
    peaks): keeps the running maximum of everything set through it."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._children[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        self._children[k] = self._children.get(k, 0.0) + float(amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def set_max(self, value: float, **labels) -> None:
        k = self._key(labels)
        self._children[k] = max(self._children.get(k, float("-inf")),
                                float(value))

    def value(self, **labels) -> float:
        return self._children.get(self._key(labels), 0.0)


class _HistChild:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)   # +1: overflow (+Inf) bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Fixed-bucket histogram: per-bucket counts + sum + count.

    ``buckets`` are the upper edges (strictly increasing); observations land
    in the first bucket whose edge is ``>= v``, or the implicit ``+Inf``
    overflow bucket. Designed for non-negative observations (latencies,
    sizes) — ``quantile`` treats 0 as the lower edge of the first bucket.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(float(b) for b in buckets)
        if not self.buckets or \
                any(a >= b for a, b in zip(self.buckets, self.buckets[1:])):
            raise ValueError(f"histogram {name!r} buckets must be non-empty "
                             f"and strictly increasing: {self.buckets}")

    def _child(self, labels: Dict[str, Any]) -> _HistChild:
        k = self._key(labels)
        child = self._children.get(k)
        if child is None:
            child = self._children[k] = _HistChild(len(self.buckets))
        return child

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        child = self._child(labels)
        i = len(self.buckets)                     # overflow by default
        for j, edge in enumerate(self.buckets):
            if v <= edge:
                i = j
                break
        child.counts[i] += 1
        child.sum += v
        child.count += 1

    # ------------------------------------------------------------- queries
    def bucket_counts(self, **labels) -> List[int]:
        """Per-bucket (non-cumulative) counts, overflow bucket last."""
        return list(self._child(labels).counts)

    def cumulative_counts(self, **labels) -> List[int]:
        out, acc = [], 0
        for c in self._child(labels).counts:
            acc += c
            out.append(acc)
        return out

    def total(self, **labels) -> int:
        return self._child(labels).count

    def sum_value(self, **labels) -> float:
        return self._child(labels).sum

    def quantile(self, q: float, **labels) -> float:
        """Bucket-interpolated quantile estimate (the classic Prometheus
        ``histogram_quantile``): linear within the owning bucket, clamped to
        the largest finite edge when the target rank falls in the overflow
        bucket. Returns nan for an empty series."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        child = self._child(labels)
        if child.count == 0:
            return float("nan")
        target = q * child.count
        acc = 0
        for i, c in enumerate(child.counts):
            prev = acc
            acc += c
            if acc >= target and c > 0:
                if i == len(self.buckets):        # overflow: no finite edge
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * (target - prev) / c
        return self.buckets[-1]


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    Re-requesting a name returns the existing metric; re-requesting with a
    conflicting type or label set raises — two components disagreeing about
    a metric's shape is a bug, not a merge.
    """

    enabled = True

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Tuple[str, ...], **kw) -> _Metric:
        existing = self._metrics.get(name)
        if existing is not None:
            if not isinstance(existing, cls) or \
                    existing.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{existing.kind} with labels {existing.labelnames}")
            return existing
        metric = cls(name, help, tuple(labelnames), **kw)
        self._metrics[name] = metric
        return metric

    def counter(self, name: str, help: str = "",
                labelnames: Tuple[str, ...] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Tuple[str, ...] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Tuple[str, ...] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    # ---------------------------------------------------------- exposition
    def to_prometheus(self) -> str:
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for key in m.label_sets():
                    base = m._labels_dict(key)
                    cum = 0
                    child = m._children[key]
                    for edge, c in zip(m.buckets + (float("inf"),),
                                       child.counts):
                        cum += c
                        lbl = {**base, "le": _fmt_value(edge)}
                        lines.append(f"{name}_bucket{_render_labels(lbl)} "
                                     f"{cum}")
                    lines.append(f"{name}_sum{_render_labels(base)} "
                                 f"{_fmt_value(child.sum)}")
                    lines.append(f"{name}_count{_render_labels(base)} "
                                 f"{child.count}")
            else:
                for key in m.label_sets():
                    lbl = m._labels_dict(key)
                    lines.append(f"{name}{_render_labels(lbl)} "
                                 f"{_fmt_value(m._children[key])}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable view of every metric and its label children."""
        out: Dict[str, Any] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            entry: Dict[str, Any] = {"type": m.kind, "help": m.help,
                                     "labelnames": list(m.labelnames),
                                     "values": []}
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
                for key in m.label_sets():
                    child = m._children[key]
                    entry["values"].append({
                        "labels": m._labels_dict(key),
                        "counts": list(child.counts),
                        "sum": child.sum, "count": child.count})
            else:
                for key in m.label_sets():
                    entry["values"].append({
                        "labels": m._labels_dict(key),
                        "value": m._children[key]})
            out[name] = entry
        return out

    def write(self, path: str) -> str:
        """Write the JSON snapshot to ``path`` and the Prometheus text to a
        ``.prom`` sibling; returns the sibling path."""
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)
        prom = os.path.splitext(path)[0] + ".prom"
        with open(prom, "w") as f:
            f.write(self.to_prometheus())
        return prom


def _render_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _NullMetric:
    """One no-op stands in for every metric type when metrics are off."""

    def inc(self, *a, **k):
        pass

    def dec(self, *a, **k):
        pass

    def set(self, *a, **k):
        pass

    def set_max(self, *a, **k):
        pass

    def observe(self, *a, **k):
        pass

    def value(self, *a, **k) -> float:
        return 0.0


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """Disabled registry: every factory returns the shared no-op metric.
    ``enabled`` is the guard components check before building label dicts or
    computing values on hot paths."""

    enabled = False

    def counter(self, *a, **k) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, *a, **k) -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, *a, **k) -> _NullMetric:
        return _NULL_METRIC

    def snapshot(self) -> Dict[str, Any]:
        return {}

    def to_prometheus(self) -> str:
        return ""

    def write(self, path: str) -> str:
        raise RuntimeError("NullRegistry has nothing to write; construct a "
                           "MetricsRegistry (repro_torch.obs.make_observability)")


class PeriodicReporter:
    """Interval-driven snapshot writer, clocked by the caller.

    The serving loop calls ``maybe_write(now)`` once per iteration; a write
    happens when ``interval_s`` elapsed since the last one (and always on
    the first call, so even a short run leaves a snapshot behind).
    """

    def __init__(self, registry: MetricsRegistry, path: str,
                 interval_s: float = 5.0):
        self.registry = registry
        self.path = path
        self.interval_s = float(interval_s)
        self._last: Optional[float] = None
        self.writes = 0

    def maybe_write(self, now_s: float) -> bool:
        if self._last is not None and now_s - self._last < self.interval_s:
            return False
        self.write()
        self._last = now_s
        return True

    def write(self) -> str:
        prom = self.registry.write(self.path)
        self.writes += 1
        return prom
