"""Serving observability: span tracing + metrics + kernel profiling hooks.

One `Observability` bundle threads through the serving pipeline
(`ExecutionBackend`, `ServingEngine`): components take ``obs=None`` and fall
back to `NULL_OBS`, whose `NullTracer`/`NullRegistry` make every
instrumentation site a guarded no-op.

    from repro_torch.obs import make_observability
    obs = make_observability()                 # live tracer + registry
    ...
    obs.metrics.write("metrics.json")          # + metrics.prom sibling
    obs.tracer.save("spans.jsonl")

Metrics and tracing are pure python; `profiling` wraps ``torch.profiler``.
"""
from repro_torch.obs.metrics import (Counter, DEFAULT_BUCKETS, Gauge,
                                     Histogram, MetricsRegistry, NullRegistry,
                                     PeriodicReporter)
from repro_torch.obs.profiling import annotate, gpu_roofline_us, kernel_scope
from repro_torch.obs.tracer import (LIFECYCLE, NullTracer, Span, Tracer,
                                    lifecycles_complete,
                                    reconstruct_lifecycles)


class Observability:
    """The bundle components thread: a tracer and a metrics registry.
    ``enabled`` is True when either side is live."""

    def __init__(self, tracer, metrics):
        self.tracer = tracer
        self.metrics = metrics

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled or self.metrics.enabled


#: shared disabled bundle — the default for every ``obs=None`` component
NULL_OBS = Observability(NullTracer(), NullRegistry())


def make_observability(store=None) -> Observability:
    """A live bundle: fresh `Tracer` (optionally mirroring spans into a
    store with an ``ingest`` method) + fresh `MetricsRegistry`."""
    return Observability(Tracer(store=store), MetricsRegistry())


__all__ = [
    "Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram", "LIFECYCLE",
    "MetricsRegistry", "NULL_OBS", "NullRegistry", "NullTracer",
    "Observability", "PeriodicReporter", "Span", "Tracer", "annotate",
    "gpu_roofline_us", "kernel_scope", "lifecycles_complete",
    "make_observability", "reconstruct_lifecycles",
]
