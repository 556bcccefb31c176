"""Request-span tracing for the serving pipeline.

A span is one named interval on an **explicit clock**: the emitter supplies
``t0_s``/``t1_s`` and says which clock they came from (``clock="sim"`` — the
scheduler's simulated pipeline clock the SLA caps are defined on — or
``clock="wall"`` for backend execution timings). The tracer never reads time
itself, so sim-clock and wall-clock spans coexist in one trace without
lying about comparability.

Lifecycle of one admitted request (sim clock unless noted)::

    admit ──► queue ──► [batch: schedule ──► prefill(wall) ──► decode*(wall)]
                   └──────────────────────► verify/early_stop? ──► release

``admit`` is the request's *root* span; later spans carrying the same
``request_id`` auto-parent under it, and batch-level spans (``schedule`` /
``prefill`` / ``decode``) attach to requests through ``batch_id`` — the
``queue`` span records which batch joined the request to its batch-level
children. `reconstruct_lifecycles` inverts this: given the emitted spans it
rebuilds every admitted request's admit→release chain and reports whether
the chain is complete and time-ordered (the serving bench gates on it).

Spans are JSONL-ready dicts (`Span.as_record`) with ``kind: "span"`` —
`TraceStore` validates and persists them next to kernel/energy/serve
records, so span traces ride the same files the `CalibrationFitter` reads.

`NullTracer` is the zero-cost default: ``enabled`` is False and ``emit`` is
a no-op, so instrumented hot paths guard on one attribute load. Emitting is
a pure observation — tracers never touch the rng stream; the obs on/off
bit-parity test pins that.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Union

#: canonical span names in lifecycle order (docs + lifecycle checker).
#: preempt/resume/cancel are the robustness detours: a preempted request
#: re-queues (original arrival kept) and later emits a resume point span
#: when its history re-enters service; cancel ends a request without a
#: release (deadline miss, load shed, retry budget exhausted).
LIFECYCLE = ("admit", "queue", "schedule", "prefill", "decode",
             "verify", "early_stop", "preempt", "resume", "cancel",
             "release")


@dataclass
class Span:
    span_id: int
    name: str
    t0_s: float
    t1_s: float
    clock: str = "sim"                 # "sim" | "wall"
    parent_id: Optional[int] = None
    request_id: Optional[int] = None
    batch_id: Optional[int] = None
    sample: Optional[int] = None       # sample index within the request
    attrs: Dict[str, Any] = field(default_factory=dict)

    def as_record(self) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"kind": "span", "span_id": self.span_id,
                               "name": self.name, "t0_s": self.t0_s,
                               "t1_s": self.t1_s, "clock": self.clock}
        for k in ("parent_id", "request_id", "batch_id", "sample"):
            v = getattr(self, k)
            if v is not None:
                rec[k] = v
        if self.attrs:
            rec["attrs"] = dict(self.attrs)
        return rec


class Tracer:
    """Collects spans; optionally mirrors them into a `TraceStore`.

    ``emit`` is the whole API: components report completed (or point)
    intervals with explicit timestamps. ``batch_context`` is scratch the
    scheduler sets around backend calls so backend-emitted wall-clock spans
    pick up the forming batch's id without widening the duck-typed backend
    signature.
    """

    enabled = True

    def __init__(self, store=None):
        self.spans: List[Span] = []
        self.store = store             # optional TraceStore mirror
        self.batch_context: Optional[int] = None
        self._roots: Dict[int, int] = {}   # request_id -> admit span_id
        self._next = 0

    def emit(self, name: str, t0_s: float, t1_s: Optional[float] = None,
             *, clock: str = "sim", request_id: Optional[int] = None,
             batch_id: Optional[int] = None, sample: Optional[int] = None,
             parent_id: Optional[int] = None, **attrs) -> int:
        """Record one span; returns its id. ``t1_s`` defaults to ``t0_s``
        (a point event). An ``admit`` span becomes its request's root;
        later spans with that ``request_id`` parent under it."""
        sid = self._next
        self._next += 1
        if batch_id is None:
            batch_id = self.batch_context
        if parent_id is None and request_id is not None:
            parent_id = self._roots.get(request_id)
        span = Span(sid, name, float(t0_s),
                    float(t1_s if t1_s is not None else t0_s),
                    clock=clock, parent_id=parent_id, request_id=request_id,
                    batch_id=batch_id, sample=sample, attrs=attrs)
        if name == "admit" and request_id is not None:
            self._roots[request_id] = sid
        self.spans.append(span)
        if self.store is not None:
            self.store.ingest(span.as_record())
        return sid

    def records(self) -> List[Dict[str, Any]]:
        return [s.as_record() for s in self.spans]

    def save(self, path: str) -> str:
        """Write every span as one JSON line (`TraceStore.load`-compatible)."""
        with open(path, "w") as f:
            for s in self.spans:
                f.write(json.dumps(s.as_record()) + "\n")
        return path

    def __len__(self) -> int:
        return len(self.spans)


class NullTracer:
    """Disabled tracer: ``emit`` no-ops; hot paths guard on ``enabled``."""

    enabled = False

    def __init__(self):
        self.spans: List[Span] = []
        self.batch_context: Optional[int] = None

    def emit(self, *a, **k) -> int:
        return -1

    def records(self) -> List[Dict[str, Any]]:
        return []

    def save(self, path: str) -> str:
        raise RuntimeError("NullTracer has no spans to save; construct a "
                           "Tracer (repro_torch.obs.make_observability)")

    def __len__(self) -> int:
        return 0


# ------------------------------------------------------- lifecycle checking

def _as_dicts(spans: Iterable[Union[Span, Dict[str, Any]]]
              ) -> List[Dict[str, Any]]:
    return [s.as_record() if isinstance(s, Span) else s for s in spans]


def reconstruct_lifecycles(spans: Iterable[Union[Span, Dict[str, Any]]]
                           ) -> Dict[int, Dict[str, Any]]:
    """Rebuild every admitted request's admit→release chain from a span set.

    Returns ``{request_id: {"complete": bool, "missing": [...],
    "batch_id": ..., "queue_delay_s": ..., "latency_s": ...}}``. A chain is
    complete when the request has admit, queue and release spans, its queue
    span names a batch that emitted schedule + prefill + >=1 decode span,
    and the sim-clock times are ordered (admit <= queue start <= queue end
    <= release). Rejected submissions (admit spans with no ``request_id``)
    are not lifecycles and are ignored.
    """
    recs = _as_dicts(spans)
    by_req: Dict[int, Dict[str, List[dict]]] = {}
    by_batch: Dict[int, Dict[str, List[dict]]] = {}
    for r in recs:
        if r.get("kind", "span") != "span":
            continue
        rid, bid = r.get("request_id"), r.get("batch_id")
        if rid is not None:
            by_req.setdefault(rid, {}).setdefault(r["name"], []).append(r)
        elif bid is not None:
            by_batch.setdefault(bid, {}).setdefault(r["name"], []).append(r)

    out: Dict[int, Dict[str, Any]] = {}
    for rid, named in sorted(by_req.items()):
        if "admit" not in named:
            continue
        missing = [n for n in ("admit", "queue", "release") if n not in named]
        admit = named["admit"][0]
        queue = named.get("queue", [{}])[0]
        release = named.get("release", [{}])[0]
        bid = queue.get("batch_id", release.get("batch_id"))
        batch = by_batch.get(bid, {})
        for n in ("schedule", "prefill", "decode"):
            if n not in batch and n not in named:
                missing.append(n)
        ordered = not missing and (
            admit["t0_s"] <= queue["t0_s"] <= queue["t1_s"]
            <= release["t1_s"])
        out[rid] = {
            "complete": not missing and ordered,
            "missing": missing,
            "batch_id": bid,
            "queue_delay_s": (queue["t1_s"] - queue["t0_s"]
                              if "queue" in named else None),
            "latency_s": (release["t1_s"] - admit["t0_s"]
                          if "release" in named else None),
        }
    return out


def lifecycles_complete(spans: Iterable[Union[Span, Dict[str, Any]]],
                        expect_requests: Optional[int] = None) -> bool:
    """True when every reconstructed lifecycle is complete (and, when
    ``expect_requests`` is given, exactly that many requests appear)."""
    lifecycles = reconstruct_lifecycles(spans)
    if expect_requests is not None and len(lifecycles) != expect_requests:
        return False
    return bool(lifecycles) and all(v["complete"]
                                    for v in lifecycles.values())
