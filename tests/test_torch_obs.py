"""The port's wall-clock spans and ranges (`repro_torch.obs`), on the CPU:
`Tracer.span` (nesting, ``parent_id``, the wall clock, ``batch_id``, the
clock header of a saved file), its ranges in a ``torch.profiler`` trace at
the saved spans' times through that header, `NullTracer` (no span, no
range), `kernel_scope`'s range only while a profiler records, and the
segment timer's arithmetic (`repro_torch.obs.segments`). A scheduler
drain's spans: tests/test_torch_preemption.py."""
import json
import os
import tempfile
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs import NullTracer, Tracer, kernel_scope  # noqa: E402
from repro_torch.obs import profiling, segments  # noqa: E402
from repro_torch.obs.tracer import NO_SPAN  # noqa: E402
from repro_torch.qeil2.telemetry.trace import TraceStore  # noqa: E402


def _busy(seconds: float) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def _profiled(fn) -> list:
    """The user ranges of a CPU profiler trace of ``fn()``, with their
    start and end on the realtime clock in ns (``ts`` in us past the
    trace's ``baseTimeNanoseconds``)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    base = int(trace.get("baseTimeNanoseconds", 0))
    return [(e["name"], float(e["ts"]) * 1e3 + base,
             (float(e["ts"]) + float(e["dur"])) * 1e3 + base)
            for e in trace["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def test_spans_nest_on_the_wall_clock():
    tr = Tracer()
    tr.batch_context = 7
    t = time.perf_counter()
    with tr.span("step", a=1) as step:
        with tr.span("step.policy"):
            _busy(0.002)
        with tr.span("decode") as dec:
            with tr.span("enqueue"):
                pass
            dec.set(n_sequences=4)
    with pytest.raises(ValueError):
        with tr.span("step"):
            raise ValueError("a span whose body raised is not recorded")
    by = {s.name: s for s in tr.spans}
    assert [s.name for s in tr.spans] == \
        ["step.policy", "enqueue", "decode", "step"]
    assert all(s.clock == "wall" and s.batch_id == 7 for s in tr.spans)
    assert by["step"].parent_id is None
    assert by["step.policy"].parent_id == by["decode"].parent_id == \
        step.span_id == by["step"].span_id
    assert by["enqueue"].parent_id == dec.span_id
    assert by["step"].attrs == {"a": 1}
    assert by["decode"].attrs == {"n_sequences": 4}
    assert t <= by["step"].t0_s <= by["step.policy"].t0_s
    assert by["step.policy"].t1_s - by["step.policy"].t0_s >= 0.002
    assert by["decode"].t1_s <= by["step"].t1_s <= time.perf_counter()
    # an explicit parent, and a point span emitted beside them
    with tr.span("readout", parent_id=dec.span_id) as ro:
        pass
    tr.emit("device_time", time.perf_counter(), clock="wall",
            parent_id=dec.span_id, **{"attn.core": 1.5, "total_ms": 2.0})
    assert tr.spans[-2].parent_id == tr.spans[-1].parent_id == dec.span_id
    assert ro.span_id == tr.spans[-2].span_id
    assert tr.spans[-1].attrs == {"attn.core": 1.5, "total_ms": 2.0}


def test_saved_spans_carry_the_clock_offset(tmp_path):
    tr = Tracer()
    assert abs(tr.clock_offset_ns - (time.time_ns()
                                     - time.perf_counter_ns())) < 5e6
    with tr.span("step"):
        pass
    tr.emit("admit", 0.0, request_id=0)
    path = tr.save(str(tmp_path / "spans.jsonl"))
    lines = [json.loads(x) for x in open(path)]
    assert lines[0] == {"kind": "clock",
                        "clock_offset_ns": tr.clock_offset_ns}
    assert [x["name"] for x in lines[1:]] == ["step", "admit"]
    store = TraceStore.load(path)
    assert store.counts() == {"clock": 1, "span": 2}


def test_profiler_ranges_lie_at_the_saved_spans():
    """Each ``step`` span opens ``repro_torch.serving/step`` while the
    profiler records; a saved span at t lands at t * 1e9 + the offset on
    the trace's clock, within 1 ms of its range."""
    tr = Tracer()

    def drain():
        with tr.span("warm"):       # a process's first range opens slowly
            pass
        for _ in range(5):
            with tr.span("step"):
                with tr.span("decode"):
                    _busy(0.003)
    ranges = _profiled(drain)
    steps = [r for r in ranges if r[0] == "repro_torch.serving/step"]
    decodes = [r for r in ranges if r[0] == "repro_torch.serving/decode"]
    assert len(steps) == len(decodes) == 5
    spans = [s for s in tr.spans if s.name == "step"]
    for (_, a, b), s in zip(sorted(steps, key=lambda r: r[1]), spans):
        assert abs(a - (s.t0_s * 1e9 + tr.clock_offset_ns)) < 1e6
        assert abs(b - (s.t1_s * 1e9 + tr.clock_offset_ns)) < 1e6


def test_null_tracer_records_nothing_and_opens_no_range():
    tr = NullTracer()

    def drain():
        with tr.span("step") as s:
            s.set(formed=1)
            with tr.span("decode"):
                pass
        tr.emit("admit", 0.0)
    ranges = _profiled(drain)
    assert tr.span("step") is NO_SPAN
    assert len(tr) == 0 and tr.records() == []
    assert not [r for r in ranges if r[0].startswith("repro_torch.")]


def test_kernel_scope_opens_a_range_only_while_a_profiler_records():
    assert kernel_scope("paged_decode_attention") is profiling.NO_RANGE

    def call():
        with kernel_scope("paged_decode_attention"):
            torch.ones(4).sum()
    ranges = _profiled(call)
    assert [r[0] for r in ranges] == \
        ["repro_torch.kernels/paged_decode_attention"]


class _Tick:
    """A stand-in timing event: its record reads the next of ``ticks``
    (ms)."""

    def __init__(self, ticks):
        self.ticks = ticks

    def record(self):
        self.t = next(self.ticks)

    def elapsed_time(self, later) -> float:
        return later.t - self.t


def test_segment_timer_sums_its_marks_by_segment():
    segments.mark("attn.norm")              # outside a capture: nothing
    ticks = iter([0.0, 1.0, 1.5, 4.0, 4.25, 6.0])
    timer = segments.SegmentTimer(lambda: _Tick(ticks))
    with timer.recording():
        for name in ("attn.norm", "attn.qkv", "attn.norm", "attn.qkv",
                     "head.sample"):
            segments.mark(name)
    segments.mark("attn.core")              # after it: nothing
    ms = timer.read()
    assert ms == {"attn.norm": 1.0 + 2.5, "attn.qkv": 0.5 + 0.25,
                  "head.sample": 1.75, "total_ms": 6.0}
    assert set(segments.GEMM_FREE) < set(segments.SEGMENTS)
