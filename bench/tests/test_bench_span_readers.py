"""The readers of the program's wall-clock spans (``program_span``
metrics) on a synthetic run: host gaps, graph launches, queue waits and
device time by segment, each leaving the profiled slice out, and each
reading nothing from a program that emits only ``prefill`` and ``decode``
spans."""
import pytest

import tiny  # noqa: F401  (sys.path)
from harness import work
from harness.runner import RequestRecord, Run
from harness.spec import load_cell, metric_reader

from repro_torch.obs.tracer import Span

CELL = load_cell("granite-moe-3b-a800m.backlog")
NAMES = ("host_gap_ms", "host_gap_ms.poisson", "graph_launch_ms",
         "queued_ms.poisson", "moe_route_ms", "elementwise_ms")


def _span(spans, name, t0, t1, parent=None, **kw):
    s = Span(len(spans), name, t0, t1, clock="wall",
             parent_id=None if parent is None else parent.span_id, **kw)
    spans.append(s)
    return s


def _decode(spans, step, t0, t1, enq, sync, read=None):
    """A decode span with its enqueue and sync; ``read``: (the decode whose
    timed replay is read here, (t0, t1) of the readout, its segments)."""
    d = _span(spans, "decode", t0, t1, step, attrs={"n_sequences": 160})
    _span(spans, "enqueue", *enq, d)
    if read is not None:
        timed, (r0, r1), segs = read
        _span(spans, "readout", r0, r1, timed)
        _span(spans, "device_time", r1, r1, timed, attrs=segs)
    _span(spans, "sync", *sync, d)
    return d


def _run():
    """Step A (0.10-0.12 s): a timed decode whose device window is 17 ms.
    Step B (0.20-0.25 s): a batch formed (a prefill with two enqueues,
    window 15 ms) and a decode (window 22 ms) inside whose window A's
    readout runs, then timed itself. Step C lies in the profiled slice
    (0.5-0.6 s). Step D (0.30-0.32 s): a decode (window 17 ms) that reads
    B's replay. Four requests queued; three done."""
    run = Run(CELL, 1, 1.0, None, work.Widths.of(CELL.config["port"]))
    run.window = (0.0, 1.0)
    run.slice_first = 2
    run.slice_wall = (0.5, 0.6)
    sp = run.spans
    a = _span(sp, "step", 0.10, 0.12)
    da = _decode(sp, a, 0.101, 0.119, (0.101, 0.103), (0.110, 0.118))
    b = _span(sp, "step", 0.20, 0.25)
    form = _span(sp, "step.form", 0.201, 0.22, b, batch_id=1)
    pre = _span(sp, "prefill", 0.202, 0.219, form)
    _span(sp, "enqueue", 0.203, 0.210, pre)
    _span(sp, "enqueue", 0.211, 0.212, pre)
    _span(sp, "sync", 0.213, 0.218, pre)
    db = _decode(sp, b, 0.221, 0.245, (0.222, 0.224), (0.225, 0.244),
                 (da, (0.2241, 0.2245),
                  {"moe.route": 1.0, "moe.combine": 0.5, "moe.gemm": 2.0,
                   "attn.norm": 0.2, "mlp.act": 0.1, "head.sample": 0.3,
                   "total_ms": 4.1}))
    c = _span(sp, "step", 0.52, 0.55)
    dc = _decode(sp, c, 0.521, 0.549, (0.521, 0.531), (0.532, 0.548),
                 (db, (0.5311, 0.5315),
                  {"moe.route": 9.0, "attn.norm": 9.0, "total_ms": 18.0}))
    d = _span(sp, "step", 0.30, 0.32)
    _decode(sp, d, 0.301, 0.319, (0.301, 0.303), (0.310, 0.318),
            (dc, (0.3031, 0.3035),
             {"moe.route": 2.0, "moe.combine": 1.5, "attn.norm": 0.4,
              "ffn.residual": 0.2, "total_ms": 4.1}))
    for rid, t0, t1, done in ((0, 0.05, 0.201, 0.9), (1, 0.10, 0.201, 0.9),
                              (2, 0.15, 0.201, None), (3, 0.45, 0.52, 0.9)):
        _span(sp, "queued", t0, t1, request_id=rid, batch_id=1)
        run.request_of[rid] = 10 + rid
        run.requests[10 + rid] = RequestRecord(10 + rid, "economy", 0.0,
                                               done=done)
    return run


def test_host_gap_leaves_out_device_windows_and_readouts():
    """A readout lies inside the next decode's window: it counts once, and
    not in the step of the replay it reads."""
    run = _run()
    gap_a = 0.020 - (0.118 - 0.101)
    gap_b = 0.050 - (0.218 - 0.203) - (0.244 - 0.222)
    gap_d = 0.020 - (0.318 - 0.301)
    for name in ("host_gap_ms", "host_gap_ms.poisson"):
        assert metric_reader(name)(run) == \
            pytest.approx(1e3 * (gap_a + gap_b + gap_d) / 3)


def test_graph_launch_reads_the_untraced_decodes_enqueues():
    assert metric_reader("graph_launch_ms")(_run()) == pytest.approx(2.0)


def test_queued_reads_the_requests_done_in_the_window():
    # request 2 is not done; request 3's span overlaps the slice
    assert metric_reader("queued_ms.poisson")(_run()) == \
        pytest.approx((151.0 + 101.0) / 2)


def test_device_time_by_segment_group():
    run = _run()
    assert metric_reader("moe_route_ms")(run) == \
        pytest.approx((1.5 + 3.5) / 2)
    assert metric_reader("elementwise_ms")(run) == \
        pytest.approx((0.6 + 0.6) / 2)


def test_the_groups_name_the_programs_segments():
    """The readers name their segments themselves (a parent's program has
    no `repro_torch.obs.segments`); they are the program's."""
    from repro_torch.obs import segments
    group = lambda n: metric_reader(n).__globals__["SEGMENTS"]  # noqa: E731
    assert set(group("elementwise_ms")) == set(segments.GEMM_FREE)
    assert set(group("moe_route_ms")) < set(segments.SEGMENTS)


def test_a_program_without_the_spans_reads_nothing():
    """The parent's program emits ``decode`` and ``prefill`` spans with no
    children: every new reader returns None (and raises nothing)."""
    run = _run()
    run.spans = [s for s in run.spans if s.name in ("decode", "prefill")]
    for s in run.spans:
        s.parent_id = None
    assert {n: metric_reader(n)(run) for n in NAMES} == \
        dict.fromkeys(NAMES)
