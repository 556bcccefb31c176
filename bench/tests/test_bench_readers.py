"""The readers of the traced run's device metrics leave the profiled slice
out: `mfu` takes the untraced steps' FLOPs over the untraced seconds, and
`idle_share` sets the slice's busy time against the wall that the same
steps take untraced."""
import pytest

import tiny  # noqa: F401  (sys.path)
from harness import work
from harness.runner import Event, Run, Step
from harness.spec import load_cell, metric_reader

CELL = load_cell("chatglm3-6b.backlog")


def _run():
    """Ten 20 ms decode steps a 25 ms apart, the fourth to seventh traced
    (slowed to 60 ms); the fifth also runs a prefill (40 ms untraced, as the
    ninth does)."""
    run = Run(CELL, 1, 1.0, None, work.Widths.of(CELL.config["port"]))
    t = 0.0
    for i in range(10):
        ev = [Event(0, "decode", 8, 128, 160, 200, 13)]
        if i in (4, 8):
            ev.append(Event(1, "prefill", 8, 128, 160, 128, 0))
        traced = 3 <= i < 7
        dur = 0.060 if traced else (0.040 if i in (4, 8) else 0.020)
        run.steps.append(Step(i, t, t + dur, ev, []))
        t += dur + 0.005
    run.window = (0.0, t)
    run.slice_first = 3
    run.slice_wall = (run.steps[3].t0, run.steps[6].t1)
    run.profile = {"steps": run.steps[3:7], "busy_s": 0.072,
                   "window_s": run.slice_wall[1] - run.slice_wall[0]}
    return run


def test_untraced_steps_and_seconds():
    run = _run()
    assert [s.index for s in run.steps_untraced()] == [0, 1, 2, 7, 8, 9]
    assert run.untraced_s == pytest.approx(run.window_s - 0.255)


def test_idle_share_against_the_untraced_wall():
    run = _run()
    # untraced: decode steps 20 ms, the prefill step 40 ms; the window's
    # untraced seconds over the steps' summed 140 ms add the gaps between
    wall = (3 * 0.020 + 0.040) * run.untraced_s / 0.140
    assert metric_reader("idle_share")(run) == \
        pytest.approx(100 * (1 - 0.072 / wall))


def test_mfu_leaves_the_slice_out():
    run = _run()
    w = run.widths
    flops = 6 * work.decode_flops(w, 160, 200) \
        + work.prefill_flops(w, 8, 128)
    assert metric_reader("mfu")(run) == pytest.approx(
        100 * flops / (run.untraced_s * work.PEAK_BF16_FLOPS))
