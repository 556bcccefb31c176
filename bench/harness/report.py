"""A run of a cell, end to end, as the result line reports it."""
from __future__ import annotations

import sys
import time
from typing import Any, Dict, Optional

import torch

from harness.check import check, verdict
from harness.runner import Runner, log
from harness.spec import metric_reader
from harness.stats import median


def metric_values(cell, run, trace: bool) -> Dict[str, Dict[str, Any]]:
    """The cell's metrics of this kind, each from its reader; a reader that
    finds nothing to read leaves its metric out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m.name)(run)
        if value is None:
            log(f"metric {m.name}: nothing to read")
            continue
        out[m.name] = {"value": float(value), "unit": m.unit}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda",
             control: Optional[str] = None,
             keep: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The result line of one run; ``keep``, where given, receives every
    number of the check (`harness.check`), compared or not."""
    runner = Runner(cell, seed, seconds, trace, device=device,
                    control=control)
    run = runner.setup()
    runner.serve(run)
    metrics = metric_values(cell, run, trace)
    runner.release_program()
    t = time.perf_counter()
    result = check(runner, run)
    if keep is not None:
        keep.update(result)
    check_s = time.perf_counter() - t
    ok, shown = verdict(result, cell.limits)
    done = run.completed_in_window()
    attempted = len(done) + run.refused
    on_card = runner.on_card
    dev: Dict[str, Any] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": run.memory_peak_bytes,
    }
    line: Dict[str, Any] = {"correct": ok, "attempted": attempted,
                            "failed": run.refused, "metrics": metrics,
                            "device": dev}
    if trace and run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        line["breakdown"] = {"device_ops": run.profile["device_ops"],
                             "idle_gaps": run.profile["idle_gaps"]}
    line["check"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in shown.items()}
    # diagnostics, then the compared numbers as the last lines of stderr
    parts = " ".join(f"{k}={v:.3f}" for k, v in run.setup_parts.items())
    log(f"setup_s={run.setup_s:.3f} ({parts}); window {run.window_s:.3f} s, "
        f"{len(run.steps_in_window())} steps, {len(done)} requests done, "
        f"{run.refused} refused; check {check_s:.1f} s")
    log(f"graphs after warm-up {run.graph_stats.get('after_warm')}, at the "
        f"window's end {run.graph_stats.get('end')}")
    if run.lateness:
        log(f"arrival lateness: median {median(run.lateness) * 1e3:.3f} ms, "
            f"max {max(run.lateness) * 1e3:.3f} ms")
    log(f"check: batches {result.get('batches')}, {result['tokens']} tokens "
        f"judged, {result['misses']} not the reference's choice, "
        + ", ".join(f"{k} {v}" for k, v in result.items()
                    if k not in ("batches", "tokens", "misses"))
        + ("" if "error" in result else ", ok"))
    for k, (v, lim) in shown.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr, flush=True)
    return line
