"""The check's readings of one cell on many seeds, in one process.

    python3 bench/tools/readings.py --workload <cell> --seconds <s> \
        --seeds 11,12 [--control-seeds 21,22] [--trace-seeds 31]

Each seed is one run of the cell as `run.py` makes it (its own weights,
warm-up and window, here ``--seconds`` long), the program's state freed
between runs; ``--control-seeds`` serve the configuration's ``control``
in place of bf16, ``--trace-seeds`` run traced. One line a run on standard
output, ``READ {json}``: the seed, the run's kind, ``correct`` and every
number of the check (`harness.check`), compared or not, with the run's
metrics. The limits of ``limits/<cell>.json`` are set from these lines.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from run import _cache_dirs  # noqa: E402


def _seeds(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--trace-seeds", default="")
    args = ap.parse_args(argv)
    _cache_dirs()
    out, sys.stdout = sys.stdout, sys.stderr
    import torch
    from harness.report import run_cell
    from harness.spec import load_cell
    cell = load_cell(args.workload)
    control = cell.config["control"]
    plan = ([(s, None, False) for s in _seeds(args.seeds)]
            + [(s, control, False) for s in _seeds(args.control_seeds)]
            + [(s, None, True) for s in _seeds(args.trace_seeds)])
    for seed, ctl, trace in plan:
        keep = {}
        line = run_cell(cell, seed, args.seconds, trace, control=ctl,
                        keep=keep)
        rec = {"cell": cell.name, "seed": seed, "control": ctl,
               "trace": trace, "correct": line["correct"],
               "check": {k: v for k, v in keep.items() if k != "batches"},
               "metrics": {k: m["value"] for k, m in line["metrics"].items()}}
        out.write("READ " + json.dumps(rec) + "\n")
        out.flush()
        del line, keep
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
