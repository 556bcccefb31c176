"""Median and spread of each metric over a set of runs' result lines.

    python3 bench/tools/spread.py RUN.out [RUN.out ...]

Each file is one run's standard output; its last line is the result. For
each metric: the runs' median and their spread, (Q3 - Q1) / median with the
quartiles of ``statistics.quantiles(values, n=4)``, the benchmark
contract's noise measure; and the check's numbers, largest first.
"""
import json
import statistics
import sys
from collections import defaultdict


def main(paths):
    values = defaultdict(list)
    checks = defaultdict(list)
    correct = []
    for p in paths:
        with open(p) as f:
            lines = [x for x in f.read().splitlines() if x.strip()]
        if not lines:
            print(f"{p}: no result")
            continue
        line = json.loads(lines[-1])
        correct.append(line["correct"])
        for k, m in line["metrics"].items():
            values[k].append(m["value"])
        for k, c in line.get("check", {}).items():
            checks[k].append(c["value"])
    print(f"runs {len(correct)}, correct {sum(bool(c) for c in correct)}")
    for k, v in sorted(values.items()):
        med = statistics.median(v)
        sp = ""
        if len(v) >= 2:
            q1, _, q3 = statistics.quantiles(v, n=4)
            sp = f" spread {(q3 - q1) / med:.5f}"
        print(f"{k}: n {len(v)} median {med:.6g}{sp} min {min(v):.6g} "
              f"max {max(v):.6g}")
    for k, v in sorted(checks.items()):
        print(f"check {k}: max {max(x for x in v if x is not None)} "
              f"values {sorted(v, reverse=True)}")


if __name__ == "__main__":
    main(sys.argv[1:])
