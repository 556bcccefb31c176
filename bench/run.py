"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line on standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (with ``--trace
0`` the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number the check of outputs compared, beside its limit. Everything else
goes to standard error, whose last lines repeat the check.

It exits non-zero, with no result, without a CUDA card (or with fewer than
the cell asks for), without the program (``src/repro_torch``), or when JAX,
flax or the JAX package were loaded. ``--control <format>`` runs the
control that the check has to refuse (``tests/test_bench_control.py``; the
benchmark's runs never pass it): the program's own weight path in that
format (the configuration's ``control``, ``int8``) in place of bf16.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names the run may not load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / "build" / "bench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)
    _cache_dirs()
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    out = sys.stdout
    sys.stdout = sys.stderr            # only the result goes to stdout

    import torch
    from harness.spec import load_cell
    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"[bench] needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"[bench] the program is missing: {e}", file=sys.stderr)
        return 2
    from harness.report import run_cell
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      control=args.control)
    found = forbidden_modules()
    if found:
        print(f"[bench] loaded forbidden modules: {found}", file=sys.stderr)
        return 3
    out.write(json.dumps(result) + "\n")
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
