"""Calibration entry point: traces in, fitted profile + residual report out.

The counterpart of ``repro.launch.calibrate``, over the port's telemetry
(`repro_torch.qeil2.telemetry`). It computes in numpy and scipy only, so it
runs on the host, card or no card:

  # fit from an existing JSONL trace (repro_torch.launch.profile --out / a
  # ControlLoop's TraceStore file):
  PYTHONPATH=src python -m repro_torch.launch.calibrate \\
      --trace traces.jsonl --out profile.json --report report.json

  # no hardware? fit against the seeded synthetic ground-truth fixture:
  PYTHONPATH=src python -m repro_torch.launch.calibrate --synthetic \\
      --seed 0 --out profile.json --report report.json

The profile JSON round-trips through `CalibrationProfile.load`, ready for

  provider = CalibratedSignalProvider(CalibrationProfile.load("profile.json"))
  PGSAMOrchestrator(..., energy_model="v2", provider=provider)

so fitted coefficients and measured kernel duty cycles feed every subsequent
anneal, re-anneal and `plan_costs(model="v2")` call.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.qeil2.telemetry import (CalibrationFitter, TraceStore,
                                         synthetic_trace_store)


def main(argv: Optional[List[str]] = None) -> None:
    """The command line; ``argv`` in place of ``sys.argv[1:]``."""
    ap = argparse.ArgumentParser(
        description="fit DASI/CPQ/Phi coefficients from telemetry traces")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--trace", default=None,
                     help="JSONL trace file (TraceStore format)")
    src.add_argument("--synthetic", action="store_true",
                     help="fit against the seeded synthetic fixture")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bootstrap", type=int, default=200,
                    help="bootstrap resamples for the coefficient CIs")
    ap.add_argument("--out", default="calibration_profile.json")
    ap.add_argument("--report", default="calibration_report.json")
    args = ap.parse_args(argv)

    if args.synthetic:
        store = synthetic_trace_store(seed=args.seed)
    else:
        store = TraceStore.load(args.trace)
    counts = store.counts()
    print(f"trace: {len(store)} records {counts}")

    fitter = CalibrationFitter(store, n_bootstrap=args.bootstrap,
                               seed=args.seed)
    profile, report = fitter.fit()
    profile.save(args.out)
    report.save(args.report)

    print(f"\n{'coefficient':<14} {'default':>9} {'fitted':>9} "
          f"{'ci 2.5%':>9} {'ci 97.5%':>9}")
    for name, row in report.coefficients.items():
        lo, hi = row["ci"]
        print(f"{name:<14} {row['default']:>9.4g} {row['fitted']:>9.4g} "
              f"{lo:>9.4g} {hi:>9.4g}")
    for name, row in report.kernel_eta.items():
        lo, hi = row["ci"]
        print(f"{'eta:' + name:<14} {1.0:>9.4g} {row['fitted']:>9.4g} "
              f"{lo:>9.4g} {hi:>9.4g}")
    print(f"\nlog-energy RMSE: defaults {report.rmse_default:.4f} -> "
          f"fitted {report.rmse_fitted:.4f} "
          f"({report.improvement_pct:.1f}% lower)")
    print(f"profile -> {args.out}\nreport  -> {args.report}")


if __name__ == "__main__":
    main()
