"""Telemetry & calibration subsystem: close the measurement -> model loop.

trace     — `TraceStore`: JSONL-persisted telemetry (kernel timings, energy
            observations, control-loop step records, dry-run HLO counts)
fit       — `CalibrationFitter`: bounded least squares + bootstrap CIs over
            traces -> `CalibrationProfile` + `ResidualReport`
provider  — `CalibratedSignalProvider`: the fitted profile as a drop-in
            signal source for ``plan_costs(model="v2")`` / PGSAM / the
            runtime control loop (measured kernel duty cycles included)
synthetic — seeded ground-truth trace fixture for CI and tests
"""
from repro_torch.qeil2.telemetry.trace import TraceStore
from repro_torch.qeil2.telemetry.fit import (CalibrationFitter,
                                             CalibrationProfile,
                                             ResidualReport,
                                             bounded_least_squares,
                                             COEF_BOUNDS, COEF_DEFAULTS,
                                             COEF_NAMES)
from repro_torch.qeil2.telemetry.provider import (CalibratedSignalProvider,
                                                  kernel_for_stage)
from repro_torch.qeil2.telemetry.synthetic import (TRUE_COEFFS,
                                                   TRUE_KERNEL_ETA,
                                                   synthetic_trace_store)
