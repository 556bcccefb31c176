"""Runtime feedback: a calibrated drop-in for the analytic signal functions.

`CalibratedSignalProvider` wraps a `CalibrationProfile` and exposes the same
signal surface `repro_torch.qeil2.signals` does — ``signals_for``, ``phi``,
``cpq_power_factor`` — plus a per-stage ``time_scale``. It is accepted by
``plan_costs(..., model="v2", provider=...)``, `PGSAM`/`PGSAMOrchestrator`
(``provider=``) and the `DeltaEvaluator`, so the control loop's re-anneal
path runs on measured DASI instead of analytic FLOP/byte counts.

Two calibration effects:

* **coefficients** — DASI's ridge point is scaled by the fitted
  ``ridge_scale``; CPQ's (kappa, exp) and Phi's (rho_ref, t_slope) come from
  the profile. With the identity profile every expression evaluates with the
  documented default constants — bit-identical to the uncalibrated path.
* **measured kernel duty cycles** — where a Pallas kernel backs a stage
  (flash attention for prefill attention, decode attention for decode,
  the SSD scan for SSM stages), the measured duty factor
  ``eta = t_roofline / t_measured`` replaces the analytic assumption that
  the kernel runs at the roofline: execution time stretches by ``1/eta``
  while both duty cycles shrink by ``eta`` (the subsystems are busy the
  same absolute time inside a longer window). Dynamic stage energy is
  invariant under that substitution — measurement moves *latency* (and
  therefore makespans, annealer objectives and SLA routing), while the
  energy model keeps its physical grounding.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.decomposition import Stage
from repro_torch.core.devices import DeviceProfile
from repro_torch.qeil2.signals import (SignalSet, cpq, cpq_power_factor, dasi,
                                       memory_saturation, phi)
from repro_torch.qeil2.telemetry.fit import CalibrationProfile

# stage-name markers -> kernel names as measured by benchmarks/kernel_bench.py
KERNEL_STAGE_MAP = (
    (".attn", "prefill", "flash_attention"),
    (".attn", "decode", "decode_attention"),
    (".ssm", "prefill", "ssd_scan"),
    (".ssm", "decode", "ssd_scan"),
)


def kernel_for_stage(stage: Stage) -> Optional[str]:
    """Which measured Pallas kernel (if any) backs a decomposition stage."""
    for marker, phase, kernel in KERNEL_STAGE_MAP:
        if marker in stage.name and stage.phase == phase:
            return kernel
    return None


class CalibratedSignalProvider:
    """`signals_for`-compatible evaluator backed by a `CalibrationProfile`."""

    def __init__(self, profile: Optional[CalibrationProfile] = None):
        self.profile = profile or CalibrationProfile.identity()

    # ------------------------------------------------------------- signals
    def eta(self, stage: Stage) -> float:
        """Measured kernel duty factor for a stage (1.0 when unmeasured)."""
        return self.profile.eta_for(kernel_for_stage(stage))

    def time_scale(self, stage: Stage) -> float:
        """Execution-time stretch from measured kernel times: t_measured /
        t_roofline = 1 / eta (1.0 for unmeasured stages)."""
        return 1.0 / self.eta(stage)

    def dasi(self, stage: Stage, device: DeviceProfile) -> float:
        d = dasi(stage, device, ridge_scale=self.profile.ridge_scale)
        return min(1.0, d * self.eta(stage))

    def memory_saturation(self, stage: Stage, device: DeviceProfile) -> float:
        m = memory_saturation(stage, device,
                              ridge_scale=self.profile.ridge_scale)
        return min(1.0, m * self.eta(stage))

    def cpq_power_factor(self, cpq_value: float) -> float:
        return cpq_power_factor(cpq_value, kappa=self.profile.cpq_kappa,
                                exp=self.profile.cpq_exp)

    def phi(self, temp_c: float) -> float:
        return phi(temp_c, rho_ref=self.profile.phi_rho_ref,
                   t_slope=self.profile.phi_t_slope,
                   t_ref_c=self.profile.phi_t_ref_c)

    def signals_for(self, stage: Stage, device: DeviceProfile,
                    resident_bytes: float = 0.0,
                    temp_c: Optional[float] = None,
                    headroom: float = 0.9) -> SignalSet:
        """Calibrated counterpart of `repro_torch.qeil2.signals.signals_for`."""
        t = device.t_ambient if temp_c is None else temp_c
        return SignalSet(dasi=self.dasi(stage, device),
                         msat=self.memory_saturation(stage, device),
                         cpq=cpq(resident_bytes, device, headroom),
                         phi=self.phi(t))

    def __repr__(self) -> str:
        p = self.profile
        return (f"CalibratedSignalProvider(source={p.source!r}, "
                f"identity={p.is_identity}, kernels={len(p.kernel_eta)})")
