"""Physics-grounded runtime signals (paper Section 3, the v2 headline).

QEIL v2 replaces v1's static per-device constants with three per-(device,
workload) signals, each derived from a first-principles hardware model:

* **DASI** — Device-Adaptive Saturation Index. Roofline-derived duty cycles
  for the two power-drawing subsystems: the compute units are busy for the
  fraction ``t_compute / t_roofline`` of a stage's execution and the memory
  subsystem for ``t_memory / t_roofline``. Both follow directly from the
  stage's analytic FLOP/byte counts (`repro_torch.core.decomposition.Stage`) and the
  device's peak rates (`repro_torch.core.devices.DeviceProfile`) — no calibration.

* **CPQ** — Capacity Pressure Quotient. Working-set bytes over the device's
  allocation headroom. DRAM row-buffer conflicts, allocator fragmentation and
  cache thrash grow superlinearly as residency approaches capacity; CPQ is the
  dimensionless pressure that the v2 energy model maps to a power penalty.

* **Phi** — thermal yield from a CMOS leakage model. Subthreshold leakage
  current grows exponentially with junction temperature (roughly doubling
  every ~15 degC on recent nodes); Phi(T) is the fraction of total power that
  does useful (dynamic) work. Temperatures come from the RC thermal state that
  `repro_torch.core.safety.ThermalModel` already tracks, closing the loop between
  the safety monitor and the energy model.

All three are pure functions of observable state, so the orchestrator can
re-evaluate them per candidate assignment at runtime — "every static heuristic
replaced by a physics-grounded, runtime-adaptive model".
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.decomposition import Stage
from repro_torch.core.devices import DeviceProfile

# --- coefficient provenance -------------------------------------------------
# CPQ_KAPPA / CPQ_EXP: memory-pressure power penalty = 1 + KAPPA * cpq^EXP.
#   EXP=2 models the superlinear onset of row-buffer conflicts and allocator
#   fragmentation near capacity; KAPPA=0.35 caps the fully-packed penalty at
#   +35% dynamic power, the upper end of published DRAM-thrash overheads.
CPQ_KAPPA = 0.35
CPQ_EXP = 2.0
# PHI_RHO_REF: leakage as a fraction of dynamic power at the 25 degC reference
#   (modern mobile-class silicon idles near 8% leakage share at nominal Vdd).
# PHI_T_SLOPE: e-folding temperature of subthreshold leakage, degC. Leakage
#   roughly doubles every 15 degC -> e-folds every 15/ln(2) ~ 21.6 degC.
PHI_RHO_REF = 0.08
PHI_T_SLOPE = 21.6
PHI_T_REF_C = 25.0


def dasi(stage: Stage, device: DeviceProfile,
         ridge_scale: float = 1.0) -> float:
    """Compute-side saturation: fraction of roofline time the MXU/SMs are busy.

    ``min(1, intensity / ridge_point)`` — equals 1 exactly at and above the
    ridge point (compute-bound), and decays linearly with arithmetic intensity
    below it (memory-bound stages leave compute idling).

    ``ridge_scale`` is the calibration hook (`repro_torch.qeil2.telemetry`): the
    effective ridge point is ``ridge_point * ridge_scale``, fitted against
    measured kernel times instead of taken from the datasheet (RooflineBench's
    central observation). The default 1.0 is the analytic model, bit-for-bit.
    """
    return min(1.0, stage.intensity / (device.ridge_point * ridge_scale))


def memory_saturation(stage: Stage, device: DeviceProfile,
                      ridge_scale: float = 1.0) -> float:
    """Dual of DASI: fraction of roofline time the memory subsystem is busy."""
    if stage.intensity <= 0:
        return 1.0
    return min(1.0, device.ridge_point * ridge_scale / stage.intensity)


def cpq(working_set_bytes: float, device: DeviceProfile,
        headroom: float = 0.9) -> float:
    """Capacity Pressure Quotient: resident bytes over allocation headroom.

    0 = empty device, 1 = at the allocator's headroom limit, >1 = overcommit
    (the orchestrator treats >1 as infeasible; the energy model clamps).
    """
    cap = device.mem_cap * headroom
    if cap <= 0:
        return float("inf")
    return max(0.0, working_set_bytes / cap)


def cpq_power_factor(cpq_value: float, kappa: float = CPQ_KAPPA,
                     exp: float = CPQ_EXP) -> float:
    """Dynamic-power multiplier from memory pressure: 1 + kappa * cpq^exp.

    ``kappa``/``exp`` default to the documented first-principles constants;
    a fitted `repro_torch.qeil2.telemetry.CalibrationProfile` substitutes measured
    values (the defaults keep the uncalibrated path bit-for-bit)."""
    return 1.0 + kappa * min(cpq_value, 1.0) ** exp


def phi(temp_c: float, rho_ref: float = PHI_RHO_REF,
        t_slope: float = PHI_T_SLOPE, t_ref_c: float = PHI_T_REF_C) -> float:
    """Thermal yield: useful (dynamic) fraction of total power at temp T.

        P_leak(T) = rho_ref * P_dyn * exp((T - T_ref) / t_slope)
        Phi(T)    = P_dyn / (P_dyn + P_leak(T))
                  = 1 / (1 + rho_ref * exp((T - T_ref) / t_slope))

    Monotonically decreasing in T, -> 1 as T -> -inf, Phi(T_ref) =
    1/(1+rho_ref) ~ 0.926 with the default leakage share.
    """
    return 1.0 / (1.0 + rho_ref * math.exp((temp_c - t_ref_c) / t_slope))


@dataclass(frozen=True)
class SignalSet:
    """The v2 signal triple for one (stage, device) under current state."""
    dasi: float           # compute duty cycle in (0, 1]
    msat: float           # memory duty cycle in (0, 1]
    cpq: float            # capacity pressure, >= 0
    phi: float            # thermal yield in (0, 1]

    def as_dict(self) -> dict:
        """Plain-float dict for structured logging / trace emission
        (`repro_torch.qeil2.telemetry.TraceStore` step records)."""
        return {"dasi": float(self.dasi), "msat": float(self.msat),
                "cpq": float(self.cpq), "phi": float(self.phi)}


def signals_for(stage: Stage, device: DeviceProfile,
                resident_bytes: float = 0.0,
                temp_c: float | None = None,
                headroom: float = 0.9) -> SignalSet:
    """Evaluate DASI/CPQ/Phi for a stage on a device given runtime state.

    ``resident_bytes`` is the device's total resident working set under the
    candidate assignment (this stage included); ``temp_c`` defaults to the
    device's ambient when no thermal state is available.
    """
    t = device.t_ambient if temp_c is None else temp_c
    return SignalSet(dasi=dasi(stage, device),
                     msat=memory_saturation(stage, device),
                     cpq=cpq(resident_bytes, device, headroom),
                     phi=phi(t))
