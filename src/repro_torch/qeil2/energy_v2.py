"""Unified v2 energy equation: DASI/CPQ/Phi-modulated dynamic power.

v1 (`repro_torch.core.energy.execute_stage`) models a stage's dynamic power as

    p_v1 = (P_peak - P_idle) * util * lambda_eff * (0.55 + 0.45 * busy_frac)

where ``0.55 + 0.45 * busy_frac`` is a *static* activity heuristic: even a
fully memory-bound stage is charged 55% of peak dynamic power. v2 replaces the
heuristic with the physics-grounded signal triple of `repro_torch.qeil2.signals`:

    p_dyn = (P_peak - P_idle) * util * lambda_eff
            * (W_COMPUTE * DASI + W_MEMORY * MSAT)     # subsystem duty cycles
            * (1 + CPQ_KAPPA * CPQ^2)                  # memory-pressure tax
    E     = t_roofline * p_dyn * f(Q) / Phi(T)         # leakage overhead

Coefficients (all documented at their definition):

* ``W_COMPUTE`` / ``W_MEMORY`` — the split of dynamic power between the
  compute datapath and the memory subsystem at full duty. 0.7/0.3 follows the
  standard accelerator power breakdown (MAC arrays and register files dominate;
  DRAM+controller draw ~30% at peak streaming).
* CPQ/Phi coefficients — see `repro_torch.qeil2.signals`.

The v1 path stays untouched and remains the default everywhere
(``plan_costs(..., model="v1")``); v2 is opt-in via the ``model`` flag so the
seed benchmarks stay reproducible bit-for-bit.

Speculative decode is priced upstream, not here: `repro_torch.spec.spec_workload`
rescales the decode-phase Workload (weight re-streams amortized across
``tokens_per_step`` committed tokens, per-query traffic multiplied by the
query factor) before `repro_torch.core.decompose` builds the stages, so the FLOP/
byte counts arriving in each Stage already reflect drafting — DASI of decode
stages rises as verify batching lifts arithmetic intensity, and the shared
`boundary_transfer_bytes` scales cross-device decode activations by
``Workload.spec_query_factor``. No equation in this module changes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.decomposition import Stage, Workload
from repro_torch.core.devices import DeviceProfile
from repro_torch.core.energy import (PlanCosts, StageExecution,
                                     TRANSFER_ENERGY_PER_BYTE,
                                     boundary_transfer_bytes)
from repro_torch.core.formalisms import quant_factor
from repro_torch.qeil2.signals import SignalSet, cpq_power_factor, signals_for

# Dynamic-power split between compute datapath and memory subsystem at full
# duty cycle (see module docstring for provenance).
W_COMPUTE = 0.70
W_MEMORY = 0.30


@dataclass
class StageExecutionV2(StageExecution):
    """StageExecution plus the signal triple that produced its energy."""
    signals: Optional[SignalSet] = None


def execute_stage_v2(stage: Stage, device: DeviceProfile,
                     quant: str = "bf16",
                     throttle: float = 1.0,
                     resident_bytes: float = 0.0,
                     temp_c: Optional[float] = None,
                     headroom: float = 0.9,
                     provider=None) -> StageExecutionV2:
    """Roofline time (identical to v1) + DASI/CPQ/Phi-modulated energy.

    ``resident_bytes`` — device working set under the candidate assignment
    (drives CPQ); ``temp_c`` — device junction temperature from the safety
    monitor's RC model (drives Phi; ambient when None). ``provider`` — an
    optional `repro_torch.qeil2.telemetry.CalibratedSignalProvider`: signals come
    from its fitted coefficients, and where a measured Pallas kernel backs
    the stage, execution time stretches to the measured time (roofline /
    eta) while both duty cycles shrink by eta. ``provider=None`` is the
    analytic path, bit-for-bit unchanged.
    """
    eff = device.util * throttle
    t_c = stage.flops / (device.peak_flops * eff)
    t_m = stage.bytes_moved / (device.mem_bw * eff)
    t = max(t_c, t_m)
    if provider is None:
        sig = signals_for(stage, device, resident_bytes, temp_c, headroom)
        cpq_factor = cpq_power_factor(sig.cpq)
    else:
        sig = provider.signals_for(stage, device, resident_bytes, temp_c,
                                   headroom)
        cpq_factor = provider.cpq_power_factor(sig.cpq)
        t = t * provider.time_scale(stage)
    activity = W_COMPUTE * sig.dasi + W_MEMORY * sig.msat
    p_dyn = (device.power_peak - device.power_idle) * device.util * \
        device.lambda_eff * activity * cpq_factor * throttle
    energy = t * p_dyn * quant_factor(quant) / sig.phi
    return StageExecutionV2(stage, device, t, energy,
                            "compute" if t_c >= t_m else "memory",
                            signals=sig)


def plan_costs_v2(stages: List[Stage],
                  assignment: Dict[str, DeviceProfile],
                  quant: str = "bf16",
                  workload: Optional[Workload] = None,
                  throttle: Optional[Dict[str, float]] = None,
                  temps: Optional[Dict[str, float]] = None,
                  headroom: float = 0.9,
                  provider=None) -> PlanCosts:
    """v2 counterpart of `repro_torch.core.energy.plan_costs`.

    Resident bytes per device are accumulated from the full assignment first,
    so every stage on a device sees the same (final) capacity pressure — the
    steady-state working set, which is what the allocator actually holds
    during pipelined execution. ``temps`` maps device name -> junction degC
    (e.g. from ``SafetyMonitor.thermal[...].state.temp_c``); ``provider``
    an optional `repro_torch.qeil2.telemetry.CalibratedSignalProvider` (fitted
    coefficients + measured kernel times; None = analytic, bit-for-bit).
    """
    throttle = throttle or {}
    temps = temps or {}
    resident: Dict[str, float] = {}
    for st in stages:
        dev = assignment[st.name]
        resident[dev.name] = resident.get(dev.name, 0.0) + st.param_bytes

    execs: List[StageExecution] = []
    for st in stages:
        dev = assignment[st.name]
        execs.append(execute_stage_v2(
            st, dev, quant,
            throttle=throttle.get(dev.name, 1.0),
            resident_bytes=resident[dev.name],
            temp_c=temps.get(dev.name),
            headroom=headroom,
            provider=provider))

    transfer_bytes = boundary_transfer_bytes(execs, workload)
    link_bw = min(d.link_bw for d in assignment.values())
    t_io = transfer_bytes / link_bw if transfer_bytes else 0.0
    e_io = transfer_bytes * TRANSFER_ENERGY_PER_BYTE
    return PlanCosts(execs, transfer_bytes, t_io, e_io,
                     devices=list({d.name: d
                                   for d in assignment.values()}.values()))
