"""Roofline-derived energy model — the "v2" contribution in the assignment title.

The paper's v1 energy law (Formalism 2) is a calibrated power law. v2 replaces the
calibration with a *mechanistic* model: every stage's execution time is its roofline
time on the assigned device (max of compute and memory terms, from the analytic
FLOP/byte counts of ``repro_torch.core.decomposition`` — or from compiled-HLO counts in
the dry-run pipeline), and energy integrates power over that time:

    t_stage  = max(FLOPs / (C_i * util), bytes / (B_i * util))
    E_stage  = t_stage * (P_idle + util * (P_peak - P_idle)) * f(Q)
    E_total  = sum over stages + idle energy of unassigned devices + transfer energy

This is what lets the orchestrator *derive* the Pareto frontier instead of
assuming the paper's measured constants — and on the TPU path, the same model
consumes ``compiled.cost_analysis()`` numbers directly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.decomposition import Stage, Workload
from repro_torch.core.devices import DeviceProfile
from repro_torch.core.formalisms import quant_factor

TRANSFER_ENERGY_PER_BYTE = 60e-12  # J/B over PCIe-class links (~60 pJ/bit*8)


@dataclass
class StageExecution:
    stage: Stage
    device: DeviceProfile
    time_s: float
    energy_j: float
    bound: str                    # compute | memory


def execute_stage(stage: Stage, device: DeviceProfile,
                  quant: str = "bf16",
                  throttle: float = 1.0) -> StageExecution:
    """Roofline time + integrated energy for one stage on one device.

    ``throttle`` in (0,1] scales effective throughput (thermal protection:
    paper Principle 6.1 reduces workload intensity, stretching time but
    lowering power draw proportionally).
    """
    eff = device.util * throttle
    t_c = stage.flops / (device.peak_flops * eff)
    t_m = stage.bytes_moved / (device.mem_bw * eff)
    t = max(t_c, t_m)
    # Dynamic power scales with the paper's architectural efficiency
    # multiplier lambda_i (Formalism 2: NPUs spend far fewer pJ per op than
    # GPUs at the same utilization) and with how busy the compute units are:
    # memory-bound stages leave the MXU/SMs idling (busy_frac < 1).
    busy_frac = (t_c / t if t > 0 else 0.0)
    p_dyn = (device.power_peak - device.power_idle) * device.util * \
        device.lambda_eff * (0.55 + 0.45 * busy_frac) * throttle
    # marginal-energy accounting: the idle floor is paid by the platform
    # whether or not this stage runs; stage energy is the dynamic part.
    energy = t * p_dyn * quant_factor(quant)
    return StageExecution(stage, device, t, energy,
                          "compute" if t_c >= t_m else "memory")


@dataclass
class PlanCosts:
    executions: List[StageExecution]
    transfer_bytes: float
    transfer_time_s: float
    transfer_energy_j: float
    devices: Sequence[DeviceProfile]

    @property
    def energy_j(self) -> float:
        return (sum(e.energy_j for e in self.executions) +
                self.transfer_energy_j)

    @property
    def busy_time_s(self) -> float:
        return sum(e.time_s for e in self.executions) + self.transfer_time_s

    def per_device_time(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.executions:
            out[e.device.name] = out.get(e.device.name, 0.0) + e.time_s
        return out

    def per_device_energy(self) -> Dict[str, float]:
        """Stage (dynamic) energy summed per device, transfer excluded —
        divides by makespan to give the per-device average power draw the
        runtime control loop feeds the RC thermal models."""
        out: Dict[str, float] = {}
        for e in self.executions:
            out[e.device.name] = out.get(e.device.name, 0.0) + e.energy_j
        return out

    @property
    def makespan_s(self) -> float:
        """Pipeline view: devices work concurrently; the busiest device plus
        transfer time bounds the steady-state latency."""
        per_dev = self.per_device_time()
        return (max(per_dev.values()) if per_dev else 0.0) + self.transfer_time_s

    @property
    def avg_power_w(self) -> float:
        t = max(self.makespan_s, 1e-12)
        return self.energy_j / max(self.busy_time_s, t)

    def phase_energy(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.executions:
            out[e.stage.phase] = out.get(e.stage.phase, 0.0) + e.energy_j
        out["transfer"] = self.transfer_energy_j
        return out


def boundary_transfer_bytes(execs: List[StageExecution],
                            workload: Optional[Workload] = None) -> float:
    """Bytes crossing a link: activations (n_tokens x d_model) transfer
    whenever consecutive stages of the same phase sit on different devices.
    Shared by the v1 and v2 cost models so their transfer accounting can
    never drift apart. Decode-phase tokens are *scored queries*: under
    speculative decode every committed token rides a verify forward of
    ``spec_query_factor`` query tokens across the boundary (1.0 when not
    drafting — bit-identical to the pre-speculation accounting)."""
    transfer_bytes = 0.0
    by_phase: Dict[str, List[StageExecution]] = {}
    for e in execs:
        by_phase.setdefault(e.stage.phase, []).append(e)
    for phase, seq in by_phase.items():
        seq = sorted(seq, key=lambda e: e.stage.layer)
        for a, b in zip(seq, seq[1:]):
            if a.device.name != b.device.name:
                if workload is not None:
                    n_tok = (workload.n_decode_tokens *
                             workload.spec_query_factor
                             if phase == "decode"
                             else workload.n_prefill_tokens)
                    transfer_bytes += (n_tok * workload.bytes_per_act *
                                       max(a.stage.width, 1))
                else:
                    transfer_bytes += a.stage.bytes_moved * 0.01
    return transfer_bytes


def plan_costs(stages: List[Stage], assignment: Dict[str, DeviceProfile],
               quant: str = "bf16", workload: Optional[Workload] = None,
               throttle: Optional[Dict[str, float]] = None,
               model: str = "v1",
               temps: Optional[Dict[str, float]] = None,
               headroom: float = 0.9,
               provider=None) -> PlanCosts:
    """Cost a full stage->device assignment, including cross-device activation
    transfers whenever consecutive layers live on different devices.

    ``model="v2"`` dispatches to the DASI/CPQ/Phi physics-grounded energy
    equation of ``repro.qeil2.energy_v2``, which the port does not have yet;
    the default keeps the v1 path bit-for-bit reproducible. ``temps`` (device -> junction degC) and
    ``headroom`` (allocator fraction that counts as CPQ=1) only affect the v2
    path, which models temperature-dependent leakage and capacity pressure.
    ``provider`` (an optional ``repro.qeil2.telemetry.CalibratedSignalProvider``)
    substitutes fitted coefficients and measured kernel times into the v2
    signals; it has no meaning for v1 and is rejected there.
    """
    if model == "v2":
        raise NotImplementedError("the v2 energy model (qeil2.energy_v2) "
                                  "arrives with the scheduler slice of the "
                                  "port")
    if model != "v1":
        raise ValueError(f"unknown energy model {model!r} (want 'v1' or 'v2')")
    if provider is not None:
        raise ValueError("provider= is a v2 calibration hook; "
                         "pass model='v2' to use it")
    throttle = throttle or {}
    execs = []
    for st in stages:
        dev = assignment[st.name]
        execs.append(execute_stage(st, dev, quant,
                                   throttle.get(dev.name, 1.0)))

    transfer_bytes = boundary_transfer_bytes(execs, workload)
    link_bw = min(d.link_bw for d in assignment.values())
    t_io = transfer_bytes / link_bw if transfer_bytes else 0.0
    e_io = transfer_bytes * TRANSFER_ENERGY_PER_BYTE
    return PlanCosts(execs, transfer_bytes, t_io, e_io,
                     devices=list({d.name: d
                                   for d in assignment.values()}.values()))


def homogeneous_assignment(stages: List[Stage],
                           device: DeviceProfile) -> Dict[str, DeviceProfile]:
    return {st.name: device for st in stages}
