"""Safety-first agentic orchestration (paper Sections 3.2, 3.7; Eq. 12).

Implements:
  * ``GreedyOrchestrator`` — the paper's algorithm: rank devices by energy
    efficiency (Eq. 11), pin embedding/LM-head to the most efficient fitting
    device, distribute decoder layers greedily minimizing per-stage energy
    under memory / thermal constraints, then validate latency & coverage SLAs.
    O(L*D), re-runnable on safety events (the paper's justification for greedy).
  * ``exhaustive_oracle`` — brute-force optimal assignment for small cases,
    used to validate the paper's "greedy within 5% of ILP" claim (Section 3.7).
  * ``ParetoOrchestrator`` — beyond-paper: sweeps the energy/latency trade-off
    via epsilon-constraint scalarization and returns the non-dominated frontier
    (the "Pareto-optimal multi-objective orchestration" of the v2 title).

The Safety monitor (repro_torch.core.safety) holds override authority: assignments are
checked against thermal predictions before being returned, and `reassign_on_failure`
redistributes stages away from failed devices.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.decomposition import Stage, Workload, decompose
from repro_torch.core.devices import DeviceProfile
from repro_torch.core.energy import PlanCosts, execute_stage, plan_costs
from repro_torch.core.formalisms import CoverageParams, coverage
from repro_torch.models.config import ArchConfig


@dataclass
class Constraints:
    latency_sla_s: Optional[float] = None
    # when no explicit SLA: per-device busy budget = factor x best homogeneous
    # makespan (1.0 = "never slower than the best single device"); None = pure
    # energy minimization with no latency constraint.
    latency_budget_factor: Optional[float] = 1.0
    coverage_min: Optional[float] = None
    thermal_margin: float = 0.85          # theta_throttle (Principle 6.1)
    memory_headroom: float = 0.9          # use <=90% of device memory


@dataclass
class Assignment:
    mapping: Dict[str, DeviceProfile]
    costs: Optional[PlanCosts]    # None iff no feasible placement exists
    feasible: bool
    violations: List[str] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)

    @property
    def energy_j(self) -> float:
        return self.costs.energy_j if self.costs is not None else float("inf")

    @property
    def latency_s(self) -> float:
        return self.costs.makespan_s if self.costs is not None else float("inf")

    def device_names(self) -> List[str]:
        return sorted({d.name for d in self.mapping.values()})


def _memory_ok(dev: DeviceProfile, used: Dict[str, float], extra: float,
               headroom: float) -> bool:
    return used.get(dev.name, 0.0) + extra <= dev.mem_cap * headroom


def latency_budget(constraints: Constraints, stages: Sequence[Stage],
                   devices: Sequence[DeviceProfile],
                   quant: str = "bf16") -> float:
    """Per-device busy-time budget: the SLA if given, else
    latency_budget_factor x the best homogeneous device's makespan
    (factor None -> unconstrained energy minimization). Shared by every
    orchestrator so 'drop-in' engines agree on what the budget means."""
    if constraints.latency_sla_s is not None:
        return constraints.latency_sla_s
    if constraints.latency_budget_factor is None:
        return float("inf")
    best = min(sum(execute_stage(st, dev, quant).time_s for st in stages)
               for dev in devices)
    return constraints.latency_budget_factor * best


def constraint_violations(constraints: Constraints, makespan_s: float,
                          cfg: ArchConfig, workload: Workload) -> List[str]:
    """SLA / coverage checks every orchestrator applies to a finished plan
    (GreedyOrchestrator step 3; PGSAMOrchestrator post-anneal)."""
    violations: List[str] = []
    if constraints.latency_sla_s is not None and \
            makespan_s > constraints.latency_sla_s:
        violations.append(
            f"latency {makespan_s * 1e3:.2f} ms > SLA "
            f"{constraints.latency_sla_s * 1e3:.2f} ms")
    if constraints.coverage_min is not None:
        cov = coverage(workload.samples, N=cfg_param_millions(cfg),
                       T=workload.decode_tokens)
        if cov < constraints.coverage_min:
            violations.append(
                f"coverage {cov:.3f} < {constraints.coverage_min}")
    return violations


class GreedyOrchestrator:
    """Paper-faithful greedy layer assignment."""

    def __init__(self, devices: Sequence[DeviceProfile],
                 constraints: Constraints = Constraints(),
                 quant: str = "bf16"):
        if not devices:
            raise ValueError("need at least one device")
        self.devices = list(devices)
        self.constraints = constraints
        self.quant = quant

    # -- step 1: preprocessing — rank devices by energy efficiency (Eq. 11)
    def ranked_devices(self) -> List[DeviceProfile]:
        return sorted(self.devices,
                      key=lambda d: d.energy_efficiency(), reverse=True)

    def _latency_budget(self, stages: List[Stage]) -> float:
        return latency_budget(self.constraints, stages, self.devices,
                              self.quant)

    def assign(self, cfg: ArchConfig, workload: Workload,
               healthy: Optional[Sequence[str]] = None) -> Assignment:
        stages = decompose(cfg, workload)
        devices = [d for d in self.devices
                   if healthy is None or d.name in healthy]
        if not devices:
            raise RuntimeError("no healthy devices")
        ranked = sorted(devices, key=lambda d: d.energy_efficiency(),
                        reverse=True)
        used_mem: Dict[str, float] = {}
        mapping: Dict[str, DeviceProfile] = {}
        notes: List[str] = []

        all_budget = self._latency_budget(stages)
        busy: Dict[str, float] = {}

        # -- step 2a: embedding + LM head to the most efficient fitting
        # device whose accumulated busy time stays within the latency budget
        # (the LM-head matmul over all tokens is NOT free — pinning it to the
        # NPU unbudgeted was a measured -11% latency regression).
        for st in stages:
            if st.phase in ("embed", "head"):
                placed = False
                for dev in ranked:
                    if not _memory_ok(dev, used_mem, st.param_bytes,
                                      self.constraints.memory_headroom):
                        continue
                    ex = execute_stage(st, dev, self.quant)
                    if busy.get(dev.name, 0.0) + ex.time_s <= all_budget:
                        mapping[st.name] = dev
                        used_mem[dev.name] = used_mem.get(dev.name, 0.0) + \
                            st.param_bytes
                        busy[dev.name] = busy.get(dev.name, 0.0) + ex.time_s
                        placed = True
                        break
                if not placed:  # fallback: minimize resulting busy time
                    cands = [(busy.get(d.name, 0.0) +
                              execute_stage(st, d, self.quant).time_s, d)
                             for d in ranked
                             if _memory_ok(d, used_mem, st.param_bytes,
                                           self.constraints.memory_headroom)]
                    if not cands:
                        return Assignment({}, None, False,
                                          [f"{st.name}: no device fits"])
                    t_new, dev = min(cands, key=lambda c: c[0])
                    mapping[st.name] = dev
                    used_mem[dev.name] = used_mem.get(dev.name, 0.0) + \
                        st.param_bytes
                    busy[dev.name] = t_new

        # -- step 2b: decoder layers greedily, minimizing per-stage energy
        # subject to the latency budget. Devices execute concurrently
        # (pipelined batches), so the plan's latency is the busiest device's
        # time; the greedy keeps every device's accumulated busy time within
        # the budget while picking the cheapest-energy device per stage. This
        # is what yields the paper's simultaneous energy AND latency win over
        # the best homogeneous device: memory-bound decode spreads across the
        # aggregate bandwidth of all devices, weighted toward efficient ones.
        # A layer's prefill and decode stages may land on different devices
        # (prefill/decode disaggregation) — weights are then mirrored.
        layer_stages = [st for st in stages if st.phase in ("prefill", "decode")]
        budget = all_budget
        # hardest (most time-consuming) stages first: classic LPT bin packing
        order = sorted(layer_stages,
                       key=lambda s: -execute_stage(s, ranked[0], self.quant).time_s)
        for st in order:
            best: Tuple[float, Optional[DeviceProfile], float] = \
                (float("inf"), None, 0.0)
            fallback: Tuple[float, Optional[DeviceProfile], float] = \
                (float("inf"), None, 0.0)
            for dev in ranked:
                if not _memory_ok(dev, used_mem, st.param_bytes,
                                  self.constraints.memory_headroom):
                    continue
                ex = execute_stage(st, dev, self.quant)
                new_busy = busy.get(dev.name, 0.0) + ex.time_s
                if new_busy <= budget and ex.energy_j < best[0]:
                    best = (ex.energy_j, dev, ex.time_s)
                if new_busy < fallback[0]:
                    fallback = (new_busy, dev, ex.time_s)
            pick = best if best[1] is not None else fallback
            if pick[1] is None:
                return Assignment({}, None, False,
                                  [f"{st.name}: no device fits "
                                   f"({st.param_bytes/1e9:.1f} GB)"])
            dev = pick[1]
            mapping[st.name] = dev
            busy[dev.name] = busy.get(dev.name, 0.0) + pick[2]
            used_mem[dev.name] = used_mem.get(dev.name, 0.0) + st.param_bytes

        self._segmentize(mapping, layer_stages)
        costs = plan_costs(stages, mapping, self.quant, workload)

        # -- step 3: constraint checking
        violations = constraint_violations(self.constraints, costs.makespan_s,
                                           cfg, workload)
        return Assignment(mapping, costs, not violations, violations, notes)

    @staticmethod
    def _segmentize(mapping: Dict[str, DeviceProfile],
                    layer_stages: List[Stage]) -> None:
        """Reorder per-layer device assignments into contiguous segments.

        Within a (phase, stage-kind) group every layer stage has identical
        cost, so permuting which layer sits on which device preserves energy
        and per-device busy time while minimizing cross-device activation
        boundaries (each boundary costs n_tokens * d_model transfer bytes).
        """
        groups: Dict[Tuple[str, str], List[Stage]] = {}
        for st in layer_stages:
            kind = st.name.split(".")[1] if "." in st.name else ""
            groups.setdefault((st.phase, kind), []).append(st)
        for group in groups.values():
            group.sort(key=lambda s: s.layer)
            devs = [mapping[s.name] for s in group]
            order: List[DeviceProfile] = []
            counts: Dict[str, int] = {}
            for d in devs:
                if d.name not in counts:
                    order.append(d)
                    counts[d.name] = 0
                counts[d.name] += 1
            it = iter(group)
            for d in order:
                for _ in range(counts[d.name]):
                    mapping[next(it).name] = d

    # -- safety integration: redistribute away from failed devices
    def reassign_on_failure(self, cfg: ArchConfig, workload: Workload,
                            failed: Sequence[str]) -> Assignment:
        healthy = [d.name for d in self.devices if d.name not in failed]
        return self.assign(cfg, workload, healthy=healthy)

    # -- drift-event hook (`repro_torch.core.safety.DriftEvent`): part of the
    # orchestrator engine contract so `SafetyMonitor.subscribe(orch.on_drift)`
    # works with any engine. Greedy keeps no cross-assign state, so there is
    # nothing to invalidate; PGSAMOrchestrator overrides this to bump its
    # frontier-cache epoch.
    def on_drift(self, event) -> None:
        return None


def cfg_param_millions(cfg: ArchConfig) -> float:
    from repro_torch.models.model import Model
    return Model(cfg).param_count() / 1e6


# --------------------------------------------------------------------- oracle

def exhaustive_oracle(cfg: ArchConfig, workload: Workload,
                      devices: Sequence[DeviceProfile],
                      quant: str = "bf16",
                      max_stages: int = 12) -> Assignment:
    """Brute-force optimal assignment (small cases only): validates the
    paper's claim that greedy lands within ~5% of the ILP optimum."""
    stages = decompose(cfg, workload)
    if len(stages) > max_stages:
        raise ValueError(f"{len(stages)} stages > {max_stages}: "
                         "oracle is exponential, reduce the model")
    best: Tuple[float, Optional[Dict]] = (float("inf"), None)
    for combo in itertools.product(devices, repeat=len(stages)):
        used: Dict[str, float] = {}
        ok = True
        for st, dev in zip(stages, combo):
            used[dev.name] = used.get(dev.name, 0.0) + st.param_bytes
            if used[dev.name] > dev.mem_cap * 0.9:
                ok = False
                break
        if not ok:
            continue
        mapping = {st.name: dev for st, dev in zip(stages, combo)}
        costs = plan_costs(stages, mapping, quant, workload)
        if costs.energy_j < best[0]:
            best = (costs.energy_j, mapping)
    if best[1] is None:
        return Assignment({}, None, False, ["no feasible assignment"])
    mapping = best[1]
    return Assignment(mapping, plan_costs(stages, mapping, quant, workload),
                      True)


# --------------------------------------------------------------------- Pareto

# epsilon-constraint schedule shared by every frontier sweep (Pareto sweep,
# PGSAM seeding, benchmarks): factors of a base latency used as SLAs.
SLA_SWEEP_FACTORS: Tuple[float, ...] = tuple(0.6 + 0.15 * k for k in range(8))


def greedy_sla_sweep(devices: Sequence[DeviceProfile], cfg: ArchConfig,
                     workload: Workload, base_latency_s: float,
                     quant: str = "bf16",
                     factors: Sequence[float] = SLA_SWEEP_FACTORS,
                     engine: Optional[type] = None,
                     memory_headroom: float = 0.9) -> List[Assignment]:
    """One assignment per SLA = factor * base_latency_s (the epsilon-constraint
    trick that traces an energy/latency frontier out of a single-objective
    orchestrator). Infeasible points are returned as-is; filter on
    ``a.mapping and a.feasible``."""
    engine = engine or GreedyOrchestrator
    return [engine(devices,
                   Constraints(latency_sla_s=f * base_latency_s,
                               memory_headroom=memory_headroom),
                   quant).assign(cfg, workload)
            for f in factors]


class ParetoOrchestrator:
    """Beyond-paper: epsilon-constraint sweep over latency budgets produces
    the energy/latency/coverage Pareto frontier; pick by scalarized preference
    or hand the frontier to the caller (examples/pareto_orchestration.py).

    ``engine`` is any orchestrator class with the GreedyOrchestrator
    constructor/assign API — pass `repro_torch.qeil2.PGSAMOrchestrator` to drive the
    sweep with the v2 annealer instead of the single-pass greedy."""

    def __init__(self, devices: Sequence[DeviceProfile], quant: str = "bf16",
                 engine: Optional[type] = None):
        self.devices = list(devices)
        self.quant = quant
        self.engine = engine or GreedyOrchestrator

    def frontier(self, cfg: ArchConfig, workload: Workload,
                 sample_budgets: Sequence[int] = (1, 5, 10, 20),
                 n_latency_points: int = 8) -> List[Dict]:
        """Enumerate (samples, latency-budget) grid -> feasible assignments,
        return the non-dominated set over (energy, latency, -coverage)."""
        from repro_torch.core.pareto import pareto_front
        candidates: List[Dict] = []
        for S in sample_budgets:
            w = Workload(batch=workload.batch,
                         prompt_tokens=workload.prompt_tokens,
                         decode_tokens=workload.decode_tokens, samples=S,
                         bytes_per_param=workload.bytes_per_param,
                         bytes_per_act=workload.bytes_per_act)
            base = self.engine(self.devices, Constraints(),
                               self.quant).assign(cfg, w)
            if not base.mapping:
                continue
            sweep = greedy_sla_sweep(
                self.devices, cfg, w, base.latency_s, self.quant,
                factors=tuple(0.6 + 0.15 * k
                              for k in range(n_latency_points)),
                engine=self.engine)
            for a in sweep:
                if not a.mapping or not a.feasible:
                    continue
                cov = coverage(S, cfg_param_millions(cfg),
                               w.decode_tokens)
                candidates.append({
                    "samples": S, "assignment": a,
                    "energy_j": a.energy_j, "latency_s": a.latency_s,
                    "coverage": cov,
                })
        keys = [(c["energy_j"], c["latency_s"], -c["coverage"])
                for c in candidates]
        idx = pareto_front(keys)
        return [candidates[i] for i in idx]
