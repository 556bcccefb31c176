"""PGSAM — Pareto-Guided Simulated Annealing with Momentum (paper Section 3).

The v2 orchestrator. Where v1's `GreedyOrchestrator` commits to each stage
placement in a single myopic pass, PGSAM searches the full stage->device
mapping space with a multi-objective annealer:

* **objectives** — simultaneously minimize ``(energy_j, makespan_s,
  underutilization)``; the third term rewards spreading work across the
  platform's aggregate bandwidth instead of piling onto one efficient device.
* **Pareto guidance** — a bounded non-dominated archive steers acceptance:
  candidates that extend the archive are always accepted; dominated
  candidates are accepted with Boltzmann probability on their normalized
  worsening, so the walk can cross energy barriers early and anneals into the
  frontier as the temperature cools geometrically.
* **momentum** — move proposals are biased toward *directions* (target
  devices) that were recently accepted: heterogeneous platforms have long
  runs of stages that belong on the same device, and momentum exploits that
  correlation instead of rediscovering it one uniform move at a time.
* **seeding** — the walk starts from `GreedyOrchestrator.assign` solutions
  (several latency budgets), so PGSAM is never worse than greedy and the
  archive's hypervolume starts at the greedy sweep's.
* **convergence** — `repro_torch.core.pareto.hypervolume_2d` over the archive's
  (energy, makespan) projection; the anneal stops when the hypervolume has
  not improved for ``hv_patience`` iterations.

Everything is deterministic under a fixed ``PGSAMConfig.seed``.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.decomposition import Stage, Workload, decompose
from repro_torch.core.devices import DeviceProfile
from repro_torch.core.energy import PlanCosts, execute_stage, plan_costs
from repro_torch.core.orchestrator import (Assignment, Constraints,
                                           GreedyOrchestrator,
                                           constraint_violations,
                                           greedy_sla_sweep, latency_budget)
from repro_torch.core.pareto import dominates, hypervolume_2d
from repro_torch.models.config import ArchConfig

Mapping = Tuple[int, ...]          # stage index -> device index


@dataclass(frozen=True)
class PGSAMConfig:
    seed: int = 0
    iters_max: int = 3000
    # Boltzmann temperature is dimensionless: the barrier height is the sum
    # of *relative* objective worsenings, so t_init_frac=0.05 means "a 5%
    # worsening is accepted with prob 1/e at the start", independent of the
    # workload's absolute joule/second scale; geometric cooling per iter.
    t_init: Optional[float] = None
    t_init_frac: float = 0.05      # initial temp when t_init is None
    cooling: float = 0.998
    # probability a proposal reuses a recently-accepted target device
    momentum: float = 0.6
    momentum_window: int = 32
    archive_max: int = 64
    # convergence: stop when frontier hypervolume hasn't improved by hv_tol
    # (relative) for hv_patience consecutive iterations
    hv_patience: int = 400
    hv_check_every: int = 25
    hv_tol: float = 1e-4
    # delta-cost evaluation (repro_torch.qeil2.runtime.incremental): every proposal
    # is a single-stage move, so candidate objectives come from O(1)
    # accumulator updates instead of a full O(stages) plan_costs pass. The
    # objective values agree with the full path to ~1e-9 relative (float
    # summation order), so the walk may differ in the last ulp; archive
    # entries get exact full-path costs filled in after the anneal.
    incremental: bool = False


@dataclass
class ArchiveEntry:
    objectives: Tuple[float, float, float]   # energy_j, makespan_s, underutil
    mapping: Mapping
    # None only transiently inside an incremental anneal; `optimize` fills
    # every returned entry with full-path costs before returning.
    costs: Optional[PlanCosts]


@dataclass
class PGSAMResult:
    archive: List[ArchiveEntry]
    best_energy: ArchiveEntry                # min-energy feasible point seen
    iterations: int
    accepted: int
    hypervolume: float
    hv_ref: Tuple[float, float]


class PGSAM:
    """The annealer itself, independent of the Assignment API (see
    `PGSAMOrchestrator` for the drop-in orchestrator wrapper)."""

    def __init__(self, stages: Sequence[Stage],
                 devices: Sequence[DeviceProfile],
                 quant: str = "bf16",
                 workload: Optional[Workload] = None,
                 config: PGSAMConfig = PGSAMConfig(),
                 memory_headroom: float = 0.9,
                 energy_model: str = "v1",
                 temps: Optional[Dict[str, float]] = None,
                 latency_budget_s: float = float("inf"),
                 provider=None):
        if provider is not None and energy_model != "v2":
            raise ValueError("a CalibratedSignalProvider requires "
                             "energy_model='v2'")
        self.stages = list(stages)
        self.devices = list(devices)
        self.quant = quant
        self.workload = workload
        self.cfg = config
        self.headroom = memory_headroom
        self.energy_model = energy_model
        self.temps = temps
        self.latency_budget_s = latency_budget_s
        self.provider = provider
        self.rng = np.random.default_rng(config.seed)
        # per-device param_bytes capacity in bytes
        self._caps = [d.mem_cap * memory_headroom for d in devices]

    # ---------------------------------------------------------------- eval
    def _mem_ok(self, mapping: Mapping) -> bool:
        used = [0.0] * len(self.devices)
        for si, di in enumerate(mapping):
            used[di] += self.stages[si].param_bytes
            if used[di] > self._caps[di]:
                return False
        return True

    def _evaluate(self, mapping: Mapping) -> ArchiveEntry:
        assign = {st.name: self.devices[di]
                  for st, di in zip(self.stages, mapping)}
        costs = plan_costs(self.stages, assign, self.quant, self.workload,
                           model=self.energy_model, temps=self.temps,
                           headroom=self.headroom, provider=self.provider)
        makespan = costs.makespan_s
        per_dev = costs.per_device_time()
        busy = sum(per_dev.values())
        n = len(self.devices)
        underutil = 1.0 - busy / (n * makespan) if makespan > 0 else 0.0
        return ArchiveEntry((costs.energy_j, makespan, underutil),
                            mapping, costs)

    def _feasible(self, entry: ArchiveEntry) -> bool:
        return entry.objectives[1] <= self.latency_budget_s

    # ------------------------------------------------------------- archive
    def _archive_insert(self, archive: List[ArchiveEntry],
                        cand: ArchiveEntry) -> bool:
        """Insert if non-dominated; prune dominated members. Returns whether
        the candidate entered the archive."""
        if any(dominates(a.objectives, cand.objectives) or
               a.objectives == cand.objectives for a in archive):
            return False
        archive[:] = [a for a in archive
                      if not dominates(cand.objectives, a.objectives)]
        archive.append(cand)
        if len(archive) > self.cfg.archive_max:
            # deterministic thinning: sort by energy, keep evenly spaced
            # points including both extremes (preserves frontier span).
            archive.sort(key=lambda a: a.objectives)
            idx = np.linspace(0, len(archive) - 1,
                              self.cfg.archive_max).round().astype(int)
            archive[:] = [archive[i] for i in sorted(set(idx.tolist()))]
        return True

    # ------------------------------------------------------------ proposal
    def _propose(self, mapping: Mapping, momentum_devs: deque
                 ) -> Optional[Tuple[Mapping, int, int]]:
        """One single-stage move: returns (new mapping, stage, target device).
        The explicit (stage, device) pair is what lets the incremental
        evaluator apply the move in O(1)."""
        n_stage, n_dev = len(mapping), len(self.devices)
        if n_dev < 2:
            return None
        use_momentum = (len(momentum_devs) > 0 and
                        self.rng.random() < self.cfg.momentum)
        if use_momentum:
            # repeat a recently-accepted direction: pull another stage onto
            # a device the walk has lately had success moving work to.
            di = momentum_devs[int(self.rng.integers(len(momentum_devs)))]
            cands = [si for si in range(n_stage) if mapping[si] != di]
            if not cands:
                use_momentum = False
            else:
                si = int(cands[int(self.rng.integers(len(cands)))])
                new = list(mapping)
                new[si] = di
                return tuple(new), si, di
        si = int(self.rng.integers(n_stage))
        di = int(self.rng.integers(n_dev - 1))
        if di >= mapping[si]:
            di += 1
        new = list(mapping)
        new[si] = di
        return tuple(new), si, di

    # ---------------------------------------------------------------- run
    def optimize(self, seeds: Sequence[Mapping]) -> PGSAMResult:
        seeds = [tuple(s) for s in seeds if self._mem_ok(tuple(s))]
        if not seeds:
            raise ValueError("no memory-feasible seed mapping")
        entries = [self._evaluate(s) for s in seeds]
        archive: List[ArchiveEntry] = []
        for e in entries:
            self._archive_insert(archive, e)

        # lexicographic: feasible beats infeasible, then min energy
        def best_key(e: ArchiveEntry) -> Tuple[bool, float]:
            return (not self._feasible(e), e.objectives[0])

        best = min(entries, key=best_key)
        current = best

        # fixed hypervolume reference: 20% beyond the worst seed objectives,
        # so 'did the frontier move' is measured against a stable yardstick.
        ref = (1.2 * max(e.objectives[0] for e in entries),
               1.2 * max(e.objectives[1] for e in entries))
        hv = hypervolume_2d([(a.objectives[0], a.objectives[1])
                             for a in archive], ref)
        last_improve = 0

        temp = (self.cfg.t_init if self.cfg.t_init is not None
                else self.cfg.t_init_frac)
        momentum_devs: deque = deque(maxlen=self.cfg.momentum_window)
        accepted = 0
        it = 0

        # delta-cost evaluation: mirror `current` in an incremental evaluator;
        # proposals are applied speculatively and reverted on rejection.
        evalr = None
        if self.cfg.incremental:
            from repro_torch.qeil2.runtime.incremental import DeltaEvaluator
            evalr = DeltaEvaluator(self.stages, self.devices, current.mapping,
                                   self.quant, self.workload,
                                   model=self.energy_model, temps=self.temps,
                                   headroom=self.headroom,
                                   provider=self.provider)

        for it in range(1, self.cfg.iters_max + 1):
            prop = self._propose(current.mapping, momentum_devs)
            if prop is None:
                break
            cand_map, si, di = prop
            if evalr is not None:
                # O(1) destination check: the source device only frees memory,
                # so feasibility of a single move is the destination's alone.
                mem_ok = evalr.move_fits(si, di, self._caps[di])
            else:
                mem_ok = self._mem_ok(cand_map)
            if mem_ok:
                if evalr is not None:
                    token = evalr.apply(si, di)
                    cand = ArchiveEntry(evalr.objectives(), cand_map, None)
                else:
                    token = None
                    cand = self._evaluate(cand_map)
                if best_key(cand) < best_key(best):
                    best = cand
                accept = self._accept(current, cand, archive, temp)
                if accept:
                    # record the accepted direction (the device that gained a
                    # stage) for momentum-biased proposals.
                    momentum_devs.append(di)
                    current = cand
                    accepted += 1
                elif evalr is not None:
                    evalr.revert(token)
            temp *= self.cfg.cooling
            if it % self.cfg.hv_check_every == 0:
                new_hv = hypervolume_2d([(a.objectives[0], a.objectives[1])
                                         for a in archive], ref)
                if new_hv > hv * (1.0 + self.cfg.hv_tol):
                    hv = new_hv
                    last_improve = it
                if it - last_improve >= self.cfg.hv_patience:
                    break

        hv = hypervolume_2d([(a.objectives[0], a.objectives[1])
                             for a in archive], ref)
        # incremental entries carry delta-evaluated objectives and no costs:
        # fill in the exact full-path PlanCosts for everything we return
        # (if best sits in the archive it is the same object and is covered
        # by the first loop).
        if evalr is not None:
            for entry in archive:
                if entry.costs is None:
                    full = self._evaluate(entry.mapping)
                    entry.costs = full.costs
                    entry.objectives = full.objectives
            if best.costs is None:
                full = self._evaluate(best.mapping)
                best.costs = full.costs
                best.objectives = full.objectives
        archive.sort(key=lambda a: a.objectives)
        return PGSAMResult(archive, best, it, accepted, hv, ref)

    def _accept(self, current: ArchiveEntry, cand: ArchiveEntry,
                archive: List[ArchiveEntry], temp: float) -> bool:
        entered = self._archive_insert(archive, cand)
        if dominates(cand.objectives, current.objectives):
            return True
        if entered:
            # Pareto guidance: frontier-extending moves are always taken.
            return True
        # dominated or archive-rejected: Boltzmann on the summed *relative*
        # worsening of the (energy, makespan) pair — dimensionless, so joules
        # and seconds exert comparable barriers regardless of absolute scale
        # (underutil is a tie-break objective and deliberately excluded).
        delta = 0.0
        for o_new, o_old in zip(cand.objectives[:2], current.objectives[:2]):
            if o_new > o_old:
                delta += (o_new - o_old) / max(abs(o_old), 1e-12)
        if delta <= 0:
            return True
        if temp <= 0:
            return False
        return bool(self.rng.random() < math.exp(-delta / temp))


# ===================================================== orchestrator wrapper

class PGSAMOrchestrator:
    """Drop-in replacement for `GreedyOrchestrator` (same constructor and
    `assign` / `reassign_on_failure` API) that anneals the greedy seed with
    PGSAM. `ParetoOrchestrator`, the safety monitor, examples and benches can
    swap it in unchanged; `pareto_frontier` additionally exposes the full
    non-dominated archive of a single anneal."""

    def __init__(self, devices: Sequence[DeviceProfile],
                 constraints: Constraints = Constraints(),
                 quant: str = "bf16",
                 config: PGSAMConfig = PGSAMConfig(),
                 energy_model: str = "v1",
                 safety=None,
                 provider=None):
        if not devices:
            raise ValueError("need at least one device")
        if provider is not None and energy_model != "v2":
            raise ValueError("a CalibratedSignalProvider requires "
                             "energy_model='v2'")
        self.devices = list(devices)
        self.constraints = constraints
        self.quant = quant
        self.config = config
        self.energy_model = energy_model
        # optional repro_torch.qeil2.telemetry.CalibratedSignalProvider: fitted
        # coefficients + measured kernel times for every v2 plan costing
        # (anneals, re-anneals, frontier materialization).
        self.provider = provider
        # optional repro_torch.core.safety.SafetyMonitor: its RC thermal states feed
        # Phi (v2 energy) and its health view feeds reassign_on_failure.
        self.safety = safety
        self.last_result: Optional[PGSAMResult] = None
        # frontier archive cache: `pareto_frontier` memoizes per (cfg,
        # workload, healthy-set, health epoch). The epoch is the invalidation
        # handle — drift events (thermal margin crossings, failures, CPQ
        # saturation) bump it via `on_drift` / `invalidate_frontier`, so a
        # stale frontier is never served after the world has moved.
        self.health_epoch = 0
        self._frontier_cache: Dict[tuple, List[Assignment]] = {}

    # -- seeds: greedy at several latency budgets spans the frontier
    def _greedy_seeds(self, cfg: ArchConfig, workload: Workload,
                      stages: List[Stage],
                      devices: List[DeviceProfile]) -> List[Mapping]:
        dev_idx = {d.name: i for i, d in enumerate(devices)}
        seeds: List[Mapping] = []
        lat0: Optional[float] = None

        def keep(a: Assignment, is_balanced: bool = False) -> None:
            nonlocal lat0
            if a.mapping and all(st.name in a.mapping for st in stages):
                seeds.append(tuple(dev_idx[a.mapping[st.name].name]
                                   for st in stages))
                if is_balanced and lat0 is None:
                    lat0 = a.latency_s

        hr = self.constraints.memory_headroom
        # only the dedicated factor-1.0 run is "balanced" — self.constraints
        # may carry an SLA while leaving latency_budget_factor at its default
        for c, balanced in [
                (self.constraints, False),
                (Constraints(latency_budget_factor=None,
                             memory_headroom=hr), False),
                (Constraints(latency_budget_factor=1.0,
                             memory_headroom=hr), True),
                (Constraints(latency_budget_factor=0.7,
                             memory_headroom=hr), False)]:
            try:
                keep(GreedyOrchestrator(devices, c, self.quant).assign(
                    cfg, workload), is_balanced=balanced)
            except RuntimeError:
                pass
        # epsilon-constraint SLA sweep around the balanced greedy latency:
        # spans the low-latency end of the frontier, so the archive starts at
        # (and can only grow beyond) the v1 sweep's hypervolume.
        if lat0 is not None:
            for a in greedy_sla_sweep(devices, cfg, workload, lat0,
                                      self.quant, memory_headroom=hr):
                keep(a)
        return list(dict.fromkeys(seeds))      # dedupe, order-stable

    def _anneal(self, cfg: ArchConfig, workload: Workload,
                healthy: Optional[Sequence[str]]) -> Tuple[
                    List[Stage], List[DeviceProfile], PGSAMResult]:
        stages = decompose(cfg, workload)
        devices = [d for d in self.devices
                   if healthy is None or d.name in healthy]
        if not devices:
            raise RuntimeError("no healthy devices")
        seeds = self._greedy_seeds(cfg, workload, stages, devices)
        if not seeds:
            raise _Infeasible([f"no device subset fits "
                               f"{sum(s.param_bytes for s in stages)/1e9:.1f} GB"])
        temps = None
        if self.safety is not None and self.energy_model == "v2":
            temps = {n: tm.state.temp_c
                     for n, tm in self.safety.thermal.items()}
        sam = PGSAM(stages, devices, self.quant, workload,
                    config=self.config,
                    memory_headroom=self.constraints.memory_headroom,
                    energy_model=self.energy_model, temps=temps,
                    latency_budget_s=latency_budget(
                        self.constraints, stages, devices, self.quant),
                    provider=self.provider)
        result = sam.optimize(seeds)
        self.last_result = result
        return stages, devices, result

    def assign(self, cfg: ArchConfig, workload: Workload,
               healthy: Optional[Sequence[str]] = None) -> Assignment:
        try:
            stages, devices, result = self._anneal(cfg, workload, healthy)
        except _Infeasible as e:
            return Assignment({}, None, False, e.violations)
        best = result.best_energy
        mapping = {st.name: devices[di]
                   for st, di in zip(stages, best.mapping)}
        violations = constraint_violations(self.constraints,
                                           best.objectives[1], cfg, workload)
        notes = [f"pgsam: {result.iterations} iters, "
                 f"{result.accepted} accepted, "
                 f"archive {len(result.archive)}, "
                 f"hv {result.hypervolume:.3g}"]
        return Assignment(mapping, best.costs, not violations, violations,
                          notes)

    # ---------------------------------------------------- frontier caching
    def _frontier_key(self, cfg: ArchConfig, workload: Workload,
                      healthy: Optional[Sequence[str]]) -> tuple:
        # a (frozen, hashable) CalibrationProfile participates directly: a
        # refitted profile is a different key, so stale-calibration archives
        # are never served.
        profile = (self.provider.profile if self.provider is not None
                   else None)
        return (cfg.name, repr(cfg), workload,
                tuple(sorted(healthy)) if healthy is not None else None,
                self.quant, self.energy_model, self.health_epoch, profile)

    def invalidate_frontier(self) -> None:
        """Bump the device-health epoch and drop every cached archive. Called
        by the runtime control loop when signals drift (and usable directly
        after out-of-band device/thermal changes)."""
        self.health_epoch += 1
        self._frontier_cache.clear()

    def on_drift(self, event) -> None:
        """`repro_torch.core.safety.SafetyMonitor.subscribe` target: any drift
        event invalidates the cached frontier (the archive was annealed
        against the pre-drift temperatures / health set)."""
        self.invalidate_frontier()

    def _materialize(self, stages: List[Stage],
                     devices: List[DeviceProfile], result: PGSAMResult,
                     cfg: ArchConfig, workload: Workload) -> List[Assignment]:
        out = []
        for entry in result.archive:
            mapping = {st.name: devices[di]
                       for st, di in zip(stages, entry.mapping)}
            # the archive deliberately keeps SLA-violating points (they shape
            # the frontier); feasibility is re-judged per entry so callers
            # filtering on `a.feasible` never pick a violating plan.
            violations = constraint_violations(
                self.constraints, entry.objectives[1], cfg, workload)
            out.append(Assignment(mapping, entry.costs, not violations,
                                  violations,
                                  notes=[f"underutil "
                                         f"{entry.objectives[2]:.3f}"]))
        return out

    def pareto_frontier(self, cfg: ArchConfig, workload: Workload,
                        healthy: Optional[Sequence[str]] = None
                        ) -> List[Assignment]:
        """Full non-dominated archive of one anneal, as Assignments sorted by
        energy — the multi-objective counterpart of
        `ParetoOrchestrator.frontier` from a single optimization run.

        Memoized on (cfg, workload, healthy, health_epoch): repeated routing
        queries against an unchanged world reuse the archive instead of
        re-annealing; `invalidate_frontier` (or any drift event delivered to
        `on_drift`) forces the next call to anneal fresh."""
        key = self._frontier_key(cfg, workload, healthy)
        hit = self._frontier_cache.get(key)
        if hit is not None:
            return hit
        try:
            stages, devices, result = self._anneal(cfg, workload, healthy)
        except _Infeasible as e:
            return [Assignment({}, None, False, e.violations)]
        out = self._materialize(stages, devices, result, cfg, workload)
        self._frontier_cache[key] = out
        return out

    # ------------------------------------------------- online re-annealing
    def _patch_mapping(self, mapping: Dict[str, DeviceProfile],
                       stages: List[Stage], devices: List[DeviceProfile],
                       caps: List[float]) -> Optional[Mapping]:
        """Repair a warm-start mapping for the current device subset: stages
        stranded on excluded devices (failed / cooling) move to the fitting
        device with the cheapest per-stage energy. Returns None when the
        mapping cannot be made memory-feasible."""
        dev_idx = {d.name: i for i, d in enumerate(devices)}
        used = [0.0] * len(devices)
        out: List[int] = []
        for st in stages:
            dev = mapping.get(st.name)
            di = dev_idx.get(dev.name) if dev is not None else None
            if di is not None and used[di] + st.param_bytes <= caps[di]:
                used[di] += st.param_bytes
                out.append(di)
                continue
            cands = [(execute_stage(st, devices[j], self.quant).energy_j, j)
                     for j in range(len(devices))
                     if used[j] + st.param_bytes <= caps[j]]
            if not cands:
                return None
            _, di = min(cands)
            used[di] += st.param_bytes
            out.append(di)
        return tuple(out)

    def reanneal(self, cfg: ArchConfig, workload: Workload,
                 warm_starts: Sequence[Dict[str, DeviceProfile]],
                 healthy: Optional[Sequence[str]] = None,
                 iters_max: Optional[int] = None) -> Assignment:
        """Bounded online re-anneal, warm-started from previously-annealed
        mappings (the current assignment plus the archive) instead of greedy
        seeds — the control loop's fast path after a drift event.

        Mappings that reference excluded devices are repaired stage-by-stage;
        ``iters_max`` bounds the walk (default: the configured budget). The
        refreshed archive replaces the cached frontier for this (cfg,
        workload, healthy) at the *current* epoch, so routers pick it up
        without a second anneal."""
        stages = decompose(cfg, workload)
        devices = [d for d in self.devices
                   if healthy is None or d.name in healthy]
        if not devices:
            raise RuntimeError("no healthy devices")
        caps = [d.mem_cap * self.constraints.memory_headroom for d in devices]
        seeds = []
        for m in warm_starts:
            s = self._patch_mapping(m, stages, devices, caps)
            if s is not None:
                seeds.append(s)
        seeds = list(dict.fromkeys(seeds))
        if not seeds:
            # nothing survives the device change: fall back to greedy seeding
            return self.assign(cfg, workload, healthy=healthy)
        cfg_sam = self.config if iters_max is None else \
            replace(self.config, iters_max=iters_max)
        temps = None
        if self.safety is not None and self.energy_model == "v2":
            temps = {n: tm.state.temp_c
                     for n, tm in self.safety.thermal.items()}
        sam = PGSAM(stages, devices, self.quant, workload,
                    config=cfg_sam,
                    memory_headroom=self.constraints.memory_headroom,
                    energy_model=self.energy_model, temps=temps,
                    latency_budget_s=latency_budget(
                        self.constraints, stages, devices, self.quant),
                    provider=self.provider)
        result = sam.optimize(seeds)
        self.last_result = result
        # the world changed enough to warrant a re-anneal, so any archive a
        # router pulled earlier is stale: bump the epoch first, then publish
        # the refreshed archive at the new epoch (routers key on the epoch,
        # not on cache object identity)
        self.invalidate_frontier()
        key = self._frontier_key(cfg, workload, healthy)
        self._frontier_cache[key] = self._materialize(
            stages, devices, result, cfg, workload)
        best = result.best_energy
        mapping = {st.name: devices[di]
                   for st, di in zip(stages, best.mapping)}
        violations = constraint_violations(self.constraints,
                                           best.objectives[1], cfg, workload)
        notes = [f"reanneal: {result.iterations} iters, "
                 f"{len(seeds)} warm seeds, archive {len(result.archive)}"]
        return Assignment(mapping, best.costs, not violations, violations,
                          notes)

    def reassign_on_failure(self, cfg: ArchConfig, workload: Workload,
                            failed: Sequence[str]) -> Assignment:
        healthy = [d.name for d in self.devices if d.name not in failed]
        return self.assign(cfg, workload, healthy=healthy)


class _Infeasible(Exception):
    def __init__(self, violations: List[str]):
        super().__init__("; ".join(violations))
        self.violations = violations
