"""Closed orchestrate -> execute -> heat -> re-orchestrate loop.

PR 1's `PGSAMOrchestrator(..., safety=...)` reads the RC thermal state once
per `assign`; the paper's headline numbers (zero hardware-throttle events at
a 75.6% energy reduction) come from placement that *keeps adapting* as the
device signals drift under sustained load. This loop closes it:

  1. **orchestrate** — an assignment from the PGSAM archive (first step), or
     a bounded warm-start re-anneal after drift.
  2. **execute** — the plan runs for one step: per-device power is the
     plan's per-device dynamic energy spread over its makespan, scaled by
     the offered load, plus the idle floor (exogenous heat — co-located
     processes, enclosure ramps — enters via ``extra_power``).
  3. **heat** — `SafetyMonitor.thermal_step` evolves every RC thermal model
     and emits `DriftEvent`s on margin crossings; the health monitor emits
     on failures/recoveries.
  4. **re-orchestrate** — drift (Phi through the proactive-throttle yield,
     a failed or recovered device, CPQ saturation) triggers a *bounded*
     re-anneal warm-started from the current archive (never from greedy
     seeds), with the frontier cache invalidated so routers re-pull.

Devices that crossed the thermal margin are excluded from placement until
they cool below the hysteresis threshold — this, not reactive throttling, is
what keeps hardware-throttle events at zero while a statically-placed
baseline rides through the margin into the throttle ceiling
(`benchmarks/pareto_router.py` measures exactly that).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.core.decomposition import Workload, decompose
from repro_torch.core.orchestrator import Assignment
from repro_torch.core.safety import THETA_THROTTLE, DriftEvent, SafetyMonitor
from repro_torch.models.config import ArchConfig


@dataclass(frozen=True)
class LoopConfig:
    dt_s: float = 2.0
    # bounded re-anneal budget per drift event (warm starts converge fast;
    # with PGSAMConfig.incremental this is ~O(iters) accumulator updates)
    reanneal_iters: int = 400
    # resident/capacity fraction that counts as CPQ saturation drift
    cpq_saturation: float = 0.95
    # excluded-for-cooling devices rejoin below this fraction of the margin
    cool_frac: float = 0.90
    # False = measurement baseline: same telemetry, no re-orchestration
    adaptive: bool = True


@dataclass
class StepReport:
    t_s: float
    load: float
    temps: Dict[str, float]
    powers: Dict[str, float]          # what our plan drew (exogenous excluded)
    drift: List[DriftEvent]
    reannealed: bool
    served: bool                      # False: plan referenced a dead device
    inferences: float
    energy_j: float
    throttle_events: int              # cumulative hardware events (safety)
    excluded: List[str] = field(default_factory=list)


class ControlLoop:
    """Drives one (cfg, workload) serving deployment against a SafetyMonitor.

    ``orchestrator`` is any engine with the GreedyOrchestrator ``assign``
    API; the re-anneal fast path and frontier bookkeeping light up when it
    also exposes `PGSAMOrchestrator`'s ``reanneal`` / ``pareto_frontier``.
    An attached `ParetoRouter` (``router=``) is kept in sync with the
    healthy-device set so tier routing follows the loop's world view; an
    attached `repro_torch.serving.ContinuousBatchingScheduler` (``scheduler=``)
    is notified after every drift-triggered re-anneal so the new frontier
    takes effect at the next batch *boundary* — in-flight batches finish on
    the operating point they were priced against.
    """

    def __init__(self, orchestrator, safety: SafetyMonitor, cfg: ArchConfig,
                 workload: Workload, loop: LoopConfig = LoopConfig(),
                 router=None, trace=None, scheduler=None, obs=None):
        self.orch = orchestrator
        self.safety = safety
        self.cfg = cfg
        self.workload = workload
        self.loop = loop
        self.router = router
        self.scheduler = scheduler
        # optional repro_torch.qeil2.telemetry.TraceStore: every step emits one
        # execution record (temps/powers/energy + per-stage SignalSet
        # snapshots when the plan was v2-costed) — the runtime's side of the
        # measurement loop the calibration fitter closes.
        self.trace = trace
        # optional repro_torch.obs bundle: live drift/re-anneal counters and
        # temperature/power gauges for the metrics endpoint (`launch/serve
        # --metrics-out`); the trace store above stays the replayable record
        self._m = None
        if obs is not None and obs.metrics.enabled:
            reg = obs.metrics
            self._m = {
                "drift": reg.counter(
                    "control_drift_events_total",
                    "Drift events seen by the control loop, by kind",
                    labelnames=("kind",)),
                "reanneal": reg.counter(
                    "control_reanneals_total",
                    "Drift-triggered re-anneals executed"),
                "energy": reg.counter(
                    "control_energy_j_total",
                    "Energy integrated over control-loop steps"),
                "throttle": reg.gauge(
                    "control_throttle_events",
                    "Cumulative hardware throttle events (safety monitor)"),
                "temp": reg.gauge(
                    "control_device_temp_c",
                    "Junction temperature per device",
                    labelnames=("device",)),
            }
        self.assignment: Optional[Assignment] = None
        self._archive: List[Assignment] = []
        self.t_s = 0.0
        self.reanneals = 0
        self.reanneal_wall_s = 0.0
        self._pending: List[DriftEvent] = []
        self._excluded: Set[str] = set()       # cooling, placement-excluded
        self._cpq_flagged: Set[str] = set()    # one saturation event per plan
        self._stage_bytes = [(st.name, st.param_bytes)
                             for st in decompose(cfg, workload)]
        safety.subscribe(self._on_drift)
        if hasattr(orchestrator, "on_drift"):
            safety.subscribe(orchestrator.on_drift)
        # the scheduler consumes the raw event stream too: a device failure
        # must preempt its in-flight batches NOW (the re-anneal below only
        # redirects future formations), and the chaos-harness kinds
        # (kv_squeeze / slow_kernel) adjust its admission/pricing state
        if scheduler is not None and hasattr(scheduler, "on_drift"):
            safety.subscribe(scheduler.on_drift)

    # ------------------------------------------------------------ plumbing
    def _on_drift(self, event: DriftEvent) -> None:
        self._pending.append(event)

    def allowed_devices(self) -> List[str]:
        """Health-monitor-healthy minus thermally-cooling devices."""
        healthy = set(self.safety.health.healthy_devices())
        out = [d.name for d in self.orch.devices
               if d.name in healthy and d.name not in self._excluded]
        return out or [d.name for d in self.orch.devices
                       if d.name in healthy]   # never exclude everything

    def _sync_router(self) -> None:
        if self.router is not None:
            self.router.set_healthy(self.allowed_devices())

    def _notify_scheduler(self, warm: bool) -> None:
        # drift re-anneal boundary: the router's healthy set / epoch moved,
        # so the scheduler's next *formed* batch re-routes on the post-drift
        # frontier (routing only ever happens at batch formation)
        if warm and self.scheduler is not None:
            self.scheduler.on_reorchestrate(healthy=self.allowed_devices())

    def _orchestrate(self, warm: bool) -> None:
        allowed = self.allowed_devices()
        t0 = time.perf_counter()
        if warm and hasattr(self.orch, "reanneal") and \
                self.assignment is not None and self.assignment.mapping:
            # drift path: bounded re-anneal warm-started from the current
            # plan + archive (never greedy seeds); refreshes the frontier
            # cache at the post-drift epoch as a side effect.
            warm_starts = [self.assignment.mapping] + \
                [a.mapping for a in self._archive if a.mapping]
            self.assignment = self.orch.reanneal(
                self.cfg, self.workload, warm_starts, healthy=allowed,
                iters_max=self.loop.reanneal_iters)
            self.reanneals += 1
            self._archive = self.orch.pareto_frontier(
                self.cfg, self.workload, healthy=allowed)   # cache hit
        elif hasattr(self.orch, "pareto_frontier"):
            # cold start: one anneal builds the archive; serve from its
            # cheapest feasible point (best-effort cheapest if none is)
            self._archive = self.orch.pareto_frontier(
                self.cfg, self.workload, healthy=allowed)
            placed = [a for a in self._archive if a.mapping]
            pool = [a for a in placed if a.feasible] or placed
            self.assignment = (min(pool, key=lambda a: a.energy_j) if pool
                               else self.orch.assign(self.cfg, self.workload,
                                                     healthy=allowed))
        else:
            self.assignment = self.orch.assign(self.cfg, self.workload,
                                               healthy=allowed)
            self._archive = [self.assignment]
        self.reanneal_wall_s += time.perf_counter() - t0
        self._sync_router()
        self._notify_scheduler(warm)

    # ------------------------------------------------------------- physics
    def _hw_speed(self) -> float:
        """Hardware-throttle slowdown: any plan device at/over T_max is
        force-clocked to half speed by firmware (the failure mode the paper
        measures in Table 10 — the closed loop exists to never hit it). The
        pipeline runs at its slowest stage's speed."""
        a = self.assignment
        if a is None or not a.mapping:
            return 1.0
        speed = 1.0
        for name in {d.name for d in a.mapping.values()}:
            tm = self.safety.thermal.get(name)
            if tm is not None and tm.state.temp_c > tm.device.t_max:
                speed = min(speed, 0.5)
        return speed

    def _plan_powers(self, load: float, speed: float = 1.0
                     ) -> Dict[str, float]:
        """Average per-device power of executing the plan at the offered
        load: dynamic energy over makespan (scaled by the hardware-throttle
        speed — a half-clocked pipeline draws half the dynamic power), plus
        the idle floor for every device the plan occupies. Devices the plan
        does not touch are put in their low-power sleep state (modeled as
        ~0 W): the runtime owns placement, so it also owns power-gating what
        placement freed up."""
        powers: Dict[str, float] = {}
        failed = {n for n in self.safety.health.health
                  if n not in self.safety.health.healthy_devices()}
        a = self.assignment
        in_plan = ({d.name for d in a.mapping.values()}
                   if a is not None and a.mapping else set())
        alive = set()
        for dev in self.orch.devices:
            on = dev.name in in_plan and dev.name not in failed
            if on:
                alive.add(dev.name)
            powers[dev.name] = dev.power_idle if on else 0.0
        if a is not None and a.costs is not None:
            mk = max(a.costs.makespan_s, 1e-12)
            for name, e_j in a.costs.per_device_energy().items():
                if name in alive:
                    powers[name] += e_j / mk * load * speed
        return powers

    def _check_cpq(self) -> None:
        """CPQ saturation drift: the plan's resident set is approaching the
        allocator headroom on some device (emitted once per plan per
        device)."""
        a = self.assignment
        if a is None or not a.mapping:
            return
        headroom = getattr(getattr(self.orch, "constraints", None),
                           "memory_headroom", 0.9)
        resident: Dict[str, float] = {}
        for st_name, pb in self._stage_bytes:
            dev = a.mapping.get(st_name)
            if dev is not None:
                resident[dev.name] = resident.get(dev.name, 0.0) + pb
        for dev in self.orch.devices:
            cap = dev.mem_cap * headroom
            frac = resident.get(dev.name, 0.0) / cap if cap > 0 else 0.0
            if frac < self.loop.cpq_saturation:
                # falling edge re-arms the detector; while saturation
                # persists (a re-anneal may not be able to relieve it) the
                # flag holds, so one episode emits one event instead of
                # re-annealing every step forever.
                self._cpq_flagged.discard(dev.name)
            elif dev.name not in self._cpq_flagged:
                self._cpq_flagged.add(dev.name)
                self.safety.emit(DriftEvent(
                    self.t_s, dev.name, "cpq_saturation", value=frac,
                    detail=f"resident {frac:.2f} of headroom"))

    def _update_exclusions(self, new_events: List[DriftEvent]) -> None:
        for ev in new_events:
            if ev.kind == "thermal_margin":
                self._excluded.add(ev.device)
        for name in sorted(self._excluded):
            tm = self.safety.thermal[name]
            cool_at = (self.loop.cool_frac * THETA_THROTTLE *
                       tm.device.t_max)
            if tm.state.temp_c < cool_at:
                self._excluded.discard(name)
                self.safety.emit(DriftEvent(
                    self.t_s, name, "device_cooled", value=tm.state.temp_c,
                    detail="rejoining placement pool"))

    # ----------------------------------------------------------------- step
    def step(self, load: float = 1.0,
             extra_power: Optional[Dict[str, float]] = None) -> StepReport:
        """One control period: execute the current plan for ``dt_s`` under
        ``load`` (a throughput multiplier), heat the RC models (plus any
        exogenous ``extra_power``), then re-orchestrate if signals drifted.
        """
        dt = self.loop.dt_s
        self.t_s += dt
        if self.assignment is None:
            self._orchestrate(warm=False)
        executed = self.assignment        # the plan this step actually ran

        # execute: our plan's draw; exogenous watts only heat, never bill
        speed = self._hw_speed()
        powers = self._plan_powers(load, speed)
        thermal_in = dict(powers)
        for name, w in (extra_power or {}).items():
            thermal_in[name] = thermal_in.get(name, 0.0) + w

        # heat: may emit thermal_margin / failure events into _pending
        n_before = len(self._pending)
        self.safety.thermal_step(thermal_in, dt)
        self._check_cpq()
        if self.loop.adaptive:
            self._update_exclusions(self._pending[n_before:])

        # accounting against the *executed* plan (a re-anneal below takes
        # effect next step; crediting its throughput or billing its power
        # for a period it never ran would skew the policy comparison)
        failed = {n for n, h in self.safety.health.health.items()
                  if n not in self.safety.health.healthy_devices()}
        served = bool(executed and executed.mapping) and not any(
            d.name in failed for d in executed.mapping.values())
        inferences = 0.0
        if served and executed.costs is not None:
            inferences = speed * load * dt / \
                max(executed.costs.makespan_s, 1e-12) * self.workload.batch
        energy = sum(powers.values()) * dt

        # re-orchestrate on drift
        reannealed = False
        drift = list(self._pending)
        self._pending.clear()
        if drift and self.loop.adaptive:
            self._orchestrate(warm=True)
            reannealed = True
        report = StepReport(
            t_s=self.t_s, load=load,
            temps={n: tm.state.temp_c
                   for n, tm in self.safety.thermal.items()},
            powers=powers, drift=drift, reannealed=reannealed,
            served=served, inferences=inferences, energy_j=energy,
            throttle_events=self.safety.total_throttle_events(),
            excluded=sorted(self._excluded))
        if self.trace is not None:
            self.trace.ingest_step(report, signals=self._plan_signals(executed))
        if self._m is not None:
            for ev in drift:
                self._m["drift"].inc(kind=ev.kind)
            if reannealed:
                self._m["reanneal"].inc()
            self._m["energy"].inc(report.energy_j)
            self._m["throttle"].set(report.throttle_events)
            for name, t in report.temps.items():
                self._m["temp"].set(t, device=name)
        return report

    def _plan_signals(self, assignment) -> Dict[str, dict]:
        """Per-stage `SignalSet.as_dict()` snapshots of the executed plan —
        present when the orchestrator costs plans with the v2 model (its
        `StageExecutionV2` records carry the signal triple)."""
        out: Dict[str, dict] = {}
        if assignment is not None and assignment.costs is not None:
            for e in assignment.costs.executions:
                sig = getattr(e, "signals", None)
                if sig is not None:
                    out[e.stage.name] = sig.as_dict()
        return out
