"""Deterministic fault injection for the serving stack.

The paper's reliability claims (100% fault recovery, zero query loss, zero
thermal throttling) need faults that land on *live* requests, not just on
the planner. A `FaultPlan` is a seeded, JSON-serializable schedule of fault
actions on the simulated clock; a `ChaosDriver` replays it through the
REAL control surface — `HealthMonitor.fail_device` / `recover_device` and
`SafetyMonitor.emit` — so every injected fault reaches the scheduler and
control loop over the same `DriftEvent` bus production drift does. Nothing
here reaches into scheduler internals: if an event kind is unhandled in
`ContinuousBatchingScheduler.on_drift`, the chaos bench fails, which is
the point.

Action kinds (JSON ``kind`` field):

* ``device_fail``    — `HealthMonitor.fail_device(device)`: the monitor's
  ``on_event`` hook emits ``DriftEvent(kind="device_failed")``, which
  preempts and re-queues every in-flight batch routed onto the device.
* ``device_recover`` — `HealthMonitor.recover_device(device)`: device
  reintroduced (degraded), ``device_recovered`` restores routing.
* ``thermal_spike``  — emits ``thermal_margin`` (value = junction temp,
  degC): the control loop re-anneals, the scheduler re-pulls the frontier
  at the next batch boundary.
* ``kv_squeeze``     — emits ``kv_squeeze`` (value = blocks withheld): the
  scheduler subtracts the reserve from admission capacity, modeling a
  co-tenant stealing KV memory. value 0 releases the squeeze.
* ``slow_kernel``    — emits ``slow_kernel`` (value = service-time
  factor >= 1): batch makespans stretch by the factor, modeling thermal
  clamps / background contention. value 1 restores nominal speed.

Plan JSON schema::

    {"seed": 0, "actions": [
        {"t_s": 2.5, "kind": "device_fail", "device": "edge-npu"},
        {"t_s": 4.0, "kind": "device_recover", "device": "edge-npu"},
        {"t_s": 3.0, "kind": "thermal_spike", "device": "soc-gpu",
         "value": 96.0},
        {"t_s": 1.0, "kind": "kv_squeeze", "value": 48},
        {"t_s": 5.0, "kind": "slow_kernel", "value": 1.5}]}
"""
from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass, field
from typing import List, Optional, Sequence

from repro_torch.core.safety import DriftEvent

ACTION_KINDS = ("device_fail", "device_recover", "thermal_spike",
                "kv_squeeze", "slow_kernel")


@dataclass(frozen=True)
class FaultAction:
    """One scheduled fault on the simulated clock."""
    t_s: float
    kind: str
    device: str = ""
    value: float = 0.0
    detail: str = ""

    def __post_init__(self):
        if self.kind not in ACTION_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(supported: {ACTION_KINDS})")
        if self.kind in ("device_fail", "device_recover") and not self.device:
            raise ValueError(f"{self.kind} needs a device name")


@dataclass
class FaultPlan:
    """A deterministic fault schedule: actions sorted by injection time.

    ``seed`` names the plan (and seeds `FaultPlan.random`); two runs of the
    same plan against the same request stream see identical fault timing.
    """
    seed: int = 0
    actions: List[FaultAction] = field(default_factory=list)

    def __post_init__(self):
        self.actions = sorted(self.actions, key=lambda a: a.t_s)

    # ------------------------------------------------------------- (de)ser
    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "actions": [asdict(a) for a in self.actions]},
                          indent=2)

    @staticmethod
    def from_json(text: str) -> "FaultPlan":
        doc = json.loads(text)
        return FaultPlan(seed=int(doc.get("seed", 0)),
                         actions=[FaultAction(**a)
                                  for a in doc.get("actions", [])])

    @staticmethod
    def load(path: str) -> "FaultPlan":
        with open(path) as f:
            return FaultPlan.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    # ------------------------------------------------------------ generator
    @staticmethod
    def random(seed: int, devices: Sequence[str], horizon_s: float,
               n_failures: int = 1, n_spikes: int = 1,
               kv_squeeze_blocks: int = 0, slow_factor: float = 0.0,
               recover_after_s: float = 1.0) -> "FaultPlan":
        """Seeded plan generator: ``n_failures`` fail/recover pairs,
        ``n_spikes`` thermal spikes, plus an optional mid-run KV squeeze and
        kernel slowdown window, all inside ``[0.1, 0.9] * horizon_s``."""
        rng = random.Random(seed)
        actions: List[FaultAction] = []
        lo, hi = 0.1 * horizon_s, 0.9 * horizon_s
        for _ in range(n_failures):
            dev = rng.choice(list(devices))
            t = rng.uniform(lo, hi)
            actions.append(FaultAction(t, "device_fail", device=dev,
                                       detail="injected"))
            actions.append(FaultAction(t + recover_after_s, "device_recover",
                                       device=dev))
        for _ in range(n_spikes):
            dev = rng.choice(list(devices))
            actions.append(FaultAction(rng.uniform(lo, hi), "thermal_spike",
                                       device=dev,
                                       value=rng.uniform(90.0, 105.0)))
        if kv_squeeze_blocks > 0:
            t = rng.uniform(lo, hi)
            actions.append(FaultAction(t, "kv_squeeze",
                                       value=float(kv_squeeze_blocks)))
            actions.append(FaultAction(t + recover_after_s, "kv_squeeze",
                                       value=0.0))
        if slow_factor > 1.0:
            t = rng.uniform(lo, hi)
            actions.append(FaultAction(t, "slow_kernel", value=slow_factor))
            actions.append(FaultAction(t + recover_after_s, "slow_kernel",
                                       value=1.0))
        return FaultPlan(seed=seed, actions=actions)


class ChaosDriver:
    """Replays a `FaultPlan` through a `SafetyMonitor` as the simulated
    clock advances. Call ``apply_due(now_s)`` once per scheduler step (or
    arrival); every action with ``t_s <= now_s`` fires, in order, through
    the monitor's real event paths — consumers (scheduler ``on_drift``,
    `ControlLoop`) cannot tell injected faults from organic ones."""

    def __init__(self, plan: FaultPlan, safety):
        self.plan = plan
        self.safety = safety
        self._pending: List[FaultAction] = list(plan.actions)
        self.applied: List[FaultAction] = []

    @property
    def done(self) -> bool:
        return not self._pending

    def apply_due(self, now_s: float) -> List[FaultAction]:
        fired: List[FaultAction] = []
        while self._pending and self._pending[0].t_s <= now_s:
            a = self._pending.pop(0)
            self._apply(a)
            fired.append(a)
            self.applied.append(a)
        return fired

    def _apply(self, a: FaultAction) -> None:
        mon = self.safety
        # events carry the injection time: align the monitor's clock so
        # organic emissions that follow do not time-travel backwards
        mon.clock_s = max(mon.clock_s, a.t_s)
        if a.kind == "device_fail":
            mon.health.fail_device(a.device, a.t_s)
        elif a.kind == "device_recover":
            mon.health.recover_device(a.device)
        elif a.kind == "thermal_spike":
            mon.emit(DriftEvent(a.t_s, a.device, "thermal_margin",
                                value=a.value,
                                detail=a.detail or "injected spike"))
        elif a.kind == "kv_squeeze":
            mon.emit(DriftEvent(a.t_s, a.device, "kv_squeeze",
                                value=a.value,
                                detail=a.detail or "injected squeeze"))
        elif a.kind == "slow_kernel":
            mon.emit(DriftEvent(a.t_s, a.device, "slow_kernel",
                                value=a.value,
                                detail=a.detail or "injected slowdown"))


def attach(plan: FaultPlan, safety, scheduler) -> ChaosDriver:
    """Wire a plan into a live scheduler: subscribes the scheduler's
    ``on_drift`` to the monitor's event bus (idempotence is the caller's
    concern) and returns the driver to pump from the arrival loop."""
    safety.subscribe(scheduler.on_drift)
    return ChaosDriver(plan, safety)
