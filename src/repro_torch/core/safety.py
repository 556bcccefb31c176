"""Safety-first reliability framework (paper Section 3.4, Principles 6.1-6.3).

Hardware adaptation note (DESIGN.md §2): the paper reads temperatures from
nvidia-smi / MSR / ACPI; with no physical sensors here, device temperature
follows a first-order RC thermal model driven by the modeled power draw:

    dT/dt = (P * R_th - (T - T_ambient)) / tau_th

which reproduces the qualitative behavior the paper exploits (sustained load
heats toward T_amb + P*R_th; backing off cools exponentially). All safety logic
— the theta=0.85 proactive throttle, health states, failure detection/recovery,
input validation and output sanity checking — follows the paper exactly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.devices import DeviceProfile

THETA_THROTTLE = 0.85       # Principle 6.1
RECOVERY_BUDGET_S = 0.100   # Principle 6.2: redistribute within 100 ms
REINTRODUCE_CAPACITY = 0.5  # recovered devices restart at 50%


class Health(Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    FAILED = "failed"


# =========================================================== thermal (P. 6.1)

@dataclass
class ThermalState:
    temp_c: float
    throttle: float = 1.0     # workload multiplier in (0, 1]
    events: int = 0           # hardware-throttle events (what we must avoid)


class ThermalModel:
    """First-order RC model + the paper's proactive throttling rule."""

    def __init__(self, device: DeviceProfile):
        self.device = device
        self.state = ThermalState(temp_c=device.t_ambient)

    def step(self, power_w: float, dt_s: float) -> ThermalState:
        d = self.device
        t_inf = d.t_ambient + power_w * d.thermal_r
        decay = math.exp(-dt_s / d.thermal_tau)
        self.state.temp_c = t_inf + (self.state.temp_c - t_inf) * decay
        limit = THETA_THROTTLE * d.t_max
        if self.state.temp_c > d.t_max:
            # hardware throttling would fire here — this is the failure mode
            self.state.events += 1
        if self.state.temp_c > limit:
            # Eq. 8 proactive reduction: linear between theta*Tmax and Tmax
            frac = (self.state.temp_c - limit) / (d.t_max - limit)
            self.state.throttle = max(0.05, 1.0 - frac)
        else:
            self.state.throttle = 1.0
        return self.state


# ==================================================== drift events (runtime)

@dataclass(frozen=True)
class DriftEvent:
    """A signal-drift notification: the world the current plan was annealed
    for no longer matches reality. Consumed by `repro_torch.qeil2.runtime`'s
    control loop (re-anneal) and by `PGSAMOrchestrator.on_drift` (frontier
    cache invalidation); emitted by `SafetyMonitor`.

    kinds:
      * ``thermal_margin``   — junction temp crossed theta*T_max (rising
        edge): Phi has decayed below the proactive-throttle yield.
      * ``device_failed``    — health monitor marked the device FAILED.
      * ``device_recovered`` — device reintroduced at reduced capacity.
      * ``cpq_saturation``   — resident working set approaching the
        allocator headroom (emitted by the control loop, not the monitor).
      * ``kv_squeeze``       — KV blocks withheld from serving admission
        (value = block count; 0 releases). Emitted by the fault-injection
        harness (`repro_torch.serving.chaos`), consumed by the scheduler.
      * ``slow_kernel``      — service-time inflation factor (value >= 1;
        1 restores nominal). Same emitter/consumer as ``kv_squeeze``.
    """
    t_s: float
    device: str
    kind: str
    value: float = 0.0          # temp degC / capacity fraction, kind-specific
    detail: str = ""


# ====================================================== fault tolerance (6.2)

@dataclass
class FaultEvent:
    t_s: float
    device: str
    kind: str                  # fail | recover


@dataclass
class RecoveryRecord:
    device: str
    detected_at_s: float
    redistributed_at_s: float
    queries_lost: int
    throughput_factor: float   # remaining / original capacity

    @property
    def recovery_ms(self) -> float:
        return (self.redistributed_at_s - self.detected_at_s) * 1e3


class HealthMonitor:
    """Tracks health state per device from timeouts / error rates / heartbeats
    (Principle 6.2's three detectors) and drives recovery."""

    def __init__(self, devices: Sequence[DeviceProfile],
                 timeout_factor: float = 10.0,
                 error_rate_limit: float = 0.01,
                 window: int = 100):
        self.devices = {d.name: d for d in devices}
        self.health: Dict[str, Health] = {d.name: Health.HEALTHY
                                          for d in devices}
        self.capacity: Dict[str, float] = {d.name: 1.0 for d in devices}
        self.timeout_factor = timeout_factor
        self.error_rate_limit = error_rate_limit
        self._errors: Dict[str, List[bool]] = {d.name: [] for d in devices}
        self.window = window
        self.records: List[RecoveryRecord] = []
        # optional (device, kind) callback — SafetyMonitor wires this to its
        # drift-event bus so orchestrators learn about failures/recoveries.
        self.on_event: Optional[Callable[[str, str], None]] = None

    def healthy_devices(self) -> List[str]:
        return [n for n, h in self.health.items() if h != Health.FAILED]

    # --- detectors
    def observe_latency(self, device: str, observed_s: float,
                        expected_s: float) -> bool:
        if observed_s > self.timeout_factor * expected_s:
            self._fail(device, 0.0)
            return True
        return False

    def observe_kernel(self, device: str, ok: bool) -> bool:
        errs = self._errors[device]
        errs.append(not ok)
        if len(errs) > self.window:
            errs.pop(0)
        if len(errs) >= 10 and np.mean(errs) > self.error_rate_limit:
            self.health[device] = Health.DEGRADED
            return True
        return False

    def heartbeat_missed(self, device: str, now_s: float) -> None:
        self._fail(device, now_s)

    # --- recovery protocol
    def _fail(self, device: str, now_s: float) -> None:
        if self.health[device] == Health.FAILED:
            return
        self.health[device] = Health.FAILED
        self.capacity[device] = 0.0
        if self.on_event is not None:
            self.on_event(device, "device_failed")

    def fail_device(self, device: str, now_s: float,
                    inflight_queries: int = 0,
                    redistribution_latency_s: float = 0.05) -> RecoveryRecord:
        """Inject a failure; redistribution is bounded by the 100 ms budget
        and in-flight queries requeue onto healthy devices (zero loss)."""
        self._fail(device, now_s)
        redis_at = now_s + min(redistribution_latency_s, RECOVERY_BUDGET_S)
        healthy = self.healthy_devices()
        total = sum(self.devices[n].peak_flops for n in self.devices)
        remaining = sum(self.devices[n].peak_flops for n in healthy)
        rec = RecoveryRecord(device=device, detected_at_s=now_s,
                             redistributed_at_s=redis_at,
                             queries_lost=0 if healthy else inflight_queries,
                             throughput_factor=remaining / total if total else 0)
        self.records.append(rec)
        return rec

    def recover_device(self, device: str) -> None:
        """Driver reset + memory clear, reintroduce at 50% capacity."""
        self.health[device] = Health.DEGRADED
        self.capacity[device] = REINTRODUCE_CAPACITY
        if self.on_event is not None:
            self.on_event(device, "device_recovered")

    def promote_if_stable(self, device: str, clean_inferences: int) -> None:
        if clean_inferences >= self.window and \
                self.health[device] == Health.DEGRADED:
            self.health[device] = Health.HEALTHY
            self.capacity[device] = 1.0

    def degraded_latency_bound(self, optimal_s: float) -> float:
        """Formal guarantee: tau_degraded <= tau_optimal * D / D_healthy."""
        d_total = len(self.devices)
        d_healthy = len(self.healthy_devices())
        if d_healthy == 0:
            return float("inf")
        return optimal_s * d_total / d_healthy


# ============================================== adversarial robustness (6.3)

@dataclass
class ValidationResult:
    ok: bool
    reason: str = ""


class InputValidator:
    """Defense-in-depth input validation (Principle 6.3)."""

    def __init__(self, max_seq_len: int, vocab_size: int,
                 max_requests_per_s: float = 100.0):
        self.max_seq_len = max_seq_len
        self.vocab_size = vocab_size
        self.max_rps = max_requests_per_s
        self._bucket = max_requests_per_s   # token bucket for rate limiting
        self._last_t = 0.0

    def validate(self, tokens: np.ndarray, now_s: float = 0.0
                 ) -> ValidationResult:
        # rate limiting
        self._bucket = min(self.max_rps,
                           self._bucket + (now_s - self._last_t) * self.max_rps)
        self._last_t = now_s
        if self._bucket < 1.0:
            return ValidationResult(False, "rate-limited")
        self._bucket -= 1.0
        # structural checks
        if tokens.ndim != 1 or tokens.size == 0:
            return ValidationResult(False, "malformed input")
        if tokens.size > self.max_seq_len:
            return ValidationResult(
                False, f"oversized input {tokens.size} > {self.max_seq_len}")
        if tokens.min() < 0 or tokens.max() >= self.vocab_size:
            return ValidationResult(False, "token ids out of range "
                                           "(malformed encoding)")
        return ValidationResult(True)


class OutputSanitizer:
    """Output sanity checking: length cap, repetition halt, logit anomalies."""

    def __init__(self, expected_len: int, repetition_window: int = 100,
                 repetition_limit: float = 0.9):
        self.max_len = 2 * expected_len
        self.rep_window = repetition_window
        self.rep_limit = repetition_limit

    def check(self, tokens: np.ndarray,
              logit_entropy: Optional[float] = None) -> ValidationResult:
        if tokens.size > self.max_len:
            return ValidationResult(False, "generation length cap")
        w = tokens[-self.rep_window:]
        if w.size >= 20:
            _, counts = np.unique(w, return_counts=True)
            if counts.max() / w.size > self.rep_limit:
                return ValidationResult(False, "repetition halt")
        if logit_entropy is not None and logit_entropy < 1e-3:
            return ValidationResult(False, "confidence anomaly")
        return ValidationResult(True)


# =================================================== unified safety monitor

class SafetyMonitor:
    """The component with override authority over the optimizer (Section 3.2).

    Wires thermal models, health monitoring and validation together; the
    orchestrator consults `throttle_factors()` before costing assignments and
    must re-assign when `on_failure` fires.
    """

    def __init__(self, devices: Sequence[DeviceProfile],
                 max_seq_len: int = 32768, vocab_size: int = 2 ** 17):
        self.devices = list(devices)
        self.thermal = {d.name: ThermalModel(d) for d in devices}
        self.health = HealthMonitor(devices)
        self.validator = InputValidator(max_seq_len, vocab_size)
        self.resource_time_factor = 5.0     # tau_max = 5x expected
        self.resource_mem_factor = 1.5      # M_max = 1.5x expected
        # --- drift-event bus: subscribers get every DriftEvent ---
        self._subscribers: List[Callable[[DriftEvent], None]] = []
        self._above_margin: Dict[str, bool] = {d.name: False for d in devices}
        self.clock_s = 0.0                  # advanced by thermal_step
        self.health.on_event = lambda dev, kind: self.emit(
            DriftEvent(self.clock_s, dev, kind))

    def subscribe(self, fn: Callable[[DriftEvent], None]) -> None:
        """Register a drift-event consumer (e.g. the runtime control loop or
        `PGSAMOrchestrator.on_drift`)."""
        self._subscribers.append(fn)

    def emit(self, event: DriftEvent) -> None:
        for fn in self._subscribers:
            fn(event)

    def thermal_step(self, powers: Dict[str, float], dt_s: float
                     ) -> Dict[str, float]:
        """Advance every RC thermal model; emits a ``thermal_margin``
        DriftEvent on the rising edge of T crossing theta*T_max (the same
        threshold that arms the proactive throttle — equivalently, Phi
        dropping below its proactive-yield floor)."""
        self.clock_s += dt_s
        out = {}
        for name, tm in self.thermal.items():
            st = tm.step(powers.get(name, 0.0), dt_s)
            out[name] = st.throttle
            above = st.temp_c > THETA_THROTTLE * tm.device.t_max
            if above and not self._above_margin[name]:
                self.emit(DriftEvent(self.clock_s, name, "thermal_margin",
                                     value=st.temp_c,
                                     detail=f"T {st.temp_c:.1f} degC > "
                                            f"{THETA_THROTTLE:.2f} * "
                                            f"{tm.device.t_max:.0f}"))
            self._above_margin[name] = above
        return out

    def throttle_factors(self) -> Dict[str, float]:
        return {n: tm.state.throttle for n, tm in self.thermal.items()}

    def total_throttle_events(self) -> int:
        return sum(tm.state.events for tm in self.thermal.values())

    def resource_bounds(self, expected_latency_s: float,
                        expected_mem: float) -> Tuple[float, float]:
        return (self.resource_time_factor * expected_latency_s,
                self.resource_mem_factor * expected_mem)
