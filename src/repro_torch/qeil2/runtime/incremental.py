"""Incremental (delta-cost) plan evaluation for PGSAM re-anneals.

`repro_torch.core.energy.plan_costs` re-executes every stage on every call — O(S)
`execute_stage` evaluations per annealer candidate, which is what makes online
re-annealing (and 50+ device fleets) expensive: PGSAM proposes *single-stage
moves*, so S-1 of those evaluations recompute numbers that did not change.

`DeltaEvaluator` maintains the cost decomposition as per-device accumulators
that a single-stage move updates in O(1) (stage-count-independent; the final
aggregation is O(D) over devices, never O(S) over stages):

* **busy time** — `sum t_stage` per device; makespan is the max over occupied
  devices plus transfer time.
* **raw energy** — `sum t * p_base * f(Q)` per device, where `p_base` is the
  part of dynamic power that depends only on (stage, device, throttle). The
  device-level factors that *couple* stages sharing a device — the CPQ
  memory-pressure tax (a function of the device's total resident bytes) and
  the Phi leakage divisor (a function of its junction temperature) — multiply
  the accumulator at aggregation time, so moving a stage re-prices every
  stage on the two affected devices without touching them individually.
* **resident bytes** — `sum param_bytes` per device, driving CPQ.
* **transfer bytes** — the phase chains (stages of one phase ordered by
  layer) are fixed by the workload; a move flips at most the two boundaries
  adjacent to the moved stage.

Per-(stage, device) roofline times and base powers are cached on first use
(`signal cache`), so a long anneal converges to pure accumulator arithmetic.

Parity contract: objectives match the full `plan_costs(..., model=...)` path
to ~1e-9 relative (float associativity is the only difference), for both the
v1 and v2 energy models — enforced by `tests/test_incremental.py`.

Moves are applied speculatively: `apply` returns an undo token holding the
*exact prior values* of every touched accumulator, and `revert` restores them
bit-for-bit (no `+= x; -= x` float drift), so a rejected proposal leaves the
evaluator in the identical state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.decomposition import Stage, Workload
from repro_torch.core.devices import DeviceProfile
from repro_torch.core.energy import TRANSFER_ENERGY_PER_BYTE, execute_stage
from repro_torch.qeil2.energy_v2 import execute_stage_v2
from repro_torch.qeil2.signals import cpq, cpq_power_factor, phi

Objectives = Tuple[float, float, float]     # energy_j, makespan_s, underutil


@dataclass
class UndoToken:
    """Exact prior state of everything one move touched."""
    stage: int
    old_dev: int
    new_dev: int
    busy: Tuple[float, float]
    raw: Tuple[float, float]
    resident: Tuple[float, float]
    count: Tuple[int, int]
    transfer_bytes: float


class DeltaEvaluator:
    """O(1)-per-move incremental counterpart of ``plan_costs``.

    ``mapping`` is the stage->device-index tuple PGSAM anneals over; the
    evaluator mirrors it and must be kept in sync via ``apply``/``revert``.
    """

    def __init__(self, stages: Sequence[Stage],
                 devices: Sequence[DeviceProfile],
                 mapping: Sequence[int],
                 quant: str = "bf16",
                 workload: Optional[Workload] = None,
                 model: str = "v2",
                 temps: Optional[Dict[str, float]] = None,
                 headroom: float = 0.9,
                 throttle: Optional[Dict[str, float]] = None,
                 provider=None):
        if model not in ("v1", "v2"):
            raise ValueError(f"unknown energy model {model!r}")
        if provider is not None and model != "v2":
            raise ValueError("a CalibratedSignalProvider requires "
                             "model='v2'")
        self.stages = list(stages)
        self.devices = list(devices)
        self.quant = quant
        self.workload = workload
        self.model = model
        self.headroom = headroom
        self.provider = provider
        temps = temps or {}
        throttle = throttle or {}
        self._throttle = [throttle.get(d.name, 1.0) for d in self.devices]
        # Phi is fixed per anneal (temperatures evolve between re-anneals, not
        # inside one), so the leakage divisor is a per-device constant here —
        # from the calibrated provider when one is installed.
        phi_fn = phi if provider is None else provider.phi
        self._phi = [phi_fn(temps.get(d.name, d.t_ambient))
                     for d in self.devices]

        # --- phase chains + per-boundary costs (device-independent) ---------
        # boundary_transfer_bytes sorts each phase's stages by layer; the
        # boundary cost depends only on the *earlier* stage and the workload.
        by_phase: Dict[str, List[int]] = {}
        for si, st in enumerate(self.stages):
            by_phase.setdefault(st.phase, []).append(si)
        self._prev: List[Optional[int]] = [None] * len(self.stages)
        self._next: List[Optional[int]] = [None] * len(self.stages)
        self._bcost: List[float] = [0.0] * len(self.stages)  # cost of (si, next)
        for phase, idxs in by_phase.items():
            idxs.sort(key=lambda i: self.stages[i].layer)
            for a, b in zip(idxs, idxs[1:]):
                self._prev[b] = a
                self._next[a] = b
                st_a = self.stages[a]
                if workload is not None:
                    n_tok = (workload.n_decode_tokens if phase == "decode"
                             else workload.n_prefill_tokens)
                    self._bcost[a] = (n_tok * workload.bytes_per_act *
                                      max(st_a.width, 1))
                else:
                    self._bcost[a] = st_a.bytes_moved * 0.01

        # --- lazily-filled (stage, device) cache: (time_s, raw_energy_j) ----
        self._sd_cache: Dict[Tuple[int, int], Tuple[float, float]] = {}

        self.rebuild(mapping)

    # ------------------------------------------------------------ primitives
    def _stage_on_device(self, si: int, di: int) -> Tuple[float, float]:
        """Roofline time + raw (device-factor-free) energy, cached.

        Delegates to the canonical energy laws so the physics lives in one
        place: v1 stage energy has no cross-stage coupling, so
        `execute_stage` is the raw energy outright; for v2,
        `execute_stage_v2` at zero residency / ambient temperature gives
        energy with CPQ factor 1 and the ambient Phi divided in — multiply
        that Phi back out to strip all device-level factors (the ~1-ulp
        round-trip is far inside the 1e-9 parity contract).
        """
        key = (si, di)
        hit = self._sd_cache.get(key)
        if hit is not None:
            return hit
        st, dev = self.stages[si], self.devices[di]
        thr = self._throttle[di]
        if self.model == "v2":
            ex = execute_stage_v2(st, dev, self.quant, throttle=thr,
                                  headroom=self.headroom,
                                  provider=self.provider)
            out = (ex.time_s, ex.energy_j * ex.signals.phi)
        else:
            ex = execute_stage(st, dev, self.quant, throttle=thr)
            out = (ex.time_s, ex.energy_j)
        self._sd_cache[key] = out
        return out

    def _dev_factor(self, di: int) -> float:
        """Device-level energy multiplier: CPQ tax / Phi yield (v2 only)."""
        if self.model != "v2":
            return 1.0
        c = cpq(self._resident[di], self.devices[di], self.headroom)
        cpf = (cpq_power_factor(c) if self.provider is None
               else self.provider.cpq_power_factor(c))
        return cpf / self._phi[di]

    # --------------------------------------------------------------- rebuild
    def rebuild(self, mapping: Sequence[int]) -> None:
        """Full O(S) (re)build from an arbitrary mapping — used for seeds and
        whenever the annealer jumps rather than steps."""
        self.mapping = list(mapping)
        n_dev = len(self.devices)
        self._busy = [0.0] * n_dev
        self._raw = [0.0] * n_dev
        self._resident = [0.0] * n_dev
        self._count = [0] * n_dev
        for si, di in enumerate(self.mapping):
            t, e = self._stage_on_device(si, di)
            self._busy[di] += t
            self._raw[di] += e
            self._resident[di] += self.stages[si].param_bytes
            self._count[di] += 1
        self._transfer_bytes = 0.0
        for si in range(len(self.stages)):
            nxt = self._next[si]
            if nxt is not None and self.mapping[si] != self.mapping[nxt]:
                self._transfer_bytes += self._bcost[si]

    def move_fits(self, si: int, new_di: int, cap_bytes: float) -> bool:
        """Memory feasibility of moving stage ``si`` to ``new_di``: only the
        destination can newly overflow (the source merely frees bytes), so a
        feasible current mapping stays feasible iff the destination fits."""
        return (self._resident[new_di] + self.stages[si].param_bytes
                <= cap_bytes)

    # ------------------------------------------------------------------ move
    def apply(self, si: int, new_di: int) -> UndoToken:
        """Move stage ``si`` to device ``new_di``; returns the undo token."""
        old_di = self.mapping[si]
        token = UndoToken(
            stage=si, old_dev=old_di, new_dev=new_di,
            busy=(self._busy[old_di], self._busy[new_di]),
            raw=(self._raw[old_di], self._raw[new_di]),
            resident=(self._resident[old_di], self._resident[new_di]),
            count=(self._count[old_di], self._count[new_di]),
            transfer_bytes=self._transfer_bytes)
        if new_di == old_di:
            return token
        t_old, e_old = self._stage_on_device(si, old_di)
        t_new, e_new = self._stage_on_device(si, new_di)
        pb = self.stages[si].param_bytes
        self._busy[old_di] -= t_old
        self._busy[new_di] += t_new
        self._raw[old_di] -= e_old
        self._raw[new_di] += e_new
        self._resident[old_di] -= pb
        self._resident[new_di] += pb
        self._count[old_di] -= 1
        self._count[new_di] += 1
        # only the two boundaries adjacent to si can flip
        for a in (self._prev[si], si):
            if a is None:
                continue
            b = self._next[a]
            if b is None:
                continue
            pair = (self.mapping[a], self.mapping[b])
            was_cut = pair[0] != pair[1]
            now = (new_di if a == si else pair[0],
                   new_di if b == si else pair[1])
            is_cut = now[0] != now[1]
            if was_cut and not is_cut:
                self._transfer_bytes -= self._bcost[a]
            elif is_cut and not was_cut:
                self._transfer_bytes += self._bcost[a]
        self.mapping[si] = new_di
        return token

    def revert(self, token: UndoToken) -> None:
        """Bit-exact rollback of ``apply`` (restores saved values, no
        floating-point round-trip)."""
        a, b = token.old_dev, token.new_dev
        self._busy[a], self._busy[b] = token.busy
        self._raw[a], self._raw[b] = token.raw
        self._resident[a], self._resident[b] = token.resident
        self._count[a], self._count[b] = token.count
        self._transfer_bytes = token.transfer_bytes
        self.mapping[token.stage] = token.old_dev

    # ------------------------------------------------------------ objectives
    def objectives(self) -> Objectives:
        """(energy_j, makespan_s, underutil) — PGSAM's objective triple,
        matching ``PGSAM._evaluate`` on the same mapping."""
        energy = self._transfer_bytes * TRANSFER_ENERGY_PER_BYTE
        busy_total = 0.0
        busy_max = 0.0
        link_bw = float("inf")
        for di in range(len(self.devices)):
            if self._count[di] == 0:
                continue
            energy += self._raw[di] * self._dev_factor(di)
            busy_total += self._busy[di]
            if self._busy[di] > busy_max:
                busy_max = self._busy[di]
            if self.devices[di].link_bw < link_bw:
                link_bw = self.devices[di].link_bw
        t_io = (self._transfer_bytes / link_bw
                if self._transfer_bytes else 0.0)
        makespan = busy_max + t_io
        n = len(self.devices)
        underutil = (1.0 - busy_total / (n * makespan)
                     if makespan > 0 else 0.0)
        return (energy, makespan, underutil)

    def peek(self, si: int, new_di: int) -> Objectives:
        """Objectives after a hypothetical move, state unchanged."""
        token = self.apply(si, new_di)
        try:
            return self.objectives()
        finally:
            self.revert(token)
