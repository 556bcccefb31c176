"""SLA-tiered operating-point routing over the PGSAM non-dominated archive.

PR 1 left the Pareto frontier a one-shot artifact: `PGSAMOrchestrator`
computes it, callers print it. This module makes it a *live routing surface*:
every request class (SLA tier) is scalarized over the archive to pick the
operating point — a full stage->device placement with known energy, makespan
and quality — that serves that tier cheapest within its caps.

* ``SLATier`` — a request class: optional hard caps (`latency_p99_s` on the
  plan makespan, `energy_cap_w` on its average power draw, `min_quality` on
  repeated-sampling coverage) plus scalarization weights for choosing among
  the cap-feasible archive points.
* ``ParetoRouter`` — holds the frontier (via the orchestrator's memoized
  `pareto_frontier`, so repeated routing never re-anneals an unchanged
  world) and maps tiers to `RoutingDecision`s. Tracks the orchestrator's
  health epoch: after a drift event invalidates the archive, the next
  `route` call transparently refreshes.
* ``route_batch`` — the batch-aware path the continuous-batching scheduler
  uses: a mixed-tier batch routes to ONE shared operating point (caps merge
  to the tightest member tier, weights blend by request count), with every
  frontier point *re-costed under the batch workload* so decode
  weight-streaming amortization is priced into feasibility, and the chosen
  point's cost attributed back per tier.
* ``RoutedServingEngine`` — thin compatibility shim over the scheduler for
  the old per-`generate` adapter API; new code should drive
  `repro_torch.serving.ContinuousBatchingScheduler` directly.
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.decomposition import Workload, decompose
from repro_torch.core.energy import PlanCosts, plan_costs
from repro_torch.core.formalisms import coverage, samples_for_coverage
from repro_torch.core.orchestrator import Assignment, cfg_param_millions
from repro_torch.models.config import ArchConfig


@dataclass(frozen=True)
class SLATier:
    """One request class. Caps are hard constraints on the operating point;
    weights scalarize among the points that satisfy them (objectives are
    normalized by the frontier minima, so the weights are unitless)."""
    name: str
    latency_p99_s: Optional[float] = None   # cap on plan makespan
    energy_cap_w: Optional[float] = None    # cap on plan average power
    min_quality: Optional[float] = None     # coverage floor (Formalism 1.1)
    energy_weight: float = 1.0
    latency_weight: float = 0.0


@dataclass
class RoutingDecision:
    tier: SLATier
    assignment: Assignment          # the chosen archive operating point
    point_index: int                # index into the router's frontier
    meets_caps: bool                # False -> best-effort (caps violated)
    quality: Optional[float] = None     # coverage at the workload's samples
    samples: Optional[int] = None       # raised budget to reach min_quality
    notes: List[str] = field(default_factory=list)

    @property
    def energy_j(self) -> float:
        return self.assignment.energy_j

    @property
    def latency_s(self) -> float:
        return self.assignment.latency_s

    @property
    def avg_power_w(self) -> float:
        return self.energy_j / max(self.latency_s, 1e-12)


@dataclass(eq=False)
class BatchRoutingDecision:
    """One shared operating point for a mixed-tier batch.

    ``tier`` is the *merged* request class (tightest member caps,
    count-blended weights; a single-tier batch keeps that tier's name).
    ``batch_costs`` is the chosen point's mapping re-costed under the batch
    workload — its makespan is the batch's simulated service time, and its
    energy is attributed per member tier in ``per_tier_energy_j``.
    """
    tier: SLATier
    tier_counts: Dict[str, int]
    assignment: Assignment
    point_index: int
    meets_caps: bool
    workload: Workload                  # the batch workload costed
    batch_costs: PlanCosts
    per_tier_energy_j: Dict[str, float]
    notes: List[str] = field(default_factory=list)

    @property
    def n_requests(self) -> int:
        return sum(self.tier_counts.values())

    @property
    def energy_j(self) -> float:
        return self.batch_costs.energy_j

    @property
    def latency_s(self) -> float:
        return self.batch_costs.makespan_s

    @property
    def avg_power_w(self) -> float:
        return self.energy_j / max(self.latency_s, 1e-12)


def merge_tiers(tiers: Sequence[SLATier],
                counts: Optional[Dict[str, int]] = None) -> SLATier:
    """Collapse a batch's member tiers into one request class: hard caps
    tighten to the strictest member (min latency/power cap, max quality
    floor) — a shared operating point must satisfy every rider — while the
    scalarization weights blend by request count (amortization: the batch
    optimizes for its population mix)."""
    by_name = {t.name: t for t in tiers}
    if len(by_name) == 1:
        return next(iter(by_name.values()))
    counts = counts or Counter(t.name for t in tiers)
    total = max(sum(counts.values()), 1)
    lat = [t.latency_p99_s for t in by_name.values()
           if t.latency_p99_s is not None]
    pow_ = [t.energy_cap_w for t in by_name.values()
            if t.energy_cap_w is not None]
    qual = [t.min_quality for t in by_name.values()
            if t.min_quality is not None]
    return SLATier(
        name="+".join(sorted(by_name)),
        latency_p99_s=min(lat) if lat else None,
        energy_cap_w=min(pow_) if pow_ else None,
        min_quality=max(qual) if qual else None,
        energy_weight=sum(by_name[n].energy_weight * c
                          for n, c in counts.items()) / total,
        latency_weight=sum(by_name[n].latency_weight * c
                           for n, c in counts.items()) / total)


def default_tiers(base_latency_s: float) -> List[SLATier]:
    """Three canonical tiers around a reference latency (typically the
    balanced plan's makespan): interactive chases the low-latency end of the
    frontier, economy the low-energy end, standard trades both under a
    relaxed cap."""
    return [
        SLATier("interactive", latency_p99_s=0.9 * base_latency_s,
                energy_weight=0.0, latency_weight=1.0),
        SLATier("standard", latency_p99_s=1.5 * base_latency_s,
                energy_weight=0.5, latency_weight=0.5),
        SLATier("economy", energy_weight=1.0, latency_weight=0.0),
    ]


class ParetoRouter:
    """Maps SLA tiers to operating points on the PGSAM archive.

    ``orchestrator`` must expose ``pareto_frontier(cfg, workload, healthy)``
    and a ``health_epoch`` counter (`repro_torch.qeil2.PGSAMOrchestrator`); the
    router re-pulls the frontier whenever the epoch moved — i.e. after any
    drift event the control loop (or safety monitor) delivered.
    """

    def __init__(self, orchestrator, cfg: ArchConfig, workload: Workload,
                 tiers: Sequence[SLATier] = (),
                 healthy: Optional[Sequence[str]] = None):
        self.orchestrator = orchestrator
        self.cfg = cfg
        self.workload = workload
        self.tiers: Dict[str, SLATier] = {t.name: t for t in tiers}
        self.healthy = list(healthy) if healthy is not None else None
        self._frontier: Optional[List[Assignment]] = None
        self._epoch = -1
        # batch-workload re-costings, keyed by (point identity, workload);
        # the value pins the assignment (id-recycling safety); dropped with
        # the frontier
        self._recost_cache: Dict[Tuple[int, Workload],
                                 Tuple[Assignment, PlanCosts]] = {}

    def add_tier(self, tier: SLATier) -> None:
        self.tiers[tier.name] = tier

    def resolve_tier(self, tier: Union[str, SLATier]) -> SLATier:
        """Registered tier by name, or an ad-hoc `SLATier` verbatim."""
        return self.tiers[tier] if isinstance(tier, str) else tier

    def set_healthy(self, healthy: Optional[Sequence[str]]) -> None:
        """Restrict routing to a device subset (the control loop calls this
        when devices fail, cool down, or come back)."""
        self.healthy = list(healthy) if healthy is not None else None
        self._frontier = None
        self._recost_cache.clear()

    @property
    def frontier(self) -> List[Assignment]:
        """The current archive (placed points only), refreshed when the
        orchestrator's health epoch has moved since the last pull."""
        epoch = getattr(self.orchestrator, "health_epoch", 0)
        if self._frontier is None or epoch != self._epoch:
            pts = self.orchestrator.pareto_frontier(
                self.cfg, self.workload, healthy=self.healthy)
            self._frontier = [a for a in pts if a.mapping]
            self._epoch = epoch
            self._recost_cache.clear()
        return self._frontier

    # ------------------------------------------------------- batch costing
    def batch_workload(self, n_requests: int,
                       samples: Optional[int] = None,
                       prompt_tokens: Optional[int] = None,
                       decode_tokens: Optional[int] = None) -> Workload:
        """The router's canonical per-request workload scaled to a batch of
        ``n_requests``, optionally overriding the sampling budget and token
        counts with what the batch will actually execute (the scheduler
        passes its bucket's prompt length / decode horizon and the members'
        admission-raised sample mean)."""
        kw = {"batch": max(int(n_requests), 1)}
        if samples is not None:
            kw["samples"] = int(samples)
        if prompt_tokens is not None:
            kw["prompt_tokens"] = int(prompt_tokens)
        if decode_tokens is not None:
            kw["decode_tokens"] = int(decode_tokens)
        return dataclasses.replace(self.workload, **kw)

    def recost(self, assignment: Assignment,
               workload: Workload) -> PlanCosts:
        """Re-cost an archive point's *mapping* under a different workload —
        same placement, batched tokens. This is where batching amortization
        becomes visible: decode stages re-stream weights once per token
        regardless of batch size, so a batch's makespan grows sublinearly in
        its request count. Uses the orchestrator's quant / energy model /
        calibration provider (and live temps when it is thermally aware)."""
        # the cached tuple pins the assignment so its id cannot be recycled
        # by a new object while the entry lives (cache drops with the
        # frontier epoch / healthy-set changes)
        key = (id(assignment), workload)
        hit = self._recost_cache.get(key)
        if hit is not None:
            return hit[1]
        orch = self.orchestrator
        stages = decompose(self.cfg, workload)
        mapping = {st.name: assignment.mapping[st.name] for st in stages}
        model = getattr(orch, "energy_model", "v1")
        temps = None
        safety = getattr(orch, "safety", None)
        if safety is not None and model == "v2":
            temps = {n: tm.state.temp_c
                     for n, tm in safety.thermal.items()}
        costs = plan_costs(
            stages, mapping, getattr(orch, "quant", "bf16"), workload,
            model=model, temps=temps,
            headroom=getattr(getattr(orch, "constraints", None),
                             "memory_headroom", 0.9),
            provider=getattr(orch, "provider", None))
        self._recost_cache[key] = (assignment, costs)
        return costs

    # ------------------------------------------------------------- routing
    def route(self, request_class: Union[str, SLATier]) -> RoutingDecision:
        """Pick the operating point for a request class: hard-filter the
        archive by the tier's caps, then scalarize (weights over frontier-
        normalized energy/latency). With no cap-feasible point the least-
        violating point is returned flagged ``meets_caps=False`` — serving
        degrades, it does not crash."""
        tier = (self.tiers[request_class]
                if isinstance(request_class, str) else request_class)
        pts = self.frontier
        if not pts:
            raise RuntimeError("empty frontier: no placeable operating point")
        e_min = max(min(a.energy_j for a in pts), 1e-12)
        t_min = max(min(a.latency_s for a in pts), 1e-12)

        def score(a: Assignment) -> float:
            return (tier.energy_weight * a.energy_j / e_min +
                    tier.latency_weight * a.latency_s / t_min)

        def violation(a: Assignment) -> float:
            v = 0.0
            if tier.latency_p99_s is not None and \
                    a.latency_s > tier.latency_p99_s:
                v += a.latency_s / tier.latency_p99_s - 1.0
            if tier.energy_cap_w is not None:
                p = a.energy_j / max(a.latency_s, 1e-12)
                if p > tier.energy_cap_w:
                    v += p / tier.energy_cap_w - 1.0
            # sub-ulp overshoot is a rounding artifact, not a violation:
            # callers routinely derive caps as fractions of frontier points
            # (cap = x/0.9 * 0.9 can land one ulp under x)
            return 0.0 if v < 1e-9 else v

        feasible = [i for i, a in enumerate(pts) if violation(a) == 0.0]
        notes = []
        if feasible:
            idx = min(feasible, key=lambda i: (score(pts[i]), i))
            meets = True
        else:
            idx = min(range(len(pts)),
                      key=lambda i: (violation(pts[i]), score(pts[i]), i))
            meets = False
            notes.append(f"no archive point satisfies tier "
                         f"{tier.name!r} caps; best-effort")

        quality = None
        samples = None
        if tier.min_quality is not None:
            quality = self._coverage()
            samples = self.required_samples(tier)
            if samples is not None:
                notes.append(f"coverage {quality:.3f} < "
                             f"{tier.min_quality}: raise samples to "
                             f"{samples}")
        return RoutingDecision(tier, pts[idx], idx, meets, quality, samples,
                               notes)

    def route_all(self) -> Dict[str, RoutingDecision]:
        return {name: self.route(name) for name in self.tiers}

    # ------------------------------------------------------- quality floor
    def _coverage(self) -> float:
        w = self.workload
        return coverage(w.samples, cfg_param_millions(self.cfg),
                        w.decode_tokens)

    def required_samples(self, tier: Union[str, SLATier]) -> Optional[int]:
        """Sampling budget needed to reach the tier's coverage floor
        (Formalism 1.1), or None when there is no floor or the canonical
        workload already meets it. The admission queue raises each
        request's budget with this at submit time."""
        tier = self.resolve_tier(tier)
        if tier.min_quality is None or self._coverage() >= tier.min_quality:
            return None
        w = self.workload
        return int(math.ceil(samples_for_coverage(
            tier.min_quality, cfg_param_millions(self.cfg),
            w.decode_tokens)))

    # ------------------------------------------------------- batch routing
    def route_batch(self, tiers: Sequence[Union[str, SLATier]],
                    samples: Optional[int] = None,
                    prompt_tokens: Optional[int] = None,
                    decode_tokens: Optional[int] = None,
                    workload_map=None
                    ) -> BatchRoutingDecision:
        """Route a mixed-tier batch to ONE shared operating point.

        Caps merge to the tightest member tier (`merge_tiers`); every
        archive point is re-costed under the batch workload before caps and
        scalarization apply, because feasibility genuinely depends on batch
        size (weight-streaming amortizes, activation traffic does not). The
        chosen point's batch energy is attributed back per tier by request
        share — the amortized per-tier cost the telemetry records. Like
        `route`, an infeasible batch degrades to the least-violating point
        flagged ``meets_caps=False`` instead of crashing.

        ``workload_map`` (Workload -> Workload) rewrites the batch workload
        before re-costing — how speculative-decode pricing enters
        (`repro_torch.spec.routing.spec_workload` divides decode weight re-streams
        by expected accepted tokens per verify step while scaling per-query
        compute); the rewritten workload rides in ``decision.workload``.
        """
        members = [self.resolve_tier(t) for t in tiers]
        if not members:
            raise ValueError("route_batch needs at least one request")
        counts = dict(Counter(t.name for t in members))
        merged = merge_tiers(members, counts)
        pts = self.frontier
        if not pts:
            raise RuntimeError("empty frontier: no placeable operating point")
        w_b = self.batch_workload(len(members), samples,
                                  prompt_tokens, decode_tokens)
        if workload_map is not None:
            w_b = workload_map(w_b)
        costed = [self.recost(a, w_b) for a in pts]
        e_min = max(min(c.energy_j for c in costed), 1e-12)
        t_min = max(min(c.makespan_s for c in costed), 1e-12)

        def score(c: PlanCosts) -> float:
            return (merged.energy_weight * c.energy_j / e_min +
                    merged.latency_weight * c.makespan_s / t_min)

        def violation(c: PlanCosts) -> float:
            v = 0.0
            if merged.latency_p99_s is not None and \
                    c.makespan_s > merged.latency_p99_s:
                v += c.makespan_s / merged.latency_p99_s - 1.0
            if merged.energy_cap_w is not None:
                p = c.energy_j / max(c.makespan_s, 1e-12)
                if p > merged.energy_cap_w:
                    v += p / merged.energy_cap_w - 1.0
            return 0.0 if v < 1e-9 else v      # sub-ulp guard, as in route

        feasible = [i for i in range(len(pts))
                    if violation(costed[i]) == 0.0]
        notes: List[str] = []
        if feasible:
            idx = min(feasible, key=lambda i: (score(costed[i]), i))
            meets = True
        else:
            idx = min(range(len(pts)),
                      key=lambda i: (violation(costed[i]),
                                     score(costed[i]), i))
            meets = False
            notes.append(f"no archive point satisfies merged caps of "
                         f"batch {counts}; best-effort")
        chosen = costed[idx]
        total = sum(counts.values())
        per_tier = {name: chosen.energy_j * c / total
                    for name, c in counts.items()}
        return BatchRoutingDecision(
            tier=merged, tier_counts=counts, assignment=pts[idx],
            point_index=idx, meets_caps=meets, workload=w_b,
            batch_costs=chosen, per_tier_energy_j=per_tier, notes=notes)


# ======================================================= serving-side adapter

class RoutedServingEngine:
    """Thin compatibility shim: the old per-`generate` adapter API on top of
    the continuous-batching scheduler.

    Each ``generate`` call submits its prompts (one tier, per-call) into a
    private `repro_torch.serving.ContinuousBatchingScheduler` sized so the whole
    call forms one batch per prompt-length bucket, drains it, and returns
    results in input order. The routed operating point lands in
    ``engine.last_placement`` / ``engine.placements`` exactly as before;
    ``decisions`` now holds `BatchRoutingDecision`s (one per formed batch).
    A tier's ``min_quality`` floor still raises the sampling budget — that
    moved into the scheduler's admission control.

    Migration: new code should construct the scheduler directly
    (``ContinuousBatchingScheduler(engine.backend, router)``) and ``submit``
    requests with per-request tiers — that is what unlocks mixed-tier
    batches; this shim serializes call-by-call like the pre-refactor
    engine did.
    """

    def __init__(self, engine, router: ParetoRouter,
                 default_tier: Optional[str] = None, obs=None):
        self.engine = engine
        self.router = router
        self.default_tier = default_tier
        self.obs = obs                 # forwarded to the backing scheduler
        # bounded: decisions reference full plans; cap the history so a
        # long-lived server doesn't grow with request count
        self.decisions: Deque[BatchRoutingDecision] = deque(maxlen=256)
        self._scheduler = None

    @property
    def scheduler(self):
        """The backing `ContinuousBatchingScheduler` (created on first
        use): batch records, telemetry, stats."""
        return self._sched()

    def _sched(self):
        if self._scheduler is None:
            from repro_torch.serving.scheduler import (
                ContinuousBatchingScheduler, SchedulerConfig)
            self._scheduler = ContinuousBatchingScheduler(
                self.engine.backend, self.router,
                config=SchedulerConfig(max_batch_requests=10 ** 9,
                                       max_inflight_batches=1,
                                       max_queue_depth=None),
                obs=self.obs)
        return self._scheduler

    def generate(self, prompts, tier: Optional[Union[str, SLATier]] = None,
                 n_samples: int = 1, max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None, rng=None,
                 extras: Optional[Dict] = None):
        """`ServingEngine.generate` semantics with frontier routing; the
        batch decision lands in ``self.decisions`` (and the operating point
        in ``engine.last_placement``)."""
        tier = tier if tier is not None else self.default_tier
        if tier is None:
            raise ValueError("no tier given and no default_tier configured")
        sched = self._sched()
        ids = []
        for i, p in enumerate(prompts):
            row = ({k: np.asarray(v)[i] for k, v in extras.items()}
                   if extras else None)
            adm = sched.submit(
                p, tier=tier, n_samples=n_samples,
                max_new_tokens=(max_new_tokens if max_new_tokens is not None
                                else self.engine.max_new_tokens),
                temperature=(temperature if temperature is not None
                             else self.engine.temperature),
                rng=rng, extras=row)
            if not adm.admitted:       # unbounded shim queue: unknown tier
                raise KeyError(adm.reason)
            ids.append(adm.request_id)
        sched.run_until_idle()
        # drain: the scheduler's completed map is the caller's to empty —
        # a long-lived shim must not accumulate every past call's results
        done = {rid: sched.completed.pop(rid) for rid in ids}
        for rid in ids:
            d = done[rid].decision
            if not any(d is seen for seen in self.decisions):
                self.decisions.append(d)
        return [done[rid].result for rid in ids]
