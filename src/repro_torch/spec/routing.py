"""Roofline-priced speculative routing (ported from ``repro.spec.routing``).

Decode is memory-bound: each step's cost is dominated by re-streaming the
(active) weights, so verifying n drafted tokens in one forward costs barely
more than emitting one. At accept rate ``a`` and depth ``n``, one verify
step commits

    E[tokens] = 1 + a + a^2 + ... + a^n = (1 - a^(n+1)) / (1 - a)

tokens while scoring n + 1 queries. `spec_workload` rewrites a `Workload`
(exactly like `repro_torch.quant.quant_workload` does for formats) so
`repro_torch.core.decompose` divides decode weight re-streams by E[tokens] and
multiplies per-query compute/activation traffic by (n+1)/E[tokens] — DASI
rises, decode bytes fall, and `plan_costs`/`plan_costs_v2` price the trade
without speculation-specific branches.

`SpecPlanner` closes the loop: per candidate depth it asks
`ParetoRouter.route_batch` for the batch's cost under the spec-rewritten
workload (accept rate from fitted calibration, per (model, tier, policy))
and keeps the depth whose chosen operating point scores best under the
merged tier's scalarization — depth 0 is always a candidate, so a low
fitted accept rate flips drafting off by losing the price comparison, not
by a special case.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from repro_torch.core.decomposition import Workload

DEFAULT_DEPTHS: Tuple[int, ...] = (0, 2, 4)
DEFAULT_ACCEPT_RATE = 0.7


def expected_tokens_per_step(n: int, accept_rate: float) -> float:
    """E[committed tokens per verify step] at draft depth n, per-token
    accept rate a: (1 - a^(n+1)) / (1 - a); n+1 as a -> 1."""
    if n <= 0:
        return 1.0
    a = min(max(float(accept_rate), 0.0), 1.0)
    if a >= 1.0 - 1e-12:
        return float(n + 1)
    return (1.0 - a ** (n + 1)) / (1.0 - a)


def spec_workload(w: Workload, n: int, accept_rate: float) -> Workload:
    """Rewrite a workload for speculative decode at depth ``n``: decode
    weight re-streams drop to one per E[tokens] committed, scored queries
    rise to (n+1) per verify step. n <= 0 returns ``w`` unchanged (off)."""
    if n <= 0:
        return w
    tps = expected_tokens_per_step(n, accept_rate)
    return dataclasses.replace(w, spec_tokens_per_step=tps,
                               spec_queries_per_step=float(n + 1))


@dataclass(frozen=True)
class SpecPlan:
    """The speculation decision attached to a routed batch: which policy
    drafts, at what depth (0 = off), priced at which accept rate."""
    policy: str
    n: int
    accept_rate: float

    @property
    def tokens_per_step(self) -> float:
        return expected_tokens_per_step(self.n, self.accept_rate)

    @property
    def enabled(self) -> bool:
        return self.n > 0


class SpecPlanner:
    """Chooses the draft depth per routed batch from predicted cost.

    ``accept_rate`` seeds the prediction; a fitted `CalibrationProfile`
    (``profile=``) overrides it per (model, tier, policy) once "spec" trace
    records have been fitted — `refresh(profile)` swaps the estimate in
    live, closing the measure -> fit -> route loop for speculation.
    """

    def __init__(self, policy_name: str,
                 depths: Sequence[int] = DEFAULT_DEPTHS,
                 accept_rate: float = DEFAULT_ACCEPT_RATE,
                 profile=None, model_name: Optional[str] = None):
        self.policy_name = policy_name
        self.depths = tuple(sorted({0, *(int(d) for d in depths)}))
        self.default_accept_rate = float(accept_rate)
        self.profile = profile
        self.model_name = model_name

    def refresh(self, profile) -> None:
        """Adopt a newly fitted calibration profile (accept rates)."""
        self.profile = profile

    def accept_rate_for(self, tier_name: Optional[str] = None) -> float:
        """Fitted accept rate for (model, tier, policy) with the profile's
        fallback chain; the constructor default when nothing is fitted."""
        if self.profile is not None:
            r = self.profile.accept_rate_for(
                model=self.model_name, tier=tier_name,
                policy=self.policy_name, default=None)
            if r is not None:
                return float(r)
        return self.default_accept_rate

    def route_batch(self, router, tiers: Sequence, samples=None,
                    prompt_tokens=None, decode_tokens=None):
        """`ParetoRouter.route_batch` swept over candidate depths.

        Returns the winning `BatchRoutingDecision` with ``decision.spec``
        set to the chosen `SpecPlan`. Cap-feasible depths beat infeasible
        ones; ties break toward smaller n (less speculative exposure).
        """
        base = router.route_batch(tiers, samples=samples,
                                  prompt_tokens=prompt_tokens,
                                  decode_tokens=decode_tokens)
        merged = base.tier
        e0 = max(base.energy_j, 1e-12)
        t0 = max(base.latency_s, 1e-12)

        def score(d) -> float:
            # normalized by the spec-off decision so the unitless tier
            # weights blend joules and seconds sensibly across depths
            return (merged.energy_weight * d.energy_j / e0 +
                    merged.latency_weight * d.latency_s / t0)

        best = ((not base.meets_caps, score(base), 0), base,
                SpecPlan("off", 0, 1.0))
        # member tiers name the accept-rate key; batches are usually
        # tier-homogeneous per key, so the first member stands in
        t0m = tiers[0]
        tier_name = t0m if isinstance(t0m, str) else t0m.name
        rate = self.accept_rate_for(tier_name)
        for n in self.depths:
            if n == 0:
                continue
            d = router.route_batch(
                tiers, samples=samples, prompt_tokens=prompt_tokens,
                decode_tokens=decode_tokens,
                workload_map=lambda w, _n=n: spec_workload(w, _n, rate))
            key = (not d.meets_caps, score(d), n)
            if key < best[0]:
                best = (key, d, SpecPlan(self.policy_name, n, float(rate)))
        decision, plan = best[1], best[2]
        decision.spec = plan
        if plan.enabled:
            decision.notes.append(
                f"spec {plan.policy} n={plan.n} "
                f"accept_rate={plan.accept_rate:.2f} "
                f"E[tok/step]={plan.tokens_per_step:.2f}")
        return decision
