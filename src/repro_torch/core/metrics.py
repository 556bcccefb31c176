"""Composite efficiency metrics: IPW, ECE, PPP (paper contribution 2).

Definitions (paper Section 1 / Saad-Falcon et al. for IPW):
  IPW = coverage (tasks solved) / average power draw          [tasks/W]
  ECE = coverage / total energy                               [coverage/J]
  PPP = dimensionless cost-power-performance balance:
        throughput-normalized performance over normalized cost x power.

The paper does not print a closed form for PPP; we implement the declared
semantics ("cost-power-throughput balance") as
    PPP = (coverage * throughput_tps) / (power_W^0.5 * cost_usd_per_1k^0.5)
scaled by PPP_SCALE so the GPT-2 standard-execution configuration reproduces the
paper's Table 16 value (16.85); the *ratios* between configurations — which is
what the paper's claims are about — are insensitive to the calibration constant.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

PPP_SCALE = 0.00221  # calibrated: GPT-2 standard-execution PPP == paper's 16.85


@dataclass(frozen=True)
class RunMetrics:
    coverage: float          # pass@k in [0,1]
    accuracy: float          # single-sample accuracy in [0,1]
    energy_j: float
    latency_s: float         # per-query end-to-end
    power_w: float           # average draw
    throughput_tps: float    # tokens/second
    cost_usd_per_1k: float   # per 1000 queries

    @property
    def ipw(self) -> float:
        return self.coverage / max(self.power_w, 1e-9)

    @property
    def ece(self) -> float:
        return self.coverage / max(self.energy_j, 1e-9)

    @property
    def ppp(self) -> float:
        denom = (max(self.power_w, 1e-9) ** 0.5 *
                 max(self.cost_usd_per_1k, 1e-9) ** 0.5)
        return PPP_SCALE * self.coverage * self.throughput_tps / denom

    def as_dict(self) -> Dict[str, float]:
        return {
            "coverage": self.coverage, "accuracy": self.accuracy,
            "energy_j": self.energy_j, "latency_s": self.latency_s,
            "power_w": self.power_w, "throughput_tps": self.throughput_tps,
            "ipw": self.ipw, "ece": self.ece, "ppp": self.ppp,
            "cost_usd_per_1k": self.cost_usd_per_1k,
        }


def improvement(base: RunMetrics, new: RunMetrics) -> Dict[str, float]:
    """Paper-style deltas: pp for coverage, % for the rest."""
    pct = lambda a, b: (b - a) / a * 100.0 if a else float("nan")
    return {
        "coverage_pp": (new.coverage - base.coverage) * 100.0,
        "accuracy_pp": (new.accuracy - base.accuracy) * 100.0,
        "energy_pct": pct(base.energy_j, new.energy_j),
        "latency_pct": pct(base.latency_s, new.latency_s),
        "power_pct": pct(base.power_w, new.power_w),
        "ipw_pct": pct(base.ipw, new.ipw),
        "ppp_pct": pct(base.ppp, new.ppp),
    }
