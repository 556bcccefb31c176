"""Scaling-exponent estimation (paper Section 4.1, Tables 1-2).

The coverage law C(S) = 1 - exp(-alpha * S^beta) linearizes exactly:
    log(-log(1 - C)) = log(alpha) + beta * log(S)
so the primary fit is ordinary least squares in transformed space; the joint
(N, S) fit adds a beta_N column. Confidence intervals come from bootstrap
resampling (1000 iterations, as in the paper's Table 1), resampling either
observed coverage points or per-problem Bernoulli outcomes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


@dataclass
class PowerLawFit:
    alpha: float
    beta: float
    r2: float
    beta_ci: Tuple[float, float]
    n_points: int

    def predict(self, S: np.ndarray) -> np.ndarray:
        return 1.0 - np.exp(-self.alpha * np.asarray(S, float) ** self.beta)


def _transform(S: np.ndarray, C: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    C = np.clip(np.asarray(C, float), 1e-6, 1 - 1e-6)
    return np.log(np.asarray(S, float)), np.log(-np.log(1.0 - C))


def fit_power_law(S: Sequence[float], C: Sequence[float],
                  n_bootstrap: int = 1000, seed: int = 0) -> PowerLawFit:
    """Fit C(S) = 1 - exp(-alpha S^beta) with bootstrap CI on beta."""
    S = np.asarray(S, float)
    C = np.asarray(C, float)
    x, y = _transform(S, C)
    A = np.stack([np.ones_like(x), x], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    log_alpha, beta = coef

    yhat = A @ coef
    ss_res = float(np.sum((y - yhat) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0

    rng = np.random.default_rng(seed)
    betas = []
    n = len(S)
    for _ in range(n_bootstrap):
        idx = rng.integers(0, n, n)
        if len(np.unique(x[idx])) < 2:
            continue
        Ab = np.stack([np.ones(n), x[idx]], axis=1)
        cb, *_ = np.linalg.lstsq(Ab, y[idx], rcond=None)
        betas.append(cb[1])
    lo, hi = (np.percentile(betas, [2.5, 97.5]) if betas
              else (beta, beta))
    return PowerLawFit(alpha=float(np.exp(log_alpha)), beta=float(beta),
                       r2=float(r2), beta_ci=(float(lo), float(hi)),
                       n_points=n)


@dataclass
class JointFit:
    alpha: float
    beta_N: float
    beta_S: float
    r2: float

    def predict(self, N: np.ndarray, S: np.ndarray) -> np.ndarray:
        rate = self.alpha * np.asarray(N, float) ** self.beta_N * \
            np.asarray(S, float) ** self.beta_S
        return 1.0 - np.exp(-rate)


def fit_coverage_joint(N: Sequence[float], S: Sequence[float],
                       C: Sequence[float]) -> JointFit:
    """Joint fit over (model size, sample budget) grids — Formalism 1.1's
    separate beta_N / beta_S characterization."""
    N = np.asarray(N, float)
    S = np.asarray(S, float)
    C = np.clip(np.asarray(C, float), 1e-6, 1 - 1e-6)
    y = np.log(-np.log(1.0 - C))
    A = np.stack([np.ones_like(y), np.log(N), np.log(S)], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    yhat = A @ coef
    ss_res = float(np.sum((y - yhat) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    return JointFit(alpha=float(np.exp(coef[0])), beta_N=float(coef[1]),
                    beta_S=float(coef[2]),
                    r2=1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0)


def empirical_coverage(outcomes: np.ndarray,
                       sample_budgets: Sequence[int],
                       n_bootstrap: int = 0, seed: int = 0
                       ) -> Dict[int, float]:
    """pass@k estimator over a (problems x max_samples) boolean outcome matrix.

    Uses the unbiased pass@k estimator: 1 - C(n-c, k)/C(n, k) averaged over
    problems (Chen et al. 2021), matching how the paper measures coverage.
    """
    outcomes = np.asarray(outcomes, bool)
    n_prob, n_max = outcomes.shape
    c = outcomes.sum(axis=1)               # successes per problem
    out = {}
    for k in sample_budgets:
        k = min(k, n_max)
        # pass@k = 1 - prod_{i=0..k-1} (n - c - i) / (n - i)
        vals = np.ones(n_prob)
        for i in range(k):
            vals *= np.clip((n_max - c - i), 0, None) / (n_max - i)
        out[k] = float(np.mean(1.0 - vals))
    return out
