"""Coefficient fitting: DASI knee / CPQ curve / Phi leakage from traces.

The v2 energy equation factors per stage as

    E = t_roofline * P0 * A(s) * C(kappa, e) / Phi(rho, tau) * f(Q)
    A = W_c * min(1, I / (R * s)) + W_m * min(1, R * s / I)
    C = 1 + kappa * min(cpq, 1)^e
    Phi = 1 / (1 + rho * exp((T - T_ref) / tau))

where every non-coefficient quantity (roofline time ``t``, base power ``P0``,
intensity ``I``, datasheet ridge ``R``, capacity pressure input ``cpq``,
junction temperature ``T``, quant factor ``f(Q)``) is carried by an ``energy``
trace record. `CalibrationFitter` fits the five coefficients theta =
(ridge_scale s, cpq_kappa, cpq_exp, phi_rho_ref, phi_t_slope) by bounded
least squares on log-energy residuals — log space makes the multiplicative
model additive and the residuals scale-free across devices — with bootstrap
confidence intervals via trace resampling (the `repro_torch.core.fitting` pattern).

Kernel duty factors ``eta_k = t_roofline / t_measured`` are fitted per kernel
from ``kernel`` records (a direct measurement; its CI comes from bootstrap
over timing reps), bounded to (0, 1]: a kernel can be slower than its
roofline, never faster.

The output is a `CalibrationProfile` (frozen, hashable — it participates in
PGSAM's frontier cache key) plus a `ResidualReport` comparing the fitted
coefficients against the documented first-principles defaults, so v2 energies
carry error bars instead of provenance comments.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.qeil2.signals import (CPQ_EXP, CPQ_KAPPA, PHI_RHO_REF,
                                       PHI_T_REF_C, PHI_T_SLOPE)
from repro_torch.qeil2.energy_v2 import W_COMPUTE, W_MEMORY
from repro_torch.qeil2.telemetry.trace import TraceStore

# fit bounds per coefficient: physically-motivated boxes (a ridge point is
# within 5x of the datasheet; leakage share stays below 50% of dynamic; the
# CPQ onset exponent is superlinear but not a cliff).
COEF_NAMES = ("ridge_scale", "cpq_kappa", "cpq_exp",
              "phi_rho_ref", "phi_t_slope")
COEF_DEFAULTS = (1.0, CPQ_KAPPA, CPQ_EXP, PHI_RHO_REF, PHI_T_SLOPE)
COEF_BOUNDS = ((0.2, 5.0), (0.0, 2.0), (1.0, 4.0), (0.0, 0.5), (5.0, 60.0))
ETA_BOUNDS = (1e-3, 1.0)
# full-precision formats keep the bare kernel name as the eta key so existing
# profiles/gates are unchanged; quantized records fit per-format keys
_FULL_PRECISION = ("bf16", "fp16", "fp32")


def _eta_key(record: dict) -> str:
    """Duty-factor grouping key for a kernel record: ``"<kernel>:<quant>"``
    when the record carries a quantized format (repro_torch.quant serving paths
    have format-dependent byte mixes), else the bare kernel name."""
    kernel = str(record["kernel"])
    quant = record.get("quant")
    if quant and str(quant).lower() not in _FULL_PRECISION:
        return f"{kernel}:{quant}"
    return kernel


@dataclass(frozen=True)
class CalibrationProfile:
    """Fitted v2 coefficients + per-kernel measured duty factors.

    The identity profile reproduces the documented defaults bit-for-bit
    (`CalibratedSignalProvider` guarantees it); a fitted profile carries the
    bootstrap CI of every coefficient in ``ci`` (name -> (lo, hi))."""
    ridge_scale: float = 1.0
    cpq_kappa: float = CPQ_KAPPA
    cpq_exp: float = CPQ_EXP
    phi_rho_ref: float = PHI_RHO_REF
    phi_t_slope: float = PHI_T_SLOPE
    phi_t_ref_c: float = PHI_T_REF_C
    # (kernel name, eta) pairs — tuples keep the profile hashable
    kernel_eta: Tuple[Tuple[str, float], ...] = ()
    # speculative-decode accept rates fitted from "spec" trace records:
    # ("model|tier|policy", rate) pairs, with "*" wildcard components for
    # the policy-wide aggregates the fallback chain lands on
    accept_rates: Tuple[Tuple[str, float], ...] = ()
    ci: Tuple[Tuple[str, Tuple[float, float]], ...] = ()
    source: str = "identity"
    n_traces: int = 0

    @classmethod
    def identity(cls) -> "CalibrationProfile":
        return cls()

    @property
    def is_identity(self) -> bool:
        return (self.coefficients() == COEF_DEFAULTS and
                not self.kernel_eta and not self.accept_rates)

    def coefficients(self) -> Tuple[float, ...]:
        return (self.ridge_scale, self.cpq_kappa, self.cpq_exp,
                self.phi_rho_ref, self.phi_t_slope)

    def eta_for(self, kernel: Optional[str],
                quant: Optional[str] = None) -> float:
        """Measured duty factor for a kernel (1.0 when unmeasured/None).

        With ``quant`` the per-format key ``"<kernel>:<quant>"`` is tried
        first (quantized kernels fit distinct etas — see `_eta_key`), falling
        back to the bare kernel name, then 1.0."""
        if kernel is not None:
            keys = ([f"{kernel}:{quant}", kernel] if quant else [kernel])
            for want in keys:
                for name, eta in self.kernel_eta:
                    if name == want:
                        return eta
        return 1.0

    def accept_rate_for(self, model: Optional[str] = None,
                        tier: Optional[str] = None,
                        policy: Optional[str] = None,
                        default: Optional[float] = None) -> Optional[float]:
        """Fitted speculative accept rate for (model, tier, policy).

        Fallback chain, most to least specific: the exact
        ``model|tier|policy`` key, then the policy-wide ``*|*|policy``
        aggregate, then ``default``. A None component matches the wildcard
        slot directly."""
        if policy is not None:
            keys = [f"{model or '*'}|{tier or '*'}|{policy}"]
            if keys[0] != f"*|*|{policy}":
                keys.append(f"*|*|{policy}")
            for want in keys:
                for key, rate in self.accept_rates:
                    if key == want:
                        return rate
        return default

    def ci_for(self, name: str) -> Optional[Tuple[float, float]]:
        for n, interval in self.ci:
            if n == name:
                return interval
        return None

    # ------------------------------------------------------------- serializ.
    def to_dict(self) -> dict:
        return {
            "ridge_scale": self.ridge_scale,
            "cpq_kappa": self.cpq_kappa, "cpq_exp": self.cpq_exp,
            "phi_rho_ref": self.phi_rho_ref,
            "phi_t_slope": self.phi_t_slope, "phi_t_ref_c": self.phi_t_ref_c,
            "kernel_eta": dict(self.kernel_eta),
            "accept_rates": dict(self.accept_rates),
            "ci": {k: list(v) for k, v in self.ci},
            "source": self.source, "n_traces": self.n_traces,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationProfile":
        return cls(
            ridge_scale=float(d.get("ridge_scale", 1.0)),
            cpq_kappa=float(d.get("cpq_kappa", CPQ_KAPPA)),
            cpq_exp=float(d.get("cpq_exp", CPQ_EXP)),
            phi_rho_ref=float(d.get("phi_rho_ref", PHI_RHO_REF)),
            phi_t_slope=float(d.get("phi_t_slope", PHI_T_SLOPE)),
            phi_t_ref_c=float(d.get("phi_t_ref_c", PHI_T_REF_C)),
            kernel_eta=tuple(sorted(
                (str(k), float(np.clip(float(v), *ETA_BOUNDS)))
                for k, v in (d.get("kernel_eta") or {}).items())),
            accept_rates=tuple(sorted(
                (str(k), float(np.clip(float(v), 0.0, 1.0)))
                for k, v in (d.get("accept_rates") or {}).items())),
            ci=tuple(sorted(
                (str(k), (float(v[0]), float(v[1])))
                for k, v in (d.get("ci") or {}).items())),
            source=str(d.get("source", "identity")),
            n_traces=int(d.get("n_traces", 0)))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f))


@dataclass
class ResidualReport:
    """Fit quality: fitted-vs-default residuals + per-coefficient provenance.

    ``rmse_*`` are log-space energy RMSEs over the energy records (relative
    error, device-scale-free); ``coefficients`` maps every fitted name to its
    documented default, fitted value and bootstrap CI — the error bars the
    ROADMAP item asks for."""
    rmse_default: float
    rmse_fitted: float
    n_energy: int
    n_kernel: int
    n_step: int
    n_dryrun: int
    n_spec: int = 0
    coefficients: Dict[str, dict] = field(default_factory=dict)
    kernel_eta: Dict[str, dict] = field(default_factory=dict)
    accept_rates: Dict[str, float] = field(default_factory=dict)

    @property
    def improvement_pct(self) -> float:
        if self.rmse_default <= 0:
            return 0.0
        return 100.0 * (1.0 - self.rmse_fitted / self.rmse_default)

    def to_dict(self) -> dict:
        return {
            "rmse_default": self.rmse_default,
            "rmse_fitted": self.rmse_fitted,
            "improvement_pct": self.improvement_pct,
            "n_energy": self.n_energy, "n_kernel": self.n_kernel,
            "n_step": self.n_step, "n_dryrun": self.n_dryrun,
            "n_spec": self.n_spec,
            "coefficients": self.coefficients,
            "kernel_eta": self.kernel_eta,
            "accept_rates": self.accept_rates,
        }

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        return path


# =========================================================== bounded LSQ core

def _project(x: np.ndarray, bounds: Sequence[Tuple[float, float]]
             ) -> np.ndarray:
    lo = np.array([b[0] for b in bounds])
    hi = np.array([b[1] for b in bounds])
    return np.clip(x, lo, hi)


def bounded_least_squares(residual_fn: Callable[[np.ndarray], np.ndarray],
                          x0: Sequence[float],
                          bounds: Sequence[Tuple[float, float]],
                          max_iter: int = 60,
                          tol: float = 1e-10) -> np.ndarray:
    """Box-constrained Levenberg-Marquardt with numeric Jacobian.

    Small-dimension (here: 5 coefficients), dense, deterministic — a
    projected-step LM is all the calibration fit needs, with no dependency
    beyond numpy. Steps that violate the box are clipped to it; the damping
    parameter adapts on accept/reject as usual.
    """
    x = _project(np.asarray(x0, float), bounds)
    r = residual_fn(x)
    cost = float(r @ r)
    lam = 1e-3
    n = len(x)
    for _ in range(max_iter):
        # central-difference Jacobian, step scaled to the box width
        J = np.empty((len(r), n))
        for j in range(n):
            h = 1e-6 * max(1.0, abs(x[j]), bounds[j][1] - bounds[j][0])
            xp, xm = x.copy(), x.copy()
            xp[j] = min(x[j] + h, bounds[j][1])
            xm[j] = max(x[j] - h, bounds[j][0])
            denom = xp[j] - xm[j]
            if denom == 0:
                J[:, j] = 0.0
                continue
            J[:, j] = (residual_fn(xp) - residual_fn(xm)) / denom
        g = J.T @ r
        if float(np.max(np.abs(g))) < tol:
            break
        H = J.T @ J
        improved = False
        for _ in range(12):                      # adapt damping until accept
            try:
                step = np.linalg.solve(H + lam * np.diag(np.diag(H) + 1e-12),
                                       -g)
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            x_new = _project(x + step, bounds)
            r_new = residual_fn(x_new)
            cost_new = float(r_new @ r_new)
            if cost_new < cost:
                x, r, cost = x_new, r_new, cost_new
                lam = max(lam * 0.3, 1e-12)
                improved = True
                break
            lam *= 10.0
        if not improved:
            break
    return x


# ============================================================ the fitter

def _energy_matrix(records: List[dict]) -> Dict[str, np.ndarray]:
    """Column-ize the energy records once; the residual fn is then pure
    vectorized numpy (the LM calls it ~hundreds of times per bootstrap)."""
    cols = {k: np.array([float(r[k]) for r in records])
            for k in ("intensity", "ridge", "cpq", "temp_c",
                      "t_s", "p0_w", "quant_f", "energy_j")}
    cols["log_e"] = np.log(np.clip(cols["energy_j"], 1e-300, None))
    cols["log_base"] = np.log(np.clip(
        cols["t_s"] * cols["p0_w"] * cols["quant_f"], 1e-300, None))
    return cols


def predict_log_energy(theta: Sequence[float], cols: Dict[str, np.ndarray],
                       t_ref_c: float = PHI_T_REF_C) -> np.ndarray:
    """log E_pred under coefficients theta for column-ized energy records."""
    s, kappa, e, rho, tau = theta
    ridge = cols["ridge"] * s
    a = (W_COMPUTE * np.minimum(1.0, cols["intensity"] / ridge) +
         W_MEMORY * np.minimum(1.0, ridge / np.maximum(cols["intensity"],
                                                       1e-300)))
    c = 1.0 + kappa * np.minimum(cols["cpq"], 1.0) ** e
    inv_phi = 1.0 + rho * np.exp((cols["temp_c"] - t_ref_c) / tau)
    return cols["log_base"] + np.log(a * c * inv_phi)


class CalibrationFitter:
    """Fit a `CalibrationProfile` from a `TraceStore`.

    ``fit()`` returns (profile, report). Deterministic under ``seed``; the
    bootstrap resamples energy records (coefficient CIs) and kernel timing
    reps (eta CIs) ``n_bootstrap`` times, taking 2.5/97.5 percentiles."""

    def __init__(self, store: TraceStore, n_bootstrap: int = 200,
                 seed: int = 0):
        self.store = store
        self.n_bootstrap = n_bootstrap
        self.seed = seed

    # ------------------------------------------------------------ coef fit
    def _fit_theta(self, cols: Dict[str, np.ndarray]) -> np.ndarray:
        def resid(theta: np.ndarray) -> np.ndarray:
            return predict_log_energy(theta, cols) - cols["log_e"]
        return bounded_least_squares(resid, COEF_DEFAULTS, COEF_BOUNDS)

    def _fit_kernel_eta(self, records: List[dict]
                        ) -> Dict[str, Tuple[float, Tuple[float, float]]]:
        by_kernel: Dict[str, List[float]] = {}
        for r in records:
            measured = float(r["measured_us"])
            if measured <= 0:
                continue
            eta = float(r["roofline_us"]) / measured
            by_kernel.setdefault(_eta_key(r), []).append(
                float(np.clip(eta, *ETA_BOUNDS)))
        rng = np.random.default_rng(self.seed + 1)
        out = {}
        for name, etas in sorted(by_kernel.items()):
            arr = np.array(etas)
            point = float(np.clip(arr.mean(), *ETA_BOUNDS))
            if len(arr) > 1 and self.n_bootstrap > 0:
                means = [float(np.clip(
                    arr[rng.integers(0, len(arr), len(arr))].mean(),
                    *ETA_BOUNDS)) for _ in range(self.n_bootstrap)]
                lo, hi = np.percentile(means, [2.5, 97.5])
            else:
                lo = hi = point
            out[name] = (point, (float(lo), float(hi)))
        return out

    def _fit_accept_rates(self, records: List[dict]) -> Dict[str, float]:
        """Pooled speculative accept rates from "spec" records: total
        accepted / total proposed per (model, tier, policy) key, plus the
        policy-wide ``*|*|policy`` aggregate the lookup chain falls back to.
        Pooling weights each batch by its proposal count — exactly the
        maximum-likelihood estimate for per-token Bernoulli acceptance."""
        prop: Dict[str, float] = {}
        acc: Dict[str, float] = {}
        for r in records:
            p = float(r["proposed"])
            if p <= 0:
                continue
            a = float(r["accepted"])
            policy = str(r["policy"])
            exact = (f"{r.get('model', '*')}|{r.get('tier', '*')}|{policy}")
            for key in {exact, f"*|*|{policy}"}:
                prop[key] = prop.get(key, 0.0) + p
                acc[key] = acc.get(key, 0.0) + a
        return {k: float(np.clip(acc[k] / prop[k], 0.0, 1.0))
                for k in sorted(prop)}

    # ----------------------------------------------------------------- fit
    def fit(self) -> Tuple[CalibrationProfile, ResidualReport]:
        energy = self.store.records("energy")
        kernel = self.store.records("kernel")
        spec = self.store.records("spec")
        if not energy and not kernel and not spec:
            raise ValueError("trace store holds no energy, kernel or spec "
                             "records to fit against")

        theta = np.array(COEF_DEFAULTS, float)
        ci: Dict[str, Tuple[float, float]] = {}
        rmse_default = rmse_fitted = 0.0
        if energy:
            cols = _energy_matrix(energy)
            theta = self._fit_theta(cols)
            r0 = predict_log_energy(COEF_DEFAULTS, cols) - cols["log_e"]
            r1 = predict_log_energy(theta, cols) - cols["log_e"]
            rmse_default = float(np.sqrt(np.mean(r0 ** 2)))
            rmse_fitted = float(np.sqrt(np.mean(r1 ** 2)))
            # bootstrap CI: refit on resampled records
            rng = np.random.default_rng(self.seed)
            n = len(energy)
            samples: List[np.ndarray] = []
            for _ in range(self.n_bootstrap):
                idx = rng.integers(0, n, n)
                sub = {k: v[idx] for k, v in cols.items()}
                samples.append(self._fit_theta(sub))
            if samples:
                arr = np.stack(samples)
                for j, name in enumerate(COEF_NAMES):
                    lo, hi = np.percentile(arr[:, j], [2.5, 97.5])
                    ci[name] = (float(lo), float(hi))
            else:
                ci = {name: (float(theta[j]), float(theta[j]))
                      for j, name in enumerate(COEF_NAMES)}

        etas = self._fit_kernel_eta(kernel)
        for name, (_, interval) in etas.items():
            ci[f"eta:{name}"] = interval
        rates = self._fit_accept_rates(spec)

        profile = CalibrationProfile(
            ridge_scale=float(theta[0]), cpq_kappa=float(theta[1]),
            cpq_exp=float(theta[2]), phi_rho_ref=float(theta[3]),
            phi_t_slope=float(theta[4]),
            kernel_eta=tuple(sorted((k, v[0]) for k, v in etas.items())),
            accept_rates=tuple(sorted(rates.items())),
            ci=tuple(sorted(ci.items())),
            source="fit", n_traces=len(self.store))

        counts = self.store.counts()
        report = ResidualReport(
            rmse_default=rmse_default, rmse_fitted=rmse_fitted,
            n_energy=counts.get("energy", 0),
            n_kernel=counts.get("kernel", 0),
            n_step=counts.get("step", 0),
            n_dryrun=counts.get("dryrun", 0),
            n_spec=counts.get("spec", 0),
            coefficients={
                name: {"default": COEF_DEFAULTS[j],
                       "fitted": float(theta[j]),
                       "ci": list(ci.get(name, (float(theta[j]),
                                                float(theta[j]))))}
                for j, name in enumerate(COEF_NAMES)},
            kernel_eta={name: {"fitted": point, "ci": list(interval)}
                        for name, (point, interval) in etas.items()},
            accept_rates=dict(rates))
        return profile, report
