"""Repeated-sampling inference with a quality-verification cascade.

Implements the paper's inference-time scaling loop (Brown et al.-style repeated
sampling, Section 2.1) on top of the serving engine, plus the quality-verification
cascade the orchestration is entangled with: a cheap verifier (sequence logprob /
self-consistency screening) gates which candidates reach the expensive exact
verifier, so verification cost scales with the *surviving* candidate count.

Two modes:
  * ``run_pass_at_k`` — real sampling with a trained model on verifiable tasks
    (the arith generator), producing true pass@k outcome matrices for the
    formalism fits.
  * ``simulate_outcomes`` — Bernoulli simulation from Formalism 1 (used by the
    paper-scale benches where running a 2.6B model is not possible here).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.fitting import empirical_coverage
from repro_torch.core.formalisms import CoverageParams, coverage


# ------------------------------------------------------------------ cascade

@dataclass
class CascadeStats:
    candidates: int = 0
    cheap_passed: int = 0
    exact_checked: int = 0
    exact_passed: int = 0
    skipped: int = 0          # CSVET: exact checks cut short by early stopping

    @property
    def verification_savings(self) -> float:
        """Fraction of exact-verifier calls avoided by the cheap screen."""
        if self.candidates == 0:
            return 0.0
        return 1.0 - self.exact_checked / self.candidates


class VerifierCascade:
    """cheap screen (logprob threshold + majority clustering) -> exact check.

    With ``early_stop`` (CSVET — cheap-score verified early termination), exact
    verification runs in descending cheap-score order and halts once a verified
    pass is found: the pass@k outcome for the batch is ``any(pass)``, so once
    one candidate passes, the remaining candidates — whose cheap-score upper
    bound is at most the already-passing candidate's — cannot change it.
    """

    def __init__(self, exact_verify: Callable[[np.ndarray], bool],
                 logprob_quantile: float = 0.5,
                 always_check_top: int = 1,
                 early_stop: bool = False, obs=None):
        self.exact_verify = exact_verify
        self.q = logprob_quantile
        self.always_check_top = always_check_top
        self.early_stop = early_stop
        self.stats = CascadeStats()
        # optional repro_torch.obs bundle: per-exact-check "verify" spans (wall
        # clock — the exact verifier is real host work) + cascade counters
        from repro_torch.obs import NULL_OBS
        self.obs = obs if obs is not None else NULL_OBS
        self._m = None
        if self.obs.metrics.enabled:
            reg = self.obs.metrics
            self._m = {
                "candidates": reg.counter(
                    "cascade_candidates_total",
                    "Samples entering the verification cascade"),
                "exact_checked": reg.counter(
                    "cascade_exact_checked_total",
                    "Exact-verifier invocations"),
                "exact_passed": reg.counter(
                    "cascade_exact_passed_total",
                    "Exact-verifier passes"),
                "skipped": reg.counter(
                    "cascade_skipped_total",
                    "Exact checks avoided by CSVET early stopping"),
            }

    def verify(self, samples: Sequence[np.ndarray],
               logprobs: Sequence[float],
               request_id: Optional[int] = None) -> List[bool]:
        """``request_id`` (optional) stamps the emitted verify/early_stop
        spans so verification time attributes to the serving request."""
        n = len(samples)
        self.stats.candidates += n
        if self._m is not None:
            self._m["candidates"].inc(n)
        lp = np.asarray(logprobs, float)
        thresh = np.quantile(lp, self.q) if n > 1 else -np.inf
        order = np.argsort(-lp)
        survivors = set(np.nonzero(lp >= thresh)[0].tolist())
        survivors |= set(order[: self.always_check_top].tolist())
        self.stats.cheap_passed += len(survivors)

        # early_stop checks best-cheap-score first so a pass is found with as
        # few exact calls as possible; without it, keep the original index
        # order (order is observable only through the verifier's side effects).
        check_order = [i for i in order.tolist() if i in survivors] \
            if self.early_stop else [i for i in range(n) if i in survivors]
        out = [False] * n
        found_pass = False
        tracer = self.obs.tracer
        for pos, i in enumerate(check_order):
            if found_pass:
                skipped = len(check_order) - pos
                self.stats.skipped += skipped
                if self._m is not None:
                    self._m["skipped"].inc(skipped)
                if tracer.enabled:
                    import time
                    tracer.emit("early_stop", time.perf_counter(),
                                clock="wall", request_id=request_id,
                                skipped=skipped)
                break
            self.stats.exact_checked += 1
            if tracer.enabled:
                import time
                t0 = time.perf_counter()
                out[i] = bool(self.exact_verify(samples[i]))
                tracer.emit("verify", t0, time.perf_counter(), clock="wall",
                            request_id=request_id, sample=i, passed=out[i])
            else:
                out[i] = bool(self.exact_verify(samples[i]))
            self.stats.exact_passed += int(out[i])
            if self._m is not None:
                self._m["exact_checked"].inc()
                self._m["exact_passed"].inc(int(out[i]))
            if out[i] and self.early_stop:
                found_pass = True
        return out


# ------------------------------------------------------------------ real runs

@dataclass
class PassAtKResult:
    outcomes: np.ndarray              # (n_tasks, n_samples) bool
    coverage_by_k: Dict[int, float]
    cascade: CascadeStats
    decode_tokens: int
    prefill_tokens: int


def run_pass_at_k(engine, tasks: Sequence[Tuple[np.ndarray, Callable]],
                  n_samples: int, noise=None,
                  budgets: Sequence[int] = (1, 2, 5, 10, 20),
                  logprob_quantile: float = 0.5) -> PassAtKResult:
    """tasks: (prompt, exact_verifier) pairs. Samples n_samples per task with
    the engine, verifies through the cascade, returns pass@k estimates.
    ``noise`` (a `repro_torch.serving.backend.NoiseSource`) is the caller's
    sampling noise; None takes the engine's default generator."""
    prompts = [t[0] for t in tasks]
    results = engine.generate(prompts, n_samples=n_samples, noise=noise)
    outcomes = np.zeros((len(tasks), n_samples), bool)
    stats = CascadeStats()
    dec_toks = pre_toks = 0
    for i, ((_, verify), res) in enumerate(zip(tasks, results)):
        cascade = VerifierCascade(verify, logprob_quantile)
        flags = cascade.verify(res.samples, res.logprobs)
        outcomes[i] = flags
        s = cascade.stats
        for f in dataclasses.fields(CascadeStats):
            setattr(stats, f.name,
                    getattr(stats, f.name) + getattr(s, f.name))
        dec_toks += res.decode_tokens
        pre_toks += res.prefill_tokens
    cov = empirical_coverage(outcomes, budgets)
    return PassAtKResult(outcomes, cov, stats, dec_toks, pre_toks)


# ------------------------------------------------------------------ simulate

DIFFICULTY_SIGMA = 1.4   # lognormal spread calibrated so fitted beta ~ 0.70


def rate_for_target(target_cov: float, S_ref: int = 20,
                    sigma: float = DIFFICULTY_SIGMA,
                    n_mc: int = 200_000, seed: int = 123) -> float:
    """Solve for the per-sample base rate giving pass@S_ref == target_cov under
    lognormal task-difficulty heterogeneity (deterministic MC + bisection)."""
    rng = np.random.default_rng(seed)
    diff = rng.lognormal(mean=-sigma ** 2 / 2, sigma=sigma, size=n_mc)

    def cov_at(rate1: float) -> float:
        q = 1.0 - np.exp(-rate1 * diff)
        return float(np.mean(1.0 - (1.0 - q) ** S_ref))

    lo, hi = 1e-6, 50.0
    for _ in range(80):
        mid = np.sqrt(lo * hi)
        if cov_at(mid) < target_cov:
            lo = mid
        else:
            hi = mid
    return float(np.sqrt(lo * hi))


def simulate_outcomes(n_tasks: int, n_samples: int,
                      target_cov: float = 0.70, S_ref: int = 20,
                      sigma: float = DIFFICULTY_SIGMA,
                      seed: int = 0) -> np.ndarray:
    """Bernoulli outcome matrix whose pass@k tracks Formalism 1.

    Heavy-tailed (lognormal) per-task difficulty is what bends the coverage
    curve from beta=1 (homogeneous Bernoulli) to the paper's beta ~ 0.7; sigma
    is calibrated so the fitted exponent lands in the paper's [0.66, 0.76]
    band while pass@S_ref hits ``target_cov``.
    """
    rng = np.random.default_rng(seed)
    rate1 = rate_for_target(target_cov, S_ref, sigma)
    diff = rng.lognormal(mean=-sigma ** 2 / 2, sigma=sigma, size=n_tasks)
    q = 1.0 - np.exp(-rate1 * diff)
    return rng.random((n_tasks, n_samples)) < q[:, None]


def adaptive_sample_budget(N_millions: float, T: float, target_cov: float,
                           max_samples: int = 64,
                           p: CoverageParams = CoverageParams()) -> int:
    """Paper's 'adaptive sample budget' component: smallest S hitting the
    coverage target (inverse of Formalism 1), capped."""
    from repro_torch.core.formalisms import samples_for_coverage
    s = samples_for_coverage(target_cov, N_millions, T, p)
    return int(min(max(np.ceil(s), 1), max_samples))
