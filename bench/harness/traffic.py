"""The one traffic generator: requests from a mix's parameters and a seed.

A mix (``traffic/<name>.json``) gives the prompt and decode lengths, the
samples a request (k), the temperature, the SLA tiers with their shares, and
the load: ``"closed"`` keeps ``outstanding`` requests in the system, a new
one submitted as each completes; ``"open"`` sends Poisson arrivals at
``rate_per_s`` on the wall clock, whether or not the server keeps up.

Every seed gets the same work: the open loop's arrival times and its
multiset of tiers are drawn once, from a fixed seed, and the run's seed only
deals the tiers out in another order; prompts (token ids uniform over the
vocabulary) come from the run's seed. A tail over one window swings with
the arrivals' bursts, so each seed sees the same bursts. The arrivals of the open loop start ``warm_s`` before the window
opens, so that the window starts on a loaded queue.

Adapted from the port's ``serving/stream.py`` (`poisson_stream`,
`TIER_MIX`), whose arrivals lie on the scheduler's simulated clock; these
lie on the wall clock.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

#: the fixed seed of the work every run shares (gaps, tier multiset)
WORK_SEED = 20240601


@dataclass
class Request:
    index: int
    tier: str
    due_s: float          # open loop: seconds after the arrivals start
    prompt: np.ndarray    # (prompt_tokens,) int32


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(k) for k in key]))


def prompt(seed: int, index: int, length: int, vocab: int) -> np.ndarray:
    """Request ``index``'s prompt: token ids uniform over ``vocab``."""
    return _rng(seed, 1, index).integers(0, vocab, size=length,
                                         dtype=np.int64).astype(np.int32)


def tier_multiset(mix: Dict[str, Any], n: int) -> List[str]:
    """``n`` tiers in the mix's shares, drawn from the fixed seed."""
    names = [t for t, _ in mix["tiers"]]
    probs = np.asarray([p for _, p in mix["tiers"]], np.float64)
    idx = _rng(WORK_SEED, 2).choice(len(names), size=n, p=probs / probs.sum())
    return [names[i] for i in idx]


def schedule(mix: Dict[str, Any], seed: int, n: int):
    """``n`` arrivals' due times (seconds from the first arrival's start) and
    tiers: the times and the tier multiset are the fixed seed's, the order
    of the tiers the run's."""
    gaps = _rng(WORK_SEED, 3).exponential(1.0 / float(mix["rate_per_s"]),
                                          size=n)
    due = np.cumsum(gaps)
    tiers = tier_multiset(mix, n)
    torder = _rng(seed, 5).permutation(n)
    return due, [tiers[i] for i in torder]


def open_loop(mix: Dict[str, Any], seed: int, seconds: float,
              vocab: int) -> List[Request]:
    """The open loop's arrivals over ``warm_s + seconds``, due times in
    seconds from the first arrival's start."""
    horizon = float(mix["warm_s"]) + seconds
    n = int(math.ceil(float(mix["rate_per_s"]) * horizon * 1.5)) + 16
    due, tiers = schedule(mix, seed, n)
    return [Request(i, tiers[i], float(due[i]),
                    prompt(seed, i, mix["prompt_tokens"], vocab))
            for i in range(n) if due[i] <= horizon]


def closed_loop(mix: Dict[str, Any], seed: int, index: int,
                vocab: int) -> Request:
    """The closed loop's ``index``-th request (tiers in the mix's order,
    cycled)."""
    tiers = [t for t, _ in mix["tiers"]]
    return Request(index, tiers[index % len(tiers)], 0.0,
                   prompt(seed, index, mix["prompt_tokens"], vocab))
