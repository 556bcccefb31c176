"""Seeded request streams through the continuous-batching scheduler.

The reference drives its scheduler with seeded streams in its benches
(``benchmarks/serving_schedule.py``, ``benchmarks/kv_paging.py``); the port
replays them with these pieces:

* `stream_router` — the scheduling bench's router: a PGSAM anneal with the
  v2 energy model, and three SLA tiers whose caps come off the frontier at
  batches of 4 and 8.
* `poisson_stream` — Poisson arrivals on the router's simulated clock at an
  offered load relative to the standard tier's batch-of-1 makespan, each
  with a tier drawn from a mix and a prompt.
* `drive` — the benches' arrival loop: submit what has arrived by the
  simulated horizon, step the scheduler, and after each step let the
  caller act (`CsvetStop`, `ReleasedWriteProbe`).
* `CsvetStop` — CSVET early stopping as ``kv_paging.py`` simulates it.
* `ReleasedWriteProbe` — counts how often a block that an early-released
  row still writes into is held by a later batch on the resident pool.

All of it is duck-typed over the scheduler and its backend's handles, so a
parity test can drive the reference's scheduler with the same loop.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence, Set, Tuple

import numpy as np

from repro_torch.core import Constraints, Workload
from repro_torch.core.devices import EDGE_PLATFORM

#: the scheduling bench's tier mix (name, probability)
TIER_MIX = (("interactive", 0.3), ("standard", 0.4), ("economy", 0.3))
#: CSVET early stopping as ``benchmarks/kv_paging.py`` simulates it: from a
#: batch's second step, a request verifies with this probability a step
STOP_FROM_STEP, STOP_P = 2, 0.5


def stream_router(cfg, workload: Workload, provider=None):
    """The router of ``benchmarks/serving_schedule.py`` for ``cfg``: an
    incremental PGSAM anneal (v2 energy, seed 0, 1500 iterations) over the
    edge platform, and a `ParetoRouter` over ``workload`` with an
    interactive tier capped at 1.01x the frontier's fastest batch-of-4
    makespan, a standard tier at 1.05x its fastest batch-of-8 one, and an
    uncapped economy tier. ``provider`` (a `CalibratedSignalProvider`)
    anneals and routes on a fitted calibration profile."""
    from repro_torch.qeil2 import (PGSAMConfig, PGSAMOrchestrator,
                                   ParetoRouter, SLATier)
    orch = PGSAMOrchestrator(
        EDGE_PLATFORM, Constraints(latency_budget_factor=None),
        config=PGSAMConfig(seed=0, iters_max=1500, incremental=True),
        energy_model="v2", provider=provider)
    router = ParetoRouter(orch, cfg, workload)
    c4 = min(router.recost(a, router.batch_workload(4)).makespan_s
             for a in router.frontier)
    c8 = min(router.recost(a, router.batch_workload(8)).makespan_s
             for a in router.frontier)
    router.add_tier(SLATier("interactive", latency_p99_s=1.01 * c4,
                            energy_weight=0.0, latency_weight=1.0))
    router.add_tier(SLATier("standard", latency_p99_s=1.05 * c8,
                            energy_weight=0.5, latency_weight=0.5))
    router.add_tier(SLATier("economy", energy_weight=1.0,
                            latency_weight=0.0))
    return router


def poisson_stream(router, n_requests: int, offered_load: float,
                   rng: np.random.Generator,
                   prompt: Callable[[np.random.Generator], np.ndarray]
                   ) -> List[Dict]:
    """``n_requests`` arrivals ``{"t", "tier", "prompt"}``: exponential gaps
    at ``offered_load`` / the standard tier's batch-of-1 makespan, then the
    tier (`TIER_MIX`), then ``prompt(rng)``, drawn in that order per
    request."""
    svc = router.recost(router.route("standard").assignment,
                        router.batch_workload(1)).makespan_s
    rate = offered_load / svc
    names = [n for n, _ in TIER_MIX]
    probs = [p for _, p in TIER_MIX]
    t = 0.0
    out = []
    for _ in range(n_requests):
        t += rng.exponential(1.0 / rate)
        out.append({"t": t, "tier": names[rng.choice(len(names), p=probs)],
                    "prompt": prompt(rng)})
    return out


def drive(sched, arrivals: Sequence[Dict], n_samples: int,
          after_step: Sequence[Callable] = ()) -> float:
    """Replay ``arrivals`` through ``sched`` as the reference's benches do:
    submit every request that has arrived by the simulated horizon, jump
    the clock over idle gaps, step, and call each of ``after_step`` with
    the scheduler. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    i = 0
    while i < len(arrivals) or sched.queue.pending or sched.inflight:
        horizon = max(sched.clock, sched.pipeline_free_t)
        while i < len(arrivals) and arrivals[i]["t"] <= horizon:
            a = arrivals[i]
            adm = sched.submit(a["prompt"], tier=a["tier"],
                               n_samples=n_samples, arrival_s=a["t"])
            if not adm.admitted:
                raise RuntimeError(f"request {i} rejected: {adm.reason}")
            i += 1
        if not sched.queue.pending and not sched.inflight:
            sched.advance_to(arrivals[i]["t"])
            continue
        sched.step()
        for fn in after_step:
            fn(sched)
    return time.perf_counter() - t0


class CsvetStop:
    """Simulated CSVET early stopping (``benchmarks/kv_paging.py``): from a
    batch's step `STOP_FROM_STEP`, each in-flight request, once, with
    probability `STOP_P` from ``rng``, verifies and releases its samples
    1..k-1 through ``sched.early_stop``. ``released`` sums the blocks
    returned; ``probe`` (a `ReleasedWriteProbe`) is told of every
    release."""

    def __init__(self, rng: np.random.Generator, probe=None):
        self.rng = rng
        self.probe = probe
        self.stopped: Set[int] = set()
        self.released = 0

    def __call__(self, sched) -> None:
        for entry in list(sched.inflight):
            if entry.handle.step < STOP_FROM_STEP:
                continue
            off = 0
            for r in entry.requests:
                if r.id not in self.stopped and self.rng.random() < STOP_P:
                    self.stopped.add(r.id)
                    if self.probe is not None:
                        self.probe.note_release(
                            entry, range(off + 1, off + r.n_samples))
                    self.released += sched.early_stop(
                        r.id, list(range(1, r.n_samples)))
                off += r.n_samples


class ReleasedWriteProbe:
    """F8 on a scheduled stream: a row released early goes on writing one
    KV slot a decode step through its table, and on the resident pool the
    blocks it released may be handed to a later batch. ``note_release``
    records the blocks each released row will still write into (its
    positions from the next decode step to the batch's last). Called after
    each scheduler step, and before the step's releases, the probe counts
    in ``hits`` every (block, batch) pair in which a batch formed in that
    step holds such a block of a batch that was still decoding. Per-batch
    pools are separate memory, so only pooled batches count."""

    def __init__(self):
        self.hits = 0
        # batch id -> (its in-flight entry, blocks its released rows write)
        self._live: Dict[int, Tuple[object, Set[int]]] = {}
        self._seen: Set[int] = set()           # batch ids already counted

    def note_release(self, entry, rows: Sequence[int]) -> None:
        h = entry.handle
        if h.paged is None or not h.paged.pooled:
            return
        bs = h.paged.block_size
        first = h.plen + h.step - 1            # the next decode step's slot
        last = h.plen + h.max_new - 2          # the batch's last written slot
        blocks = {int(h.paged.decode_table[i][p // bs])
                  for i in rows for p in range(first, last + 1)}
        if blocks:
            self._live.setdefault(entry.record.batch_id,
                                  (entry, set()))[1].update(blocks)

    def __call__(self, sched) -> None:
        # a batch preempted in this step stopped writing before the step
        # formed its batches; one that retired in it wrote after that
        for key, (entry, _) in list(self._live.items()):
            if entry.record.preempted is not None:
                del self._live[key]
        hazard: Set[int] = set()
        for _, held in self._live.values():
            hazard |= held
        for e in sched.inflight:
            if e.record.batch_id in self._seen:
                continue
            self._seen.add(e.record.batch_id)
            p = e.handle.paged
            if hazard and p is not None and p.pooled:
                self.hits += len(hazard & {int(g) for g in
                                           np.asarray(p.decode_table).ravel()})
        live = {e.record.batch_id for e in sched.inflight}
        for key in [k for k in self._live if k not in live]:
            del self._live[key]                 # its rows stopped writing
