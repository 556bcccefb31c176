"""The scheduling bench's stream (benchmarks/serving_schedule.py), replayed on
the PyTorch port.

    PYTHONPATH=src python scripts/port_serving_schedule.py --device cpu \
        [--out FILE]
    python benchmarks/compare.py benchmarks/baselines/serving_schedule.json \
        FILE --bench serving_schedule

The same seeded Poisson stream (48 requests at an offered load of 1.6, tiers
0.3 / 0.4 / 0.3, prompts of 12 tokens, 2 samples of 8 tokens) goes through
the port's `ContinuousBatchingScheduler` over its `ExecutionBackend` (the
bench's 2-layer model, random f32 weights from the seed), the router the
bench builds (`repro_torch.serving.stream.stream_router`), and the bench's
analytic per-call baseline. The artifact has the bench's fields: the
scheduler's and the per-call policy's throughput, per-tier p95 latency and
IPW on the simulated clock, and the obs gate (sampled tokens and
log-probabilities equal with tracing off and on, every request's span
lifecycle complete, the wall-clock overhead). Sampling draws the port's
own noise (the scheduler's per-batch generator), so the sampled tokens are
the port's, not the reference's; no other field depends on them. The
script imports neither JAX nor the reference package. ``--device`` is
``cuda`` unless the caller asks for ``cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import Workload
from repro_torch.device import resolve_device
from repro_torch.models import ArchConfig, Model
from repro_torch.obs import (NULL_OBS, lifecycles_complete,
                             make_observability)
from repro_torch.qeil2 import TraceStore
from repro_torch.serving import (ContinuousBatchingScheduler,
                                 ExecutionBackend, SchedulerConfig)
from repro_torch.serving.stream import drive, poisson_stream, stream_router

SEED = 0
N_REQUESTS = 48
PROMPT_LEN = 12
MAX_NEW = 8
SAMPLES = 2
OFFERED_LOAD = 1.6
ARCH = dict(name="sched-bench", arch_type="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64)


def _sampled(sched) -> Dict[int, Tuple]:
    return {rid: ([s.tolist() for s in c.result.samples],
                  [float(lp) for lp in c.result.logprobs])
            for rid, c in sched.completed.items()}


def _run_scheduler(backend, router, arrivals,
                   obs=None) -> Tuple[Dict, object]:
    trace = TraceStore()
    sched = ContinuousBatchingScheduler(
        backend, router,
        SchedulerConfig(max_batch_requests=8, max_inflight_batches=2,
                        max_new_tokens=MAX_NEW, seed=SEED), trace=trace,
        obs=obs)
    wall_s = drive(sched, arrivals, SAMPLES)
    s = sched.stats()
    return {
        "completed": s["completed"],
        "batches": s["batches"],
        "mean_batch_requests": s["mean_batch_requests"],
        "caps_met_fraction": s["caps_met_fraction"],
        "throughput_rps": s["completed"] / s["makespan_s"],
        "p95_latency_s": s["latency_p95_s"],
        "energy_j": s["energy_j"],
        "ipw_seq_per_j": s["sequences"] / max(s["energy_j"], 1e-12),
        "serve_trace_records": len(trace.records("serve")),
        "wall_s": wall_s,
    }, sched


def _run_per_call(router, arrivals) -> Dict:
    """The bench's analytic baseline: each request alone at its tier's
    routed point, serialized in arrival order."""
    free = energy = 0.0
    lat: Dict[str, List[float]] = {}
    for a in arrivals:
        costs = router.recost(router.route(a["tier"]).assignment,
                              router.batch_workload(1))
        start = max(a["t"], free)
        free = start + costs.makespan_s
        energy += costs.energy_j
        lat.setdefault(a["tier"], []).append(free - a["t"])
    n = len(arrivals)
    return {"completed": n, "throughput_rps": n / free,
            "p95_latency_s": {t: float(np.percentile(v, 95))
                              for t, v in sorted(lat.items())},
            "energy_j": energy,
            "ipw_seq_per_j": n * SAMPLES / max(energy, 1e-12)}


def _obs_gate(backend, router, arrivals, reference) -> Dict:
    """Replay the stream over the warm backend twice, tracing off then on:
    sampled tokens equal, lifecycles complete, overhead measured."""
    wall_off, wall_on = [], []
    obs_sched = None
    for _ in range(2):
        off, _ = _run_scheduler(backend, router, arrivals)
        wall_off.append(off["wall_s"])
        obs = make_observability()
        backend.set_obs(obs)
        try:
            on, obs_sched = _run_scheduler(backend, router, arrivals, obs)
        finally:
            backend.set_obs(NULL_OBS)
        wall_on.append(on["wall_s"])
    tracer = obs_sched.obs.tracer
    t_off, t_on = min(wall_off), min(wall_on)
    return {"parity_ok": _sampled(obs_sched) == reference,
            "span_lifecycle_ok": bool(lifecycles_complete(
                tracer.spans, expect_requests=len(reference))),
            "n_spans": len(tracer), "wall_off_s": t_off, "wall_on_s": t_on,
            "overhead_frac": t_on / t_off - 1.0,
            "overhead_ok": t_on / t_off - 1.0 < 0.05}


def run(device: str) -> Dict:
    dev = resolve_device(device)
    cfg = ArchConfig(**ARCH)
    router = stream_router(cfg, Workload(batch=1, prompt_tokens=PROMPT_LEN,
                                         decode_tokens=MAX_NEW,
                                         samples=SAMPLES))
    arrivals = poisson_stream(
        router, N_REQUESTS, OFFERED_LOAD, np.random.default_rng(SEED),
        lambda rng: rng.integers(0, cfg.vocab_size,
                                 size=(PROMPT_LEN,)).astype(np.int32))
    model = Model(cfg, dtype=torch.float32, device=dev,
                  use_kernel=dev.type == "cuda")
    backend = ExecutionBackend(
        model, model.init(torch.Generator(device=dev).manual_seed(SEED)))
    sched, sched_obj = _run_scheduler(backend, router, arrivals)
    base = _run_per_call(router, arrivals)
    obs = _obs_gate(backend, router, arrivals, _sampled(sched_obj))
    p95_ok = {t: sched["p95_latency_s"][t] <= v * (1 + 1e-9)
              for t, v in base["p95_latency_s"].items()}
    return {
        "seed": SEED, "n_requests": N_REQUESTS, "offered_load": OFFERED_LOAD,
        "device": str(dev),
        "scheduler": sched, "per_call": base,
        "throughput_ratio": sched["throughput_rps"] / base["throughput_rps"],
        "ipw_ratio": sched["ipw_seq_per_j"] / base["ipw_seq_per_j"],
        "p95_no_worse": p95_ok, "obs": obs,
        "acceptance_all": bool(
            sched["throughput_rps"] > base["throughput_rps"]
            and all(p95_ok.values())
            and sched["ipw_seq_per_j"] >= base["ipw_seq_per_j"]
            and sched["completed"] == N_REQUESTS
            and obs["parity_ok"] and obs["span_lifecycle_ok"]),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    t0 = time.perf_counter()
    res = run(args.device)
    print(json.dumps(res, indent=2))
    print(f"[port_serving_schedule] {time.perf_counter() - t0:.1f}s, "
          f"acceptance_all={res['acceptance_all']}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=2)


if __name__ == "__main__":
    main()
