"""The speculative-decode bench (benchmarks/spec_decode.py), replayed on the
PyTorch port.

    PYTHONPATH=src python scripts/port_spec_decode.py --device cpu \
        [--out FILE]
    python benchmarks/compare.py benchmarks/baselines/spec_decode.json \
        FILE --bench spec_decode

The same seeded mixed-tier greedy stream (10 requests, prompts of 16
tokens, 12 new tokens, draft depth 4, paged KV of 160 blocks of 4) goes
through the port's `ContinuousBatchingScheduler`, the router the bench
builds (PGSAM over the v2 energy model, the bench's tier caps) and a
`SpecPlanner` over depths 0, 2 and 4, three ways: ``off`` (plain decode),
``ngram`` (prompt lookup) and ``draft`` (draft model = target model, which
greedy verify accepts entirely). The bench's 2-layer model has random f32
weights from the seed. After each speculating variant the calibration loop
runs: `CalibrationFitter` fits the accept rates from the scheduler's "spec"
trace records, the planner refreshes and one economy batch is routed again.
Before the variants, greedy speculative decode is held to plain greedy
decode on the engine path (tokens equal, logprobs within 3e-5). The
artifact has the bench's fields; it adds the device. The script imports
neither JAX nor the reference package. ``--device`` is ``cuda`` unless the
caller asks for ``cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core import Constraints, Workload
from repro_torch.core.devices import EDGE_PLATFORM
from repro_torch.device import resolve_device
from repro_torch.models import ArchConfig, Model
from repro_torch.qeil2 import (PGSAMConfig, PGSAMOrchestrator, ParetoRouter,
                               SLATier)
from repro_torch.qeil2.telemetry import CalibrationFitter, TraceStore
from repro_torch.serving import (ContinuousBatchingScheduler,
                                 ExecutionBackend, SchedulerConfig)
from repro_torch.spec import SpecPlanner, make_draft_policy

SEED = 0
N_REQUESTS = 10
PROMPT_LEN = 16
MAX_NEW = 12
K_SAMPLES = 1
SPEC_N = 4
BLOCK_SIZE = 4
KV_BLOCKS = 160
TIER_MIX = (("interactive", 0.3), ("standard", 0.4), ("economy", 0.3))
SPEEDUP_FLOOR = 1.5            # committed tokens per decode forward, draft
LOGPROB_ATOL = 3e-5            # one verify forward vs n one-token forwards

ARCH = dict(name="spec-bench", arch_type="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64)


def build_router():
    """The bench's router: latency caps off the frontier at a batch of 8
    (feasible by construction), economy pure energy."""
    cfg = ArchConfig(**ARCH)
    w = Workload(batch=1, prompt_tokens=PROMPT_LEN, decode_tokens=MAX_NEW,
                 samples=K_SAMPLES)
    orch = PGSAMOrchestrator(
        EDGE_PLATFORM, Constraints(latency_budget_factor=None),
        config=PGSAMConfig(seed=SEED, iters_max=1500, incremental=True),
        energy_model="v2")
    router = ParetoRouter(orch, cfg, w)
    c8 = min(router.recost(a, router.batch_workload(8)).makespan_s
             for a in router.frontier)
    router.add_tier(SLATier("interactive", latency_p99_s=1.05 * c8,
                            energy_weight=0.0, latency_weight=1.0))
    router.add_tier(SLATier("standard", latency_p99_s=1.25 * c8,
                            energy_weight=0.5, latency_weight=0.5))
    router.add_tier(SLATier("economy", energy_weight=1.0,
                            latency_weight=0.0))
    return cfg, router


def arrivals() -> List[Dict]:
    """The bench's stream, drawn from one ``default_rng(SEED)``."""
    rng = np.random.default_rng(SEED)
    names = [n for n, _ in TIER_MIX]
    probs = [p for _, p in TIER_MIX]
    t, out = 0.0, []
    for _ in range(N_REQUESTS):
        t += rng.exponential(0.5)
        out.append({"t": t, "tier": names[rng.choice(len(names), p=probs)],
                    "prompt": rng.integers(0, ARCH["vocab_size"],
                                           size=(PROMPT_LEN,)
                                           ).astype(np.int32)})
    return out


def make_backend(model, params, policy) -> ExecutionBackend:
    kw = {"spec_policy": policy, "spec_n": SPEC_N} if policy else {}
    return ExecutionBackend(model, params, kv_blocks=KV_BLOCKS,
                            kv_block_size=BLOCK_SIZE, **kw)


def generate(backend, prompts):
    """Engine-path greedy generation: prefill and decode to completion."""
    h = backend.start_batch(prompts, 1, MAX_NEW, 0.0, None, {})
    while backend.decode_step(h):
        pass
    return backend.finalize(h)


def parity(model, params, prompts) -> Dict:
    """Greedy speculative decode gives plain greedy decode's tokens, and
    its logprobs within the reduction-order tolerance."""
    ref = generate(make_backend(model, params, None), prompts)
    out = {}
    for kind in ("ngram", "draft"):
        policy = make_draft_policy(kind, draft_model=model,
                                   draft_params=params)
        got = generate(make_backend(model, params, policy), prompts)
        out[kind] = {
            "tokens_equal": all(np.array_equal(a.samples[0], b.samples[0])
                                for a, b in zip(ref, got)),
            "logprobs_allclose": all(
                np.allclose(a.logprobs, b.logprobs, atol=LOGPROB_ATOL)
                for a, b in zip(ref, got))}
    return out


def run_variant(kind: str, cfg, router, model, params,
                stream: List[Dict]) -> Dict:
    """Serve the stream once with draft policy ``kind`` (``off``: none);
    for a speculating variant, then fit the accept rates, refresh the
    planner and route one economy batch again."""
    policy = (make_draft_policy(kind, draft_model=model, draft_params=params)
              if kind != "off" else None)
    backend = make_backend(model, params, policy)
    planner = (SpecPlanner(kind, depths=(0, SPEC_N // 2, SPEC_N),
                           model_name=cfg.name) if policy else None)
    trace = TraceStore()
    sched = ContinuousBatchingScheduler(
        backend, router,
        SchedulerConfig(max_batch_requests=8, max_inflight_batches=2,
                        max_new_tokens=MAX_NEW, temperature=0.0, seed=SEED),
        trace=trace, spec_planner=planner)
    # decode forwards are the bench's time unit: each re-streams the weights
    decode_calls = 0
    inner = backend.decode_step

    def counted(h):
        nonlocal decode_calls
        decode_calls += 1
        return inner(h)

    backend.decode_step = counted
    i = 0
    while i < len(stream) or sched.queue.pending or sched.inflight:
        horizon = max(sched.clock, sched.pipeline_free_t)
        while i < len(stream) and stream[i]["t"] <= horizon:
            a = stream[i]
            adm = sched.submit(a["prompt"], tier=a["tier"],
                               n_samples=K_SAMPLES, temperature=0.0,
                               arrival_s=a["t"])
            if not adm.admitted:
                raise RuntimeError(f"request {i} refused: {adm.reason}")
            i += 1
        if not sched.queue.pending and not sched.inflight:
            sched.advance_to(stream[i]["t"])
            continue
        sched.step()

    recs = list(sched.records)
    completed = len(sched.completed)
    n_seqs = completed * K_SAMPLES
    # the first token of every sequence is sampled at prefill
    tps = (n_seqs * MAX_NEW - n_seqs) / max(decode_calls, 1)
    energy = sum(r.energy_j for r in recs)
    proposed = sum(r.spec_proposed for r in recs)
    accepted = sum(r.spec_accepted for r in recs)
    out = {
        "policy": kind,
        "completed": completed,
        "batches": len(recs),
        "decode_forwards": int(decode_calls),
        "tokens_per_forward": float(tps),
        "energy_j": float(energy),
        "energy_per_request_j": float(energy / max(completed, 1)),
        "ipw": completed / energy,
        "proposed": int(proposed),
        "accepted": int(accepted),
        "accept_rate": (accepted / proposed) if proposed else None,
        "routed_depths": sorted({r.spec_n for r in recs}),
        "leaks": int(backend.allocator.blocks_in_use),
    }
    if policy is not None:
        profile, _ = CalibrationFitter(trace, n_bootstrap=0).fit()
        planner.refresh(profile)
        d = planner.route_batch(router, ["economy"] * 4, samples=K_SAMPLES,
                                prompt_tokens=PROMPT_LEN,
                                decode_tokens=MAX_NEW)
        out["fitted_accept_rate"] = float(planner.accept_rate_for("economy"))
        out["refit_depth"] = int(d.spec.n)
    return out


def run(device: str) -> Dict:
    dev = resolve_device(device)
    cfg, router = build_router()
    model = Model(ArchConfig(**ARCH), dtype=torch.float32, device=dev,
                  use_kernel=dev.type == "cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    stream = arrivals()
    par = parity(model, params, [a["prompt"] for a in stream[:4]])
    by_kind = {kind: run_variant(kind, cfg, router, model, params, stream)
               for kind in ("off", "ngram", "draft")}
    off, ng, dr = by_kind["off"], by_kind["ngram"], by_kind["draft"]
    speedup = dr["tokens_per_forward"] / off["tokens_per_forward"]
    return {
        "seed": SEED,
        "spec_n": SPEC_N,
        "device": str(dev),
        "parity": par,
        "variants": by_kind,
        "tokens_per_forward_ratio": float(speedup),
        "energy_ratio_draft": dr["energy_per_request_j"] /
        off["energy_per_request_j"],
        "acceptance_all": bool(
            all(v["completed"] == N_REQUESTS for v in by_kind.values()) and
            all(v["leaks"] == 0 for v in by_kind.values()) and
            all(p["tokens_equal"] and p["logprobs_allclose"]
                for p in par.values()) and
            speedup >= SPEEDUP_FLOOR and
            dr["energy_per_request_j"] <= off["energy_per_request_j"] *
            (1 + 1e-9) and
            dr["ipw"] >= off["ipw"] and
            dr["accept_rate"] is not None and dr["accept_rate"] > 0.99 and
            ng["accept_rate"] is not None and ng["accept_rate"] < 0.3 and
            dr["fitted_accept_rate"] > 0.99 and
            ng["fitted_accept_rate"] < 0.3 and
            dr["refit_depth"] == SPEC_N and
            ng["refit_depth"] == 0),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    t0 = time.perf_counter()
    res = run(args.device)
    print(json.dumps(res, indent=2))
    print(f"[port_spec_decode] {time.perf_counter() - t0:.1f}s, "
          f"acceptance_all={res['acceptance_all']}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=2)


if __name__ == "__main__":
    main()
