"""Serving launcher: batched requests through the engine with the QEIL
greedy orchestration plan and safety monitoring in the loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \
        --requests 8 --samples 4 --prompt-len 256 --max-new 32 --kv-blocks 256 \
        [--quant int8|int4 [--group-size 32]] [--kv-int8] \
        [--kv-pool [--pool-evict lru|off]] [--prefill-chunk N] \
        [--router [--tier T | --mixed] [--max-batch N] [--preempt]
         [--deadline F] [--chaos PLAN.json]] \
        [--metrics-out FILE [--metrics-interval S]] [--spans-out FILE]

Weights are random, drawn from a seeded ``torch.Generator``. On ``cuda``
(the default) the model runs in bf16 with ``use_kernel=True``: prefill goes
through the flash attention kernel and decode through the dense or paged
decode kernel; the kernels are built and one short request is served before
the timed run. ``--quant int8|int4`` quantizes the weights after init
(`repro_torch.quant.quantize_model`): every linear layer then runs a
dequant-matmul kernel. ``--kv-int8`` keeps the paged KV pools in int8, which
the paged decode kernel does not read: decode attention then takes the plain
gather path, as in the reference. MoE archs run their expert products
through the grouped-GEMM kernel, and Mamba-2 layers (``--arch mamba2-370m``,
``--arch jamba-v0.1-52b``) their prefill through the SSD chunk kernel; archs
without a paged layout (MLA, SSM) serve dense only and refuse
``--kv-blocks``. ``--kv-pool`` serves the paged cache as one resident
prefix pool that outlives batches (a prompt whose leading blocks are cached
prefills only its tail), and ``--prefill-chunk N`` prefills in slices of at
most N tokens; both need ``--kv-blocks``. The launcher serves the full
depth of the arch, and all 32 layers of jamba-v0.1-52b (103 GB of bf16
weights) do not fit one 80 GB card. ``--device cpu`` runs the plain
PyTorch path; ``--smoke`` serves the arch's reduced config in f32.
``repro_torch.launch.profile_serve`` takes the same flags and says where the
device time goes.

``--router`` serves as the reference's ``launch/serve.py --router`` does:
a PGSAM anneal builds the non-dominated archive once, requests enter
tier-aware admission, and the continuous-batching scheduler forms
(optionally mixed-tier, with ``--mixed``) batches routed to shared
operating points off the archive (`repro_torch.serving.scheduler` +
`repro_torch.qeil2.runtime`) and drives the backend with them.
``--preempt``, ``--deadline`` and ``--chaos`` need ``--router``. Without
it the blocking ``ServingEngine.generate`` path serves one greedy plan.
``--metrics-out`` and ``--spans-out`` write the run's metrics snapshot
(JSON + ``.prom``; with ``--router`` refreshed every ``--metrics-interval``
simulated seconds while the scheduler drains) and its spans (JSONL).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.core import (Constraints, EDGE_PLATFORM, GreedyOrchestrator,
                              SafetyMonitor, Workload)
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.models import Model
from repro_torch.models.cache import paged_supported
from repro_torch.obs import NULL_OBS, PeriodicReporter, make_observability
from repro_torch.quant import param_bytes, quant_workload, quantize_model
from repro_torch.serving import (ContinuousBatchingScheduler,
                                 ExecutionBackend, GumbelNoise,
                                 SchedulerConfig, ServingEngine)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ASSIGNED_ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config in f32")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="paged KV cache: block budget (prefix sharing "
                         "across repeated samples; supported archs only)")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="paged KV cache: token slots per block")
    ap.add_argument("--quant", default="bf16",
                    choices=["bf16", "int8", "int4"],
                    help="weight-only serving format (repro_torch.quant): "
                         "linear layers run the dequant-matmul kernels")
    ap.add_argument("--group-size", type=int, default=32,
                    help="int4 quantization group size along d_in")
    ap.add_argument("--kv-int8", action="store_true",
                    help="store the paged KV cache int8 (needs --kv-blocks; "
                         "halves cache bytes per token slot)")
    ap.add_argument("--kv-pool", action="store_true",
                    help="resident prefix pool: one paged cache shared by "
                         "every batch, cached prompt blocks reused across "
                         "batches (needs --kv-blocks)")
    ap.add_argument("--pool-evict", default="lru", choices=["lru", "off"],
                    help="prefix-pool eviction of idle (zero-ref) trie "
                         "blocks: lru reclaims them, off never does")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: slices of at most this many "
                         "tokens, one a decode step (needs --kv-blocks)")
    ap.add_argument("--router", action="store_true",
                    help="scheduler-centric serving: tier-aware admission "
                         "+ continuous batching over the PGSAM archive")
    ap.add_argument("--tier", default="standard",
                    choices=["interactive", "standard", "economy"],
                    help="SLA tier to serve requests under (--router)")
    ap.add_argument("--mixed", action="store_true",
                    help="round-robin requests over all three tiers so "
                         "batches mix tiers (--router)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="scheduler batch size bound (--router)")
    ap.add_argument("--preempt", action="store_true",
                    help="decode-boundary preemption (--router): an "
                         "interactive arrival may cut a lower-tier "
                         "in-flight batch; with --kv-pool the victim's "
                         "blocks park in the trie and resume prefills "
                         "only the tail")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-tier deadline factor (--router): cancel a "
                         "queued request once it waits longer than "
                         "FACTOR x its tier's p99 latency cap")
    ap.add_argument("--chaos", default=None, metavar="PLAN.json",
                    help="fault-injection plan (repro_torch.serving.chaos "
                         "JSON) replayed on the simulated clock through "
                         "the SafetyMonitor into the live scheduler")
    ap.add_argument("--metrics-out", default=None,
                    help="write a metrics snapshot (JSON + .prom sibling) "
                         "here; with --router, refreshed periodically while "
                         "the scheduler drains")
    ap.add_argument("--metrics-interval", type=float, default=5.0,
                    help="simulated seconds between periodic metrics writes")
    ap.add_argument("--spans-out", default=None,
                    help="write request lifecycle spans (JSONL) here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels on) or cpu (plain PyTorch path)")
    return ap.parse_args(argv)


def build_router(cfg, w):
    """The reference launcher's router: a PGSAM anneal over the edge
    platform, and a `ParetoRouter` with the default tiers scaled to the
    archive's fastest point. Prints the archive and each tier's route, and
    returns ``(router, plan)``: ``router`` is None (and ``plan`` the
    infeasible report) when no operating point places the model."""
    from repro_torch.qeil2 import (PGSAMConfig, PGSAMOrchestrator,
                                   ParetoRouter, default_tiers)
    orch = PGSAMOrchestrator(
        EDGE_PLATFORM, Constraints(latency_budget_factor=None),
        config=PGSAMConfig(seed=0, incremental=True))
    frontier = orch.pareto_frontier(cfg, w)
    placed = [a for a in frontier if a.mapping]
    if not placed:
        print(f"[router] no placeable operating point: "
              f"{'; '.join(frontier[0].violations)}")
        return None, frontier[0]
    base = min(a.latency_s for a in placed) / 0.9
    router = ParetoRouter(orch, cfg, w, tiers=default_tiers(base))
    print(f"[router] archive {len(placed)} operating points")
    for name, d in sorted(router.route_all().items()):
        print(f"[router] tier {name:12s} -> point {d.point_index:2d} "
              f"E={d.energy_j:.2f} J T={d.latency_s * 1e3:.1f} ms "
              f"P={d.avg_power_w:.1f} W caps_met={d.meets_caps}")
    return router, None


def setup(args: argparse.Namespace
          ) -> Tuple[Callable[[], Tuple[list, float]], ExecutionBackend]:
    """Build the model, plan the workload, draw the prompts and, on the
    card, build and warm the kernels. Returns ``serve()``, which serves the
    requests once and gives ``(results, wall seconds)``, and the backend it
    serves through."""
    if args.kv_int8 and args.kv_blocks is None:
        raise SystemExit("--kv-int8 requires --kv-blocks (paged cache)")
    if args.kv_pool and args.kv_blocks is None:
        raise SystemExit("--kv-pool requires --kv-blocks (paged cache)")
    if args.prefill_chunk is not None and args.kv_blocks is None:
        raise SystemExit("--prefill-chunk requires --kv-blocks (paged "
                         "cache)")
    if (args.chaos or args.preempt or args.deadline) and not args.router:
        raise SystemExit("--chaos/--preempt/--deadline need --router "
                         "(the continuous-batching scheduler)")
    obs = (make_observability() if args.metrics_out or args.spans_out
           else NULL_OBS)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    on_card = dev.type == "cuda"
    model = Model(cfg, dtype=torch.float32 if args.smoke else torch.bfloat16,
                  device=dev, use_kernel=on_card)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    print(f"[model] {cfg.name}: {model.param_count() / 1e9:.3f} B params, "
          f"{model.dtype}, device={dev}, kernels={'on' if on_card else 'off'}")
    if args.quant != "bf16":
        before = param_bytes(params)
        params = quantize_model(params, args.quant, args.group_size)
        print(f"[quant] weights {args.quant}: {before / 1e6:.1f} MB -> "
              f"{param_bytes(params) / 1e6:.1f} MB")
    kv_format = "int8" if args.kv_int8 else "bf16"

    # --- QEIL plan for this workload (simulated edge platform profile)
    w = quant_workload(Workload(batch=args.requests,
                                prompt_tokens=args.prompt_len,
                                decode_tokens=args.max_new,
                                samples=args.samples), args.quant,
                       kv_format=kv_format)
    router = None
    if args.router:
        router, plan = build_router(cfg, w)
        if router is not None:
            plan = router.route(args.tier).assignment
    else:
        plan = GreedyOrchestrator(EDGE_PLATFORM,
                                  Constraints(latency_budget_factor=1.0)
                                  ).assign(cfg, w)
    print(f"[orchestrator] devices={plan.device_names()} "
          f"energy={plan.energy_j:.2f} J latency={plan.latency_s * 1e3:.1f} ms "
          f"feasible={plan.feasible}")

    safety = SafetyMonitor(EDGE_PLATFORM, max_seq_len=args.prompt_len * 4,
                           vocab_size=cfg.vocab_size)
    rng = np.random.default_rng(0)
    prompts = []
    for _ in range(args.requests):
        p = rng.integers(0, cfg.vocab_size,
                         size=(args.prompt_len,)).astype(np.int32)
        check = safety.validator.validate(p, now_s=time.time() % 1e6)
        if not check.ok:
            print("[safety] rejected request:", check.reason)
            continue
        prompts.append(p)

    extras = {}
    if cfg.frontend == "vision":
        extras["vision_embeds"] = np.zeros((len(prompts), 4, cfg.d_model),
                                           np.float32)

    if args.kv_blocks is None:
        backend = ExecutionBackend(model, params, obs=obs)
    else:
        if not paged_supported(cfg):
            raise SystemExit(f"--kv-blocks: arch {cfg.name!r} unsupported "
                             "for paging")
        backend = ExecutionBackend(model, params, kv_blocks=args.kv_blocks,
                                   kv_block_size=args.kv_block_size,
                                   kv_format=kv_format, kv_pool=args.kv_pool,
                                   pool_evict=args.pool_evict,
                                   prefill_chunk=args.prefill_chunk, obs=obs)
        print(f"[kv] paged cache: {args.kv_blocks} blocks x "
              f"{args.kv_block_size} slots ({kv_format}, "
              f"{backend.kv_token_bytes} B/token)")
        if args.kv_pool:
            print(f"[kv] resident prefix pool: cross-batch block reuse, "
                  f"evict={args.pool_evict}")
        if args.prefill_chunk:
            print(f"[kv] chunked prefill: <= {args.prefill_chunk} tokens "
                  "per slice, interleaved with decode")
    engine = ServingEngine(model, params, max_new_tokens=args.max_new,
                           temperature=args.temperature, backend=backend)
    if on_card:
        t0 = time.perf_counter()
        build.build()
        # a prompt whose first token starts none of the served prompts
        # shares no block with them: on a prefix pool it caches nothing
        # they could hit
        warm = prompts[0].copy()
        warm[0] = min(set(range(cfg.vocab_size))
                      - {int(p[0]) for p in prompts})
        engine.generate([warm], n_samples=1, max_new_tokens=2,
                        extras={k: v[:1] for k, v in extras.items()})
        torch.cuda.synchronize()
        print(f"[warm-up] kernels built and one request served in "
              f"{time.perf_counter() - t0:.1f}s")

    def serve() -> Tuple[list, float]:
        t0 = time.perf_counter()
        if router is not None:
            serve.scheduler, out = serve_scheduled(
                args, router, backend, prompts, extras, cfg.vocab_size, obs)
        else:
            noise = GumbelNoise(torch.Generator(device=dev).manual_seed(0))
            out = engine.generate(prompts, n_samples=args.samples,
                                  noise=noise, extras=extras)
        if on_card:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    serve.scheduler = None
    serve.obs = obs
    return serve, backend


def serve_scheduled(args: argparse.Namespace, router, backend, prompts,
                    extras, vocab_size: int, obs):
    """The reference launcher's ``--router`` drain: submit every prompt
    (tiers round-robin with ``--mixed``) to a new scheduler over
    ``backend`` and run it until idle, replaying the ``--chaos`` plan and
    writing periodic metrics between steps. Returns the scheduler and the
    results of the requests it completed, in submission order."""
    sched = ContinuousBatchingScheduler(
        backend, router,
        SchedulerConfig(max_batch_requests=args.max_batch,
                        max_new_tokens=args.max_new,
                        temperature=args.temperature, preempt=args.preempt,
                        deadline_factor=args.deadline), obs=obs)
    chaos = None
    if args.chaos:
        from repro_torch.serving.chaos import FaultPlan, attach
        plan_doc = FaultPlan.load(args.chaos)
        safety = SafetyMonitor(EDGE_PLATFORM, max_seq_len=args.prompt_len * 4,
                               vocab_size=vocab_size)
        chaos = attach(plan_doc, safety, sched)
        print(f"[chaos] plan seed={plan_doc.seed}: "
              f"{len(plan_doc.actions)} actions")
    tiers = (["interactive", "standard", "economy"] if args.mixed
             else [args.tier])
    ids = []
    for i, p in enumerate(prompts):
        row = {k: np.asarray(v)[i] for k, v in extras.items()} or None
        adm = sched.submit(p, tier=tiers[i % len(tiers)],
                           n_samples=args.samples, extras=row)
        if adm.admitted:
            ids.append(adm.request_id)
        else:
            print(f"[admission] rejected request {i}: {adm.reason}")
    reporter = (PeriodicReporter(obs.metrics, args.metrics_out,
                                 interval_s=args.metrics_interval)
                if args.metrics_out and obs.metrics.enabled else None)
    while sched.queue.pending or sched.inflight:
        if chaos is not None:
            for act in chaos.apply_due(sched.clock):
                print(f"[chaos] t={act.t_s:.2f}s {act.kind} "
                      f"{act.device or ''}".rstrip())
        if not sched.step():
            break
        if reporter is not None:
            reporter.maybe_write(sched.clock)
    done = sched.completed
    # lifecycle policies may cancel (deadline/shed); report completions
    return sched, [done[i].result for i in ids if i in done]


def report_scheduler(args: argparse.Namespace, sched, backend) -> None:
    """The reference launcher's ``[robustness]``, ``[scheduler]`` and
    pooled ``[kv]`` lines for one scheduled drain."""
    st = sched.stats()
    if st["preemptions_total"] or st["cancelled"]:
        print(f"[robustness] preemptions={st['preemptions']} "
              f"deadline_misses={st['deadline_misses']} "
              f"retries={st['retries_total']} shed={st['shed_total']} "
              f"resume_tail/full={st['resume_tail_tokens']}/"
              f"{st['resume_full_tokens']} tokens")
    for rec in sched.records:
        pool = ""
        if args.kv_pool:
            pool = (f" pool_hits={rec.pool_hit_blocks}"
                    f" evict={rec.pool_evictions}")
        print(f"[scheduler] batch {rec.batch_id}: "
              f"{rec.n_requests} req ({rec.tier_mix}) -> point "
              f"{rec.point_index} E={rec.energy_j * 1e3:.2f} mJ "
              f"T={rec.latency_s * 1e3:.2f} ms "
              f"queue={rec.queue_delay_s * 1e3:.2f} ms "
              f"caps_met={rec.meets_caps}{pool}")
    if backend.prefix_pool is not None:
        resident = backend.prefix_pool.blocks_resident
        cached = resident * args.kv_block_size * backend.kv_token_bytes
        print(f"[kv] prefix pool: {st['pool_hit_blocks']} hit blocks, "
              f"{st['pool_evictions']} evictions, "
              f"{st['prefill_bytes_saved'] / 1e3:.1f} kB prefill "
              f"saved; {resident} blocks resident "
              f"({cached / 1e3:.1f} kB cached)")


def report(args: argparse.Namespace, results: list, dt: float) -> None:
    n_tok = sum(r.decode_tokens for r in results)
    print(f"[serve] {len(results)} requests x {args.samples} samples, "
          f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.0f} tok/s)")
    for i, r in enumerate(results[:3]):
        print(f"  req {i}: best logprob {max(r.logprobs):.3f}")


def write_obs(args: argparse.Namespace, obs) -> None:
    if args.metrics_out and obs.metrics.enabled:
        obs.metrics.write(args.metrics_out)
        print(f"[obs] metrics snapshot -> {args.metrics_out} (+ .prom)")
    if args.spans_out and obs.tracer.enabled:
        obs.tracer.save(args.spans_out)
        print(f"[obs] {len(obs.tracer)} spans -> {args.spans_out}")


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    serve, backend = setup(args)
    results, dt = serve()
    if serve.scheduler is not None:
        report_scheduler(args, serve.scheduler, backend)
    report(args, results, dt)
    write_obs(args, serve.obs)


if __name__ == "__main__":
    main()
