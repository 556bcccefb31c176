"""Serving launcher: batched requests through the engine with the QEIL
greedy orchestration plan and safety monitoring in the loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \
        --requests 8 --samples 4 --prompt-len 256 --max-new 32 --kv-blocks 256 \
        [--quant int8|int4 [--group-size 32]] [--kv-int8]

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
``--kv-blocks``. The launcher serves the full depth of the arch, and all 32
layers of jamba-v0.1-52b (103 GB of bf16 weights) do not fit one 80 GB
card. ``--device cpu`` runs the plain PyTorch path; ``--smoke`` serves the
arch's reduced config in f32.
``repro_torch.launch.profile_serve`` takes the same flags and says where the
device time goes.
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
from repro_torch.quant import param_bytes, quant_workload, quantize_model
from repro_torch.serving import ExecutionBackend, GumbelNoise, ServingEngine


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
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels on) or cpu (plain PyTorch path)")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace
          ) -> Tuple[Callable[[], Tuple[list, float]], ExecutionBackend]:
    """Build the model, plan the workload, draw the prompts and, on the
    card, build and warm the kernels. Returns ``serve()``, which serves the
    requests once and gives ``(results, wall seconds)``, and the backend it
    serves through."""
    if args.kv_int8 and args.kv_blocks is None:
        raise SystemExit("--kv-int8 requires --kv-blocks (paged cache)")
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
        backend = ExecutionBackend(model, params)
    else:
        if not paged_supported(cfg):
            raise SystemExit(f"--kv-blocks: arch {cfg.name!r} unsupported "
                             "for paging")
        backend = ExecutionBackend(model, params, kv_blocks=args.kv_blocks,
                                   kv_block_size=args.kv_block_size,
                                   kv_format=kv_format)
        print(f"[kv] paged cache: {args.kv_blocks} blocks x "
              f"{args.kv_block_size} slots ({kv_format}, "
              f"{backend.kv_token_bytes} B/token)")
    engine = ServingEngine(model, params, max_new_tokens=args.max_new,
                           temperature=args.temperature, backend=backend)
    if on_card:
        t0 = time.perf_counter()
        build.build()
        engine.generate(prompts[:1], n_samples=1, max_new_tokens=2,
                        extras={k: v[:1] for k, v in extras.items()})
        torch.cuda.synchronize()
        print(f"[warm-up] kernels built and one request served in "
              f"{time.perf_counter() - t0:.1f}s")

    def serve() -> Tuple[list, float]:
        noise = GumbelNoise(torch.Generator(device=dev).manual_seed(0))
        t0 = time.perf_counter()
        out = engine.generate(prompts, n_samples=args.samples, noise=noise,
                              extras=extras)
        if on_card:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    return serve, backend


def report(args: argparse.Namespace, results: list, dt: float) -> None:
    n_tok = sum(r.decode_tokens for r in results)
    print(f"[serve] {len(results)} requests x {args.samples} samples, "
          f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.0f} tok/s)")
    for i, r in enumerate(results[:3]):
        print(f"  req {i}: best logprob {max(r.logprobs):.3f}")


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    serve, _ = setup(args)
    report(args, *serve())


if __name__ == "__main__":
    main()
