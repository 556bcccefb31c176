"""Per-kernel profiling: timed reps of the port's kernel call sites, emitted
as TraceStore-ingestible ``kind="kernel"`` records.

The counterpart of ``repro.launch.profile``, at its five jobs, shapes and
dtypes (f32): causal flash attention, dense decode attention, the SSD chunk
scan, and the fused dequant-matmul in int8 and in int4. Each job's FLOP and
byte counts are the reference's analytic ones (``cost_source:
"analytic"``), the counts the reference itself stamps when the compiler
reports none; each record prices them against the modeled H100
(`repro_torch.obs.gpu_roofline_us`). Timed reps run under
`repro_torch.obs.annotate`, so they are attributable in a profiler trace,
and the dequant records carry their ``quant`` stamp, so the calibration
fitter keys them as ``dequant_matmul:int8`` / ``dequant_matmul:int4``
(`repro_torch.qeil2.telemetry.fit._eta_key`).

On the card the wrappers launch the hand-written kernels (built before the
first timed call, so no rep times ``nvcc``) and their launch counters grow
by one a call; with ``--device cpu`` they run their plain versions, which
says nothing about the card. At these small f32 shapes a call on the card
is bound by its launch, not by its flops or bytes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.profile \\
      --out traces/kernels.jsonl
  PYTHONPATH=src python -m repro_torch.launch.profile --device cpu \\
      --kernels dequant_matmul
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.devices import CLOUD_GPU
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.profiling import annotate, gpu_roofline_us


def _time_reps(fn: Callable, args: tuple, sync: Callable[[], None],
               n: int = 3, label: str = "kernel") -> List[float]:
    """Per-rep us/call, warm call excluded; each rep annotated for the
    profiler and timed on the host around a synchronisation."""
    fn(*args)
    sync()
    out = []
    for _ in range(n):
        with annotate(f"profile/{label}"):
            t0 = time.perf_counter()
            fn(*args)
            sync()
            out.append((time.perf_counter() - t0) * 1e6)
    return out


def _records(kernel: str, reps: List[float], flops: float,
             bytes_moved: float, backend: str,
             quant: str = "fp32") -> List[dict]:
    roofline = gpu_roofline_us(flops, bytes_moved)
    return [{"kind": "kernel", "kernel": kernel, "rep": i,
             "flops": flops, "bytes": bytes_moved,
             "measured_us": us, "roofline_us": roofline,
             "device": CLOUD_GPU.name, "backend": backend,
             "cost_source": "analytic", "quant": quant}
            for i, us in enumerate(reps)]


def _jobs(dev: torch.device) -> List[Tuple[str, Callable, tuple, float,
                                           float, str]]:
    """The reference's five jobs: (name, wrapper, inputs on ``dev``,
    analytic flops, analytic bytes, quant), inputs from one seeded
    generator."""
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention_cache
    from repro_torch.kernels.dequant_matmul.ops import dequant_matmul
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_chunk
    from repro_torch.quant import quantize_int4, quantize_int8

    g = torch.Generator().manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float32)

    def on(*ts):
        return tuple(t.to(dev) for t in ts)

    jobs = []
    # flash attention (causal prefill tile)
    B, S, H, D = 1, 256, 4, 64
    jobs.append(("flash_attention", flash_attention,
                 on(normal(B, S, H, D), normal(B, S, H, D),
                    normal(B, S, H, D)),
                 4.0 * B * S * S / 2 * H * D, 4 * B * S * H * D * 4, "fp32"))

    # decode attention (cache streaming)
    W = 1024
    kc, vc = normal(2, W, 2, 64), normal(2, W, 2, 64)
    qd = normal(2, 1, 4, 64)
    pos = torch.arange(W, dtype=torch.int32)[None].repeat(2, 1)
    qpos = torch.full((2,), W - 1, dtype=torch.int32)
    jobs.append(("decode_attention", decode_attention_cache,
                 on(qd, kc, vc, pos, qpos),
                 4.0 * 2 * W * 4 * 64, 2 * W * 2 * 64 * 2 * 4, "fp32"))

    # ssd chunked scan
    nc, Q, P, N = 4, 64, 32, 64
    x = normal(2, nc, Q, 2, P)
    dt = torch.nn.functional.softplus(normal(2, nc, Q, 2))
    A = -torch.exp(normal(2))
    dA = dt * A[None, None, None]
    dAcs = torch.cumsum(dA, dim=2)
    Bm, Cm = normal(2, nc, Q, 2, N), normal(2, nc, Q, 2, N)
    jobs.append(("ssd_scan", ssd_chunk, on(x, dt, dA, dAcs, Bm, Cm),
                 2 * nc * (2 * Q * Q * 2 * (P + N)),
                 2 * nc * Q * 2 * (P + 2 * N) * 4, "fp32"))

    # fused dequant-matmul, both serving formats (quant-stamped records)
    M, Kd, Nd = 8, 256, 256
    xq, wq = normal(M, Kd), normal(Kd, Nd)
    fl_q = 2.0 * M * Kd * Nd
    for fmt, (qw, sc), wbytes in (
            ("int8", quantize_int8(wq), Kd * Nd),
            ("int4", quantize_int4(wq, 32), Kd * Nd // 2)):
        by_q = wbytes + sc.numel() * 4 + (M * Kd + M * Nd) * 4
        jobs.append(("dequant_matmul", dequant_matmul, on(xq, qw, sc),
                     fl_q, by_q, fmt))
    return jobs


def run(verbose: bool = True, reps: int = 3,
        kernels: Optional[List[str]] = None,
        device: DeviceLike = "cuda") -> Dict:
    """Profile the kernel call sites at the reference's profile shapes on
    ``device`` (the card unless the caller asks for ``"cpu"``) and return
    TraceStore-ingestible records plus per-kernel summaries."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build()

        def sync() -> None:
            torch.cuda.synchronize(dev)
    else:
        def sync() -> None:
            pass

    results: Dict = {"records": [], "kernels": []}
    with torch.no_grad():
        for name, fn, args, fl, by, quant in _jobs(dev):
            if kernels and name not in kernels:
                continue
            timed = _time_reps(fn, args, sync, n=reps, label=name)
            recs = _records(name, timed, fl, by, dev.type, quant=quant)
            summary = {"kernel": name, "quant": quant,
                       "cost_source": "analytic", "flops": fl, "bytes": by,
                       "mean_us": float(np.mean(timed)),
                       "roofline_us": recs[0]["roofline_us"]}
            results["records"] += recs
            results["kernels"].append(summary)
            if verbose:
                print(f"[profile] {name}"
                      f"{'[' + quant + ']' if quant != 'fp32' else '':8s} "
                      f"{summary['mean_us']:9.0f} us/call  "
                      f"roofline {summary['roofline_us']:8.2f} us  "
                      f"costs: {summary['cost_source']}")
    results["n_records"] = len(results["records"])
    return results


def main(argv: Optional[List[str]] = None) -> None:
    """The command line; ``argv`` in place of ``sys.argv[1:]``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="append kernel records to this JSONL trace")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--kernels", nargs="*", default=None,
                    help="subset of kernel names to profile")
    ap.add_argument("--profile-dir", default=None,
                    help="also write a torch.profiler chrome trace "
                         "(trace.json) into this dir")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    def profiled() -> Dict:
        return run(verbose=True, reps=args.reps, kernels=args.kernels,
                   device=args.device)

    if args.profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if resolve_device(args.device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            results = profiled()
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"[profile] torch.profiler trace -> {path}")
    else:
        results = profiled()

    if args.out:
        from repro_torch.qeil2.telemetry import TraceStore
        store = TraceStore(path=args.out)
        n = store.ingest_many(results["records"])
        print(f"appended {n} kernel records -> {args.out}")


if __name__ == "__main__":
    main()
