"""Where the device time of a launcher run goes.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch chatglm3-6b --requests 8 --samples 4 --prompt-len 256 \
        --max-new 32 [--kv-blocks 192] [--quant int4] [--kv-int8] \
        [--spec ngram|draft [--spec-n N]]

Takes the flags of ``repro_torch.launch.serve``. Serves the requests once
unprofiled (the timed run, reported as the launcher reports it), then the
same requests once more under ``torch.profiler``, which slows the host. It
prints, as ``[profile] {json}``, the device time of the top kernels, the
device time of each of the port's own kernels (``port_kernels``, by source:
``moe_gemm``, ``flash_attention``, ...; under each source ``by_kernel``,
each CUDA kernel's device time and launches, so that a source's routes
read apart: the paged and the dense decode kernel, the split-K, wgmma and
tiled dequant-matmul) whether or not it is among the top,
and the profiled run's device time. The timed run is traced (`repro_torch.obs`): the line adds
its CUDA graph captures, their host time, and its replays (one capture a
batch, a replay for each decode step after the first), and the host's mean
time a decode step
(``decode_step_ms``, the mean of its ``decode`` spans: enqueue, replay or
eager launches, and the wait for the step's tokens).

With ``--kv-pool`` the first pass over the requests fills the prefix pool
and every later pass finds each prompt's cached blocks there. So a pooled
run serves the requests once more before the timed run: that cold pass is
reported, traced the same way, under ``"cold"``, and the timed and the
profiled runs are both warm.

With ``--router`` each pass is the launcher's scheduled drain (a new
`ContinuousBatchingScheduler` over the same backend and router), and the
line adds the timed pass's ``"scheduler"`` numbers: batches, preemptions,
completed and cancelled requests, and pool hits.

With ``--spec`` the line adds the speculative numbers of the timed run:
verify forwards, the host's mean ms a verify (``verify_ms``, its
``verify`` spans: the enqueue of the forward or the graph's replay, and the
wait for its accept lengths and tokens) and a ``propose`` call
(``propose_ms``, its ``draft`` spans), the verify graphs' captures and
replays, and the drafts proposed and accepted.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import List, Optional

import torch

from repro_torch.kernels import build
from repro_torch.launch.serve import (parse_args, report,
                                      report_scheduler, setup)
from repro_torch.obs import make_observability


def kernel_name(symbol: str) -> str:
    """A CUDA kernel's function name from the profiler's symbol, demangled
    (``void (anonymous namespace)::sk::dequant_matmul_int8_splitk_kernel<4>(
    ...)``) or not (``_ZN12_GLOBAL__N_120moe_gemm_bf16_kernelILb1EEEv...``):
    its last name before the template arguments, so that instantiations sum
    under one name."""
    if symbol.startswith("_ZN"):
        names, i = [], 3
        while i < len(symbol) and symbol[i].isdigit():
            j = i
            while j < len(symbol) and symbol[j].isdigit():
                j += 1
            n = int(symbol[i:j])
            names.append(symbol[j:j + n])
            i = j + n
        if names:
            return names[-1]
    head = symbol.replace("(anonymous namespace)", "")
    names = re.findall(r"[A-Za-z_]\w*", head.split("(", 1)[0].split("<", 1)[0])
    return names[-1] if names else symbol


def profile_summary(prof, wall_s: float, top: int = 12) -> dict:
    """Device time by kernel from a ``torch.profiler`` trace, and its sum
    (``device_busy_s``: kernels of one stream do not overlap) beside the
    timed run's ``wall_s``. The device-side copies of ``record_function``
    ranges (the kernel scopes) are left out: they would count their
    kernels twice. Empty without device activity (a CPU run)."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    port = {}
    for source in build.SOURCES:     # kernel names carry their source's name
        hits = [r for r in rows if source in r[0]]
        if hits:
            us = sum(r[1] for r in hits)
            by_kernel = {}
            for name, k_us, n in hits:
                k = by_kernel.setdefault(kernel_name(name),
                                         {"device_ms": 0.0, "count": 0})
                k["device_ms"] += k_us / 1e3
                k["count"] += n
            port[source] = {"device_ms": us / 1e3, "share": us / busy_us,
                            "count": sum(r[2] for r in hits),
                            "by_kernel": by_kernel}
    return {"wall_s": wall_s, "device_busy_s": busy_us / 1e6,
            "kernels": [{"name": k[:120], "device_ms": us / 1e3,
                         "share": us / busy_us, "count": n}
                        for k, us, n in rows[:top]],
            "port_kernels": port}


def traced(serve, backend) -> tuple:
    """One traced serve: ``(results, wall seconds, stats)``, the stats its
    graph captures, their host ms, replays, decode steps, the host's mean
    ms a decode step, on a prefix pool the blocks its batches found cached
    (``pool_hit_blocks``) and, speculating, its verify numbers."""
    obs = make_observability()
    backend.set_obs(obs)
    before = dataclasses.replace(backend.graph_stats)
    results, dt = serve()
    backend.set_obs(None)
    steps = [s.t1_s - s.t0_s for s in obs.tracer.spans if s.name == "decode"]
    after = backend.graph_stats
    stats = {"graph_captures": after.captures - before.captures,
             "graph_capture_ms": 1e3 * (after.capture_s - before.capture_s),
             "graph_replays": after.replays - before.replays,
             "decode_steps": len(steps),
             "decode_step_ms": (1e3 * sum(steps) / len(steps)
                                if steps else None)}
    if backend.prefix_pool is not None:
        stats["pool_hit_blocks"] = obs.metrics.counter(
            "serving_prefix_pool_hits_total").value()
    if backend.spec_policy is not None:
        spans = {name: [s.t1_s - s.t0_s for s in obs.tracer.spans
                        if s.name == name] for name in ("verify", "draft")}
        stats.update(
            verify_forwards=len(spans["verify"]),
            verify_ms=(1e3 * sum(spans["verify"]) / len(spans["verify"])
                       if spans["verify"] else None),
            propose_ms=(1e3 * sum(spans["draft"]) / len(spans["draft"])
                        if spans["draft"] else None),
            verify_captures=after.verify_captures - before.verify_captures,
            verify_replays=after.verify_replays - before.verify_replays,
            spec_proposed=obs.metrics.counter(
                "serving_spec_proposed_total").value(),
            spec_accepted=obs.metrics.counter(
                "serving_spec_accepted_total").value())
    return results, dt, stats


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    serve, backend = setup(args)
    cold = None
    if backend.prefix_pool is not None:
        results, dt, stats = traced(serve, backend)
        print("[cold]", end=" ")
        report(args, results, dt)
        cold = dict(wall_s=dt, **stats)
    results, dt, stats = traced(serve, backend)
    sched = serve.scheduler
    if sched is not None:
        report_scheduler(args, sched, backend)
        st = sched.stats()
        stats["scheduler"] = {key: st[key] for key in (
            "completed", "cancelled", "batches", "preemptions_total",
            "pool_hit_blocks", "prefill_bytes_saved")}
    report(args, results, dt)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(args.device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        _, dt_prof = serve()
    summary = profile_summary(prof, dt)
    summary["profiled_wall_s"] = dt_prof
    summary.update(stats)
    if cold is not None:
        summary["cold"] = cold
    print("[profile] " + json.dumps(summary))


if __name__ == "__main__":
    main()
