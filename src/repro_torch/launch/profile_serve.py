"""Where the device time of a launcher run goes.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch chatglm3-6b --requests 8 --samples 4 --prompt-len 256 \
        --max-new 32 [--kv-blocks 192] [--quant int4] [--kv-int8]

Takes the flags of ``repro_torch.launch.serve``. Serves the requests once
unprofiled (the timed run, reported as the launcher reports it), then the
same requests once more under ``torch.profiler``, which slows the host. It
prints, as ``[profile] {json}``, the device time of the top kernels, the
device time of each of the port's own kernels (``port_kernels``, by source:
``moe_gemm``, ``flash_attention``, ...; under each source ``by_kernel``,
each CUDA kernel's device time and launches, so that a source's routes
read apart: the paged and the dense decode kernel, the split-K, wgmma and
tiled dequant-matmul) whether or not it is among the top,
and the device's busy share: the profiled run's device time over the timed
run's wall time. The timed run is traced (`repro_torch.obs`): the line adds
its CUDA graph captures, their host time, and its replays (one capture a
batch, a replay for each decode step after the first), and the host's mean
time a decode step
(``decode_step_ms``, the mean of its ``decode`` spans: enqueue, replay or
eager launches, and the wait for the step's tokens).
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import List, Optional

import torch

from repro_torch.kernels import build
from repro_torch.launch.serve import parse_args, report, setup
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
    """Device time by kernel from a ``torch.profiler`` trace, and the share
    of ``wall_s`` the device was busy (kernels of one stream do not
    overlap). The device-side copies of ``record_function`` ranges (the
    kernel scopes) are left out: they would count their kernels twice.
    Empty without device activity (a CPU run)."""
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
            "device_busy_share": busy_us / 1e6 / wall_s if rows else None,
            "kernels": [{"name": k[:120], "device_ms": us / 1e3,
                         "share": us / busy_us, "count": n}
                        for k, us, n in rows[:top]],
            "port_kernels": port}


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    serve, backend = setup(args)
    obs = make_observability()
    backend.set_obs(obs)
    before = dataclasses.replace(backend.graph_stats)
    results, dt = serve()
    backend.set_obs(None)
    report(args, results, dt)
    steps = [s.t1_s - s.t0_s for s in obs.tracer.spans if s.name == "decode"]
    after = backend.graph_stats
    graphs = {"graph_captures": after.captures - before.captures,
              "graph_capture_ms": 1e3 * (after.capture_s - before.capture_s),
              "graph_replays": after.replays - before.replays,
              "decode_steps": len(steps),
              "decode_step_ms": (1e3 * sum(steps) / len(steps)
                                 if steps else None)}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(args.device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        _, dt_prof = serve()
    summary = profile_summary(prof, dt)
    summary["profiled_wall_s"] = dt_prof
    summary.update(graphs)
    print("[profile] " + json.dumps(summary))


if __name__ == "__main__":
    main()
