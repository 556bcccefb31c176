"""Where the device time of a launcher run goes.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch chatglm3-6b --requests 8 --samples 4 --prompt-len 256 \
        --max-new 32 [--kv-blocks 192] [--quant int4] [--kv-int8]

Takes the flags of ``repro_torch.launch.serve``. Serves the requests once
unprofiled (the timed run, reported as the launcher reports it), then the
same requests once more under ``torch.profiler``, which slows the host. It
prints, as ``[profile] {json}``, the device time of the top kernels, the
device time of each of the port's own kernels (``port_kernels``, by source:
``moe_gemm``, ``flash_attention``, ...) whether or not it is among the top,
and the device's busy share: the profiled run's device time over the timed
run's wall time.
"""
from __future__ import annotations

import json
from typing import List, Optional

import torch

from repro_torch.kernels import build
from repro_torch.launch.serve import parse_args, report, setup


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
            port[source] = {"device_ms": us / 1e3, "share": us / busy_us,
                            "count": sum(r[2] for r in hits)}
    return {"wall_s": wall_s, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall_s if rows else None,
            "kernels": [{"name": k[:120], "device_ms": us / 1e3,
                         "share": us / busy_us, "count": n}
                        for k, us, n in rows[:top]],
            "port_kernels": port}


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    serve = setup(args)
    results, dt = serve()
    report(args, results, dt)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(args.device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        _, dt_prof = serve()
    summary = profile_summary(prof, dt)
    summary["profiled_wall_s"] = dt_prof
    print("[profile] " + json.dumps(summary))


if __name__ == "__main__":
    main()
