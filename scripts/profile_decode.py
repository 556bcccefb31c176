"""Time the decode steps of a launcher serve on the host, in any checkout
of the PyTorch port, beside that checkout's own profile: one method for a
change and its parent.

    PYTHONPATH=<checkout>/src python scripts/profile_decode.py \
        <flags of repro_torch.launch.profile_serve>

Runs the checkout's ``repro_torch.launch.profile_serve`` (its ``[serve]``
and ``[profile]`` lines as it prints them) with
``ExecutionBackend.decode_step`` timed on the host clock, then prints
``[decode-host] {"steps": n, "mean_ms": x}`` over the decode steps of the
timed serve: of the steps of the widest batches (the warm-up request is
one sequence), the first half; the profiled serve makes the other half.
A step's time covers its launches (or its graph's replay) and the wait for
its tokens on the host.
"""
import json
import sys
import time

from repro_torch.launch import profile_serve
from repro_torch.serving.backend import ExecutionBackend


def main(argv) -> None:
    calls = []
    step = ExecutionBackend.decode_step

    def timed(self, h):
        t0 = time.perf_counter()
        try:
            return step(self, h)
        finally:
            calls.append((h.n_sequences, time.perf_counter() - t0))

    ExecutionBackend.decode_step = timed
    try:
        profile_serve.main(argv)
    finally:
        ExecutionBackend.decode_step = step
    width = max(n for n, _ in calls)
    wide = [dt for n, dt in calls if n == width]
    timed_run = wide[:len(wide) // 2]
    print("[decode-host] " + json.dumps({
        "steps": len(timed_run), "sequences": width,
        "mean_ms": 1e3 * sum(timed_run) / len(timed_run)}))


if __name__ == "__main__":
    main(sys.argv[1:])
