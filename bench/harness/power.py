"""The card's power draw, sampled beside the window by ``nvidia-smi``.

`PowerSampler` runs ``nvidia-smi --query-gpu=power.draw -lms <period>`` for
the cards a run uses, reads each sample with the host's clock as it
arrives, and integrates the draw over a time range (trapezoids between
samples, the first and last sample held to the range's ends). The child
process is stopped and waited for in `stop`.
"""
from __future__ import annotations

import subprocess
import threading
import time
from typing import List, Tuple


class PowerSampler:
    def __init__(self, indices: List[int], period_ms: int = 100):
        self.samples: List[Tuple[float, float]] = []    # (t, watts summed)
        self._proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits", "-lms", str(period_ms),
             "-i", ",".join(str(i) for i in indices)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._n = len(indices)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self) -> None:
        batch: List[float] = []
        for line in self._proc.stdout:
            try:
                batch.append(float(line.strip()))
            except ValueError:
                continue
            if len(batch) == self._n:
                self.samples.append((time.perf_counter(), sum(batch)))
                batch = []

    def stop(self) -> None:
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._thread.join(timeout=10)

    def energy_j(self, t0: float, t1: float) -> float | None:
        """Joules over [t0, t1] (host perf_counter seconds), or None with
        fewer than two samples in the range."""
        pts = [(t, w) for t, w in self.samples if t0 <= t <= t1]
        if len(pts) < 2:
            return None
        e = pts[0][1] * (pts[0][0] - t0) + pts[-1][1] * (t1 - pts[-1][0])
        for (ta, wa), (tb, wb) in zip(pts, pts[1:]):
            e += 0.5 * (wa + wb) * (tb - ta)
        return e
