"""The Gumbel draws the benchmark hands the program, one stream a batch.

The scheduler asks its ``noise_for_batch(batch_id, requests)`` hook for each
batch's noise source; the program calls that source once a sampled token
position, for a (rows, vocab) draw. Here the j-th call of batch b draws from
a generator seeded by (run seed, stream, b, j), so that the reference can
draw the same noise again for any position of any batch after the window.
`BatchNoise` also records which requests a batch holds, in its row order,
and the shapes it was asked for.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def gumbel(seed: int, stream: int, batch: int, call: int,
           shape: Tuple[int, ...], device) -> torch.Tensor:
    s = np.random.SeedSequence([int(seed), int(stream), int(batch),
                                int(call)]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(s[0]) << 31 | int(s[1]) >> 1)
    u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class BatchNoise:
    """The noise source of one batch (``__call__(shape, device)``)."""

    def __init__(self, seed: int, stream: int, batch: int, device,
                 requests: List[Tuple[int, int]], formed_in_step: int):
        self.seed, self.stream, self.batch = seed, stream, batch
        self.device = torch.device(device)
        self.requests = requests            # (request id, samples), in order
        self.formed_in_step = formed_in_step
        self.shapes: List[Tuple[int, ...]] = []

    def __call__(self, shape, device) -> torch.Tensor:
        j = len(self.shapes)
        self.shapes.append(tuple(shape))
        return gumbel(self.seed, self.stream, self.batch, j, tuple(shape),
                      self.device).to(device)

    def draw(self, j: int) -> torch.Tensor:
        """The j-th draw again."""
        return gumbel(self.seed, self.stream, self.batch, j, self.shapes[j],
                      self.device)


class NoiseBook:
    """The ``noise_for_batch`` hook of one scheduler: a `BatchNoise` a
    batch, kept by batch id. ``step`` is the index of the scheduler step
    under way, which the runner sets."""

    def __init__(self, seed: int, stream: int, device):
        self.seed, self.stream, self.device = seed, stream, device
        self.batches: Dict[int, BatchNoise] = {}
        self.step = 0

    def __call__(self, batch_id: int, requests) -> BatchNoise:
        src = BatchNoise(self.seed, self.stream, batch_id, self.device,
                         [(r.id, r.n_samples) for r in requests], self.step)
        self.batches[batch_id] = src
        return src
