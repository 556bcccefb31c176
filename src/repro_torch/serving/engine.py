"""Serving engine: batched prefill + autoregressive decode with KV caches.

Ported from ``repro.serving.engine``: a thin *blocking* loop over
`repro_torch.serving.backend.ExecutionBackend`. One ``generate`` call groups
its prompts by length, runs each group start to finish through the backend's
step API, and returns. Repeated sampling tiles each prompt ``n_samples``
times so all samples of a request decode in one batch.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.serving.backend import (ExecutionBackend, GenerationResult,
                                         GumbelNoise, NoiseSource)


class ServingEngine:
    def __init__(self, model: Model, params, max_new_tokens: int = 32,
                 temperature: float = 0.8, eos_token: Optional[int] = None,
                 placement_provider: Optional[Callable] = None,
                 backend: Optional[ExecutionBackend] = None, obs=None):
        self.model = model
        self.params = params
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos_token = eos_token
        # placement hook: called once per `generate` with (n_prompts,
        # n_samples); returns the orchestrator's operating point for the call
        self.placement_provider = placement_provider
        # obs only shapes the default-constructed backend; an explicit
        # backend keeps whatever bundle it was built with
        self.backend = backend if backend is not None else \
            ExecutionBackend(model, params, eos_token=eos_token, obs=obs)

    @property
    def last_placement(self):
        return self.backend.last_placement

    @property
    def placements(self):
        return self.backend.placements

    # ------------------------------------------------------------------ public
    def generate(self, prompts: Sequence[np.ndarray], n_samples: int = 1,
                 max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None,
                 noise: Optional[NoiseSource] = None,
                 extras: Optional[Dict] = None) -> List[GenerationResult]:
        """Generate ``n_samples`` completions per prompt.

        ``noise`` supplies the Gumbel draws of sampling, batch after batch in
        order (default: `GumbelNoise` over a generator seeded 0 on the
        backend's device); greedy decoding (temperature 0) draws none."""
        max_new = max_new_tokens or self.max_new_tokens
        temp = temperature if temperature is not None else self.temperature
        if noise is None:
            dev = self.backend.device
            noise = GumbelNoise(torch.Generator(device=dev).manual_seed(0))
        extras = extras or {}

        if self.placement_provider is not None:
            self.backend.note_placement(
                self.placement_provider(len(prompts), n_samples))

        results: List[Optional[GenerationResult]] = [None] * len(prompts)
        by_len: Dict[int, List[int]] = {}
        for i, p in enumerate(prompts):
            by_len.setdefault(len(p), []).append(i)

        for plen, idxs in by_len.items():
            for chunk in self._budget_chunks(idxs, plen, n_samples, max_new):
                row_extras = {k: np.asarray(v)[chunk]
                              for k, v in extras.items()}
                h = self.backend.start_batch([prompts[i] for i in chunk],
                                             n_samples, max_new, temp, noise,
                                             row_extras)
                while self.backend.decode_step(h):
                    pass
                for i, r in zip(chunk, self.backend.finalize(h)):
                    results[i] = r
        return results  # type: ignore[return-value]

    def _budget_chunks(self, idxs: List[int], plen: int, n_samples: int,
                       max_new: int) -> List[List[int]]:
        """Split one prompt-length group so every chunk fits the backend's
        KV budget (blocks or slots); an unbounded backend keeps the whole
        group as one batch."""
        capacity = getattr(self.backend, "capacity_total", None)
        if capacity is None:
            return [idxs]
        cost = self.backend.request_cost(plen, max_new, n_samples)
        if cost > capacity:
            raise ValueError(
                f"one request needs {cost} KV budget units but the backend "
                f"only has {capacity}; lower n_samples/max_new_tokens or "
                "raise the budget")
        per_chunk = max(1, capacity // cost)
        return [idxs[i:i + per_chunk] for i in range(0, len(idxs), per_chunk)]
