"""Draft policies for speculative decode.

Ported from ``repro.spec.policy``. A draft policy proposes ``n``
continuation tokens per sequence from the request's committed token
history; the backend then scores all of them (plus the last committed
token) in ONE verify forward and keeps the longest accepted prefix
(`repro_torch.spec.verify`). Two policies ship behind the `DraftPolicy`
protocol:

* `NGramDraftPolicy`: model-free self-speculation (prompt lookup): the
  longest recent suffix of the sequence's own history that re-occurs earlier
  predicts its historical continuation. Zero extra FLOPs; the accept rate is
  whatever self-similarity the stream has.
* `DraftModelPolicy`: a (smaller) model from the serving zoo rolls out
  greedily over the committed context. Stateless by construction: every
  propose left-pads contexts into a fixed-width bucket and runs cache-free
  forwards, so there is no draft-side KV cache to roll back on rejection.

Policies are host-side (numpy in, numpy out); only the verify forward runs
against the target model's cache.
"""
from __future__ import annotations

from typing import Optional, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import Model


@runtime_checkable
class DraftPolicy(Protocol):
    """Proposes draft continuations from per-sequence token histories."""
    name: str

    def propose(self, histories: Sequence[np.ndarray],
                n: int) -> np.ndarray:
        """histories: one 1-D int array per sequence (prompt + committed
        tokens, oldest first). Returns proposed continuations (B, n) int32.
        Proposals are *deterministic* given the histories: the verify step's
        accept/reject treats them as point-mass distributions."""
        ...


def spec_supported(cfg: ArchConfig) -> bool:
    """Speculative verify covers the same shape of stack as paged caching
    plus single-codebook heads: every mixer is attention (SSM state updates
    are one-token-sequential), no MLA, no sliding window (a ring cache of
    width ``window`` would let a verify step's tail writes evict slots that
    earlier query tokens of the same step still attend to), no
    cross-attention, one codebook."""
    return (all(m == "a" for m in cfg.pattern)
            and cfg.mla is None
            and cfg.attn_window is None
            and not cfg.cross_attention
            and cfg.n_codebooks == 1)


class NGramDraftPolicy:
    """Self-speculative prompt-lookup drafting.

    For each sequence, find the longest suffix (length ``max_ngram`` down to
    ``min_ngram``) of its history that also occurs earlier, and propose the
    tokens that followed that earlier occurrence (latest match wins: recent
    repetition is the better predictor). Falls back to repeating the last
    token, which the verify step then rejects at the model's discretion: a
    bad draft costs compute, never correctness.
    """

    def __init__(self, max_ngram: int = 4, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(f"bad ngram range [{min_ngram}, {max_ngram}]")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.name = "ngram"

    def propose(self, histories: Sequence[np.ndarray],
                n: int) -> np.ndarray:
        out = np.zeros((len(histories), n), np.int32)
        for b, h in enumerate(histories):
            out[b] = self._propose_one(np.asarray(h, np.int64).ravel(), n)
        return out

    def _propose_one(self, h: np.ndarray, n: int) -> np.ndarray:
        """The reference's search, with the scan over earlier start
        positions done by numpy on all of them at once (the reference
        compares one slice at a time in Python, which dominates a
        ``propose`` of long histories)."""
        draft = np.zeros((n,), np.int32)
        L = len(h)
        if L == 0:
            return draft
        draft[:] = h[-1]                      # fallback: repeat last token
        for k in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            # windows h[i:i + k] for every earlier start i <= L - k - 1
            windows = np.lib.stride_tricks.sliding_window_view(h[:L - 1], k)
            hits = np.flatnonzero((windows == h[L - k:]).all(axis=1))
            if hits.size:
                i = int(hits[-1])             # latest earlier occurrence
                cont = h[i + k:i + k + n]     # non-empty: i + k <= L - 1
                draft[:len(cont)] = cont
                if len(cont) < n:
                    draft[len(cont):] = cont[-1]
                return draft
        return draft


class DraftModelPolicy:
    """Greedy rollout of a draft model (usually a reduced config from the
    same zoo) over the committed context.

    Layout per propose: contexts right-align into a fixed-width bucket of
    ``ceil((l_max + n) / bucket) * bucket`` columns with ``n`` rollout
    columns on the right; pad columns carry negative positions, which the
    masked attention path (`repro_torch.models.attention.causal_mask`)
    masks out, so padding never leaks into real positions. Then ``n``
    cache-free forwards, each writing its argmax into the next column. The
    reference projects every column to the vocabulary and reads one; the
    port projects only that one (``Model.forward(logits_at=)``), which is
    most of a rollout's work at a full vocabulary (32 rows x 320 columns x
    65024 tokens for chatglm3-6b).

    The rollout runs ``model``'s config and weights through a `Model` of its
    own with ``use_kernel=False``. A cache-free forward with the kernels on
    goes to the flash attention kernel, whose positions are an iota from 0:
    it would let each left-padded row attend to its pad keys. The reference
    serves with its kernels off, so its drafts come from the masked plain
    path too; the target model keeps its kernels for the verify.
    """

    def __init__(self, model: Model, params, bucket: int = 64):
        self.model = Model(model.cfg, dtype=model.dtype, device=model.device,
                           use_kernel=False)
        self.params = params
        self.bucket = max(int(bucket), 8)
        self.name = "draft"

    @torch.no_grad()
    def propose(self, histories: Sequence[np.ndarray],
                n: int) -> np.ndarray:
        B = len(histories)
        hs = [np.asarray(h, np.int64).ravel() for h in histories]
        l_max = max((len(h) for h in hs), default=0)
        width = -(-(l_max + n) // self.bucket) * self.bucket
        start_col = width - n
        toks = np.zeros((B, width), np.int32)
        positions = np.zeros((B, width), np.int32)
        for b, h in enumerate(hs):
            L = len(h)
            toks[b, start_col - L:start_col] = h
            positions[b] = np.arange(width) - (start_col - L)
        dev = self.params["final_norm"]["scale"].device
        t = torch.as_tensor(toks, device=dev)
        batch = {"tokens": t, "positions": torch.as_tensor(positions,
                                                           device=dev)}
        for j in range(n):
            logits, _, _ = self.model.forward(self.params, batch,
                                              logits_at=start_col - 1 + j)
            t[:, start_col + j] = torch.argmax(
                logits[:, 0].float(), dim=-1).to(t.dtype)
        return t[:, start_col:].cpu().numpy().astype(np.int32)


def make_draft_policy(kind: str, *, draft_model=None, draft_params=None,
                      max_ngram: int = 4,
                      bucket: int = 64) -> Optional[DraftPolicy]:
    """Policy factory for the launcher and the benches: ``off`` -> None,
    ``ngram`` -> `NGramDraftPolicy`, ``draft`` -> `DraftModelPolicy`
    (requires the draft model and params)."""
    if kind == "off":
        return None
    if kind == "ngram":
        return NGramDraftPolicy(max_ngram=max_ngram)
    if kind == "draft":
        if draft_model is None or draft_params is None:
            raise ValueError("draft policy needs draft_model and draft_params")
        return DraftModelPolicy(draft_model, draft_params, bucket=bucket)
    raise ValueError(f"unknown draft policy {kind!r}")
