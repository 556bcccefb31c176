"""Deterministic synthetic LM data pipeline, ported from
``repro.data.pipeline``.

No external datasets are needed: the pipeline generates structured
synthetic corpora with the reference's numpy draws, so a batch of the port
is element for element the reference's batch.

* ``markov``  — an order-2 Markov chain over the vocabulary with a sparse,
  seeded transition table: low-entropy transitions a model learns.
* ``arith``   — tokenized modular-arithmetic problems "a+b=c" with a
  verifiable answer (`ArithGenerator.make_prompt` / `verify`).
* ``copy``    — needle-in-haystack copy task exercising long-context recall.

Batches are dicts {"tokens", "labels"} of int32 tensors on the generator's
device, labels already shifted; every batch is a pure function of (seed,
step). With ``n_codebooks > 1`` codebook k reads ``(token + 7k) % vocab``,
stacked on a last axis: (B, S, K).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    kind: str = "markov"        # markov | arith | copy
    seed: int = 0
    n_codebooks: int = 1        # musicgen
    branching: int = 4          # markov out-degree


class _Generator:
    def __init__(self, cfg: DataConfig, device: DeviceLike = "cuda"):
        self.cfg = cfg
        # resolved (and refused without a card) when a batch is made, so
        # make_prompt / verify need no device
        self.device = torch.device(device)

    def _finish(self, toks: np.ndarray) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        inp, lab = toks[:, :-1], toks[:, 1:]
        if cfg.n_codebooks > 1:
            inp = np.stack([(inp + k * 7) % cfg.vocab_size
                            for k in range(cfg.n_codebooks)], axis=-1)
            lab = np.stack([(lab + k * 7) % cfg.vocab_size
                            for k in range(cfg.n_codebooks)], axis=-1)
        dev = resolve_device(self.device)
        return {"tokens": torch.from_numpy(np.ascontiguousarray(inp)).to(dev),
                "labels": torch.from_numpy(np.ascontiguousarray(lab)).to(dev)}


class MarkovGenerator(_Generator):
    """Order-2 Markov chain with `branching` successors per state pair."""

    def __init__(self, cfg: DataConfig, device: DeviceLike = "cuda"):
        super().__init__(cfg, device)
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        self.n_states = min(V * 8, 65536)
        self.succ = rng.integers(0, V, size=(self.n_states, cfg.branching),
                                 dtype=np.int32)
        self.probs = rng.dirichlet(np.ones(cfg.branching) * 0.5,
                                   size=self.n_states).astype(np.float32)

    def _state(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return (a * 31 + b * 7) % self.n_states

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.batch_size, cfg.seq_len
        toks = np.zeros((B, S + 1), np.int32)
        toks[:, :2] = rng.integers(0, cfg.vocab_size, size=(B, 2))
        for t in range(2, S + 1):
            st = self._state(toks[:, t - 2], toks[:, t - 1])
            choice = (rng.random(B)[:, None] >
                      np.cumsum(self.probs[st], -1)).sum(-1)
            choice = np.minimum(choice, cfg.branching - 1)
            toks[:, t] = self.succ[st, choice]
        return self._finish(toks)


class ArithGenerator(_Generator):
    """`a + b = c (mod m)` sequences; answer verifiable by re-parsing.

    Token layout per problem (digits=2):
        [a_hi a_lo PLUS b_hi b_lo EQ c_hi c_lo SEP]
    or (digits=1):
        [a PLUS b EQ c SEP]
    Digits are base-`base` tokens; special tokens live at the top of the
    vocab.
    """

    def __init__(self, cfg: DataConfig, digits: int = 1,
                 device: DeviceLike = "cuda"):
        super().__init__(cfg, device)
        self.digits = digits
        self.base = max(2, min(cfg.vocab_size - 3, 10))
        self.PLUS = cfg.vocab_size - 3
        self.EQ = cfg.vocab_size - 2
        self.SEP = cfg.vocab_size - 1
        self.mod = self.base ** digits

    def _digits_of(self, x: int) -> list:
        return [(x // self.base ** i) % self.base
                for i in reversed(range(self.digits))]

    def problem(self, rng) -> Tuple[np.ndarray, int]:
        a = int(rng.integers(0, self.mod))
        b = int(rng.integers(0, self.mod))
        c = (a + b) % self.mod
        seq = (self._digits_of(a) + [self.PLUS] + self._digits_of(b) +
               [self.EQ] + self._digits_of(c) + [self.SEP])
        return np.array(seq, np.int32), c

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, 1))
        B, S = cfg.batch_size, cfg.seq_len
        toks = np.zeros((B, S + 1), np.int32)
        for i in range(B):
            buf = []
            while len(buf) < S + 1:
                seq, _ = self.problem(rng)
                buf.extend(seq.tolist())
            toks[i] = np.array(buf[: S + 1], np.int32)
        return self._finish(toks)

    # -- verification used by the sampling engine's cascade
    def answer_of_prompt(self, a: int, b: int) -> int:
        return (a + b) % self.mod

    def make_prompt(self, rng) -> Tuple[np.ndarray, int]:
        """Prompt ends right after EQ; target is the answer digits."""
        a = int(rng.integers(0, self.mod))
        b = int(rng.integers(0, self.mod))
        prompt = np.array(self._digits_of(a) + [self.PLUS] +
                          self._digits_of(b) + [self.EQ], np.int32)
        return prompt, (a + b) % self.mod

    def verify(self, completion: np.ndarray, answer: int) -> bool:
        if completion.shape[0] < self.digits:
            return False
        got = 0
        for i in range(self.digits):
            got = got * self.base + int(completion[i])
        return got == answer


class CopyGenerator(_Generator):
    """needle copy: [needle ... SEP needle] — long-range recall."""

    def __init__(self, cfg: DataConfig, device: DeviceLike = "cuda"):
        super().__init__(cfg, device)
        self.SEP = cfg.vocab_size - 1

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, 2))
        B, S = cfg.batch_size, cfg.seq_len
        toks = rng.integers(0, cfg.vocab_size - 1,
                            size=(B, S + 1)).astype(np.int32)
        klen = min(8, S // 4)
        toks[:, -klen - 1] = self.SEP
        toks[:, -klen:] = toks[:, :klen]
        return self._finish(toks)


_GENS = {"markov": MarkovGenerator, "arith": ArithGenerator,
         "copy": CopyGenerator}


def make_generator(cfg: DataConfig, device: DeviceLike = "cuda"):
    return _GENS[cfg.kind](cfg, device=device)


def data_iterator(cfg: DataConfig, start_step: int = 0,
                  device: DeviceLike = "cuda"
                  ) -> Iterator[Dict[str, torch.Tensor]]:
    gen = make_generator(cfg, device)
    step = start_step
    while True:
        yield gen.batch(step)
        step += 1
