"""Execution backend: the *how* of serving, as a stepwise batch API.

Ported from ``repro.serving.backend`` (dense-slot and paged-block modes).
The step API:

* ``start_batch`` — prefill a group of equal-length prompts (each tiled by
  its per-request sample count) and sample the first token; returns an
  `InFlightBatch` holding the KV cache and the batch's noise stream.
* ``decode_step`` — advance an in-flight batch by one autoregressive token.
* ``finalize`` — stack the sampled tokens into per-request
  `GenerationResult`s and release the batch's KV budget.

Batches are formed within a *bucket* (`bucket_key`): prompts of one length,
one decode horizon and one temperature.

Paged mode (``kv_blocks=``): a `BlockAllocator` of fixed-size KV blocks is
the budget. Prefill runs once per *unique prompt*; the k repeats share the
full prefix blocks by reference, a partially filled last prefix block is
copied once per repeat (copy-on-write) at ``start_batch``, and decode reads
through per-sequence block tables that stay fixed for the batch's life.

Sampling: where the reference draws ``jax.random.categorical``, the port
samples ``argmax(logits / T + g)`` with Gumbel noise ``g`` from the batch's
noise source: `GumbelNoise` over a ``torch.Generator`` by default, or any
callable ``(shape, device) -> tensor`` the caller injects (a test can feed
``jax.random.gumbel`` draws and get the reference's tokens). ``T == 0`` is
plain argmax and draws nothing.

The reference's ``jax.jit`` step functions are plain methods here, and the
KV cache is updated in place. On the card, a batch's decode steps from the
second on replay one CUDA graph of the step (`repro_torch.serving.graphs`;
``cuda_graphs=False`` decodes eagerly); prefill runs eagerly, once a batch.
``kv_format="int8"`` (paged mode only) keeps the KV pools in int8 with
per-slot scales. The resident prefix pool,
chunked prefill and speculative decode arrive with later slices of the port;
their constructor arguments raise until then.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Callable, Deque, Dict, List, Optional, Sequence, Set,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.models import cache as cache_mod
from repro_torch.models.model import Model
from repro_torch.obs import NULL_OBS
from repro_torch.quant.quantize import param_bytes, params_quant_format
from repro_torch.serving.graphs import (DecodeGraph, GraphStats,
                                        StaticDecodeStep)

#: ``(shape, device) -> float32 tensor`` of standard Gumbel draws
NoiseSource = Callable[[Tuple[int, ...], torch.device], torch.Tensor]


class GumbelNoise:
    """Standard Gumbel draws from a ``torch.Generator``:
    ``-log(-log(u))`` with ``u`` uniform in [tiny, 1), as
    ``jax.random.gumbel`` computes them (the bits differ)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, shape: Tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, dtype=torch.float32,
                       device=self.generator.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return (-torch.log(-torch.log(u))).to(device)


def sample_tokens(logits: torch.Tensor, temperature: float,
                  noise: NoiseSource) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample one token per row of f32 ``logits`` (B, V); returns the tokens
    (int64) and their log-probabilities under the untempered softmax."""
    logp = torch.log_softmax(logits, dim=-1)
    if temperature > 0:
        g = noise(tuple(logits.shape), logits.device)
        tok = torch.argmax(logits / temperature + g, dim=-1)
    else:
        tok = torch.argmax(logits, dim=-1)
    lp = torch.gather(logp, -1, tok[:, None])[:, 0]
    return tok, lp


@dataclass
class GenerationResult:
    prompt: np.ndarray
    samples: List[np.ndarray]          # n_samples completions (token arrays)
    logprobs: List[float]              # mean per-token logprob per sample
    prefill_tokens: int = 0
    decode_tokens: int = 0


# ============================================================ block allocator

class BlockAllocator:
    """Fixed-size KV block accounting: free list + refcounts + copy-on-write.

    The admission budget of paged serving: every in-flight batch's physical
    pool layout is mirrored here block for block, double frees raise, and a
    shared prefix block returns to the free list only when its *last* holder
    releases it.
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks <= 0 or block_size <= 0:
            raise ValueError("n_blocks and block_size must be positive")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.n_blocks - len(self._free)

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    def alloc(self) -> int:
        """Take one block off the free list (refcount 1)."""
        if not self._free:
            raise RuntimeError(
                f"KV block pool exhausted ({self.n_blocks} blocks; "
                "admission must check blocks_free)")
        bid = self._free.pop()
        self._ref[bid] = 1
        return bid

    def fork(self, bid: int) -> int:
        """Add a reference to a live block (prefix sharing across the
        repeated samples of one prompt)."""
        ref = self._ref.get(bid)
        if ref is None:
            raise KeyError(f"fork of unallocated block {bid}")
        self._ref[bid] = ref + 1
        return bid

    def cow(self, bid: int) -> Tuple[int, bool]:
        """Copy-on-write: the writable version of ``bid`` for one holder.
        Sole holder writes in place (``(bid, False)``); a shared block costs
        a fresh private block and drops one reference (``(new, True)``: the
        caller must physically copy the contents)."""
        ref = self._ref.get(bid)
        if ref is None:
            raise KeyError(f"cow of unallocated block {bid}")
        if ref == 1:
            return bid, False
        new = self.alloc()              # may raise before any state changes
        self._ref[bid] = ref - 1
        return new, True

    def free(self, bid: int) -> bool:
        """Drop one reference; returns True when the block physically went
        back to the free list. Freeing an unallocated block raises."""
        ref = self._ref.get(bid)
        if ref is None:
            raise RuntimeError(f"double free / free of unallocated block {bid}")
        if ref > 1:
            self._ref[bid] = ref - 1
            return False
        del self._ref[bid]
        self._free.append(bid)
        return True


@dataclass
class PagedBatchLayout:
    """Physical pool layout of one in-flight batch, built once at
    ``start_batch`` and fixed for the batch's life."""
    block_size: int
    n_pool_blocks: int                 # physical pool size (local ids)
    kv_len: int                        # logical slots per sequence
    prefill_table: np.ndarray          # (R, ceil(plen/bs)) local block ids
    decode_table: np.ndarray           # (B, ceil(kv_len/bs)) local block ids
    copy_src: np.ndarray               # CoW pairs: partial prefix block ->
    copy_dst: np.ndarray               #   each repeat's private copy
    seq_gids: List[List[int]]          # allocator ids referenced per sequence


def build_paged_layout(allocator: BlockAllocator, plen: int, max_new: int,
                       repeats: Sequence[int]) -> PagedBatchLayout:
    """Allocate one batch's blocks and build its tables.

    Per request: the ``plen // bs`` full prefix blocks are allocated once and
    forked to every repeat; a partially filled last prefix block is CoW-forked
    per repeat (the first divergent token lands there); decode blocks are
    private. Blocks cover written positions only: the last is
    ``plen + max_new - 2`` (the final sampled token is never cached). The
    caller must have checked ``request_blocks`` against ``blocks_free``.
    Tables hold local ids ``0 .. n_pool_blocks - 1`` into the batch's pool.
    """
    bs = allocator.block_size
    n_logical = max(-(-(plen + max_new - 1) // bs), 1)
    full_prefix = plen // bs
    has_partial = plen % bs != 0

    pool_gids: List[int] = []
    local_of: Dict[int, int] = {}

    def loc(gid: int) -> int:
        if gid not in local_of:
            local_of[gid] = len(pool_gids)
            pool_gids.append(gid)
        return local_of[gid]

    prefill_rows: List[List[int]] = []
    decode_rows: List[List[int]] = []
    seq_gids: List[List[int]] = []
    copy_src: List[int] = []
    copy_dst: List[int] = []

    for k in repeats:
        shared = [allocator.alloc() for _ in range(full_prefix)]
        part = allocator.alloc() if has_partial else None
        for _ in range(k - 1):
            for g in shared:
                allocator.fork(g)
            if part is not None:
                allocator.fork(part)
        prefill_rows.append([loc(g) for g in shared]
                            + ([loc(part)] if part is not None else []))
        for _ in range(k):
            gids = list(shared)
            row = [loc(g) for g in shared]
            if part is not None:
                wg, copied = allocator.cow(part)
                if copied:
                    copy_src.append(loc(part))
                    copy_dst.append(loc(wg))
                gids.append(wg)
                row.append(loc(wg))
            while len(row) < n_logical:
                g = allocator.alloc()
                gids.append(g)
                row.append(loc(g))
            decode_rows.append(row)
            seq_gids.append(gids)

    return PagedBatchLayout(
        block_size=bs,
        n_pool_blocks=len(pool_gids),
        kv_len=plen + max_new,
        prefill_table=np.asarray(prefill_rows, np.int32),
        decode_table=np.asarray(decode_rows, np.int32),
        copy_src=np.asarray(copy_src, np.int32),
        copy_dst=np.asarray(copy_dst, np.int32),
        seq_gids=seq_gids)


@dataclass
class InFlightBatch:
    """One prefilled batch mid-decode."""
    prompts: List[np.ndarray]
    repeats: List[int]                 # samples per prompt (KV budget held)
    plen: int
    max_new: int
    temperature: float
    noise: NoiseSource                 # Gumbel stream of this batch
    extras: Dict[str, torch.Tensor]    # already tiled to sequence count
    cache: Dict
    tok: torch.Tensor                  # last sampled token (B,)
    step: int                          # tokens sampled so far (>= 1)
    out_toks: List[np.ndarray] = field(default_factory=list)
    out_lps: List[np.ndarray] = field(default_factory=list)
    # paged state (None in dense mode)
    paged: Optional[PagedBatchLayout] = None
    block_table: Optional[torch.Tensor] = None  # decode table on device
    prefill_bytes_saved: float = 0.0   # KV bytes prefix sharing did not move
    freed_seqs: Set[int] = field(default_factory=set)   # early-released rows
    graph: Optional[DecodeGraph] = None  # the decode step, on the card

    @property
    def n_sequences(self) -> int:
        return sum(self.repeats)

    @property
    def done(self) -> bool:
        return self.step >= self.max_new


def _host(tok: torch.Tensor,
          lp: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """A step's sampled tokens and logprobs on the host. From the card: one
    synchronisation a step, as the reference copies both at once
    (non-blocking copies into pinned buffers, then one event)."""
    if tok.is_cuda:
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in (tok, lp)]
        for dst, src in zip(host, (tok, lp)):
            dst.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        tok, lp = host
    return tok.numpy(), lp.numpy()


def bucket_key(prompt: np.ndarray, max_new: int,
               temperature: float) -> Tuple[int, int, float]:
    """Batches may only group requests that share the prompt length, decode
    horizon and temperature."""
    return (len(prompt), max_new, float(temperature))


def _not_yet(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported (arrives with the "
                               f"{slice_name} slice of the port)")


class ExecutionBackend:
    """Owns model execution state: the KV budget and placement history.

    Dense mode: ``max_slots`` bounds concurrently resident sequences
    (prompt x samples rows); ``None`` means unbounded. Paged mode
    (``kv_blocks`` set): a `BlockAllocator` of ``kv_blocks`` blocks of
    ``kv_block_size`` token slots is the budget, and admission prices a
    request at shared-prefix cost (`request_blocks`).

    ``cuda_graphs`` (on by default) decodes each batch on the card through
    one CUDA graph of its decode step; ``False`` decodes eagerly, so that a
    run can hold the graphs against the eager step. CPU tensors always
    decode eagerly. ``graph_stats`` counts captures and replays."""

    def __init__(self, model: Model, params, eos_token: Optional[int] = None,
                 max_slots: Optional[int] = None,
                 kv_blocks: Optional[int] = None, kv_block_size: int = 16,
                 kv_format: str = "bf16", obs=None,
                 spec_policy=None, spec_n: int = 0,
                 kv_pool: bool = False, pool_evict: str = "lru",
                 prefill_chunk: Optional[int] = None,
                 cuda_graphs: bool = True):
        if spec_policy is not None or spec_n:
            raise _not_yet("speculative decode (spec_policy/spec_n)", "spec")
        if kv_pool or pool_evict != "lru":
            raise _not_yet("the resident prefix pool (kv_pool/pool_evict)",
                           "prefix-pool")
        if prefill_chunk is not None:
            raise _not_yet("chunked prefill (prefill_chunk)", "prefix-pool")
        if kv_format not in ("bf16", "int8"):
            raise ValueError(f"unknown kv_format {kv_format!r} "
                             "(supported: bf16, int8)")
        if kv_format == "int8" and kv_blocks is None:
            raise ValueError("kv_format='int8' requires the paged cache "
                             "(set kv_blocks)")
        if model.cfg.n_codebooks > 1:
            raise _not_yet("multi-codebook serving", "remaining-arch-features")
        self.model = model
        self.params = params
        self.eos_token = eos_token
        self.max_slots = max_slots
        self.slots_in_use = 0
        self.kv_format = kv_format
        self.cuda_graphs = cuda_graphs
        self.graph_stats = GraphStats()
        self.quant_format = params_quant_format(params)
        self.weight_bytes = param_bytes(params)
        self.allocator: Optional[BlockAllocator] = None
        if kv_blocks is not None:
            if not cache_mod.paged_supported(model.cfg):
                raise ValueError(
                    f"paged KV cache unsupported for arch "
                    f"{model.cfg.name!r} (see repro_torch.models.cache."
                    "paged_supported); use the dense max_slots budget")
            self.allocator = BlockAllocator(kv_blocks, kv_block_size)
        # live handles: release() must be called exactly once per batch
        self._live: Dict[int, InFlightBatch] = {}
        self.last_placement = None
        self.placements: Deque = deque(maxlen=256)
        self.set_obs(obs)

    def set_obs(self, obs) -> None:
        """Attach (or detach, ``None``) an `Observability` bundle; metric
        handles are resolved once, here."""
        self.obs = obs if obs is not None else NULL_OBS
        self._m = None
        if self.obs.metrics.enabled:
            reg = self.obs.metrics
            self._m = {
                "tokens_in": reg.counter(
                    "serving_tokens_in_total",
                    "Prompt tokens prefilled (unique rows in paged mode)"),
                "tokens_out": reg.counter(
                    "serving_tokens_out_total",
                    "Tokens sampled across all sequences"),
                "kv_blocks": reg.gauge(
                    "serving_kv_blocks_in_use",
                    "Paged KV blocks currently allocated"),
                "kv_high": reg.gauge(
                    "serving_kv_blocks_high_water",
                    "Peak paged KV block occupancy"),
                "slots": reg.gauge(
                    "serving_slots_in_use",
                    "Dense KV sequence slots currently resident"),
            }

    def _note_occupancy(self) -> None:
        if self._m is None:
            return
        if self.allocator is not None:
            used = self.allocator.blocks_in_use
            self._m["kv_blocks"].set(used)
            self._m["kv_high"].set_max(used)
        else:
            self._m["slots"].set(self.slots_in_use)

    @property
    def device(self) -> torch.device:
        return self.params["final_norm"]["scale"].device

    # ------------------------------------------------------------ model steps
    def _prefill(self, params, tokens, cache, extras, block_table=None,
                 copy_src=None, copy_dst=None):
        batch = {"tokens": tokens, **extras}
        if block_table is not None:
            batch["block_table"] = block_table
        logits, cache, _ = self.model.forward(params, batch, cache)
        if copy_src is not None:
            # CoW fan-out of the shared partial prefix block, in place
            cache = cache_mod.copy_cache_blocks(cache, copy_src, copy_dst)
        return logits[:, -1], cache

    # ---------------------------------------------------------------- plumbing
    @property
    def paged(self) -> bool:
        return self.allocator is not None

    @property
    def slots_free(self) -> Optional[int]:
        """Remaining KV slot budget (None = unbounded; dense mode only)."""
        if self.max_slots is None:
            return None
        return self.max_slots - self.slots_in_use

    @property
    def blocks_free(self) -> Optional[int]:
        return self.allocator.blocks_free if self.allocator else None

    @property
    def blocks_in_use(self) -> Optional[int]:
        return self.allocator.blocks_in_use if self.allocator else None

    @property
    def capacity_free(self) -> Optional[int]:
        """Admission budget remaining, in this backend's currency: KV blocks
        (paged) or sequence slots (dense); None = unbounded."""
        if self.allocator is not None:
            return self.allocator.blocks_free
        return self.slots_free

    @property
    def capacity_total(self) -> Optional[int]:
        if self.allocator is not None:
            return self.allocator.n_blocks
        return self.max_slots

    def request_blocks(self, plen: int, max_new: int, n_samples: int) -> int:
        """Block cost of a request at shared-prefix price: the full prefix
        blocks once, plus per-sample privates (the CoW copy of a partial
        prefix block and the decode blocks). Mirrors `build_paged_layout`."""
        bs = self.allocator.block_size
        n_logical = max(-(-(plen + max_new - 1) // bs), 1)
        full_prefix = plen // bs
        return full_prefix + n_samples * (n_logical - full_prefix)

    def request_cost(self, plen: int, max_new: int, n_samples: int) -> int:
        """Admission cost in ``capacity_free`` units (blocks or slots)."""
        if self.allocator is not None:
            return self.request_blocks(plen, max_new, n_samples)
        return n_samples

    @property
    def kv_token_bytes(self) -> int:
        """KV bytes one token position costs across the stack. int8 KV counts
        one byte per element and, like the reference, leaves out its f32
        per-slot scales."""
        el = 1 if self.kv_format == "int8" else \
            torch.empty((), dtype=self.model.dtype).element_size()
        return cache_mod.kv_bytes_per_token(self.model.cfg, el)

    def note_placement(self, placement) -> None:
        self.last_placement = placement
        self.placements.append(placement)

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _tile(self, t: torch.Tensor, rep: Union[int, np.ndarray]):
        if isinstance(rep, int):
            return torch.repeat_interleave(t, rep, dim=0)
        return torch.repeat_interleave(
            t, torch.as_tensor(rep, device=t.device), dim=0)

    # ---------------------------------------------------------------- step API
    @torch.no_grad()
    def start_batch(self, prompts: Sequence[np.ndarray],
                    n_samples: Union[int, Sequence[int]], max_new: int,
                    temperature: float, noise: NoiseSource,
                    extras: Optional[Dict] = None) -> InFlightBatch:
        """Prefill equal-length prompts and sample the first token.

        ``n_samples`` may be one count or one per prompt. ``extras`` values
        are per-prompt rows, tiled to the sequence count here, once. Paged
        mode prefills one row per *prompt* and fans the result out to the
        repeats through shared prefix blocks.
        """
        extras = extras or {}
        repeats = ([int(n_samples)] * len(prompts)
                   if isinstance(n_samples, int) else
                   [int(n) for n in n_samples])
        if not prompts or any(k < 1 for k in repeats):
            raise ValueError("start_batch needs >= 1 prompt and >= 1 "
                             f"sample per prompt (got repeats={repeats})")
        plen = len(prompts[0])
        if any(len(p) != plen for p in prompts):
            raise ValueError("start_batch requires equal-length prompts "
                             "(one bucket)")
        uniform = len(set(repeats)) == 1
        rep: Union[int, np.ndarray] = \
            repeats[0] if uniform else np.asarray(repeats)
        base = np.stack(list(prompts))                      # (R, L)
        B = int(sum(repeats))
        extras = {k: (v.to(self.device) if isinstance(v, torch.Tensor)
                      else torch.as_tensor(np.asarray(v), device=self.device))
                  for k, v in extras.items()}

        tracer = self.obs.tracer
        t0 = time.perf_counter() if tracer.enabled else 0.0
        if self.allocator is not None:
            h = self._start_batch_paged(prompts, repeats, rep, base, B, plen,
                                        max_new, temperature, noise, extras)
            prefilled = len(prompts) * plen     # one row per unique prompt
        else:
            h = self._start_batch_dense(prompts, repeats, rep, base, B, plen,
                                        max_new, temperature, noise, extras)
            prefilled = B * plen
        self._live[id(h)] = h
        if tracer.enabled:
            tracer.emit("prefill", t0, time.perf_counter(), clock="wall",
                        prefill_tokens=prefilled, n_sequences=B, plen=plen)
        if self._m is not None:
            self._m["tokens_in"].inc(prefilled)
            self._m["tokens_out"].inc(B)    # first token per sequence
            self._note_occupancy()
        return h

    def _first_token(self, h: InFlightBatch, last_logits: torch.Tensor,
                     rep) -> InFlightBatch:
        """Sample the first token from the prefill logits, fanned out to the
        repeats (identical rows for the repeats of one prompt)."""
        lf = self._tile(last_logits.float(), rep)
        tok, lp = sample_tokens(lf, h.temperature, h.noise)
        h.tok = tok
        toks, lps = _host(tok, lp)
        h.out_toks = [toks]
        h.out_lps = [lps]
        return h

    def _start_batch_dense(self, prompts, repeats, rep, base, B, plen,
                           max_new, temperature, noise,
                           extras) -> InFlightBatch:
        tokens = np.repeat(base, rep, axis=0)               # (B, L)
        if self.max_slots is not None and \
                self.slots_in_use + B > self.max_slots:
            raise RuntimeError(
                f"KV slot budget exceeded: {self.slots_in_use}+{B} > "
                f"{self.max_slots} (scheduler must check slots_free)")
        tiled_extras = {k: self._tile(v, rep) for k, v in extras.items()}
        cache = self.model.init_cache(B, plen + max_new)
        last_logits, cache = self._prefill(self.params, self._tokens(tokens),
                                           cache, tiled_extras)
        self.slots_in_use += B
        h = InFlightBatch(
            prompts=list(prompts), repeats=repeats, plen=plen,
            max_new=max_new, temperature=temperature, noise=noise,
            extras=tiled_extras, cache=cache, tok=None, step=1)
        # the first token comes from the prefill logits of each (tiled) row
        return self._first_token(h, last_logits, 1)

    def _start_batch_paged(self, prompts, repeats, rep, base, B, plen,
                           max_new, temperature, noise,
                           extras) -> InFlightBatch:
        R = len(prompts)
        need = sum(self.request_blocks(plen, max_new, k) for k in repeats)
        if need > self.allocator.blocks_free:
            raise RuntimeError(
                f"KV block budget exceeded: need {need} > "
                f"{self.allocator.blocks_free} free (scheduler must check "
                "blocks_free)")
        layout = build_paged_layout(self.allocator, plen, max_new, repeats)
        try:
            cache = self.model.init_paged_cache(
                layout.n_pool_blocks, layout.block_size,
                kv_dtype=torch.int8 if self.kv_format == "int8" else None)
            # prefill rows are the unique prompts (extras per prompt as is);
            # decode rows are the tiled sequences: both tiled exactly once
            decode_extras = {k: self._tile(v, rep) for k, v in extras.items()}
            has_cow = layout.copy_src.size > 0
            last_logits, cache = self._prefill(
                self.params, self._tokens(base), cache, extras,
                self._tokens(layout.prefill_table),
                self._tokens(layout.copy_src) if has_cow else None,
                self._tokens(layout.copy_dst) if has_cow else None)
        except BaseException:
            # no handle exists yet to release(): return every reference the
            # layout took, or a failed prefill permanently shrinks the budget
            for gids in layout.seq_gids:
                for g in gids:
                    self.allocator.free(g)
            raise
        h = InFlightBatch(
            prompts=list(prompts), repeats=repeats, plen=plen,
            max_new=max_new, temperature=temperature, noise=noise,
            extras=decode_extras, cache=cache, tok=None, step=1,
            paged=layout, block_table=self._tokens(layout.decode_table),
            prefill_bytes_saved=float((B - R) * plen * self.kv_token_bytes))
        return self._first_token(h, last_logits, rep)

    @torch.no_grad()
    def decode_step(self, h: InFlightBatch) -> bool:
        """Advance one token; returns True while the batch still has decode
        steps left (so ``while backend.decode_step(h): pass`` drains it)."""
        if h.done:
            return False
        tracer = self.obs.tracer
        t0 = time.perf_counter() if tracer.enabled else 0.0
        step_pos = h.plen + h.step - 1
        if h.graph is None and h.step >= 2 and self._graphs_on(h):
            # no fallback: a capture that fails raises
            t_cap = time.perf_counter()
            h.graph = DecodeGraph.capture(self._static_step(h))
            self.graph_stats.captures += 1
            self.graph_stats.capture_s += time.perf_counter() - t_cap
            self.graph_stats.pool_bytes += h.graph.pool_bytes
        if h.graph is not None:
            h.tok, lp = h.graph.replay(step_pos, h.noise)
            self.graph_stats.replays += 1
        else:
            pos = torch.full((h.n_sequences, 1), step_pos, dtype=torch.int32,
                             device=h.tok.device)
            h.tok, lp = self._decode_fn(h)(h.tok[:, None], pos, h.noise)
        toks, lps = _host(h.tok, lp)
        h.out_toks.append(toks)
        h.out_lps.append(lps)
        h.step += 1
        if tracer.enabled:
            tracer.emit("decode", t0, time.perf_counter(), clock="wall",
                        step=h.step, n_sequences=h.n_sequences)
        if self._m is not None:
            self._m["tokens_out"].inc(h.n_sequences - len(h.freed_seqs))
        return not h.done

    def _graphs_on(self, h: InFlightBatch) -> bool:
        """Whether ``h`` decodes through a CUDA graph: on the card, unless
        the backend was built with ``cuda_graphs=False``."""
        return self.cuda_graphs and h.tok.is_cuda

    def _decode_fn(self, h: InFlightBatch):
        """The reference's ``_decode_step`` for ``h``: ``(tok (B, 1) token
        ids, pos (B, 1) int32 positions, noise) -> (tokens, logprobs)``, one
        decode step over the batch's cache, updated in place. Closes over
        the batch's state, not the handle, so a graph that holds it does
        not hold the batch."""
        cache, temp = h.cache, h.temperature
        b = dict(h.extras)
        if h.block_table is not None:
            b["block_table"] = h.block_table
        kv_len = h.paged.kv_len if h.paged is not None else None
        mrope = bool(self.model.cfg.mrope_sections)

        def decode(tok, pos, noise):
            if mrope:
                pos = pos[..., None].expand(tok.shape[0], 1, 3)
            logits, _, _ = self.model.forward(
                self.params, {"tokens": tok, "positions": pos, **b}, cache,
                kv_len=kv_len)
            return sample_tokens(logits[:, 0].float(), temp, noise)
        return decode

    def _static_step(self, h: InFlightBatch) -> StaticDecodeStep:
        """The body of ``h``'s decode graph, reading ``h``'s last token."""
        return StaticDecodeStep(self._decode_fn(h), h.tok,
                                self.model.cfg.padded_vocab,
                                sampled=h.temperature > 0)

    def release(self, h: InFlightBatch) -> None:
        """Return a batch's remaining KV budget (blocks or slots). Raises on
        an unknown or already-released handle."""
        if self._live.pop(id(h), None) is None:
            raise RuntimeError("release of unknown or already-released "
                               "batch handle")
        if h.paged is not None:
            for i, gids in enumerate(h.paged.seq_gids):
                if i in h.freed_seqs:
                    continue
                for g in gids:
                    self.allocator.free(g)
        else:
            self.slots_in_use -= h.n_sequences - len(h.freed_seqs)
        h.freed_seqs = set(range(h.n_sequences))
        h.cache = None                     # the KV memory goes with the batch
        h.graph = None                     # and the graph that addresses it
        self._note_occupancy()

    def release_sequences(self, h: InFlightBatch,
                          seq_indices: Sequence[int]) -> int:
        """Early-release finished sequences' KV budget (CSVET early stop).
        The batch keeps decoding with its shapes, but the released rows'
        blocks/slots are free for new admissions now. Returns blocks (or
        slots) actually returned to the budget; shared prefix blocks only
        come back with their last holder. This frees budget, not bytes: the
        batch's pool is resident until retirement."""
        if id(h) not in self._live:
            raise RuntimeError("release_sequences on unknown or "
                               "already-released batch handle")
        bad = [i for i in seq_indices if not 0 <= i < h.n_sequences]
        if bad:
            raise ValueError(f"sequence indices {bad} out of range for a "
                             f"{h.n_sequences}-sequence batch")
        freed = 0
        for i in seq_indices:
            if i in h.freed_seqs:
                continue
            h.freed_seqs.add(i)
            if h.paged is not None:
                freed += sum(self.allocator.free(g)
                             for g in h.paged.seq_gids[i])
            else:
                self.slots_in_use -= 1
                freed += 1
        self._note_occupancy()
        return freed

    def finalize(self, h: InFlightBatch) -> List[GenerationResult]:
        """Stack per-step samples into per-request results and release the
        batch's KV budget."""
        toks = np.stack(h.out_toks, axis=1)             # (B, T)
        lps = np.stack(h.out_lps, axis=1)               # (B, T)
        results = []
        offset = 0
        for prompt, ns in zip(h.prompts, h.repeats):
            sl = slice(offset, offset + ns)
            offset += ns
            samples = [toks[i] for i in range(sl.start, sl.stop)]
            if self.eos_token is not None:
                samples = [self._truncate(s) for s in samples]
            results.append(GenerationResult(
                prompt=prompt,
                samples=samples,
                logprobs=[float(lps[i].mean())
                          for i in range(sl.start, sl.stop)],
                prefill_tokens=h.plen,
                decode_tokens=int(toks.shape[1]) * ns,
            ))
        self.release(h)
        return results

    def _truncate(self, sample: np.ndarray) -> np.ndarray:
        hits = np.nonzero(sample == self.eos_token)[0]
        return sample[: hits[0]] if hits.size else sample
