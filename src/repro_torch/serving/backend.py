"""Execution backend: the *how* of serving, as a stepwise batch API.

Ported from ``repro.serving.backend`` (dense-slot, paged-block and resident
prefix-pool modes, and chunked prefill). The step API:

* ``start_batch`` — prefill a group of equal-length prompts (each tiled by
  its per-request sample count) and sample the first token; returns an
  `InFlightBatch` holding the KV cache and the batch's noise stream.
* ``decode_step`` — advance an in-flight batch by one autoregressive token
  (or, while a chunked prefill drains, by one prefill slice).
* ``finalize`` — stack the sampled tokens into per-request
  `GenerationResult`s and release the batch's KV budget.

Batches are formed within a *bucket* (`bucket_key`): prompts of one length,
one decode horizon and one temperature.

Paged mode (``kv_blocks=``): a `BlockAllocator` of fixed-size KV blocks is
the budget. Prefill runs once per *unique prompt*; the k repeats share the
full prefix blocks by reference, a partially filled last prefix block is
copied once per repeat (copy-on-write) at ``start_batch``, and decode reads
through per-sequence block tables that stay fixed for the batch's life.

Resident prefix pool (``kv_pool=True``, paged mode): ONE physical cache of
``kv_blocks`` blocks outlives every batch, and a `PrefixPool` radix trie
indexes its filled full-prefix blocks. A batch resolves each prompt's
longest cached chain, evicts idle chains (LRU) to fit the rest, prefills
only the tails (``_tail_prefill``: explicit positions through the block
table, ``decode=True``), fans the copy-on-write blocks out, and indexes its
new chains. Its tables carry global block ids into the resident cache.

Chunked prefill (``prefill_chunk=``, paged mode): the prefill is cut into
slices of at most ``prefill_chunk`` tokens, one slice a ``decode_step``
call, so a long prompt interleaves with in-flight decode; the first token
is sampled when the last slice lands.

Sampling: where the reference draws ``jax.random.categorical``, the port
samples ``argmax(logits / T + g)`` with Gumbel noise ``g`` from the batch's
noise source: `GumbelNoise` over a ``torch.Generator`` by default, or any
callable ``(shape, device) -> tensor`` the caller injects (a test can feed
``jax.random.gumbel`` draws and get the reference's tokens). ``T == 0`` is
plain argmax and draws nothing.

The reference's ``jax.jit`` step functions are plain methods here, and the
KV cache is updated in place. On the card, decode steps replay CUDA graphs
of the step (`repro_torch.serving.graphs`; ``cuda_graphs=False`` decodes
eagerly); prefill runs eagerly, once a batch. One graph serves every batch
of its shape (`_graph_key`: rows, table shape, cache length, greedy or
sampled, KV format, extras), as the reference's jit compiles once per
static shape: the first batch of a shape decodes its first step eagerly
and captures its second, and every later batch of that shape replays from
its first decode step. The temperature is a buffer the replay fills, not
part of the shape. A graph addresses one cache: on the resident pool the
backend's one cache, off it a `CacheArena` that a retired batch hands on to
the next batch of its cache's shape, which prefills into the same tensors
(reset first to what a fresh cache holds). ``kv_format="int8"`` (paged
mode only) keeps the KV pools in int8 with per-slot scales.

Multi-codebook archs (musicgen: K codebooks) take prompts (L, K): a step
samples K tokens a sequence from (B, K, vocab) noise and records the mean
of their logprobs, and EOS truncation is off, as in the reference. The
``extras`` of a batch (``vision_embeds``, ``cond_memory``) are tiled to its
sequences once and ride into every forward; a decode graph reads static
copies of them, as it reads the block table. A dense cache with
``cross_kv_cache`` holds the memory's keys and values, sized to its length
(part of the arena's key).

Speculative decode (``spec_policy=``, ``spec_n=``): with a
`repro_torch.spec` draft policy attached, ``decode_step`` on a drafting
batch runs draft -> verify -> commit instead of one-token sampling. The
policy proposes n tokens from each sequence's own history, ONE verify
forward scores them against the cache (``decode=True`` takes the
cache-attending branches at S = n + 1), and `repro_torch.spec.verify_tokens`
keeps the longest accepted prefix plus a correction/bonus token:
distribution-preserving under sampling, the same tokens as plain greedy
decode under greedy. Sampled verifies take their draws, a uniform per draft
and a Gumbel row, from the batch's noise stream (`verify_draws`). Rollback
is free: a verify writes the KV of all its S positions before attending,
positions above a query's own are masked, and the next verify writes the
span again, so rejected drafts' KV entries are overwritten, with no
allocator traffic. Rows progress raggedly (each commits 1 to n + 1 tokens a
step), so a batch whose rows finish at different steps allocates a slack
of ``spec_n + 1`` token slots a sequence for the tail writes of finished
rows (`request_blocks` prices it). On the card verifies replay one CUDA
graph a shape and draft depth, kept beside the decode graphs of the same
cache; a batch's first verify runs eagerly until its shape has one.

Tracing (a live ``obs.tracer``): each prefill and decode is a wall-clock
span (`repro_torch.obs.tracer`) with two children, ``enqueue`` (the
forward's device work enqueued: for a replay the step's `load` and the
graph launch) and ``sync`` (the host blocked on the step's token copy);
from the start of the first to the end of the second the device holds the
forward's work. A decode graph captured while tracing is on carries a
timed copy (`repro_torch.serving.graphs`), which one replay in
`DEVICE_TIME_EVERY` takes. Its events are read at the next decode step,
once that step's work is enqueued, so the host reads them while the
device computes: a ``readout`` span, and a ``device_time`` span with the
milliseconds by segment (`repro_torch.obs.segments`), both children of
the timed replay's ``decode`` span.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Set, Tuple, Union)

import numpy as np
import torch

from repro_torch.kernels.decode_attention.split import prefix_groups
from repro_torch.models import cache as cache_mod
from repro_torch.models.model import Model
from repro_torch.obs import NULL_OBS
from repro_torch.obs.metrics import RATIO_BUCKETS
from repro_torch.obs.segments import mark
from repro_torch.quant.quantize import param_bytes, params_quant_format
from repro_torch.serving.graphs import (DecodeGraph, GraphStats,
                                        StaticDecodeStep, StaticVerifyStep)
from repro_torch.serving.prefix_pool import PrefixPool
from repro_torch.spec.policy import spec_supported
from repro_torch.spec.verify import verify_tokens

#: ``(shape, device) -> float32 tensor`` of standard Gumbel draws
NoiseSource = Callable[[Tuple[int, ...], torch.device], torch.Tensor]
#: with tracing on, one decode replay in this many takes its graph's timed
#: copy: at one in 8 the timed replays' event nodes and launches lengthened
#: a traced run's mean decode by 4-6% on an H100 (`PERF.md` §6)
DEVICE_TIME_EVERY = 32


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

    def verify_draws(self, rows: int, n: int, vocab: int,
                     device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One sampled verify step's draws: (rows, n) uniform in [0, 1),
        then (rows, vocab) Gumbel."""
        u = torch.rand((rows, n), generator=self.generator,
                       dtype=torch.float32, device=self.generator.device)
        return u.to(device), self((rows, vocab), device)


def verify_draws(noise: NoiseSource, rows: int, n: int, vocab: int,
                 device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The draws of one sampled verify step from a batch's noise stream:
    ``u`` (rows, n) uniform for the accept tests and ``g`` (rows, vocab)
    Gumbel for the correction/bonus draw. A source with a ``verify_draws``
    method gives them itself (`GumbelNoise`; a test replaying the
    reference's keys); from any other, ``u`` is a (rows, n) Gumbel draw
    mapped through the Gumbel CDF ``exp(-exp(-x))``."""
    own = getattr(noise, "verify_draws", None)
    if own is not None:
        return own(rows, n, vocab, device)
    u = torch.exp(-torch.exp(-noise((rows, n), device)))
    return u, noise((rows, vocab), device)


def sample_tokens(logits: torch.Tensor,
                  temperature: Union[float, torch.Tensor],
                  noise: NoiseSource, sampled: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample one token per row of f32 ``logits`` (B, V), or per row and
    codebook of (B, K, V); returns the tokens (int64) and their
    log-probabilities under the untempered softmax, (B,) or (B, K).

    ``temperature`` is a float, or a 0-dim f32 tensor (a decode graph's
    buffer, which every batch of a shape fills with its own), and then
    ``sampled`` says which branch runs; for a float it is ``temperature >
    0``. The greedy branch is a plain argmax: it draws nothing and divides
    by nothing."""
    if sampled is None:
        sampled = temperature > 0
    logp = torch.log_softmax(logits, dim=-1)
    if sampled:
        g = noise(tuple(logits.shape), logits.device)
        tok = torch.argmax(logits / temperature + g, dim=-1)
    else:
        tok = torch.argmax(logits, dim=-1)
    lp = torch.gather(logp, -1, tok[..., None])[..., 0]
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
    releases it. Blocks indexed by a resident `PrefixPool` are protected:
    their last reference belongs to the trie, and only the pool's eviction
    returns them.
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks <= 0 or block_size <= 0:
            raise ValueError("n_blocks and block_size must be positive")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        # trie-resident blocks: block id -> owning-prefix description
        self._protected: Dict[int, str] = {}

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

    def protect(self, bid: int, owner: str) -> None:
        """Mark a live block as trie-resident: `free` refuses to return it
        to the free list, so eviction must go through the pool."""
        if bid not in self._ref:
            raise KeyError(f"protect of unallocated block {bid}")
        self._protected[bid] = owner

    def unprotect(self, bid: int) -> None:
        self._protected.pop(bid, None)

    def protected_owner(self, bid: int) -> Optional[str]:
        return self._protected.get(bid)

    def free(self, bid: int) -> bool:
        """Drop one reference; returns True when the block physically went
        back to the free list. Freeing an unallocated block raises, and so
        does freeing the *last* reference of a trie-resident block (naming
        the block and its owning prefix): cached KV returning to the free
        list behind the pool's back would corrupt the prefix index."""
        ref = self._ref.get(bid)
        if ref is None:
            raise RuntimeError(f"double free / free of unallocated block {bid}")
        owner = self._protected.get(bid)
        if owner is not None and ref == 1:
            raise RuntimeError(
                f"free of trie-resident block {bid} (owning prefix: "
                f"{owner}) would return an indexed block to the free list; "
                "evict it through PrefixPool.evict instead")
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
    n_pool_blocks: int                 # physical pool size
    kv_len: int                        # logical slots per sequence
    prefill_table: np.ndarray          # (R, ceil(plen/bs)) block ids
    decode_table: np.ndarray           # (B, ceil(kv_len/bs)) block ids
    copy_src: np.ndarray               # CoW pairs: partial prefix block ->
    copy_dst: np.ndarray               #   each repeat's private copy
    seq_gids: List[List[int]]          # allocator ids referenced per sequence
    # resident-pool path (`hit_chains` given): tables carry GLOBAL allocator
    # ids into the backend's resident cache, and each prompt's leading
    # ``hit_counts[i]`` prefill blocks are already filled
    pooled: bool = False
    hit_counts: List[int] = field(default_factory=list)
    # (B, 2) each decode row's group's first row and the table blocks the
    # group shares (`kernels.decode_attention.split.prefix_groups`)
    prefix_groups: Optional[np.ndarray] = None

    def prefix_stats(self, context: int) -> Tuple[int, float]:
        """(groups, share) at a decode step whose rows attend ``context``
        positions: the groups of rows sharing leading table blocks, and the
        share of the table's valid logical slots in those blocks, which the
        paged kernel reads once a group where its grouped path takes the
        group (`kernels.decode_attention.split.groups_engage` and
        `min_shared_blocks`) instead of once a row."""
        g = self.prefix_groups
        grouped = g[:, 1] > 0
        shared = np.minimum(g[grouped, 1] * self.block_size, context).sum()
        return (int(np.unique(g[grouped, 0]).size),
                float(shared) / (len(g) * context) if len(g) and context
                else 0.0)


def build_paged_layout(allocator: BlockAllocator, plen: int, max_new: int,
                       repeats: Sequence[int],
                       hit_chains: Optional[Sequence[List[int]]] = None
                       ) -> PagedBatchLayout:
    """Allocate one batch's blocks and build its tables.

    Per request: the ``plen // bs`` full prefix blocks are allocated once and
    forked to every repeat; a partially filled last prefix block is CoW-forked
    per repeat (the first divergent token lands there); decode blocks are
    private. Blocks cover written positions only: the last is
    ``plen + max_new - 2`` (the final sampled token is never cached). The
    caller must have checked ``request_blocks`` against ``blocks_free``.

    The rows of a request form a group over its ``plen // bs`` full prefix
    blocks (on the resident pool the hit chain and the newly shared blocks
    alike; the CoW-forked partial block is each row's own):
    ``prefix_groups``, which the paged decode kernel reads to stream them
    once for all the request's rows where that pays
    (`kernels.decode_attention.split.prefix_groups`).

    Without ``hit_chains`` the tables hold local ids ``0 .. n_pool_blocks -
    1`` into the batch's own pool. With them (the resident prefix pool),
    ``hit_chains[i]`` is prompt *i*'s cached full-prefix chain, already
    filled and already holding one reference per repeat
    (``PrefixPool.acquire``): those blocks head the prompt's tables, only
    the tail is allocated, and every table holds global allocator ids into
    the resident cache.
    """
    bs = allocator.block_size
    n_logical = max(-(-(plen + max_new - 1) // bs), 1)
    full_prefix = plen // bs
    has_partial = plen % bs != 0
    pooled = hit_chains is not None
    if not pooled:
        hit_chains = [[] for _ in repeats]

    pool_gids: List[int] = []
    local_of: Dict[int, int] = {}

    def loc(gid: int) -> int:
        if pooled:                     # resident pool: global ids ARE the map
            return gid
        if gid not in local_of:
            local_of[gid] = len(pool_gids)
            pool_gids.append(gid)
        return local_of[gid]

    prefill_rows: List[List[int]] = []
    decode_rows: List[List[int]] = []
    seq_gids: List[List[int]] = []
    copy_src: List[int] = []
    copy_dst: List[int] = []

    for k, hits in zip(repeats, hit_chains):
        if len(hits) > full_prefix:
            raise ValueError(f"hit chain of {len(hits)} blocks exceeds the "
                             f"{full_prefix} full prefix blocks of plen={plen}")
        shared = list(hits) + [allocator.alloc()
                               for _ in range(full_prefix - len(hits))]
        part = allocator.alloc() if has_partial else None
        for _ in range(k - 1):
            for g in shared[len(hits):]:   # hit refs already taken by acquire
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
        n_pool_blocks=allocator.n_blocks if pooled else len(pool_gids),
        kv_len=plen + max_new,
        prefill_table=np.asarray(prefill_rows, np.int32),
        decode_table=np.asarray(decode_rows, np.int32),
        copy_src=np.asarray(copy_src, np.int32),
        copy_dst=np.asarray(copy_dst, np.int32),
        seq_gids=seq_gids,
        pooled=pooled,
        hit_counts=[len(h) for h in hit_chains],
        prefix_groups=prefix_groups(repeats, full_prefix))


@dataclass
class SpecState:
    """Speculative decode state of one in-flight batch.

    Sequences progress *raggedly* (each verify step commits between 1 and
    n+1 tokens a row), so per-sequence token/logprob lists replace the
    per-step stacked arrays, ``committed`` tracks each row's emitted count,
    and ``InFlightBatch.step`` is ``committed.min()`` (the batch retires
    when the slowest row reaches the horizon; finished rows keep riding the
    fixed-shape verify forward, writing only into their slack slots).
    ``proposed``/``accepted`` feed the "spec" telemetry record that the
    `CalibrationFitter` learns accept rates from.
    """
    policy: Any                        # DraftPolicy proposing the drafts
    n: int                             # draft depth for this batch
    committed: np.ndarray              # (B,) tokens emitted per sequence
    histories: List[np.ndarray]        # prompt + committed tokens, per seq
    toks: List[List[int]]              # emitted tokens per sequence
    lps: List[List[float]]             # emitted logprobs per sequence
    proposed: int = 0                  # draft tokens offered to verify
    accepted: int = 0                  # draft tokens verify accepted
    steps: int = 0                     # verify forwards run

    @property
    def accept_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0


@dataclass
class PendingPrefill:
    """Prefill work of a batch that has its blocks but not yet its KV:
    ``jobs`` are (prompt idxs, start, end) token slices. A chunked prefill
    drains one per ``decode_step`` call; the finish pass (CoW fan-out, trie
    indexing, first-token sampling) runs when the last one lands. The
    handle's ``step`` stays 0 and its ``tok`` None throughout, and a
    preemption mid-prefill releases instead of parking (no block is
    guaranteed filled yet)."""
    jobs: Deque[Tuple[List[int], int, int]]
    base: np.ndarray                   # (R, L) stacked unique prompts
    extras: Dict[str, torch.Tensor]    # per-prompt rows (untiled)
    last_rows: List[Optional[torch.Tensor]]  # final-position logits
    rep: Union[int, np.ndarray]
    full_prefix: int                   # blocks to trie-index at finish
    n_spec: int = 0                    # draft depth armed at finish


@dataclass
class CacheArena:
    """A per-batch cache (dense, or a per-batch paged pool) and the decode
    and verify graphs that address it. A retired batch's arena waits idle
    for the next batch of its ``key`` (the cache's shape), which prefills
    into the same tensors, so the graphs stay valid and replay from that
    batch's first step. ``size`` is what it holds of the backend's KV
    budget: rows (dense) or blocks (paged)."""
    key: tuple
    cache: Dict
    size: int
    graphs: Dict[tuple, DecodeGraph] = field(default_factory=dict)


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
    arena: Optional[CacheArena]        # None on the resident pool
    tok: Optional[torch.Tensor]        # last sampled token (B,); None while
    #                                    a chunked prefill drains
    step: int                          # tokens sampled so far
    out_toks: List[np.ndarray] = field(default_factory=list)
    out_lps: List[np.ndarray] = field(default_factory=list)
    # paged state (None in dense mode)
    paged: Optional[PagedBatchLayout] = None
    block_table: Optional[torch.Tensor] = None  # decode table on device
    prefix_groups: Optional[torch.Tensor] = None  # its groups, on device
    prefill_bytes_saved: float = 0.0   # KV bytes prefix sharing did not move
    # prefix-pool accounting (pooled batches only)
    pool_hit_blocks: int = 0           # trie-cached blocks this batch reused
    pool_evictions: int = 0            # idle blocks evicted to fit the tail
    freed_seqs: Set[int] = field(default_factory=set)   # early-released rows
    graph: Optional[DecodeGraph] = None  # the decode step, on the card
    pending_prefill: Optional[PendingPrefill] = None
    spec: Optional[SpecState] = None   # set when this batch drafts (n > 0)
    verify_graph: Optional[DecodeGraph] = None  # its verify step, on card

    @property
    def n_sequences(self) -> int:
        return sum(self.repeats)

    @property
    def cache(self) -> Optional[Dict]:
        """The batch's own cache (None on the resident pool, and once
        released)."""
        return self.arena.cache if self.arena is not None else None

    @property
    def done(self) -> bool:
        return self.step >= self.max_new

    @property
    def pooled(self) -> bool:
        """Whether the batch lives in the backend's resident cache."""
        return self.paged is not None and self.paged.pooled


def _host(tracer, *ts: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """A step's outputs (its sampled tokens and logprobs; a verify's accept
    lengths too) on the host. From the card: one synchronisation a step,
    as the reference copies them at once (non-blocking copies into pinned
    buffers, then one event); ``tracer`` times the wait as ``sync``."""
    done = None
    if ts[0].is_cuda:
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in ts]
        for dst, src in zip(host, ts):
            dst.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        ts = tuple(host)
    with tracer.span("sync"):
        if done is not None:
            done.synchronize()
    return tuple(t.numpy() for t in ts)


def bucket_key(prompt: np.ndarray, max_new: int,
               temperature: float) -> Tuple[int, int, float]:
    """Batches may only group requests that share the prompt length, decode
    horizon and temperature."""
    return (len(prompt), max_new, float(temperature))


class ExecutionBackend:
    """Owns model execution state: the KV budget and placement history.

    Dense mode: ``max_slots`` bounds concurrently resident sequences
    (prompt x samples rows); ``None`` means unbounded. Paged mode
    (``kv_blocks`` set): a `BlockAllocator` of ``kv_blocks`` blocks of
    ``kv_block_size`` token slots is the budget, and admission prices a
    request at shared-prefix cost (`request_blocks`). ``kv_pool`` adds the
    resident prefix pool (``pool_evict``: ``"lru"`` reclaims idle chains,
    ``"off"`` never does), and ``prefill_chunk`` chunked prefill.
    ``spec_policy`` (a `repro_torch.spec` draft policy) speculates in every
    mode, at the maximum draft depth ``spec_n``; `note_spec` lowers it for
    the next batch.

    ``cuda_graphs`` (on by default) decodes on the card through CUDA graphs
    of the decode step, one a shape; ``False`` decodes eagerly, so that a
    run can hold the graphs against the eager step. CPU tensors always
    decode eagerly. ``graph_stats`` counts captures and replays. Off the
    resident pool, retired batches' caches and graphs wait in idle arenas
    for the next batch of their shape: at most the backend's KV budget of
    them (``max_slots`` rows, or ``kv_blocks`` blocks; an unbounded dense
    backend, the most rows it held at once), the least recently retired
    dropped first."""

    def __init__(self, model: Model, params, eos_token: Optional[int] = None,
                 max_slots: Optional[int] = None,
                 kv_blocks: Optional[int] = None, kv_block_size: int = 16,
                 kv_format: str = "bf16", obs=None,
                 spec_policy=None, spec_n: int = 0,
                 kv_pool: bool = False, pool_evict: str = "lru",
                 prefill_chunk: Optional[int] = None,
                 cuda_graphs: bool = True):
        # speculative decode: spec_n is the MAXIMUM draft depth; it sizes the
        # per-sequence slack allocation, so per-batch depths noted through
        # note_spec may only go down from it
        self.spec_policy = spec_policy
        self.spec_n = int(spec_n)
        self._next_spec_n: Optional[int] = None
        if spec_policy is not None:
            if self.spec_n < 1:
                raise ValueError("spec_policy requires spec_n >= 1 "
                                 "(the maximum draft depth)")
            if not spec_supported(model.cfg):
                raise ValueError(
                    f"speculative decode unsupported for arch "
                    f"{model.cfg.name!r} (see repro_torch.spec."
                    "spec_supported)")
        if kv_format not in ("bf16", "int8"):
            raise ValueError(f"unknown kv_format {kv_format!r} "
                             "(supported: bf16, int8)")
        if kv_format == "int8" and kv_blocks is None:
            raise ValueError("kv_format='int8' requires the paged cache "
                             "(set kv_blocks)")
        self.model = model
        self.params = params
        self.eos_token = eos_token
        self.max_slots = max_slots
        self.slots_in_use = 0
        self.kv_format = kv_format
        self.cuda_graphs = cuda_graphs
        self.graph_stats = GraphStats()
        # the last timed replay's (segment timer, decode span id), until
        # the next decode step reads it
        self._timed_replay: Optional[Tuple[Any, int]] = None
        self.quant_format = params_quant_format(params)
        self.weight_bytes = param_bytes(params)
        self.allocator: Optional[BlockAllocator] = None
        self.prefix_pool: Optional[PrefixPool] = None
        self._pool_cache: Optional[Dict] = None   # resident physical cache
        # decode and verify graphs of the resident pool, one a shape
        # (`_graph_key`), kept as long as the cache they address
        self._pool_graphs: Dict[tuple, DecodeGraph] = {}
        # retired per-batch caches with their graphs, least recently
        # retired first (`_take_arena`, `_retire_arena`)
        self._idle_arenas: List[CacheArena] = []
        self._slots_peak = 0
        if kv_blocks is not None:
            if not cache_mod.paged_supported(model.cfg):
                raise ValueError(
                    f"paged KV cache unsupported for arch "
                    f"{model.cfg.name!r} (see repro_torch.models.cache."
                    "paged_supported); use the dense max_slots budget")
            self.allocator = BlockAllocator(kv_blocks, kv_block_size)
            if kv_pool:
                self.prefix_pool = PrefixPool(self.allocator,
                                              evict=pool_evict)
        elif kv_pool:
            raise ValueError("kv_pool requires the paged cache (set "
                             "kv_blocks)")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1 "
                                 f"(got {prefill_chunk})")
            if self.allocator is None:
                raise ValueError("prefill_chunk requires the paged cache "
                                 "(set kv_blocks)")
        self.prefill_chunk = prefill_chunk
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
                "spec_proposed": reg.counter(
                    "serving_spec_proposed_total",
                    "Draft tokens proposed to speculative verify"),
                "spec_accepted": reg.counter(
                    "serving_spec_accepted_total",
                    "Draft tokens accepted by speculative verify"),
                "spec_accept": reg.histogram(
                    "serving_spec_accept_rate",
                    "Per-verify-step draft token accept rate",
                    buckets=RATIO_BUCKETS),
                "spec_tps": reg.gauge(
                    "serving_spec_tokens_per_step",
                    "Tokens committed per decode step "
                    "(last speculative verify)"),
                "pool_hits": reg.counter(
                    "serving_prefix_pool_hits_total",
                    "Full prefix blocks resolved from the resident "
                    "prefix-pool trie (prefill skipped)"),
                "pool_misses": reg.counter(
                    "serving_prefix_pool_misses_total",
                    "Full prefix blocks prefilled fresh and inserted "
                    "into the trie"),
                "pool_evictions": reg.counter(
                    "serving_prefix_pool_evictions_total",
                    "Idle (zero-ref) trie blocks evicted LRU to fit "
                    "new tails"),
                "pool_resident": reg.gauge(
                    "serving_prefix_pool_blocks_resident",
                    "KV blocks currently indexed by the prefix-pool trie"),
                "pool_ratio": reg.histogram(
                    "serving_prefix_pool_hit_ratio",
                    "Per-batch fraction of full prefix blocks served "
                    "from the trie", buckets=RATIO_BUCKETS),
                "prefix_groups": reg.gauge(
                    "serving_decode_prefix_groups",
                    "Row groups sharing prompt blocks at the last paged "
                    "decode step"),
                "prefix_share": reg.gauge(
                    "serving_decode_prefix_slot_share",
                    "Share of the last paged decode step's valid table "
                    "slots in blocks its row groups share"),
            }

    def _note_occupancy(self) -> None:
        if self._m is None:
            return
        if self.allocator is not None:
            used = self.allocator.blocks_in_use
            self._m["kv_blocks"].set(used)
            self._m["kv_high"].set_max(used)
            if self.prefix_pool is not None:
                self._m["pool_resident"].set(
                    self.prefix_pool.blocks_resident)
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
        with self.obs.tracer.span("enqueue"):
            logits, cache, _ = self.model.forward(params, batch, cache)
            if copy_src is not None:
                # CoW fan-out of the shared partial prefix block, in place
                cache = cache_mod.copy_cache_blocks(cache, copy_src,
                                                    copy_dst)
        return logits[:, -1], cache

    def _tail_prefill(self, tokens: torch.Tensor, start_pos: int, cache,
                      extras, block_table: torch.Tensor,
                      kv_len: int) -> torch.Tensor:
        """Prefill the prompt positions ``start_pos ..`` against the blocks
        already filled; returns the last position's logits.

        ``decode=True`` forces the cache-attending branch at S > 1: the
        queries write their KV through ``block_table`` in place before
        attending, then each attends to every cached position ``<=`` its
        own (the hit chain's prefix and the slice itself), gathered and
        sliced to ``kv_len``. The pooled and the chunked prefill run here;
        so does a zero-hit prompt, from position 0. Summed over other
        shapes than a one-shot prefill, its logits agree with it to f32
        rounding, not bit for bit."""
        B, S = tokens.shape
        pos = (start_pos + torch.arange(S, dtype=torch.int32,
                                        device=tokens.device))[None]
        pos = pos.expand(B, S)
        if self.model.cfg.mrope_sections:
            pos = pos[..., None].expand(B, S, 3)
        b = {"tokens": tokens, "positions": pos, "block_table": block_table,
             **extras}
        with self.obs.tracer.span("enqueue"):
            logits, _, _ = self.model.forward(self.params, b, cache,
                                              kv_len=kv_len, decode=True)
        return logits[:, -1]

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
    def pool_blocks_resident(self) -> Optional[int]:
        """Physical pool blocks resident right now. Per-batch pools live
        until their batch retires, so this can exceed ``blocks_in_use``
        after early releases; the resident prefix pool is ONE cache of
        ``kv_blocks`` blocks shared by every batch."""
        if self.allocator is None:
            return None
        if self.prefix_pool is not None:
            return self.allocator.n_blocks if self._pool_cache is not None \
                else 0
        return sum(h.paged.n_pool_blocks for h in self._live.values()
                   if h.paged is not None)

    @property
    def capacity_free(self) -> Optional[int]:
        """Admission budget remaining, in this backend's currency: KV blocks
        (paged) or sequence slots (dense); None = unbounded. Idle prefix-pool
        blocks count as free: a pooled start evicts them on demand."""
        if self.allocator is not None:
            free = self.allocator.blocks_free
            if self.prefix_pool is not None:
                free += self.prefix_pool.evictable_blocks
            return free
        return self.slots_free

    @property
    def capacity_total(self) -> Optional[int]:
        if self.allocator is not None:
            return self.allocator.n_blocks
        return self.max_slots

    def _spec_slack(self) -> int:
        """Extra token slots per sequence a speculative backend allocates.

        A verify step writes KV for all its queries before masking decides
        acceptance: a row that already finished (``committed == max_new``)
        still rides the fixed-shape forward with base position ``plen +
        max_new - 1``, writing up to ``plen + max_new - 1 + n``. Slack of
        ``spec_n + 1`` slots past the non-speculative last written position
        (``plen + max_new - 2``) covers the worst case; priced into
        `request_blocks` so admission stays exact."""
        return self.spec_n + 1 if self.spec_policy is not None else 0

    def request_blocks(self, plen: int, max_new: int, n_samples: int,
                       prompt: Optional[np.ndarray] = None) -> int:
        """Block cost of a request at shared-prefix price: the full prefix
        blocks once, plus per-sample privates (the CoW copy of a partial
        prefix block and the decode blocks). Mirrors `build_paged_layout`,
        with the speculative slack when a draft policy is attached.

        With the resident prefix pool and the prompt given, the cost is
        *marginal* against `capacity_free` (free + evictable blocks): a hit
        already pinned by a live batch (refcount >= 2) is free, while an
        idle hit still charges one unit, because admitting the request pins
        it and removes it from the evictable headroom. Under
        ``pool_evict="off"`` every hit is free. The lookup leaves the LRU
        order as it is."""
        bs = self.allocator.block_size
        horizon = max_new + self._spec_slack()
        n_logical = max(-(-(plen + horizon - 1) // bs), 1)
        full_prefix = plen // bs
        shared = full_prefix
        if prompt is not None and self.prefix_pool is not None:
            chain = self.prefix_pool.lookup(prompt, self._max_hit(plen),
                                            touch=False)
            if self.prefix_pool.evict_policy == "off":
                free_hits = len(chain)
            else:
                free_hits = sum(1 for g in chain
                                if self.allocator.refcount(g) >= 2)
            shared = full_prefix - free_hits
        return shared + n_samples * (n_logical - full_prefix)

    def request_cost(self, plen: int, max_new: int, n_samples: int,
                     prompt: Optional[np.ndarray] = None) -> int:
        """Admission cost in ``capacity_free`` units (blocks or slots)."""
        if self.allocator is not None:
            return self.request_blocks(plen, max_new, n_samples,
                                       prompt=prompt)
        return n_samples

    def marginal_request_cost(self, prompt: np.ndarray, max_new: int,
                              n_samples: int) -> int:
        """Post-dedup admission price of one request: `request_cost` with
        the prompt, so that hits pinned by live batches are free."""
        return self.request_cost(len(prompt), max_new, n_samples,
                                 prompt=np.asarray(prompt))

    def _max_hit(self, plen: int) -> int:
        """Cap on trie-reusable full prefix blocks: at least one prompt
        token stays in the tail, whose forward gives the logits of the
        first sample."""
        return (plen - 1) // self.allocator.block_size

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

    def note_spec(self, n: int) -> None:
        """Set the draft depth for the NEXT ``start_batch`` (the router's
        per-batch choice; 0 runs the batch without drafting). Depths above
        ``spec_n`` raise: the slack allocation is sized for ``spec_n``."""
        if self.spec_policy is None:
            raise RuntimeError("note_spec on a backend with no draft policy")
        n = int(n)
        if not 0 <= n <= self.spec_n:
            raise ValueError(f"spec depth {n} outside [0, {self.spec_n}] "
                             "(slack allocation is sized for spec_n)")
        self._next_spec_n = n

    def _consume_spec_n(self) -> int:
        """Draft depth the next batch runs at: the noted per-batch depth if
        the router set one, else the configured maximum."""
        if self.spec_policy is None:
            return 0
        n = self._next_spec_n if self._next_spec_n is not None else self.spec_n
        self._next_spec_n = None
        return n

    def _tokens(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _tile(self, t: torch.Tensor, rep: Union[int, np.ndarray]):
        if isinstance(rep, int):
            return torch.repeat_interleave(t, rep, dim=0)
        return torch.repeat_interleave(
            t, torch.as_tensor(rep, device=t.device), dim=0)

    def _cache(self, h: InFlightBatch) -> Dict:
        return self._pool_cache if h.pooled else h.cache

    def _graphs(self, h: InFlightBatch) -> Dict[tuple, DecodeGraph]:
        """The graphs over ``h``'s cache, by `_graph_key`."""
        return self._pool_graphs if h.pooled else h.arena.graphs

    def _take_arena(self, key: tuple, size: int,
                    make: Callable[[], Dict]) -> CacheArena:
        """The idle arena of ``key`` retired last, its cache reset in place
        to what ``make`` gives (positions -1, all else 0); else a new arena
        over ``make()``."""
        for i in range(len(self._idle_arenas) - 1, -1, -1):
            if self._idle_arenas[i].key == key:
                arena = self._idle_arenas.pop(i)
                cache_mod.reset_cache(arena.cache)
                return arena
        return CacheArena(key, make(), size)

    def _retire_arena(self, arena: CacheArena) -> None:
        """Keep a released batch's arena idle for the next batch of its
        shape, then drop the least recently retired ones until the idle
        arenas fit the KV budget."""
        self._idle_arenas.append(arena)
        if self.allocator is not None:
            budget = self.allocator.n_blocks
        else:
            budget = (self.max_slots if self.max_slots is not None
                      else self._slots_peak)
        while sum(a.size for a in self._idle_arenas) > budget:
            self._idle_arenas.pop(0)

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
        repeats through shared prefix blocks. With ``prefill_chunk`` the
        prefill is only planned here: ``decode_step`` runs it.
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
        with tracer.span("prefill") as span:
            n_spec = self._consume_spec_n()
            if self.prefix_pool is not None:
                h = self._start_batch_pooled(prompts, repeats, rep, base, B,
                                             plen, max_new, temperature,
                                             noise, extras)
                # only the post-dedup tails were prefilled
                prefilled = (len(prompts) * plen
                             - h.pool_hit_blocks * self.allocator.block_size)
            elif self.allocator is not None:
                h = self._start_batch_paged(prompts, repeats, rep, base, B,
                                            plen, max_new, temperature,
                                            noise, extras)
                prefilled = len(prompts) * plen  # one row per unique prompt
            else:
                h = self._start_batch_dense(prompts, repeats, rep, base, B,
                                            plen, max_new, temperature,
                                            noise, extras)
                prefilled = B * plen
            if h.pending_prefill is not None:
                # chunked: nothing forwarded yet; each slice meters its own
                # tokens, and the draft depth arms when the last one lands
                prefilled = 0
                h.pending_prefill.n_spec = n_spec
            elif n_spec > 0:
                self._arm_spec(h, n_spec)
            self._live[id(h)] = h
            if tracer.enabled:
                span.set(prefill_tokens=prefilled, n_sequences=B, plen=plen)
        if self._m is not None:
            self._m["tokens_in"].inc(prefilled)
            if h.pending_prefill is None:       # else metered at finish
                self._m["tokens_out"].inc(B)    # first token per sequence
            if self.prefix_pool is not None:
                lookupable = len(prompts) * (plen // self.allocator.block_size)
                self._m["pool_hits"].inc(h.pool_hit_blocks)
                self._m["pool_misses"].inc(lookupable - h.pool_hit_blocks)
                if h.pool_evictions:
                    self._m["pool_evictions"].inc(h.pool_evictions)
                if lookupable:
                    self._m["pool_ratio"].observe(
                        h.pool_hit_blocks / lookupable)
            self._note_occupancy()
        return h

    def _first_token(self, h: InFlightBatch, last_logits: torch.Tensor,
                     rep) -> InFlightBatch:
        """Sample the first token from the prefill logits, fanned out to the
        repeats (identical rows for the repeats of one prompt)."""
        lf = self._tile(last_logits.float(), rep)
        tok, lp = sample_tokens(lf, h.temperature, h.noise)
        h.tok = tok
        h.step = 1
        toks, lps = _host(self.obs.tracer, tok, self._step_lp(lp))
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
        length = plen + max_new + self._spec_slack()
        key = ("dense", B, length)
        cond_len = None
        if self.model.cfg.cross_kv_cache and "cond_memory" in extras:
            # the cache's cross K/V entries hold the memory's rows
            cond_len = int(extras["cond_memory"].shape[1])
            key += (cond_len,)
        arena = self._take_arena(
            key, B, lambda: self.model.init_cache(B, length, cond_len))
        last_logits, _ = self._prefill(self.params, self._tokens(tokens),
                                       arena.cache, tiled_extras)
        self.slots_in_use += B
        self._slots_peak = max(self._slots_peak, self.slots_in_use)
        h = InFlightBatch(
            prompts=list(prompts), repeats=repeats, plen=plen,
            max_new=max_new, temperature=temperature, noise=noise,
            extras=tiled_extras, arena=arena, tok=None, step=0)
        # the first token comes from the prefill logits of each (tiled) row
        return self._first_token(h, last_logits, 1)

    def _slices(self, starts: Dict[int, List[int]],
                plen: int) -> Deque[Tuple[List[int], int, int]]:
        """Prefill jobs: for each start position (the prompts whose tail
        begins there), slices of at most ``prefill_chunk`` tokens up to
        ``plen``, or one slice without chunking."""
        step = self.prefill_chunk or plen
        jobs: Deque[Tuple[List[int], int, int]] = deque()
        for s, idxs in sorted(starts.items()):
            while s < plen:
                e = min(s + step, plen)
                jobs.append((idxs, s, e))
                s = e
        return jobs

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
        layout = build_paged_layout(self.allocator, plen,
                                    max_new + self._spec_slack(), repeats)
        try:
            n_pool = layout.n_pool_blocks
            arena = self._take_arena(
                ("paged", n_pool), n_pool,
                lambda: self.model.init_paged_cache(
                    n_pool, layout.block_size,
                    kv_dtype=torch.int8 if self.kv_format == "int8"
                    else None))
            cache = arena.cache
            # prefill rows are the unique prompts (extras per prompt as is);
            # decode rows are the tiled sequences: both tiled exactly once
            decode_extras = {k: self._tile(v, rep) for k, v in extras.items()}
            h = InFlightBatch(
                prompts=list(prompts), repeats=repeats, plen=plen,
                max_new=max_new, temperature=temperature, noise=noise,
                extras=decode_extras, arena=arena, tok=None, step=0,
                paged=layout, block_table=self._tokens(layout.decode_table),
                prefix_groups=self._tokens(layout.prefix_groups),
                prefill_bytes_saved=float((B - R) * plen
                                          * self.kv_token_bytes))
            if self.prefill_chunk is not None:
                # chunked: the fresh (or reset) cache masks every position,
                # so slices can fill it one at a time; `decode_step` drains
                # them
                h.pending_prefill = PendingPrefill(
                    jobs=self._slices({0: list(range(R))}, plen), base=base,
                    extras=extras, last_rows=[None] * R, rep=rep,
                    full_prefix=0)
                return h
            has_cow = layout.copy_src.size > 0
            last_logits, _ = self._prefill(
                self.params, self._tokens(base), cache, extras,
                self._tokens(layout.prefill_table),
                self._tokens(layout.copy_src) if has_cow else None,
                self._tokens(layout.copy_dst) if has_cow else None)
        except BaseException:
            # no handle exists yet to release(): return every reference the
            # layout took, or a failed prefill permanently shrinks the budget
            self._free_layout(layout)
            raise
        return self._first_token(h, last_logits, rep)

    def _free_layout(self, layout: PagedBatchLayout) -> None:
        for gids in layout.seq_gids:
            for g in gids:
                self.allocator.free(g)

    def _ensure_pool_cache(self) -> Dict:
        """The single resident physical cache, sized to the whole
        ``kv_blocks`` budget and made at the first pooled batch. Block
        tables index it with global allocator ids; it outlives every batch,
        and nothing rebinds its tensors (the decode graphs address them)."""
        if self._pool_cache is None:
            self._pool_cache = self.model.init_paged_cache(
                self.allocator.n_blocks, self.allocator.block_size,
                kv_dtype=torch.int8 if self.kv_format == "int8" else None)
        return self._pool_cache

    def _start_batch_pooled(self, prompts, repeats, rep, base, B, plen,
                            max_new, temperature, noise,
                            extras) -> InFlightBatch:
        """Paged start on the resident prefix pool: resolve each prompt's
        longest cached block chain (pinning it with per-sequence refs),
        evict idle LRU blocks to fit the post-dedup tails, reset the
        positions of the blocks allocated fresh, then prefill *only the
        tails*, one forward per hit depth (or, chunked, plan them), fan the
        CoW blocks out and index the newly filled chains."""
        pool = self.prefix_pool
        alloc = self.allocator
        bs = alloc.block_size
        R = len(prompts)
        full_prefix = plen // bs
        # 1. acquire hit chains first: refs pin them, so the eviction pass
        #    below can never reclaim a block this batch just resolved
        hit_chains = [pool.acquire(p, self._max_hit(plen), holders=k)
                      for p, k in zip(prompts, repeats)]
        horizon = max_new + self._spec_slack()
        n_logical = max(-(-(plen + horizon - 1) // bs), 1)
        need = sum(full_prefix - len(ch) + k * (n_logical - full_prefix)
                   for ch, k in zip(hit_chains, repeats))
        # 2. make room for the tails (LRU over idle trie leaves only)
        evicted = pool.ensure_free(need)
        if need > alloc.blocks_free:
            for ch, k in zip(hit_chains, repeats):
                for g in ch:
                    for _ in range(k):
                        alloc.free(g)
            raise RuntimeError(
                f"KV block budget exceeded: need {need} tail blocks > "
                f"{alloc.blocks_free} free after {evicted} eviction(s) "
                "(scheduler must check capacity_free)")
        # 3. static block schedule over GLOBAL ids (cannot fail past the
        #    check above)
        layout = build_paged_layout(alloc, plen, horizon, repeats,
                                    hit_chains=hit_chains)
        try:
            cache = self._ensure_pool_cache()
            # a block back from the free list still holds its previous
            # occupant's positions; a stale slot of a partly filled tail
            # block would become visible once decode moves past it
            hit_gids = {g for ch in hit_chains for g in ch}
            fresh = sorted({g for gids in layout.seq_gids
                            for g in gids} - hit_gids)
            if fresh:
                cache_mod.reset_cache_block_positions(cache,
                                                      self._tokens(fresh))
            # 4. tail-only prefill, one job per hit depth (chunked: slices)
            starts: Dict[int, List[int]] = {}
            for i, c in enumerate(layout.hit_counts):
                starts.setdefault(c * bs, []).append(i)
            tail_tokens = sum(plen - c * bs for c in layout.hit_counts)
            h = InFlightBatch(
                prompts=list(prompts), repeats=repeats, plen=plen,
                max_new=max_new, temperature=temperature, noise=noise,
                extras={k: self._tile(v, rep) for k, v in extras.items()},
                arena=None, tok=None, step=0, paged=layout,
                block_table=self._tokens(layout.decode_table),
                prefix_groups=self._tokens(layout.prefix_groups),
                prefill_bytes_saved=float((B * plen - tail_tokens)
                                          * self.kv_token_bytes),
                pool_hit_blocks=sum(layout.hit_counts),
                pool_evictions=evicted,
                pending_prefill=PendingPrefill(
                    jobs=self._slices(starts, plen), base=base,
                    extras=extras, last_rows=[None] * R, rep=rep,
                    full_prefix=full_prefix))
            if self.prefill_chunk is None:
                while h.pending_prefill.jobs:
                    self._prefill_job(h)
                self._finish_prefill(h)
        except BaseException:
            # every reference the batch took (hits included: their holder
            # refs unwind to the trie ref) must return
            self._free_layout(layout)
            raise
        return h

    def _prefill_job(self, h: InFlightBatch) -> Tuple[List[int], int, int]:
        """Run the next prefill slice of ``h`` through `_tail_prefill`;
        returns it."""
        pp = h.pending_prefill
        idxs, s, e = pp.jobs.popleft()
        sel = torch.as_tensor(idxs, device=self.device)
        gl = self._tail_prefill(
            self._tokens(pp.base[idxs][:, s:e]), s, self._cache(h),
            {k: v[sel] for k, v in pp.extras.items()},
            self._tokens(h.paged.prefill_table[idxs]), h.plen)
        if e == h.plen:
            for j, i in enumerate(idxs):
                pp.last_rows[i] = gl[j]
        return idxs, s, e

    def _finish_prefill(self, h: InFlightBatch) -> None:
        """The last slice landed: CoW-fan-out the shared partial block,
        index the now-filled full-prefix chains (resident pool), sample the
        first token with the one-shot path's noise draw, and arm the draft
        state if a chunked batch noted a depth."""
        pp = h.pending_prefill
        layout = h.paged
        if layout.copy_src.size > 0:
            cache_mod.copy_cache_blocks(self._cache(h),
                                        self._tokens(layout.copy_src),
                                        self._tokens(layout.copy_dst))
        if h.pooled:
            # after the fill: the trie must never point at unfilled blocks;
            # a same-prefix sibling of this batch keeps the first writer's
            for i, p in enumerate(h.prompts):
                self.prefix_pool.insert(
                    p, [int(g) for g in
                        layout.prefill_table[i][:pp.full_prefix]])
        self._first_token(h, torch.stack(pp.last_rows), pp.rep)
        h.pending_prefill = None
        if pp.n_spec > 0:
            self._arm_spec(h, pp.n_spec)

    def _arm_spec(self, h: InFlightBatch, n: int) -> None:
        """Start ``h``'s draft state at depth ``n`` from its first token:
        each row's history is its prompt and that token."""
        first, lp0 = h.out_toks[0], h.out_lps[0]
        hists: List[np.ndarray] = []
        for prompt, k in zip(h.prompts, h.repeats):
            p = np.asarray(prompt, np.int64).ravel()
            for _ in range(k):
                i = len(hists)
                hists.append(np.concatenate([p, first[i:i + 1].astype(
                    np.int64)]))
        h.spec = SpecState(
            policy=self.spec_policy, n=n,
            committed=np.ones(h.n_sequences, np.int64), histories=hists,
            toks=[[int(t)] for t in first], lps=[[float(x)] for x in lp0])

    def _prefill_chunk_step(self, h: InFlightBatch) -> None:
        """Run ONE pending prefill slice: the unit a ``decode_step`` call
        spends instead of a token while a chunked prefill drains."""
        tracer = self.obs.tracer
        t0 = time.perf_counter() if tracer.enabled else 0.0
        idxs, s, e = self._prefill_job(h)
        if tracer.enabled:
            tracer.emit("prefill", t0, time.perf_counter(), clock="wall",
                        prefill_tokens=len(idxs) * (e - s),
                        n_sequences=h.n_sequences, plen=h.plen,
                        chunk=[s, e])
        if self._m is not None:
            self._m["tokens_in"].inc(len(idxs) * (e - s))
        if not h.pending_prefill.jobs:
            self._finish_prefill(h)
            if self._m is not None:
                self._m["tokens_out"].inc(h.n_sequences)

    def park_batch(self, h: InFlightBatch,
                   histories: Sequence[np.ndarray]) -> int:
        """Preemption handoff: index the victim's *filled* full blocks in
        the resident prefix pool before releasing the batch, so resuming it
        is a trie hit that prefills only the post-preemption tail.

        ``histories[i]`` is sequence row *i*'s token history (prompt +
        committed tokens). After ``step`` sampled tokens the KV holds
        positions through ``plen + step - 2`` (the newest token is sampled,
        not yet written), so the leading ``(len(history) - 1) //
        block_size`` blocks of the row's table are full and correct.
        Returns parked blocks; releases instead when there is no resident
        pool, or mid-chunked-prefill (no block is guaranteed filled)."""
        pool = self.prefix_pool
        if pool is None or h.paged is None or h.pending_prefill is not None:
            self.release(h)
            return 0
        if len(histories) != h.n_sequences:
            raise ValueError(
                f"park_batch needs one history per sequence row "
                f"({h.n_sequences}), got {len(histories)}")
        bs = self.allocator.block_size
        parked = 0
        for i, hist in enumerate(histories):
            if i in h.freed_seqs:
                continue
            hist = np.asarray(hist)
            filled = (len(hist) - 1) // bs
            if filled <= 0:
                continue
            pool.insert(hist, [int(g) for g in
                               h.paged.decode_table[i][:filled]])
            parked += filled
        self.release(h)
        return parked

    @torch.no_grad()
    def decode_step(self, h: InFlightBatch) -> bool:
        """Advance one token (or run one slice of a pending chunked
        prefill); returns True while the batch still has steps left (so
        ``while backend.decode_step(h): pass`` drains it)."""
        if h.pending_prefill is not None:
            self._prefill_chunk_step(h)
            return True
        if h.spec is not None:
            return self._spec_decode_step(h)
        if h.done:
            return False
        tracer = self.obs.tracer
        with tracer.span("decode") as span:
            step_pos = h.plen + h.step - 1
            if h.graph is None and self._graphs_on(h):
                graphs = self._graphs(h)
                key = self._graph_key(h) + ("decode", not h.temperature > 0)
                h.graph = graphs.get(key)
                if h.graph is None and h.step >= 2:
                    # no fallback: a capture that fails raises
                    t_cap = time.perf_counter()
                    h.graph = DecodeGraph.capture(self._static_step(h),
                                                  timed=tracer.enabled)
                    self.graph_stats.captures += 1
                    self.graph_stats.capture_s += \
                        time.perf_counter() - t_cap
                    self.graph_stats.pool_bytes += h.graph.pool_bytes
                    graphs[key] = h.graph
            timed = (tracer.enabled and h.graph is not None
                     and h.graph.timer is not None
                     and (self.graph_stats.replays + 1)
                     % DEVICE_TIME_EVERY == 0)
            with tracer.span("enqueue"):
                if h.graph is not None:
                    # the graph serves every batch of its shape: load this
                    # batch's last tokens, decode inputs and temperature,
                    # and keep its sampled tokens apart from the graph's
                    # output, which the next replay overwrites
                    tok, lp = h.graph.replay(step_pos, h.noise, tok=h.tok,
                                             inputs=self._decode_inputs(h),
                                             temperature=h.temperature,
                                             timed=timed)
                    h.tok = tok.clone()
                    self.graph_stats.replays += 1
                else:
                    pos = torch.full((h.n_sequences, 1), step_pos,
                                     dtype=torch.int32, device=h.tok.device)
                    h.tok, lp = self._decode_fn(h, self._decode_inputs(h))(
                        h.tok[:, None], pos, h.noise, self._temperature(h))
            if self._timed_replay is not None:
                self._read_device_time()
            toks, lps = _host(tracer, h.tok, self._step_lp(lp))
            h.out_toks.append(toks)
            h.out_lps.append(lps)
            h.step += 1
            if h.paged is not None and (tracer.enabled
                                        or self._m is not None):
                groups, share = h.paged.prefix_stats(step_pos + 1)
                if tracer.enabled:
                    span.set(prefix_groups=groups, prefix_slot_share=share)
                if self._m is not None:
                    self._m["prefix_groups"].set(groups)
                    self._m["prefix_share"].set(share)
            if tracer.enabled:
                span.set(step=h.step, n_sequences=h.n_sequences)
        if timed:
            self._timed_replay = (h.graph.timer, span.span_id)
        if self._m is not None:
            self._m["tokens_out"].inc(h.n_sequences - len(h.freed_seqs))
        return not h.done

    def _read_device_time(self) -> None:
        """Read the last timed replay's segments (a ``readout`` span) and
        emit them as its ``device_time`` span, both children of its
        ``decode`` span: ms by segment summed over layers, and
        ``total_ms``."""
        timer, decode_id = self._timed_replay
        self._timed_replay = None
        tracer = self.obs.tracer
        with tracer.span("readout", parent_id=decode_id):
            ms = timer.read()
        tracer.emit("device_time", time.perf_counter(), clock="wall",
                    parent_id=decode_id, **ms)

    def _step_lp(self, lp: torch.Tensor) -> torch.Tensor:
        """A step's logprob a sequence: with K codebooks the mean of the K
        sampled tokens' logprobs (B, K), as the reference records it."""
        return lp.mean(-1) if self._multi_codebook else lp

    @property
    def _multi_codebook(self) -> bool:
        return self.model.cfg.n_codebooks > 1

    def _graphs_on(self, h: InFlightBatch) -> bool:
        """Whether ``h`` decodes through a CUDA graph: on the card, unless
        the backend was built with ``cuda_graphs=False``."""
        return self.cuda_graphs and h.tok.is_cuda

    def _graph_key(self, h: InFlightBatch) -> tuple:
        """The shape of ``h``'s steps: what a graph bakes in besides its
        cache (whose shape keys the arena that holds it) and the weights.
        Rows, table shape, logical cache length and KV format, and the
        shapes of any extra inputs. A decode graph's key adds whether it
        samples, a verify graph's its draft depth too, as the reference
        keys its jit programs by ``greedy``; the temperature is a buffer
        each replay fills."""
        return (h.n_sequences,
                None if h.block_table is None else tuple(
                    h.block_table.shape),
                None if h.paged is None else h.paged.kv_len, self.kv_format,
                tuple((k, tuple(v.shape), v.dtype)
                      for k, v in sorted(h.extras.items())))

    def _temperature(self, h: InFlightBatch) -> torch.Tensor:
        """``h``'s temperature as the 0-dim f32 tensor an eager step reads,
        as a graph's step reads its buffer."""
        return torch.full((), h.temperature, dtype=torch.float32,
                          device=self.device)

    def _decode_inputs(self, h: InFlightBatch) -> Dict[str, torch.Tensor]:
        """A batch's decode inputs besides tokens and positions."""
        inputs = dict(h.extras)
        if h.block_table is not None:
            inputs["block_table"] = h.block_table
            inputs["prefix_groups"] = h.prefix_groups
        return inputs

    def _decode_fn(self, h: InFlightBatch, inputs: Dict[str, torch.Tensor]):
        """The reference's ``_decode_step`` for ``h``: ``(tok (B, 1) token
        ids, pos (B, 1) int32 positions, noise, temperature (0-dim f32)) ->
        (tokens, logprobs)``, one decode step over the batch's cache,
        updated in place, reading the decode ``inputs`` given. Closes over
        the batch's cache and shape, not the handle or the backend, so a
        graph that holds it holds neither."""
        model, params, cache = self.model, self.params, self._cache(h)
        sampled = h.temperature > 0
        kv_len = h.paged.kv_len if h.paged is not None else None
        mrope = bool(model.cfg.mrope_sections)

        def decode(tok, pos, noise, temperature):
            if mrope:
                pos = pos[..., None].expand(tok.shape[0], 1, 3)
            logits, _, _ = model.forward(
                params, {"tokens": tok, "positions": pos, **inputs},
                cache, kv_len=kv_len)
            mark("head.sample")
            return sample_tokens(logits[:, 0].float(), temperature, noise,
                                 sampled)
        return decode

    def _static_step(self, h: InFlightBatch) -> StaticDecodeStep:
        """The body of the decode graph of ``h``'s shape, over static copies
        of ``h``'s last token and decode inputs, which each replay refills
        from its batch's."""
        inputs = {k: v.clone() for k, v in self._decode_inputs(h).items()}
        return StaticDecodeStep(self._decode_fn(h, inputs), h.tok,
                                self.model.cfg.padded_vocab,
                                sampled=h.temperature > 0, inputs=inputs)

    # ------------------------------------------------------ speculative decode
    def _spec_decode_step(self, h: InFlightBatch) -> bool:
        """One draft -> verify -> commit round of a speculative batch.

        Rows progress raggedly: each commits ``accept_len + 1`` tokens,
        clamped to its remaining horizon room; a finished row stays in the
        fixed-shape verify (its writes land in the slack slots, see
        `_spec_slack`) but commits nothing. Early-released rows
        (``freed_seqs``) keep committing as the non-speculative path keeps
        sampling them (their tokens just stop counting toward metrics), so
        a release between verify steps touches the allocator exactly once a
        block, never the in-flight verify state."""
        if h.done:
            return False
        sp = h.spec
        tracer = self.obs.tracer
        t_step = time.perf_counter() if tracer.enabled else 0.0
        B = h.n_sequences
        n = sp.n
        drafts = np.asarray(sp.policy.propose(sp.histories, n), np.int32)
        if drafts.shape != (B, n):
            raise ValueError(f"draft policy {sp.policy.name!r} returned "
                             f"shape {drafts.shape}, expected {(B, n)}")
        t_draft = time.perf_counter() if tracer.enabled else 0.0
        if tracer.enabled:
            tracer.emit("draft", t_step, t_draft, clock="wall",
                        policy=sp.policy.name, n=n, n_sequences=B)
        last = np.asarray([row[-1] for row in sp.toks], np.int32)
        toks_in = np.concatenate([last[:, None], drafts], axis=1)
        base_pos = np.asarray(h.plen + sp.committed - 1, np.int32)
        accept_len, out_tokens, out_lps = self._verify(h, toks_in, base_pos)

        emitted = 0             # metric-visible tokens (non-released rows)
        committed_this = 0      # tokens committed by rows still decoding
        accepted_this = 0
        active = 0
        for b in range(B):
            room = h.max_new - int(sp.committed[b])
            if room <= 0:
                continue        # finished row: verify output discarded
            active += 1
            a = int(accept_len[b])
            accepted_this += a
            sp.proposed += n
            sp.accepted += a
            e = min(a + 1, room)
            new = out_tokens[b, :e]
            sp.toks[b].extend(int(t) for t in new)
            sp.lps[b].extend(float(x) for x in out_lps[b, :e])
            sp.histories[b] = np.concatenate(
                [sp.histories[b], new.astype(np.int64)])
            sp.committed[b] += e
            committed_this += e
            if b not in h.freed_seqs:
                emitted += e
        sp.steps += 1
        h.step = int(sp.committed.min())
        if tracer.enabled:
            now = time.perf_counter()
            tracer.emit("verify", t_draft, now, clock="wall", n=n,
                        n_sequences=B, accepted=accepted_this)
            tracer.emit("decode", t_step, now, clock="wall", step=h.step,
                        n_sequences=B)
        if self._m is not None:
            self._m["tokens_out"].inc(emitted)
            if active and n > 0:
                self._m["spec_proposed"].inc(active * n)
                self._m["spec_accepted"].inc(accepted_this)
                self._m["spec_accept"].observe(accepted_this / (active * n))
                self._m["spec_tps"].set(committed_this / active)
        return not h.done

    def _verify(self, h: InFlightBatch, toks_in: np.ndarray,
                base_pos: np.ndarray) -> Tuple[np.ndarray, ...]:
        """One verify forward of ``h`` over ``toks_in`` (B, n + 1) from
        ``base_pos`` (B,); returns (accept_len, out_tokens, out_lps) on the
        host. A sampled batch draws its uniforms and Gumbel row from its
        noise stream first (outside any graph). On the card the verify graph
        of the batch's shape and draft depth serves it (on the pool and off
        it, as `decode_step`'s graphs do); a batch whose shape has none yet
        verifies eagerly first and captures at its second verify."""
        B, n_q = toks_in.shape
        greedy = h.temperature == 0.0
        toks, pos = self._tokens(toks_in), self._tokens(base_pos)
        draws = {} if greedy else dict(zip("ug", verify_draws(
            h.noise, B, n_q - 1, self.model.cfg.padded_vocab, self.device)))
        if h.verify_graph is None and self._graphs_on(h):
            graphs = self._graphs(h)
            key = self._graph_key(h) + ("verify", n_q - 1, greedy)
            h.verify_graph = graphs.get(key)
            if h.verify_graph is None and h.spec.steps >= 1:
                # no fallback: a capture that fails raises
                t_cap = time.perf_counter()
                h.verify_graph = DecodeGraph.capture(
                    self._static_verify(h, n_q - 1))
                self.graph_stats.verify_captures += 1
                self.graph_stats.capture_s += time.perf_counter() - t_cap
                self.graph_stats.pool_bytes += h.verify_graph.pool_bytes
                graphs[key] = h.verify_graph
        if h.verify_graph is not None:
            out = h.verify_graph.replay(toks, pos, **draws,
                                        inputs=self._decode_inputs(h),
                                        temperature=h.temperature)
            self.graph_stats.verify_replays += 1
        else:
            out = self._verify_fn(h, self._decode_inputs(h))(
                toks, pos, draws.get("u"), draws.get("g"),
                self._temperature(h))
        return _host(self.obs.tracer, *out)

    def _verify_fn(self, h: InFlightBatch, inputs: Dict[str, torch.Tensor]):
        """The reference's ``_spec_verify`` for ``h``: ``(toks (B, n + 1),
        base_pos (B,) int32, u, g, temperature (0-dim f32)) -> (accept_len,
        out_tokens, out_lps)``, one forward at S = n + 1 with
        ``decode=True`` over the batch's cache (updated in place: the S
        positions are written before they are attended), then
        `verify_tokens`. Rows progress raggedly, so each has its own base
        position. Closes over the batch's cache and shape, not the handle
        or the backend."""
        model, params, cache = self.model, self.params, self._cache(h)
        greedy = h.temperature == 0.0
        kv_len = h.paged.kv_len if h.paged is not None else None
        mrope = bool(model.cfg.mrope_sections)

        def verify(toks, base_pos, u, g, temperature):
            B, n_q = toks.shape
            pos = base_pos[:, None] + torch.arange(
                n_q, dtype=torch.int32, device=toks.device)[None]
            if mrope:
                pos = pos[..., None].expand(B, n_q, 3)
            logits, _, _ = model.forward(
                params, {"tokens": toks, "positions": pos, **inputs},
                cache, kv_len=kv_len, decode=True)
            return verify_tokens(logits, toks[:, 1:], temperature, greedy,
                                 u, g)
        return verify

    def _static_verify(self, h: InFlightBatch, n: int) -> StaticVerifyStep:
        """The body of the verify graph of ``h``'s shape at depth ``n``,
        over static copies of the decode inputs, which each replay refills
        from its batch's."""
        inputs = {k: v.clone() for k, v in self._decode_inputs(h).items()}
        return StaticVerifyStep(self._verify_fn(h, inputs), h.n_sequences, n,
                                self.model.cfg.padded_vocab, self.device,
                                sampled=h.temperature > 0, inputs=inputs)

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
        if h.arena is not None:
            # its cache and graphs wait for the next batch of its shape
            self._retire_arena(h.arena)
        h.arena = None
        h.graph = None
        h.verify_graph = None
        self._note_occupancy()

    def release_sequences(self, h: InFlightBatch,
                          seq_indices: Sequence[int]) -> int:
        """Early-release finished sequences' KV budget (CSVET early stop).
        The batch keeps decoding with its shapes, but the released rows'
        blocks/slots are free for new admissions now. Returns blocks (or
        slots) actually returned to the budget; shared prefix blocks only
        come back with their last holder. This frees budget, not bytes: a
        per-batch pool is resident until retirement. As in the reference,
        the released rows go on writing their KV through their tables; on
        the resident pool those blocks may already belong to a later
        batch."""
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
        if h.spec is not None:
            # ragged per-sequence lists -> (B, max_new); the commit clamp
            # means done implies every row holds exactly max_new tokens
            toks = np.asarray([row[:h.max_new] for row in h.spec.toks],
                              np.int64)
            lps = np.asarray([row[:h.max_new] for row in h.spec.lps],
                             np.float32)
        else:
            toks = np.stack(h.out_toks, axis=1)         # (B, T[, K])
            lps = np.stack(h.out_lps, axis=1)           # (B, T)
        results = []
        offset = 0
        for prompt, ns in zip(h.prompts, h.repeats):
            sl = slice(offset, offset + ns)
            offset += ns
            samples = [toks[i] for i in range(sl.start, sl.stop)]
            if self.eos_token is not None and not self._multi_codebook:
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
