"""Global prefix-sharing KV pool: a radix-trie index over filled KV blocks.

A copy of ``repro.serving.prefix_pool`` (numpy only), so that the port does
not import the reference. `PrefixPool` promotes the `BlockAllocator` budget
to a single resident pool that outlives batches:

* The trie is keyed on *token-id block chunks*: each node owns one physical
  KV block holding the keys/values of exactly ``block_size`` tokens, and the
  path from the root spells the token prefix those blocks encode. Causal
  attention makes block content a pure function of its token chain, so any
  request whose prompt extends a cached chain can reuse the chain's blocks
  verbatim and prefill only the tail.
* ``lookup`` resolves a prompt to the longest chain of already-filled
  blocks in one trie walk (unique by construction: children are keyed by
  chunk bytes, so at most one child matches each step).
* Residency holds ONE allocator reference per node (the "trie ref") and
  marks the block protected; live requests hold their own refs on top via
  ``acquire``. A block whose refcount has fallen back to 1 is *cached but
  idle*: reclaimable, never on the free list.
* Eviction (`ensure_free`) peels idle leaves in LRU order. Evicting a block
  with live holder refs is a hard error, as is returning a trie-resident
  block to the free list behind the pool's back (`BlockAllocator.free`
  raises, naming the block and its owning prefix).

Holders always reference whole chains from the root (``acquire`` forks every
block on the hit path; layouts built on top append the freshly filled tail
blocks), so a node with refcount 1 has no held descendants either: every
idle node is eventually reachable by leaf-first peeling.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def chunk_key(tokens: np.ndarray, start: int, block_size: int) -> bytes:
    """Canonical bytes key of one full block chunk of token ids.

    Token dtype is canonicalized (prompts arrive as int32 or int64 depending
    on the producer) so the same ids always hash to the same node; multi-
    codebook prompts of shape (L, K) chunk along the first axis.
    """
    chunk = np.ascontiguousarray(
        np.asarray(tokens)[start:start + block_size], dtype=np.int64)
    return chunk.tobytes()


class _TrieNode:
    __slots__ = ("chunk", "block", "children", "parent", "last_touch",
                 "depth", "preview")

    def __init__(self, chunk: bytes, block: int, parent: "_TrieNode",
                 depth: int, preview: tuple):
        self.chunk = chunk
        self.block = block
        self.children: Dict[bytes, _TrieNode] = {}
        self.parent = parent
        self.last_touch = 0
        self.depth = depth                 # 1-based chain position
        self.preview = preview             # first token ids of the chunk

    def describe(self) -> str:
        return f"depth {self.depth}, chunk tokens {list(self.preview)}..."


class PrefixPool:
    """Radix-trie block reuse across the request stream (see module doc).

    The pool layers cached-block state over a `BlockAllocator`; it never
    allocates blocks itself — callers fill blocks through their batch
    layouts and `insert` the completed full-prefix chains afterwards, so the
    trie only ever indexes blocks whose KV content is final.
    """

    EVICT_POLICIES = ("lru", "off")

    def __init__(self, allocator, evict: str = "lru"):
        if evict not in self.EVICT_POLICIES:
            raise ValueError(f"unknown eviction policy {evict!r} "
                             f"(supported: {self.EVICT_POLICIES})")
        self.allocator = allocator
        self.evict_policy = evict
        self._root = _TrieNode(b"", -1, None, 0, ())  # type: ignore[arg-type]
        self._by_block: Dict[int, _TrieNode] = {}
        self._clock = 0                    # LRU recency counter
        self.evictions = 0                 # lifetime evicted blocks

    # ------------------------------------------------------------- queries
    @property
    def blocks_resident(self) -> int:
        """Blocks currently indexed by the trie (held + idle)."""
        return len(self._by_block)

    @property
    def evictable_blocks(self) -> int:
        """Idle resident blocks (refcount == trie ref only) reclaimable by
        eviction — counted into the scheduler's admission headroom. All of
        them are reachable by leaf-first peeling (module doc), so the count
        is exact, not a bound."""
        if self.evict_policy == "off":
            return 0
        return sum(1 for n in self._by_block.values()
                   if self.allocator.refcount(n.block) == 1)

    def owner_of(self, bid: int) -> Optional[str]:
        node = self._by_block.get(bid)
        return node.describe() if node is not None else None

    def lookup(self, tokens: np.ndarray, max_blocks: int,
               touch: bool = True) -> List[int]:
        """Longest cached prefix of ``tokens``, as its chain of block ids
        (possibly empty), capped at ``max_blocks`` full blocks. One trie
        walk; ``touch=False`` for cost queries that must not perturb LRU."""
        bs = self.allocator.block_size
        node = self._root
        chain: List[int] = []
        for i in range(max(0, int(max_blocks))):
            child = node.children.get(chunk_key(tokens, i * bs, bs))
            if child is None:
                break
            chain.append(child.block)
            node = child
            if touch:
                self._clock += 1
                node.last_touch = self._clock
        return chain

    # ------------------------------------------------------------ mutation
    def acquire(self, tokens: np.ndarray, max_blocks: int,
                holders: int) -> List[int]:
        """Look up the longest cached prefix and take ``holders`` references
        on every block of the chain (one per sequence that will read through
        it). Pinning happens here, before any eviction the caller runs for
        its tail blocks, so a hit chain can never be evicted out from under
        the batch that just resolved it."""
        chain = self.lookup(tokens, max_blocks, touch=True)
        for bid in chain:
            for _ in range(holders):
                self.allocator.fork(bid)
        return chain

    def insert(self, tokens: np.ndarray, chain: List[int]) -> int:
        """Index a prompt's freshly filled full-prefix chain. ``chain[i]``
        must hold the KV of tokens ``[i*bs, (i+1)*bs)``; chunks already
        resident are kept (first writer wins — a same-prefix sibling in one
        batch filled a duplicate block, which simply stays a plain
        refcounted block). Returns blocks newly indexed; each takes one trie
        ref and protection."""
        bs = self.allocator.block_size
        node = self._root
        created = 0
        for i, bid in enumerate(chain):
            key = chunk_key(tokens, i * bs, bs)
            child = node.children.get(key)
            if child is None:
                preview = tuple(np.asarray(
                    np.frombuffer(key, np.int64)[:4]).tolist())
                child = _TrieNode(key, bid, node, node.depth + 1, preview)
                self.allocator.fork(bid)
                self.allocator.protect(bid, child.describe())
                node.children[key] = child
                self._by_block[bid] = child
                created += 1
            self._clock += 1
            child.last_touch = self._clock
            node = child
        return created

    def evict(self, bid: int) -> None:
        """Drop one resident block: release the trie ref (returning the
        block to the free list) and unlink its node. Hard errors: a block
        with live holder refs, or an interior node whose children would be
        orphaned — eviction is leaf-first by construction."""
        node = self._by_block.get(bid)
        if node is None:
            raise KeyError(f"evict of block {bid} not resident in the pool")
        live = self.allocator.refcount(bid) - 1
        if live > 0:
            raise RuntimeError(
                f"evicting trie-resident block {bid} (owning prefix: "
                f"{node.describe()}) with {live} live holder ref(s) — "
                "eviction requires zero-ref trie nodes")
        if node.children:
            raise RuntimeError(
                f"evicting interior trie block {bid} (owning prefix: "
                f"{node.describe()}) would orphan {len(node.children)} "
                "resident child block(s)")
        del node.parent.children[node.chunk]
        del self._by_block[bid]
        self.allocator.unprotect(bid)
        self.allocator.free(bid)
        self.evictions += 1

    def ensure_free(self, n_blocks: int) -> int:
        """Evict idle leaves (LRU order) until the allocator has
        ``n_blocks`` free, or no candidate remains. Returns blocks evicted;
        a no-op under the ``off`` policy — the caller's budget check then
        fails loudly instead of reclaiming."""
        evicted = 0
        if self.evict_policy == "off":
            return 0
        while self.allocator.blocks_free < n_blocks:
            victim: Optional[_TrieNode] = None
            for node in self._by_block.values():
                if node.children:
                    continue               # interior: peel its leaves first
                if self.allocator.refcount(node.block) != 1:
                    continue               # held by a live sequence
                if victim is None or node.last_touch < victim.last_touch:
                    victim = node
            if victim is None:
                break
            self.evict(victim.block)
            evicted += 1
        return evicted
