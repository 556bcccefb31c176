"""KV cache construction, in the layouts of ``repro.models.cache``.

GQA attention entries: k, v ``(B, W, n_kv, hd)`` + per-slot absolute
positions ``pos`` ``(B, W)`` int32 (-1 = empty), with
W = min(cache_len, cfg.attn_window or cache_len).

Paged layout (``paged=PagedLayout(...)``): GQA entries become block *pools*,
k/v ``(n_blocks, block_size, n_kv, hd)`` plus positions
``(n_blocks, block_size)``, addressed through a per-sequence block table the
serving backend builds (`repro_torch.serving.backend.BlockAllocator`). One
logical block id addresses the same slot in every layer's pool.

A full cache is ``{"prefix": [entry, ...], "blocks": {"l{i}": entry}}`` where
every ``blocks`` leaf carries a leading super-block axis. Unlike the JAX
reference, the port writes caches in place (see `copy_cache_blocks` and
``models.attention``).

int8 KV (``kv_dtype=torch.int8``, paged only): k/v pools are int8 with f32
per-(block, slot, kv-head) scales ``k_scale`` / ``v_scale``
``(n_blocks, block_size, n_kv)`` beside them; `copy_cache_blocks` moves the
scales with the blocks, and `reset_cache_block_positions` (the resident
prefix pool's reuse of a freed block) resets only the positions.

MLA entries (dense only, as in the reference): the latent ``c_kv``
``(B, W, kv_lora)``, the shared rope key ``k_rope`` ``(B, W, rope_hd)`` and
``pos`` ``(B, W)``.

Mamba-2 (SSM) entries (dense only, as in the reference): the state ``ssm``
``(B, H, P, N)`` in f32 and the conv tail ``conv`` ``(B, d_conv - 1, Ch)``
in the model dtype, both starting at zero.

Cross-attention K/V (``cfg.cross_kv_cache``, dense only): every attention
entry also holds ``xk`` / ``xv`` ``(B, Tm, n_heads, hd)`` in the model
dtype, the conditioning memory's projected keys and values: Tm rows,
``cond_len`` as the caller sizes them to its memory, else
``cfg.n_cond_tokens``. A prefill writes them in place (a decode graph
addresses them), where the reference's prefill replaces them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ArchConfig


@dataclass(frozen=True)
class PagedLayout:
    """Physical geometry of a paged KV cache: ``n_blocks`` fixed-size blocks
    of ``block_size`` token slots, shared by every attention layer."""
    n_blocks: int
    block_size: int


def paged_supported(cfg: ArchConfig) -> bool:
    """Paged KV caching covers the GQA ring-free case: every mixer is
    attention, no MLA latent cache, no sliding window, no cross-attention
    conditioning memory riding in the cache."""
    return (all(m == "a" for m in cfg.pattern)
            and cfg.mla is None
            and cfg.attn_window is None
            and not cfg.cross_attention)


def n_prefix_layers(cfg: ArchConfig) -> int:
    """Leading non-uniform layers kept out of the stacked blocks (e.g.
    deepseek's first dense layer before the MoE stack)."""
    if cfg.moe is not None and cfg.moe.first_dense:
        return cfg.moe.first_dense
    return 0


def n_scanned_super_blocks(cfg: ArchConfig) -> int:
    period = len(cfg.pattern)
    rest = cfg.n_layers - n_prefix_layers(cfg)
    if rest % period:
        raise ValueError(f"{cfg.name}: {rest} layers not a multiple of the "
                         f"pattern period {period}")
    return rest // period


def _entry_shapes(cfg: ArchConfig, mixer: str, batch: int, cache_len: int,
                  dtype, paged: Optional[PagedLayout], kv_dtype,
                  cond_len: Optional[int] = None):
    """{name: (shape, dtype)} of one layer's cache entry."""
    if mixer != "a":
        s = cfg.ssm
        conv_ch = cfg.d_inner + 2 * s.n_groups * s.d_state
        return {"ssm": ((batch, cfg.ssm_heads, s.headdim, s.d_state),
                        torch.float32),
                "conv": ((batch, s.d_conv - 1, conv_ch), dtype)}
    if paged is not None:
        lead = (paged.n_blocks, paged.block_size)
        el_dtype = dtype if kv_dtype is None else kv_dtype
    else:
        if kv_dtype is not None:
            raise ValueError("kv_dtype (quantized KV) requires the paged "
                             "layout")
        W = min(cache_len, cfg.attn_window) if cfg.attn_window else cache_len
        lead = (batch, W)
        el_dtype = dtype
    if paged is None and cfg.mla is not None:
        m = cfg.mla
        shapes = {"c_kv": (lead + (m.kv_lora_rank,), dtype),
                  "k_rope": (lead + (m.qk_rope_head_dim,), dtype),
                  "pos": (lead, torch.int32)}
    else:
        shapes = {"k": (lead + (cfg.n_kv_heads, cfg.hd), el_dtype),
                  "v": (lead + (cfg.n_kv_heads, cfg.hd), el_dtype),
                  "pos": (lead, torch.int32)}
    if paged is None and cfg.cross_attention and cfg.cross_kv_cache:
        xkv = (batch, cond_len or cfg.n_cond_tokens, cfg.n_heads, cfg.hd)
        shapes["xk"] = (xkv, dtype)
        shapes["xv"] = (xkv, dtype)
    if el_dtype == torch.int8:
        # int8 KV: per-(block, slot, kv-head) dequant scales
        shapes["k_scale"] = (lead + (cfg.n_kv_heads,), torch.float32)
        shapes["v_scale"] = (lead + (cfg.n_kv_heads,), torch.float32)
    return shapes


def make_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device: DeviceLike = "cuda",
               paged: Optional[PagedLayout] = None, kv_dtype=None,
               cond_len: Optional[int] = None) -> Dict:
    """Full-model cache: {"prefix": [...], "blocks": stacked entries}, on
    ``device`` (the card unless the caller asks for ``"cpu"``).
    ``cond_len`` is the conditioning memory's length that cross K/V entries
    hold (default ``cfg.n_cond_tokens``).

    With ``paged`` the attention entries become block pools (see module
    docstring); ``batch``/``cache_len`` are then ignored: capacity lives in
    the block table the caller maintains. k/v start at zero and pos at -1.
    """
    device = resolve_device(device)
    if paged is not None and not paged_supported(cfg):
        raise ValueError(f"paged KV cache unsupported for arch {cfg.name!r} "
                         "(needs all-attention pattern, no MLA, no window, "
                         "no cross-attention)")

    def entry(mixer: str, stack=()):
        shapes = _entry_shapes(cfg, mixer, batch, cache_len, dtype, paged,
                               kv_dtype, cond_len)
        return {k: (torch.full(stack + s, -1, dtype=d, device=device)
                    if k == "pos" else
                    torch.zeros(stack + s, dtype=d, device=device))
                for k, (s, d) in shapes.items()}

    period = len(cfg.pattern)
    n_super = n_scanned_super_blocks(cfg)
    return {
        "prefix": [entry(cfg.pattern[i % period])
                   for i in range(n_prefix_layers(cfg))],
        "blocks": {f"l{i}": entry(mixer, (n_super,))
                   for i, mixer in enumerate(cfg.pattern)},
    }


def copy_cache_blocks(cache: Dict, src: torch.Tensor,
                      dst: torch.Tensor) -> Dict:
    """Physically copy pool blocks ``src[i] -> dst[i]`` in every attention
    pool, in place: the copy-on-write fan-out of a shared, partially filled
    prefix block. Only valid on paged caches. Returns ``cache``."""
    src, dst = src.long(), dst.long()
    for entry in cache["prefix"]:
        for leaf in entry.values():
            leaf[dst] = leaf[src]
    for entry in cache["blocks"].values():
        for leaf in entry.values():
            leaf[:, dst] = leaf[:, src]
    return cache


def reset_cache_block_positions(cache: Dict, gids: torch.Tensor) -> Dict:
    """Invalidate the position slots of blocks ``gids`` in every attention
    pool, in place. A resident pooled cache outlives batches, so a block
    back from the free list still carries its previous occupant's positions,
    and a stale slot whose old position falls inside the new sequence's
    visible window would leak stale KV into attention. Only ``pos`` needs
    resetting: position -1 masks the slot. Returns ``cache``."""
    gids = gids.long()
    for entry in cache["prefix"]:
        entry["pos"][gids] = -1
    for entry in cache["blocks"].values():
        entry["pos"][:, gids] = -1
    return cache


def reset_cache(cache: Dict) -> Dict:
    """Reset every leaf of ``cache`` in place to what `make_cache` gives
    (positions -1, everything else 0: KV, int8 scales, SSM state and conv
    tail), so that a cache handed from one batch to the next gives exactly
    what a fresh one gives while keeping its tensors (the decode graphs
    address them). Returns ``cache``."""
    for entry in list(cache["prefix"]) + list(cache["blocks"].values()):
        for name, leaf in entry.items():
            if name == "pos":
                leaf.fill_(-1)
            else:
                leaf.zero_()
    return cache


def kv_bytes_per_token(cfg: ArchConfig, bytes_per_el: int = 2) -> int:
    """KV-cache bytes one token position occupies across the whole stack
    (k + v + int32 position, summed over attention layers)."""
    period = len(cfg.pattern)
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.pattern[i % period] == "a")
    if cfg.mla is not None:
        per_layer = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) \
            * bytes_per_el + 4
    else:
        per_layer = 2 * cfg.n_kv_heads * cfg.hd * bytes_per_el + 4
    return n_attn * per_layer


def paged_cache_bytes(cfg: ArchConfig, n_blocks: int, block_size: int,
                      bytes_per_el: int = 2) -> int:
    """Real memory of a paged pool: the block budget admission prices
    requests against."""
    return n_blocks * block_size * kv_bytes_per_token(cfg, bytes_per_el)


def prefix_pool_bytes(cfg: ArchConfig, n_resident: int, block_size: int,
                      bytes_per_el: int = 2) -> int:
    """Bytes of cached KV the resident prefix pool indexes
    (`PrefixPool.blocks_resident` blocks): the prefill bytes the next hit on
    each chain does not have to move. The physical array is
    `paged_cache_bytes` of the whole budget regardless."""
    return n_resident * block_size * kv_bytes_per_token(cfg, bytes_per_el)


def cache_bytes(cfg: ArchConfig, batch: int, cache_len: int,
                bytes_per_el: int = 2) -> int:
    """Analytic dense cache size (the orchestrator's memory constraint),
    counted from shapes without allocating: int32 and f32 leaves (positions,
    SSM state) at 4 bytes, the others at ``bytes_per_el``."""
    period = len(cfg.pattern)
    mixers = ([cfg.pattern[i % period] for i in range(n_prefix_layers(cfg))]
              + list(cfg.pattern) * n_scanned_super_blocks(cfg))
    total = 0
    for mixer in mixers:
        for shape, dt in _entry_shapes(cfg, mixer, batch, cache_len, None,
                                       None, None).values():
            n = 1
            for s in shape:
                n *= s
            total += n * (4 if dt in (torch.int32, torch.float32)
                          else bytes_per_el)
    return total
