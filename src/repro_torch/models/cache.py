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
scales with the blocks.

MLA entries (dense only, as in the reference): the latent ``c_kv``
``(B, W, kv_lora)``, the shared rope key ``k_rope`` ``(B, W, rope_hd)`` and
``pos`` ``(B, W)``. SSM state and cross-attention K/V arrive with later
slices of the port and raise here.
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
                  dtype, paged: Optional[PagedLayout], kv_dtype):
    """{name: (shape, dtype)} of one layer's cache entry."""
    if mixer != "a":
        raise NotImplementedError("SSM caches arrive with the SSM slice of "
                                  "the port")
    if cfg.cross_attention and cfg.cross_kv_cache:
        raise NotImplementedError("cross-attention K/V caches arrive with "
                                  "the cross-attention slice of the port")
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
        if cfg.mla is not None:
            m = cfg.mla
            return {"c_kv": (lead + (m.kv_lora_rank,), dtype),
                    "k_rope": (lead + (m.qk_rope_head_dim,), dtype),
                    "pos": (lead, torch.int32)}
    shapes = {"k": (lead + (cfg.n_kv_heads, cfg.hd), el_dtype),
              "v": (lead + (cfg.n_kv_heads, cfg.hd), el_dtype),
              "pos": (lead, torch.int32)}
    if el_dtype == torch.int8:
        # int8 KV: per-(block, slot, kv-head) dequant scales
        shapes["k_scale"] = (lead + (cfg.n_kv_heads,), torch.float32)
        shapes["v_scale"] = (lead + (cfg.n_kv_heads,), torch.float32)
    return shapes


def make_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device: DeviceLike = "cuda",
               paged: Optional[PagedLayout] = None, kv_dtype=None) -> Dict:
    """Full-model cache: {"prefix": [...], "blocks": stacked entries}, on
    ``device`` (the card unless the caller asks for ``"cpu"``).

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
                               kv_dtype)
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


def cache_bytes(cfg: ArchConfig, batch: int, cache_len: int,
                bytes_per_el: int = 2) -> int:
    """Analytic dense cache size (the orchestrator's memory constraint),
    counted from shapes without allocating."""
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
            total += n * (4 if dt == torch.int32 else bytes_per_el)
    return total
