"""Unified model: config -> params / forward (train, prefill, decode).

Ported from ``repro.models.model``. Parameters are a nested dict of tensors
in the reference's pytree layout: ``blocks`` leaves carry a leading
super-block axis, and `forward` loops over it in Python where the reference
runs ``jax.lax.scan``. Caches are updated in place.

Modes:
  * train:   ``forward(params, batch)`` — full causal sequence, no cache.
  * prefill: ``forward(params, batch, cache=fresh_cache)`` — fills the cache.
  * decode:  ``forward(params, batch, cache=cache)`` with S==1.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models import cache as cache_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (embed, embed_init, embed_shapes,
                                       lm_head, lm_head_init, lm_head_shapes,
                                       rmsnorm, rmsnorm_init)


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree: views, so cache writes land in place."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _leaf_shapes(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaf_shapes(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaf_shapes(v)
    else:
        yield tree


class Model:
    def __init__(self, cfg: ArchConfig, dtype=torch.bfloat16,
                 device: DeviceLike = "cuda", use_kernel: bool = False):
        self.cfg = cfg
        self.dtype = dtype
        # resolved (and refused without a card) when something is allocated,
        # so analytic uses such as param_count need no device
        self.device = torch.device(device)
        self.use_kernel = use_kernel

    # ------------------------------------------------------------------ params
    def _prefix_kinds(self):
        cfg = self.cfg
        period = len(cfg.pattern)
        return [(cfg.pattern[i % period],
                 "moe" if cfg.is_moe_layer(i) else "mlp")
                for i in range(cache_mod.n_prefix_layers(cfg))]

    def param_shapes(self) -> Dict:
        """Shapes of every parameter, in the params tree's nesting; stacked
        leaves carry the super-block axis."""
        cfg = self.cfg
        n_prefix = cache_mod.n_prefix_layers(cfg)
        n_super = cache_mod.n_scanned_super_blocks(cfg)

        def stacked(tree):
            if isinstance(tree, dict):
                return {k: stacked(v) for k, v in tree.items()}
            return (n_super,) + tuple(tree)

        shapes = {
            "embed": embed_shapes(cfg.padded_vocab, cfg.d_model,
                                  cfg.n_codebooks),
            "prefix": [blk.sublayer_shapes(cfg, mx, ff)
                       for mx, ff in self._prefix_kinds()],
            "blocks": stacked(blk.super_block_shapes(cfg, n_prefix)),
            "final_norm": {"scale": (cfg.d_model,)},
        }
        if not cfg.tie_embeddings:
            shapes["lm_head"] = lm_head_shapes(cfg.d_model, cfg.padded_vocab,
                                               cfg.n_codebooks)
        return shapes

    def param_count(self) -> int:
        total = 0
        for shape in _leaf_shapes(self.param_shapes()):
            n = 1
            for s in shape:
                n *= s
            total += n
        return total

    def init(self, generator: torch.Generator) -> Dict:
        """Random parameters with the reference's distributions, drawn from
        ``generator`` (which must live on the model's device)."""
        cfg, dt = self.cfg, self.dtype
        dev = resolve_device(self.device)
        n_prefix = cache_mod.n_prefix_layers(cfg)
        n_super = cache_mod.n_scanned_super_blocks(cfg)
        params = {
            "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, dt,
                                dev, cfg.n_codebooks),
            "prefix": [blk.sublayer_init(generator, cfg, mx, ff, dt, dev)
                       for mx, ff in self._prefix_kinds()],
            "blocks": blk.super_block_init(generator, cfg, n_prefix, dt, dev,
                                           stack=(n_super,)),
            "final_norm": rmsnorm_init(cfg.d_model, dt, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = lm_head_init(generator, cfg.d_model,
                                             cfg.padded_vocab, dt, dev,
                                             cfg.n_codebooks)
        return params

    # ------------------------------------------------------------------ cache
    def init_cache(self, batch: int, cache_len: int) -> Dict:
        return cache_mod.make_cache(self.cfg, batch, cache_len, self.dtype,
                                    device=resolve_device(self.device))

    def init_paged_cache(self, n_blocks: int, block_size: int,
                         kv_dtype=None) -> Dict:
        """Block-pool cache; address it by passing ``batch["block_table"]``
        (and ``kv_len``) to `forward`."""
        return cache_mod.make_cache(
            self.cfg, 0, 0, self.dtype, device=resolve_device(self.device),
            paged=cache_mod.PagedLayout(n_blocks, block_size),
            kv_dtype=kv_dtype)

    # ------------------------------------------------------------------ forward
    def forward(self, params: Dict, batch: Dict,
                cache: Optional[Dict] = None,
                kv_len: Optional[int] = None,
                decode: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
        """Returns (logits, cache, aux_loss); ``cache`` is the one passed in,
        updated in place (None in train mode).

        ``batch["block_table"]`` switches attention caching to the paged
        layout (prefill: one row per unique prompt; decode: one row per
        sequence); ``kv_len`` is the logical cache length the plain paged
        path slices the gathered pools to. ``decode=True`` forces the
        cache-attending branches even when S > 1.
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape[:2]
        dev = tokens.device
        block_table = batch.get("block_table")

        positions = batch.get("positions")
        if positions is None:
            base = batch.get("position_offset", 0)
            positions = (torch.arange(S, dtype=torch.int32, device=dev)[None]
                         .expand(B, S) + base)
            if cfg.mrope_sections:
                positions = positions[..., None].expand(B, S, 3)

        h = embed(params["embed"], tokens)

        if cfg.rope_variant == "sinusoidal":  # musicgen-style additive positions
            half = cfg.d_model // 2
            freq = torch.exp(-torch.log(torch.tensor(10000.0)) *
                             torch.arange(half, dtype=torch.float32) / half
                             ).to(dev)
            ang = positions[..., None].float() * freq
            h = h + torch.cat([torch.sin(ang), torch.cos(ang)],
                              dim=-1).to(h.dtype)

        vision = batch.get("vision_embeds")
        if vision is not None and S > 1 and not decode:
            nv = min(vision.shape[1], S)
            h = h.clone()
            h[:, :nv] = vision[:, :nv].to(h.dtype)

        if cfg.cross_attention:
            raise NotImplementedError("cross-attention arrives with the "
                                      "remaining-arch-features slice of the "
                                      "port")

        kw = dict(use_kernel=self.use_kernel, block_table=block_table,
                  kv_len=kv_len, decode=decode)
        # ---- prefix layers (unrolled)
        for i, (mixer, _ffn) in enumerate(self._prefix_kinds()):
            sub_cache = cache["prefix"][i] if cache is not None else None
            h, _ = blk.sublayer_forward(params["prefix"][i], cfg, h, positions,
                                        mixer, sub_cache, **kw)

        # ---- stacked super-blocks: a loop in place of the reference's scan
        for i in range(cache_mod.n_scanned_super_blocks(cfg)):
            sub_cache = (_index(cache["blocks"], i) if cache is not None
                         else None)
            h, _ = blk.super_block_forward(_index(params["blocks"], i), cfg,
                                           h, positions, sub_cache, **kw)

        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        if cfg.tie_embeddings:
            table = params["embed"]["table"]
            logits = h @ table.T if table.dim() == 2 else torch.einsum(
                "bsd,kvd->bskv", h, table)
        else:
            logits = lm_head(params["lm_head"], h)
        if cfg.padded_vocab != cfg.vocab_size:
            # mask pad columns: exact softmax/sampling over the true vocab
            pad_mask = torch.arange(cfg.padded_vocab,
                                    device=dev) >= cfg.vocab_size
            logits = logits.masked_fill(pad_mask, -1e9)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        return logits, cache, aux
