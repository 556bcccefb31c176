"""Unified model: config -> params / forward (train, prefill, decode).

Ported from ``repro.models.model``. Parameters are a nested dict of tensors
in the reference's pytree layout: ``blocks`` leaves carry a leading
super-block axis, and `forward` loops over it in Python where the reference
runs ``jax.lax.scan``. Caches are updated in place.

Modes:
  * train:   ``forward(params, batch)`` — full causal sequence, no cache;
    `Model.loss` is the training objective, and ``remat=True`` recomputes
    each super-block's activations in the backward pass
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``).
  * prefill: ``forward(params, batch, cache=fresh_cache)`` — fills the cache.
  * decode:  ``forward(params, batch, cache=cache)`` with S==1.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models import cache as cache_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (embed, embed_init, embed_shapes,
                                       embed_tp, lm_head, lm_head_init,
                                       lm_head_shapes, lm_head_tp, rmsnorm,
                                       rmsnorm_init, rmsnorm_tp)
from repro_torch.obs.segments import mark


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree: views, so cache writes land in place.
    A leaf may also be a list of per-layer tensors (the train step's
    gradient leaves, `repro_torch.training.loop`)."""
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
                 device: DeviceLike = "cuda", use_kernel: bool = False,
                 remat: bool = False):
        self.cfg = cfg
        self.dtype = dtype
        # resolved (and refused without a card) when something is allocated,
        # so analytic uses such as param_count need no device
        self.device = torch.device(device)
        self.use_kernel = use_kernel
        self.remat = remat

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

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k + shared
        experts)."""
        cfg = self.cfg
        total = self.param_count()
        if cfg.moe is None:
            return total
        m = cfg.moe
        per_expert = 3 * cfg.d_model * cfg.expert_ff()
        n_moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
        return total - n_moe_layers * per_expert * (m.n_experts - m.top_k)

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
    def init_cache(self, batch: int, cache_len: int,
                   cond_len: Optional[int] = None) -> Dict:
        """Dense cache; ``cond_len`` sizes cross K/V entries to the
        conditioning memory (default ``cfg.n_cond_tokens``)."""
        return cache_mod.make_cache(self.cfg, batch, cache_len, self.dtype,
                                    device=resolve_device(self.device),
                                    cond_len=cond_len)

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
                decode: bool = False, logits_at: Optional[int] = None,
                dp=None, tp=None
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
        """Returns (logits, cache, aux_loss); ``cache`` is the one passed in,
        updated in place (None in train mode).

        ``batch["block_table"]`` switches attention caching to the paged
        layout (prefill: one row per unique prompt; decode: one row per
        sequence); ``kv_len`` is the logical cache length the plain paged
        path slices the gathered pools to; ``batch["prefix_groups"]`` (B, 2)
        the decode rows' groups of shared leading table blocks, which the
        paged decode kernel reads once a group. ``decode=True`` forces the
        cache-attending branches even when S > 1. ``logits_at`` projects
        only that sequence position to the vocabulary (logits (B, 1, V)):
        a caller that reads one position skips the head's product over the
        others. ``dp``, with ``tp``: the process group whose ranks hold the
        batch's other rows, for the MoE FFN's global capacity, slots and aux
        loss (`repro_torch.models.moe`; the sharded step passes both).
        ``tp``: the sharded step's tensor-parallel context
        (`repro_torch.distributed.tp`): ``params`` then holds its leaves,
        the residual stream runs sharded on d_model, and the logits come
        back as the rank's vocabulary range (pad columns masked on the
        rank that holds them).
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

        mark("embed")
        h = (embed(params["embed"], tokens) if tp is None
             else embed_tp(params["embed"], tokens, tp))
        # the residual stream's d_model range on this rank
        d_own = tp.own(cfg.d_model) if tp is not None else \
            range(0, cfg.d_model)

        if cfg.rope_variant == "sinusoidal":  # musicgen-style additive positions
            # made on the device: a decode graph's capture copies nothing
            # from the host
            half = cfg.d_model // 2
            freq = torch.exp(
                -torch.log(torch.full((), 10000.0, device=dev))
                * torch.arange(half, dtype=torch.float32, device=dev) / half)
            ang = positions[..., None].float() * freq
            h = h + torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[
                ..., d_own.start:d_own.stop].to(h.dtype)

        vision = batch.get("vision_embeds")
        if vision is not None and S > 1 and not decode:
            nv = min(vision.shape[1], S)
            h = h.clone()
            h[:, :nv] = vision[:, :nv, d_own.start:d_own.stop].to(h.dtype)

        memory = batch.get("cond_memory") if cfg.cross_attention else None
        if memory is not None:
            memory = memory.to(h.dtype)

        kw = dict(use_kernel=self.use_kernel, block_table=block_table,
                  kv_len=kv_len, decode=decode, dp=dp, tp=tp,
                  prefix_groups=batch.get("prefix_groups"))
        aux_total = 0.0            # a tensor once an MoE layer adds to it
        # ---- prefix layers (unrolled; deepseek's leading dense layer)
        for i, (mixer, _ffn) in enumerate(self._prefix_kinds()):
            sub_cache = cache["prefix"][i] if cache is not None else None
            h, _, aux = blk.sublayer_forward(params["prefix"][i], cfg, h,
                                             positions, mixer, sub_cache,
                                             memory, **kw)
            aux_total = aux_total + aux

        # ---- stacked super-blocks: a loop in place of the reference's scan
        def one(bp, x):                 # a super-block recomputed (remat)
            x2, _, a = blk.super_block_forward(bp, cfg, x, positions, None,
                                               memory, **kw)
            return x2, a

        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i in range(cache_mod.n_scanned_super_blocks(cfg)):
            bp = _index(params["blocks"], i)
            if remat:
                if tp is not None:      # the block's input, saved by remat
                    tp.registry.count(h)
                h, aux = checkpoint(one, bp, h, use_reentrant=False)
            else:
                sub_cache = (_index(cache["blocks"], i) if cache is not None
                             else None)
                h, _, aux = blk.super_block_forward(
                    bp, cfg, h, positions, sub_cache, memory, **kw)
            aux_total = aux_total + aux

        mark("head.norm")
        if tp is not None:
            h = rmsnorm_tp(params["final_norm"], h, cfg.norm_eps, tp)
        else:
            h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        if logits_at is not None:
            h = h[:, logits_at:logits_at + 1]
        mark("head.vocab")
        if tp is not None:
            tied = cfg.tie_embeddings
            logits = lm_head_tp(params["embed"]["table"] if tied
                                else params["lm_head"]["w"], h, tp, tied)
            v_own = tp.own(cfg.padded_vocab)
            if v_own.stop > cfg.vocab_size:
                pad_mask = torch.arange(v_own.start, v_own.stop,
                                        device=dev) >= cfg.vocab_size
                logits = logits.masked_fill(pad_mask, -1e9)
        elif cfg.tie_embeddings:
            table = params["embed"]["table"]
            logits = h @ table.T if table.dim() == 2 else torch.einsum(
                "bsd,kvd->bskv", h, table)
        else:
            logits = lm_head(params["lm_head"], h)
        if tp is None and cfg.padded_vocab != cfg.vocab_size:
            # mask pad columns: exact softmax/sampling over the true vocab
            pad_mask = torch.arange(cfg.padded_vocab,
                                    device=dev) >= cfg.vocab_size
            logits = logits.masked_fill(pad_mask, -1e9)
        if not isinstance(aux_total, torch.Tensor):      # no MoE layer
            aux_total = torch.zeros((), dtype=torch.float32, device=dev)
        return logits, cache, aux_total

    # ------------------------------------------------------------------ losses
    def loss(self, params: Dict, batch: Dict, dp=None,
             tp=None) -> torch.Tensor:
        """Mean next-token NLL of ``batch["labels"]`` ((B, S), or (B, S, K)
        with K codebooks) under f32 log-softmax, plus the MoE aux loss
        (``dp`` and ``tp`` as in `forward`). Under ``tp`` the logits are
        vocabulary ranges, and the cross-entropy is vocabulary-parallel:
        the max, the sum of exponentials and the target's logit are
        all-reduced over the tensor group, in f32."""
        logits, _, aux = self.forward(params, batch, dp=dp, tp=tp)
        labels = batch["labels"].long()
        if tp is None or tp.n == 1:         # the whole vocabulary here
            logp = torch.log_softmax(logits.float(), dim=-1)
            nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
            return nll.mean() + aux
        lf = logits.float()
        m = tp.all_reduce_max(lf.amax(dim=-1, keepdim=True))
        sumexp = tp.reduce_from(torch.sum(torch.exp(lf - m), dim=-1))
        own = tp.own(self.cfg.padded_vocab)
        here = (labels >= own.start) & (labels < own.stop)
        idx = torch.where(here, labels - own.start, torch.zeros_like(labels))
        target = torch.gather(lf, -1, idx[..., None])[..., 0]
        target = tp.reduce_from(torch.where(here, target,
                                            torch.zeros_like(target)))
        nll = m[..., 0] + torch.log(sumexp) - target
        return nll.mean() + aux
