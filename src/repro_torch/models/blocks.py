"""Decoder blocks: pre-norm attention + MLP sublayers and super-blocks.

A *super-block* is one period of ``cfg.pattern``; the model stacks
``n_scanned_super_blocks`` of them (params carry a leading super-block axis)
and loops over them. Ported from ``repro.models.blocks``.

Each layer mixes with attention (GQA or MLA, mixer ``"a"``) or a Mamba-2
block (mixer ``"m"``), then runs a dense MLP, a MoE FFN (`cfg.is_moe_layer`)
or, for pure-Mamba stacks (``d_ff == 0``), no FFN. With
``cfg.cross_attention`` (musicgen) a cross-attention sublayer over the
conditioning memory follows the mixer; with ``cfg.cross_kv_cache`` its keys
and values ride in the attention sub-cache as ``xk`` / ``xv``: a prefill
writes them in place, a decode step reads them and needs no memory.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (Params, dense_shapes, mlp, mlp_init,
                                       mlp_shapes, mlp_tp, rmsnorm,
                                       rmsnorm_init, rmsnorm_tp)
from repro_torch.obs.segments import mark


def layer_kinds(cfg: ArchConfig, n_prefix: int):
    """[(mixer_kind, ffn_kind)] for one super-block, given prefix layer count."""
    return [(mixer, "moe" if cfg.is_moe_layer(n_prefix + i) else "mlp")
            for i, mixer in enumerate(cfg.pattern)]


# --------------------------------------------------------------------------- shapes

def _moe_shapes(cfg: ArchConfig) -> Dict:
    m = cfg.moe
    d, ff = cfg.d_model, cfg.expert_ff()
    s = {"router": dense_shapes(d, m.n_experts),
         "gate": (m.n_experts, d, ff),
         "up": (m.n_experts, d, ff),
         "down": (m.n_experts, ff, d)}
    if m.n_shared:
        s["shared"] = mlp_shapes(d, ff * m.n_shared, "swiglu")
    return s


def sublayer_shapes(cfg: ArchConfig, mixer: str, ffn: str) -> Dict:
    d = cfg.d_model
    s: Dict = {"ln1": {"scale": (d,)}}
    if mixer == "a":
        s["attn"] = attn.attn_shapes(cfg)
    else:
        s["ssm"] = ssm_mod.ssm_shapes(cfg)
    if cfg.cross_attention:
        s["ln_x"] = {"scale": (d,)}
        s["cross"] = attn.cross_attn_shapes(cfg)
    if ffn == "moe":
        s["ln2"] = {"scale": (d,)}
        s["moe"] = _moe_shapes(cfg)
    elif cfg.d_ff > 0:  # pure mamba blocks (d_ff == 0) have no FFN
        s["ln2"] = {"scale": (d,)}
        s["mlp"] = mlp_shapes(d, cfg.d_ff, cfg.mlp_variant)
    return s


def super_block_shapes(cfg: ArchConfig, n_prefix: int) -> Dict:
    return {f"l{i}": sublayer_shapes(cfg, mx, ff)
            for i, (mx, ff) in enumerate(layer_kinds(cfg, n_prefix))}


# --------------------------------------------------------------------------- init

def sublayer_init(gen: torch.Generator, cfg: ArchConfig, mixer: str,
                  ffn: str, dtype, device,
                  stack: Tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    p: Params = {"ln1": rmsnorm_init(d, dtype, device, stack)}
    if mixer == "a":
        p["attn"] = attn.attn_init(gen, cfg, dtype, device, stack)
    else:
        p["ssm"] = ssm_mod.ssm_init(gen, cfg, dtype, device, stack)
    if cfg.cross_attention:
        p["ln_x"] = rmsnorm_init(d, dtype, device, stack)
        p["cross"] = attn.cross_attn_init(gen, cfg, dtype, device, stack)
    if ffn == "moe":
        p["ln2"] = rmsnorm_init(d, dtype, device, stack)
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype, device, stack)
    elif cfg.d_ff > 0:
        p["ln2"] = rmsnorm_init(d, dtype, device, stack)
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.mlp_variant, dtype, device,
                            stack)
    return p


def super_block_init(gen: torch.Generator, cfg: ArchConfig, n_prefix: int,
                     dtype, device, stack: Tuple[int, ...] = ()) -> Params:
    return {f"l{i}": sublayer_init(gen, cfg, mx, ff, dtype, device, stack)
            for i, (mx, ff) in enumerate(layer_kinds(cfg, n_prefix))}


# --------------------------------------------------------------------------- forward

def sublayer_forward(p: Params, cfg: ArchConfig, x: torch.Tensor,
                     positions: torch.Tensor, mixer: str,
                     cache: Optional[Dict], memory: Optional[torch.Tensor],
                     use_kernel: bool,
                     block_table: Optional[torch.Tensor] = None,
                     kv_len: Optional[int] = None,
                     decode: bool = False, dp=None, tp=None,
                     prefix_groups: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[Dict],
                                Union[torch.Tensor, float]]:
    """Returns (x, cache, aux loss): the MoE FFN's aux loss (a 0-d f32
    tensor), else 0.0, which launches nothing. ``memory`` (B, Tm, d) is
    the conditioning memory of a cross-attention arch, or None. ``dp`` and
    ``tp``: the sharded step's batch-axes group (the MoE FFN's, see
    `repro_torch.models.moe`) and tensor-parallel context
    (`_sublayer_tp`)."""
    if tp is not None:
        return _sublayer_tp(p, cfg, x, positions, mixer, cache, memory,
                            decode, dp, tp)
    aux = 0.0
    # the cross-attention K/V cache entries: read at a decode step (S == 1,
    # or ``decode``), as the reference reads them before its self-attention
    # rebuilds the sub-cache dict
    cross_kv = None
    if cfg.cross_attention and cfg.cross_kv_cache and cache is not None \
            and (x.shape[1] == 1 or decode):
        cross_kv = (cache["xk"], cache["xv"])
    # segment marks (`repro_torch.obs.segments`): no-ops outside a timing
    # capture; GQA marks its own phases
    mark("attn.norm")
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if mixer != "a":
        mark("mixer")
        y, new_cache = ssm_mod.ssm_forward(p["ssm"], cfg, h, cache,
                                           use_kernel=use_kernel)
    elif cfg.mla is not None:
        mark("mixer")
        y, new_cache = attn.mla_forward(p["attn"], cfg, h, positions, cache,
                                        absorbed_decode=cfg.mla_absorbed,
                                        use_kernel=use_kernel)
    else:
        y, new_cache = attn.gqa_forward(p["attn"], cfg, h, positions, cache,
                                        use_kernel=use_kernel,
                                        block_table=block_table,
                                        kv_len=kv_len, decode=decode,
                                        prefix_groups=prefix_groups)
    mark("attn.residual")
    x = x + y
    if cfg.cross_attention and (memory is not None or cross_kv is not None):
        mark("cross")
        y, (k, v) = attn.cross_forward(p["cross"], cfg,
                                       rmsnorm(p["ln_x"], x, cfg.norm_eps),
                                       memory, cached_kv=cross_kv)
        x = x + y
        if cfg.cross_kv_cache and new_cache is not None and cross_kv is None:
            # in place: a decode graph addresses these tensors
            new_cache["xk"].copy_(k)
            new_cache["xv"].copy_(v)
    if "moe" in p or "mlp" in p:
        mark("ffn.norm")
        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        if "moe" in p:
            y, aux = moe_mod.moe_forward(p["moe"], cfg, h,
                                         use_kernel=use_kernel)
        else:
            y = mlp(p["mlp"], h, cfg.mlp_variant)
        mark("ffn.residual")
        x = x + y
    return x, new_cache, aux


def super_block_forward(p: Params, cfg: ArchConfig, x: torch.Tensor,
                        positions: torch.Tensor, cache: Optional[Dict],
                        memory: Optional[torch.Tensor], use_kernel: bool,
                        block_table: Optional[torch.Tensor] = None,
                        kv_len: Optional[int] = None,
                        decode: bool = False, dp=None, tp=None,
                        prefix_groups: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[Dict],
                                   Union[torch.Tensor, float]]:
    """One period of the layer pattern. cache is {"l{i}": sub-cache} or None;
    sub-caches are updated in place. The aux loss sums over the period."""
    aux_total = 0.0
    new_cache = {} if cache is not None else None
    for i, mixer in enumerate(cfg.pattern):
        key = f"l{i}"
        sub_cache = cache.get(key) if cache is not None else None
        x, nc, aux = sublayer_forward(p[key], cfg, x, positions, mixer,
                                      sub_cache, memory, use_kernel,
                                      block_table=block_table, kv_len=kv_len,
                                      decode=decode, dp=dp, tp=tp,
                                      prefix_groups=prefix_groups)
        if new_cache is not None:
            new_cache[key] = nc
        aux_total = aux_total + aux
    return x, new_cache, aux_total


# --------------------------------------------------------------------------- tensor-parallel

def _sublayer_tp(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor, mixer: str, cache: Optional[Dict],
                 memory: Optional[torch.Tensor], decode: bool, dp, tp):
    """`sublayer_forward` on the d-sharded residual stream ``x`` (B, S,
    d / n) over the tensor group of ``tp``: every mixer (GQA and MLA by
    head, the Mamba-2 mixer by SSD head, cross-attention by head), the
    dense MLP and the MoE FFN compute on their shards, and read and write
    their caches in the policy's placements (the cross K/V cache, held
    whole over the tensor axis: a prefill writes every head, gathered)."""
    aux = 0.0
    eps = cfg.norm_eps
    cross_kv = None
    if cfg.cross_attention and cfg.cross_kv_cache and cache is not None \
            and (x.shape[1] == 1 or decode):
        cross_kv = (cache["xk"], cache["xv"])
    h = rmsnorm_tp(p["ln1"], x, eps, tp)
    if mixer != "a":
        y, new_cache = ssm_mod.ssm_forward_tp(p["ssm"], cfg, h, cache, tp)
    elif cfg.mla is not None:
        y, new_cache = attn.mla_forward_tp(p["attn"], cfg, h, positions,
                                           cache, tp,
                                           absorbed_decode=cfg.mla_absorbed)
    else:
        y, new_cache = attn.gqa_forward_tp(p["attn"], cfg, h, positions,
                                           cache, tp, decode=decode)
    x = x + y
    if cfg.cross_attention and (memory is not None or cross_kv is not None):
        y, (k, v) = attn.cross_forward_tp(p["cross"], cfg,
                                          rmsnorm_tp(p["ln_x"], x, eps, tp),
                                          memory, tp, cached_kv=cross_kv)
        x = x + y
        if cfg.cross_kv_cache and new_cache is not None and cross_kv is None:
            heads = tp.ranges(cfg.n_heads)
            new_cache["xk"].copy_(tp.gather_sets(k, 2, heads, cfg.n_heads))
            new_cache["xv"].copy_(tp.gather_sets(v, 2, heads, cfg.n_heads))
    if "moe" in p:
        y, aux = moe_mod.moe_forward_tp(p["moe"], cfg,
                                        rmsnorm_tp(p["ln2"], x, eps, tp),
                                        tp, dp)
        x = x + y
    elif "mlp" in p:
        x = x + mlp_tp(p["mlp"], rmsnorm_tp(p["ln2"], x, eps, tp),
                       cfg.mlp_variant, tp)
    return x, new_cache, aux
