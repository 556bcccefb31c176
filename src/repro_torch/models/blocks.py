"""Decoder blocks: pre-norm attention + MLP sublayers and super-blocks.

A *super-block* is one period of ``cfg.pattern``; the model stacks
``n_scanned_super_blocks`` of them (params carry a leading super-block axis)
and loops over them. Ported from ``repro.models.blocks``.

This slice of the port runs attention + dense MLP sublayers. The MoE FFN,
the Mamba-2 (SSM) mixer and cross-attention raise `NotImplementedError`
naming the slice they arrive with; their parameter shapes are here so that
parameter counts cover every arch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (Params, dense_shapes, mlp, mlp_init,
                                       mlp_shapes, rmsnorm, rmsnorm_init)


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


def _ssm_shapes(cfg: ArchConfig) -> Dict:
    s = cfg.ssm
    d_in = cfg.d_inner
    H = cfg.ssm_heads
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    if cfg.ssm_split_proj:
        proj = {"in_proj_z": dense_shapes(cfg.d_model, d_in),
                "in_proj_x": dense_shapes(cfg.d_model, d_in),
                "in_proj_bc": dense_shapes(cfg.d_model,
                                           2 * s.n_groups * s.d_state),
                "in_proj_dt": dense_shapes(cfg.d_model, H)}
    else:
        proj = {"in_proj": dense_shapes(
            cfg.d_model, 2 * d_in + 2 * s.n_groups * s.d_state + H)}
    return {**proj, "conv_w": (s.d_conv, conv_ch), "conv_b": (conv_ch,),
            "A_log": (H,), "dt_bias": (H,), "D": (H,),
            "norm_scale": (d_in,), "out_proj": dense_shapes(d_in, cfg.d_model)}


def sublayer_shapes(cfg: ArchConfig, mixer: str, ffn: str) -> Dict:
    d = cfg.d_model
    s: Dict = {"ln1": {"scale": (d,)}}
    if mixer == "a":
        s["attn"] = attn.attn_shapes(cfg)
    else:
        s["ssm"] = _ssm_shapes(cfg)
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

def _unported(cfg: ArchConfig, mixer: str, ffn: str) -> Optional[str]:
    if mixer != "a":
        return "the Mamba-2 (SSM) mixer arrives with the SSM slice of the port"
    if ffn == "moe":
        return "the MoE FFN arrives with the MLA/MoE slice of the port"
    if cfg.cross_attention:
        return ("cross-attention arrives with the remaining-arch-features "
                "slice of the port")
    return None


def sublayer_init(gen: torch.Generator, cfg: ArchConfig, mixer: str,
                  ffn: str, dtype, device,
                  stack: Tuple[int, ...] = ()) -> Params:
    why = _unported(cfg, mixer, ffn)
    if why:
        raise NotImplementedError(why)
    d = cfg.d_model
    p: Params = {"ln1": rmsnorm_init(d, dtype, device, stack),
                 "attn": attn.attn_init(gen, cfg, dtype, device, stack)}
    if cfg.d_ff > 0:
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
                     cache: Optional[Dict], use_kernel: bool,
                     block_table: Optional[torch.Tensor] = None,
                     kv_len: Optional[int] = None,
                     decode: bool = False
                     ) -> Tuple[torch.Tensor, Optional[Dict]]:
    why = _unported(cfg, mixer, "moe" if "moe" in p else "mlp")
    if why:
        raise NotImplementedError(why)
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention arrives with the MLA slice "
                                  "of the port")
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, new_cache = attn.gqa_forward(p["attn"], cfg, h, positions, cache,
                                    use_kernel=use_kernel,
                                    block_table=block_table, kv_len=kv_len,
                                    decode=decode)
    x = x + y
    if "mlp" in p:
        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], h, cfg.mlp_variant)
    return x, new_cache


def super_block_forward(p: Params, cfg: ArchConfig, x: torch.Tensor,
                        positions: torch.Tensor, cache: Optional[Dict],
                        use_kernel: bool,
                        block_table: Optional[torch.Tensor] = None,
                        kv_len: Optional[int] = None,
                        decode: bool = False
                        ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One period of the layer pattern. cache is {"l{i}": sub-cache} or None;
    sub-caches are updated in place."""
    new_cache = {} if cache is not None else None
    for i, mixer in enumerate(cfg.pattern):
        key = f"l{i}"
        sub_cache = cache.get(key) if cache is not None else None
        x, nc = sublayer_forward(p[key], cfg, x, positions, mixer, sub_cache,
                                 use_kernel, block_table=block_table,
                                 kv_len=kv_len, decode=decode)
        if new_cache is not None:
            new_cache[key] = nc
    return x, new_cache
