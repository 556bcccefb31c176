"""GQA attention (llama/qwen/yi/chatglm) and MLA (DeepSeek-V2): train,
prefill and decode, over a dense ring cache or (GQA) a paged block pool.
Ported from ``repro.models.attention``.

The plain PyTorch path here is the semantics the kernels are held to; with
``use_kernel`` the hand-written Hopper kernels in `repro_torch.kernels` take
fresh prefill (flash attention) and single-token decode (dense ring and
paged over bf16 pools). On CPU tensors the kernel wrappers run their plain
versions. Paged pools may be int8 (``kv_dtype=torch.int8`` in
`repro_torch.models.cache.make_cache`): keys and values quantize on fill and
dequantize on read, through the gather path, as in the reference.

Cache writes happen in place (``tensor[idx] = ...``) where the reference
builds a new array with ``.at[].set``: the cache dict passed in is the one
returned, its tensors updated.

MLA caches only the compressed latent ``c_kv`` and the shared rope key;
its prefill decompresses them and runs the flash kernel with
``use_kernel`` (head dims D = nope + rope, Dv = v_head_dim), and its decode
is plain PyTorch, absorbed (W_uk folded into q) or not, as in the reference,
which has no decode kernel for it.

Cross-attention (musicgen) arrives with a later slice; its parameter shapes
are here so that parameter counts cover every arch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (Params, Shapes, apply_rope, dense,
                                       dense_init, dense_shapes)

NEG_INF = -1e30


# =============================================================================
# parameter shapes / init
# =============================================================================

def attn_shapes(cfg: ArchConfig) -> Dict[str, Shapes]:
    if cfg.mla is not None:
        m = cfg.mla
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "wq": dense_shapes(cfg.d_model, cfg.n_heads * qd),
            "w_dkv": dense_shapes(cfg.d_model, m.kv_lora_rank),
            "w_krope": dense_shapes(cfg.d_model, m.qk_rope_head_dim),
            "w_uk": dense_shapes(m.kv_lora_rank,
                                 cfg.n_heads * m.qk_nope_head_dim),
            "w_uv": dense_shapes(m.kv_lora_rank, cfg.n_heads * m.v_head_dim),
            "wo": dense_shapes(cfg.n_heads * m.v_head_dim, cfg.d_model),
        }
    hd = cfg.hd
    return {
        "wq": dense_shapes(cfg.d_model, cfg.n_heads * hd, bias=cfg.qkv_bias),
        "wk": dense_shapes(cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias),
        "wv": dense_shapes(cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias),
        "wo": dense_shapes(cfg.n_heads * hd, cfg.d_model),
    }


def cross_attn_shapes(cfg: ArchConfig) -> Dict[str, Shapes]:
    hd = cfg.hd
    return {
        "wq": dense_shapes(cfg.d_model, cfg.n_heads * hd),
        "wk": dense_shapes(cfg.d_model, cfg.n_heads * hd),
        "wv": dense_shapes(cfg.d_model, cfg.n_heads * hd),
        "wo": dense_shapes(cfg.n_heads * hd, cfg.d_model),
    }


def attn_init(gen: torch.Generator, cfg: ArchConfig, dtype, device,
              stack: Tuple[int, ...] = ()) -> Params:
    kw = dict(dtype=dtype, device=device, stack=stack)
    if cfg.mla is not None:
        m = cfg.mla
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        H = cfg.n_heads
        return {
            "wq": dense_init(gen, cfg.d_model, H * qd, **kw),
            "w_dkv": dense_init(gen, cfg.d_model, m.kv_lora_rank, **kw),
            "w_krope": dense_init(gen, cfg.d_model, m.qk_rope_head_dim, **kw),
            "w_uk": dense_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim,
                               **kw),
            "w_uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, **kw),
            "wo": dense_init(gen, H * m.v_head_dim, cfg.d_model, **kw),
        }
    hd = cfg.hd
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd,
                         bias=cfg.qkv_bias, **kw),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd,
                         bias=cfg.qkv_bias, **kw),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd,
                         bias=cfg.qkv_bias, **kw),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, **kw),
    }


# =============================================================================
# masking / core softmax attention
# =============================================================================

def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    """Boolean mask (..., Sq, Sk): True = attend. Supports sliding window."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    ok &= k_pos[..., None, :] >= 0  # left-padding uses negative positions
    if window is not None:
        ok &= k_pos[..., None, :] > q_pos[..., :, None] - window
    return ok


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D'), GQA by head-group broadcast; f32
    scores and softmax."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, g, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, Hq, v.shape[-1]).to(v.dtype)


# Above this many score elements per (batch, head), causal attention switches
# to the q-blocked path: O(S * block) memory instead of O(S^2).
BLOCKED_THRESHOLD = 4_194_304  # 2048^2
BLOCK_Q = 512


def sdpa_causal_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        positions: torch.Tensor, window: Optional[int],
                        scale: float, block_q: int = BLOCK_Q) -> torch.Tensor:
    """Causal attention without materializing (Sq, Sk) scores: a loop over
    q blocks (the reference's ``lax.map``). positions: (B, S) absolute
    positions shared by q and k."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    pad = (-S) % block_q
    positions_q = positions
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        positions_q = torch.nn.functional.pad(positions, (0, pad),
                                              value=-(10 ** 9))
    kf, vf = k.float(), v.float()
    outs = []
    for i in range(q.shape[1] // block_q):
        qi = q[:, i * block_q:(i + 1) * block_q]
        pqi = positions_q[:, i * block_q:(i + 1) * block_q]
        qg = qi.reshape(B, block_q, Hkv, g, D).float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
        ok = positions[:, None, :] <= pqi[:, :, None]
        ok &= positions[:, None, :] >= 0
        if window is not None:
            ok &= positions[:, None, :] > pqi[:, :, None] - window
        s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
        outs.append(o.reshape(B, block_q, Hq, vf.shape[-1]))
    return torch.cat(outs, dim=1)[:, :S].to(v.dtype)


# =============================================================================
# GQA attention: train / prefill / decode
# =============================================================================

def gqa_forward(p: Params, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor,
                cache: Optional[Dict] = None,
                use_kernel: bool = False,
                block_table: Optional[torch.Tensor] = None,
                kv_len: Optional[int] = None,
                decode: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Unified GQA attention.

    train/prefill: x (B,S,D), positions (B,S[,3]); cache None (train) or an
      empty cache dict to fill (prefill).
    decode: x (B,1,D); cache holds k/v + per-slot absolute positions; ring
      writes when cfg.attn_window is set.
    paged: with ``block_table`` (B, n_blocks) the cache entries are block
      pools; position p lives in pool block ``table[b, p // bs]`` row
      ``p % bs``. ``kv_len`` bounds the logical sequence so the gathered
      plain path is element for element the dense cache.
    ``decode=True`` forces the cache-attending branches at S > 1 (the
      speculative verify and tail prefill); only the S == 1 kernels are gated
      off there.
    """
    B, S, _ = x.shape
    hd = cfg.hd
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)

    if cfg.rope_variant not in ("none", "sinusoidal"):
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction,
                       cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction,
                       cfg.mrope_sections)

    scale = 1.0 / np.sqrt(hd)
    pos1d = positions[..., 0] if positions.dim() == 3 else positions

    if cache is None or (S > 1 and not decode):
        # ---- train / prefill over the full (possibly windowed) sequence;
        # the flash kernel's positions are an iota from 0: fresh prefill only
        if use_kernel:
            from repro_torch.kernels.flash_attention import ops as fa_ops
            out = fa_ops.flash_attention(q, k, v, window=cfg.attn_window,
                                         scale=scale)
        elif S * S > BLOCKED_THRESHOLD:
            out = sdpa_causal_blocked(q, k, v, pos1d, cfg.attn_window, scale)
        else:
            mask = causal_mask(pos1d, pos1d, cfg.attn_window)
            out = sdpa(q, k, v, mask, scale)
        new_cache = None
        if cache is not None:
            new_cache = (_fill_cache_paged(cache, k, v, pos1d, block_table)
                         if block_table is not None
                         else _fill_cache(cfg, cache, k, v, pos1d))
        y = dense(p["wo"], out.reshape(B, S, cfg.n_heads * hd))
        return y, new_cache

    if block_table is not None:
        # ---- paged decode: write through the block table, then attend over
        # the table-indexed pools (kernel) or the gathered pools (plain)
        new_cache = _fill_cache_paged(cache, k, v, pos1d, block_table)
        ck, cv, cpos = new_cache["k"], new_cache["v"], new_cache["pos"]
        quantized = ck.dtype == torch.int8
        if use_kernel and not quantized and S == 1:
            from repro_torch.kernels.decode_attention import ops as da_ops
            out = da_ops.paged_decode_attention(
                q, ck, cv, cpos, block_table, pos1d[:, 0].contiguous(),
                scale=scale)
        else:
            # gather the sequence's blocks in logical order and slice to the
            # exact cache length: element for element the dense decode path
            # (int8 pools dequantize here; the paged kernel reads bf16 pools
            # only, as in the reference, so quantized caches take this path)
            bt = block_table.long()
            kc = ck[bt].reshape(B, -1, *ck.shape[2:])
            vc = cv[bt].reshape(B, -1, *cv.shape[2:])
            pc = cpos[bt].reshape(B, -1)
            if kv_len is not None:
                kc, vc, pc = kc[:, :kv_len], vc[:, :kv_len], pc[:, :kv_len]
            if quantized:
                # dequantize after the slice: elementwise, so the same
                # values as the reference's dequantize-then-slice
                n = kc.shape[1]
                ksc = new_cache["k_scale"][bt].reshape(B, -1, ck.shape[2])
                vsc = new_cache["v_scale"][bt].reshape(B, -1, cv.shape[2])
                kc = (kc.float() * ksc[:, :n, :, None]).to(q.dtype)
                vc = (vc.float() * vsc[:, :n, :, None]).to(q.dtype)
            ok = (pc[:, None, :] >= 0) & (pc[:, None, :] <= pos1d[:, :, None])
            out = sdpa(q, kc, vc, ok, scale)
        y = dense(p["wo"], out.reshape(B, S, cfg.n_heads * hd))
        return y, new_cache

    # ---- dense decode: single (or few) new tokens against the ring cache;
    # the new k/v land in their slots in place
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    W = ck.shape[1]
    slot = (pos1d % W).long()  # (B, S)
    bidx = torch.arange(B, device=x.device)[:, None]
    ck[bidx, slot] = k.to(ck.dtype)
    cv[bidx, slot] = v.to(cv.dtype)
    cpos[bidx, slot] = pos1d.to(torch.int32)

    if use_kernel and S == 1:
        from repro_torch.kernels.decode_attention import ops as da_ops
        out = da_ops.decode_attention_cache(q, ck, cv, cpos,
                                            pos1d[:, 0].contiguous(),
                                            scale=scale,
                                            window=cfg.attn_window)
    else:
        # mask over cache slots by absolute position validity
        ok = (cpos[:, None, :] >= 0) & (cpos[:, None, :] <= pos1d[:, :, None])
        if cfg.attn_window is not None:
            ok &= cpos[:, None, :] > pos1d[:, :, None] - cfg.attn_window
        out = sdpa(q, ck, cv, ok, scale)
    y = dense(p["wo"], out.reshape(B, S, cfg.n_heads * hd))
    return y, cache


def _fill_cache(cfg: ArchConfig, cache: Dict, k, v, pos1d) -> Dict:
    """Write prefill keys/values into an allocated cache, in place (ring
    slots for windowed archs). When S > W only the last W tokens survive, so
    slice first: the scatter's indices stay unique."""
    B, S = pos1d.shape
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    W = ck.shape[1]
    if S > W:
        k, v, pos1d = k[:, -W:], v[:, -W:], pos1d[:, -W:]
    slot = (pos1d % W).long()
    bidx = torch.arange(B, device=k.device)[:, None]
    ck[bidx, slot] = k.to(ck.dtype)
    cv[bidx, slot] = v.to(cv.dtype)
    cpos[bidx, slot] = pos1d.to(torch.int32)
    return cache


def _fill_cache_paged(cache: Dict, k, v, pos1d,
                      block_table: torch.Tensor) -> Dict:
    """Write keys/values through the block table into paged pools, in place:
    position p lands in pool block ``table[b, p // bs]`` row ``p % bs``.
    Every row owns distinct blocks, so the scatter's indices stay unique.

    int8 pools (``cache["k"].dtype == int8``) quantize on fill: each written
    slot stores ``round(k / scale)`` per kv head with ``scale = absmax /
    127``, scattered into ``k_scale`` / ``v_scale`` alongside."""
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    bs = ck.shape[1]
    bidx = torch.arange(pos1d.shape[0], device=k.device)[:, None]
    pos_l = pos1d.long()
    blk = block_table.long()[bidx, pos_l // bs]
    row = pos_l % bs
    if ck.dtype == torch.int8:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        ck[blk, row] = kq
        cv[blk, row] = vq
        cache["k_scale"][blk, row] = ks
        cache["v_scale"][blk, row] = vs
    else:
        ck[blk, row] = k.to(ck.dtype)
        cv[blk, row] = v.to(cv.dtype)
    cpos[blk, row] = pos1d.to(torch.int32)
    return cache


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-(token, kv-head) quantization over the head dim:
    x (B, S, n_kv, hd) -> (q int8, scale f32 (B, S, n_kv))."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


# =============================================================================
# MLA attention (DeepSeek-V2): latent KV cache
# =============================================================================

def mla_forward(p: Params, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor,
                cache: Optional[Dict] = None,
                absorbed_decode: bool = True,
                use_kernel: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Multi-head Latent Attention.

    The cache stores only the compressed latent ``c_kv`` (rank kv_lora) plus
    the shared rope key. Absorbed decode scores in latent space (W_uk folded
    into q, W_uv applied after), so a step reads O(S * (kv_lora + rope_hd))
    cache bytes instead of O(S * 2 * H * hd). Cache writes happen in place.
    """
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    nd, rd, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    scale = 1.0 / np.sqrt(nd + rd)
    pos1d = positions[..., 0] if positions.dim() == 3 else positions

    q = dense(p["wq"], x).reshape(B, S, H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, pos1d, cfg.rope_theta)

    c_kv = dense(p["w_dkv"], x)                       # (B, S, r)
    k_rope = dense(p["w_krope"], x).reshape(B, S, 1, rd)
    k_rope = apply_rope(k_rope, pos1d, cfg.rope_theta)

    if cache is not None and S == 1:
        cc, cr, cpos = cache["c_kv"], cache["k_rope"], cache["pos"]
        W = cc.shape[1]
        slot = (pos1d % W).long()
        bidx = torch.arange(B, device=x.device)[:, None]
        cc[bidx, slot] = c_kv.to(cc.dtype)
        cr[bidx, slot] = k_rope[:, :, 0].to(cr.dtype)
        cpos[bidx, slot] = pos1d.to(torch.int32)
        ok = (cpos[:, None, :] >= 0) & (cpos[:, None, :] <= pos1d[:, :, None])
        if cfg.attn_window is not None:
            ok &= cpos[:, None, :] > pos1d[:, :, None] - cfg.attn_window

        if absorbed_decode:
            w_uk = p["w_uk"]["w"].reshape(m.kv_lora_rank, H, nd)
            q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(),
                                 w_uk.float())
            ccf = cc.float()
            scores = torch.einsum("bshr,bkr->bhsk", q_lat, ccf)
            scores = scores + torch.einsum("bshr,bkr->bhsk", q_rope.float(),
                                           cr.float())
            scores = torch.where(ok[:, None], scores * scale,
                                 torch.full_like(scores, NEG_INF))
            probs = torch.softmax(scores, dim=-1)
            ctx_lat = torch.einsum("bhsk,bkr->bshr", probs, ccf)  # (B,S,H,r)
            w_uv = p["w_uv"]["w"].reshape(m.kv_lora_rank, H, vd)
            out = torch.einsum("bshr,rhv->bshv", ctx_lat,
                               w_uv.float()).to(x.dtype)
        else:
            k_nope = dense(p["w_uk"], cc).reshape(B, -1, H, nd)
            vv = dense(p["w_uv"], cc).reshape(B, -1, H, vd)
            k_full = torch.cat([k_nope,
                                cr[:, :, None].expand(B, W, H, rd)], dim=-1)
            q_full = torch.cat([q_nope, q_rope], dim=-1)
            out = sdpa(q_full, k_full, vv, ok, scale)
        y = dense(p["wo"], out.reshape(B, S, H * vd))
        return y, cache

    # ---- train / prefill: decompress the latent to full keys and values
    k_nope = dense(p["w_uk"], c_kv).reshape(B, S, H, nd)
    vv = dense(p["w_uv"], c_kv).reshape(B, S, H, vd)
    k_full = torch.cat([k_nope, k_rope.expand(B, S, H, rd)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    if use_kernel:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        out = fa_ops.flash_attention(q_full, k_full, vv,
                                     window=cfg.attn_window, scale=scale)
    elif S * S > BLOCKED_THRESHOLD:
        out = sdpa_causal_blocked(q_full, k_full, vv, pos1d, cfg.attn_window,
                                  scale)
    else:
        mask = causal_mask(pos1d, pos1d, cfg.attn_window)
        out = sdpa(q_full, k_full, vv, mask, scale)
    if cache is not None:
        cc, cr, cpos = cache["c_kv"], cache["k_rope"], cache["pos"]
        W = cc.shape[1]
        c_w, kr_w, pos_w = c_kv, k_rope[:, :, 0], pos1d
        if S > W:
            c_w, kr_w, pos_w = c_w[:, -W:], kr_w[:, -W:], pos_w[:, -W:]
        slot = (pos_w % W).long()
        bidx = torch.arange(B, device=x.device)[:, None]
        cc[bidx, slot] = c_w.to(cc.dtype)
        cr[bidx, slot] = kr_w.to(cr.dtype)
        cpos[bidx, slot] = pos_w.to(torch.int32)
    y = dense(p["wo"], out.reshape(B, S, H * vd))
    return y, cache
