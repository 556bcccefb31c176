"""GQA attention (llama/qwen/yi/chatglm) and MLA (DeepSeek-V2): train,
prefill and decode, over a dense ring cache or (GQA) a paged block pool;
and cross-attention to a static conditioning memory (musicgen). Ported
from ``repro.models.attention``.

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

Cross-attention (`cross_forward`) is plain PyTorch, as the reference's is
jnp outside any Pallas kernel: queries from ``x``, keys and values projected
from the memory, or taken from the cross K/V cache entries ``xk`` / ``xv``
when ``cfg.cross_kv_cache`` keeps them (`repro_torch.models.blocks`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (Params, Shapes, apply_rope, dense,
                                       dense_init, dense_shapes, dense_tp)
from repro_torch.obs.segments import mark

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


def cross_attn_init(gen: torch.Generator, cfg: ArchConfig, dtype, device,
                    stack: Tuple[int, ...] = ()) -> Params:
    """`cross_attn_shapes`: four bias-free projections, keys and values at
    every query head."""
    kw = dict(dtype=dtype, device=device, stack=stack)
    d, hd = cfg.d_model, cfg.n_heads * cfg.hd
    return {"wq": dense_init(gen, d, hd, **kw),
            "wk": dense_init(gen, d, hd, **kw),
            "wv": dense_init(gen, d, hd, **kw),
            "wo": dense_init(gen, hd, d, **kw)}


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
                decode: bool = False,
                prefix_groups: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Unified GQA attention.

    train/prefill: x (B,S,D), positions (B,S[,3]); cache None (train) or an
      empty cache dict to fill (prefill).
    decode: x (B,1,D); cache holds k/v + per-slot absolute positions; ring
      writes when cfg.attn_window is set.
    paged: with ``block_table`` (B, n_blocks) the cache entries are block
      pools; position p lives in pool block ``table[b, p // bs]`` row
      ``p % bs``. ``kv_len`` bounds the logical sequence so the gathered
      plain path is element for element the dense cache.
      ``prefix_groups`` (B, 2): the rows' groups of shared leading blocks,
      which the paged decode kernel reads once a group
      (`kernels.decode_attention.split.prefix_groups`).
    ``decode=True`` forces the cache-attending branches at S > 1 (the
      speculative verify and tail prefill); only the S == 1 kernels are gated
      off there.
    """
    B, S, _ = x.shape
    hd = cfg.hd
    mark("attn.qkv")
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)

    mark("attn.rope_kv")
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
        mark("attn.core")
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
        mark("attn.out")
        y = dense(p["wo"], out.reshape(B, S, cfg.n_heads * hd))
        return y, new_cache

    if block_table is not None:
        # ---- paged decode: write through the block table, then attend over
        # the table-indexed pools (kernel) or the gathered pools (plain)
        new_cache = _fill_cache_paged(cache, k, v, pos1d, block_table)
        ck, cv, cpos = new_cache["k"], new_cache["v"], new_cache["pos"]
        quantized = ck.dtype == torch.int8
        mark("attn.core")
        if use_kernel and not quantized and S == 1:
            from repro_torch.kernels.decode_attention import ops as da_ops
            out = da_ops.paged_decode_attention(
                q, ck, cv, cpos, block_table, pos1d[:, 0].contiguous(),
                scale=scale, prefix_groups=prefix_groups)
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
        mark("attn.out")
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

    mark("attn.core")
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
    mark("attn.out")
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
# GQA attention, tensor-parallel (the sharded step)
# =============================================================================

def _kv_ranges(ranges, group: int):
    """The K/V heads each rank's query heads read (whole heads)."""
    return [range(r.start // group, (r.stop - 1) // group + 1) if len(r)
            else range(0, 0) for r in ranges]


def gqa_forward_tp(p: Params, cfg: ArchConfig, x: torch.Tensor,
                   positions: torch.Tensor, cache: Optional[Dict], tp,
                   decode: bool = False
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """`gqa_forward` from and to the d-sharded residual stream over the
    tensor group ``tp``.

    Train and fresh prefill: the query heads split over the tensor ranks
    (floor ranges: 56 heads on 16 ranks give 3 or 4), each rank with the
    whole K/V heads its query heads read (a head shared by two ranks is
    computed on both), RoPE on whole heads; ``wo`` re-laid to the rows of
    the rank's heads, its partial output reduce-scattered. A prefill writes
    the cache's head-dim chunk of every K/V head (the policy's cache
    placement) from the K/V heads all-gathered. Decode against the cache:
    every head's head-dim chunk (the chunk the cache holds), the partial
    scores all-reduced, RoPE on the gathered whole heads, ``wo`` re-laid to
    the rows of the chunk. Plain PyTorch: the kernels take no shards."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if H < tp.n:
        raise ValueError(f"{H} heads over a {tp.n}-wide tensor axis")
    h = tp.gather_input(x)
    pos1d = positions[..., 0] if positions.dim() == 3 else positions
    rope = cfg.rope_variant not in ("none", "sinusoidal")
    scale = 1.0 / np.sqrt(hd)

    if cache is None or (S > 1 and not decode):
        heads = tp.ranges(H)
        kvs = _kv_ranges(heads, H // KV)
        q_sets = tp.head_sets(heads, hd)
        mine, kv_mine = heads[tp.rank], kvs[tp.rank]
        q = dense_tp(p["wq"], h, tp, q_sets).reshape(B, S, len(mine), hd)
        kv_sets = tp.head_sets(kvs, hd)
        k = dense_tp(p["wk"], h, tp, kv_sets).reshape(B, S, len(kv_mine), hd)
        v = dense_tp(p["wv"], h, tp, kv_sets).reshape(B, S, len(kv_mine), hd)
        if rope:
            q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction,
                           cfg.mrope_sections)
            k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction,
                           cfg.mrope_sections)
        if cache is not None:
            if tp.cache_dims.get("k") != 3:
                raise NotImplementedError("a tensor-parallel prefill writes "
                                          "a cache sharded on head_dim")
            own = tp.own(hd)
            _fill_cache(cfg, cache,
                        tp.gather_sets(k, 2, kvs, KV)[..., own.start:own.stop],
                        tp.gather_sets(v, 2, kvs, KV)[..., own.start:own.stop],
                        pos1d)
        # each query head reads its K/V head: whole groups go to sdpa as
        # they are, else K/V repeat to one a query head
        ql, kl, g = len(mine), len(kv_mine), H // KV
        idx = [(mine.start + i) // g - kv_mine.start for i in range(ql)]
        if ql % kl or idx != [i // (ql // kl) for i in range(ql)]:
            k, v = k[:, :, idx], v[:, :, idx]
        if S * S > BLOCKED_THRESHOLD:
            out = sdpa_causal_blocked(q, k, v, pos1d, cfg.attn_window, scale)
        else:
            out = sdpa(q, k, v, causal_mask(pos1d, pos1d, cfg.attn_window),
                       scale)
        y = out.reshape(B, S, len(mine) * hd) @ tp.take(p["wo"]["w"], 0,
                                                        q_sets)
        return tp.reduce_scatter(y), cache

    # ---- decode: every head's head-dim chunk, against the cache's chunk
    if tp.cache_dims.get("k") != 3:
        raise NotImplementedError("a tensor-parallel decode reads a cache "
                                  "sharded on head_dim")
    c = hd // tp.n
    q_sets, kv_sets = tp.chunk_sets(H, hd), tp.chunk_sets(KV, hd)
    q = dense_tp(p["wq"], h, tp, q_sets).reshape(B, S, H, c)
    k = dense_tp(p["wk"], h, tp, kv_sets).reshape(B, S, KV, c)
    v = dense_tp(p["wv"], h, tp, kv_sets).reshape(B, S, KV, c)
    if rope:
        q = tp.chunk(apply_rope(tp.gather(q, -1), positions, cfg.rope_theta,
                                cfg.rope_fraction, cfg.mrope_sections), -1)
        k = tp.chunk(apply_rope(tp.gather(k, -1), positions, cfg.rope_theta,
                                cfg.rope_fraction, cfg.mrope_sections), -1)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    W = ck.shape[1]
    slot = (pos1d % W).long()
    bidx = torch.arange(B, device=x.device)[:, None]
    ck[bidx, slot] = k.to(ck.dtype)
    cv[bidx, slot] = v.to(cv.dtype)
    cpos[bidx, slot] = pos1d.to(torch.int32)
    ok = (cpos[:, None, :] >= 0) & (cpos[:, None, :] <= pos1d[:, :, None])
    if cfg.attn_window is not None:
        ok &= cpos[:, None, :] > pos1d[:, :, None] - cfg.attn_window
    g = H // KV
    qg = q.reshape(B, S, KV, g, c)
    scores = tp.all_reduce(torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                                        ck.float())) * scale
    scores = torch.where(ok[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, cv.float())
    out = out.reshape(B, S, H * c).to(cv.dtype)
    y = out @ tp.take(p["wo"]["w"], 0, q_sets)
    return tp.reduce_scatter(y), cache


# =============================================================================
# MLA attention (DeepSeek-V2): latent KV cache
# =============================================================================

def _fill_latent(cache: Dict, c_kv: torch.Tensor, k_rope: torch.Tensor,
                 pos1d: torch.Tensor) -> None:
    """Write latents (B, S, r) and rope keys (B, S, rd) into the MLA cache's
    ring slots, in place (only the last W tokens when S > W, so that the
    scatter's indices stay unique)."""
    cc, cr, cpos = cache["c_kv"], cache["k_rope"], cache["pos"]
    W = cc.shape[1]
    if pos1d.shape[1] > W:
        c_kv, k_rope, pos1d = c_kv[:, -W:], k_rope[:, -W:], pos1d[:, -W:]
    slot = (pos1d % W).long()
    bidx = torch.arange(pos1d.shape[0], device=pos1d.device)[:, None]
    cc[bidx, slot] = c_kv.to(cc.dtype)
    cr[bidx, slot] = k_rope.to(cr.dtype)
    cpos[bidx, slot] = pos1d.to(torch.int32)


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
        _fill_latent(cache, c_kv, k_rope[:, :, 0], pos1d)
        cc, cr, cpos = cache["c_kv"], cache["k_rope"], cache["pos"]
        W = cc.shape[1]
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
        _fill_latent(cache, c_kv, k_rope[:, :, 0], pos1d)
    y = dense(p["wo"], out.reshape(B, S, H * vd))
    return y, cache


def mla_forward_tp(p: Params, cfg: ArchConfig, x: torch.Tensor,
                   positions: torch.Tensor, cache: Optional[Dict], tp,
                   absorbed_decode: bool = True
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """`mla_forward` from and to the d-sharded residual stream over the
    tensor group ``tp``, the heads split over the tensor ranks (floor
    ranges: deepseek-v2-lite's 16 heads on 16 ranks give one each).

    Train and fresh prefill: ``wq``, ``w_uk`` and ``w_uv`` are taken by
    head, RoPE on the rank's heads; ``c_kv`` is computed on the rank's
    latent chunk (``w_dkv``'s at-rest shard, no relayout), which a prefill
    writes to the cache's chunk, and all-gathered for the up-projections;
    the rope key (rd wide) is computed whole on every rank (its overlapping
    sets sum the heads' partial gradients back into the leaf) and a prefill
    writes its chunk; ``wo`` is re-laid to the rows of the rank's heads and
    its partial output reduce-scattered.

    Absorbed decode reads the cache in its latent placement: the rank's
    query heads are all-gathered over heads (S = 1), RoPE on whole rd;
    ``q_lat`` on the cache's latent chunk for every head (``w_uk`` taken
    along its latent dim with the chunk's sets); the latent and rope
    partial scores summed in one all-reduce; the context on the chunk times
    ``w_uv``'s chunk rows is a partial (B, 1, H, vd), reduce-scattered over
    heads, then through the rows of ``wo``. Naive decode gathers the
    layer's latent window and decompresses it for the rank's heads. Plain
    PyTorch: the kernels take no shards. With one tensor rank,
    `mla_forward`'s arithmetic."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    nd, rd, vd, r = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)
    if H < tp.n or r % tp.n:
        raise ValueError(f"{H} heads and a latent rank of {r} over a "
                         f"{tp.n}-wide tensor axis")
    scale = 1.0 / np.sqrt(nd + rd)
    pos1d = positions[..., 0] if positions.dim() == 3 else positions
    heads = tp.ranges(H)
    mine = heads[tp.rank]
    hl = len(mine)
    q_sets = tp.head_sets(heads, nd + rd)
    o_sets = tp.head_sets(heads, vd)
    h = tp.gather_input(x)

    q = dense_tp(p["wq"], h, tp, q_sets).reshape(B, S, hl, nd + rd)
    q_full = torch.cat([q[..., :nd], apply_rope(q[..., nd:], pos1d,
                                                cfg.rope_theta)], dim=-1)
    c_own = dense_tp(p["w_dkv"], h, tp, tp.range_sets(r))    # (B, S, r / n)
    k_rope = dense_tp(p["w_krope"], h, tp, tp.every(rd)).reshape(B, S, 1, rd)
    k_rope = apply_rope(k_rope, pos1d, cfg.rope_theta)
    rd_own = tp.own(rd)

    if cache is not None:           # the cache's latent and rope chunks
        if tp.n > 1 and any(tp.cache_dims.get(k) != 2
                            for k in ("c_kv", "k_rope")):
            raise NotImplementedError("a tensor-parallel MLA reads and "
                                      "writes a cache sharded on its latent "
                                      "dims")
        kr_own = k_rope[:, :, 0, rd_own.start:rd_own.stop]
    if cache is not None and S == 1:
        _fill_latent(cache, c_own, kr_own, pos1d)
        cc, cr, cpos = cache["c_kv"], cache["k_rope"], cache["pos"]
        W = cc.shape[1]
        ok = (cpos[:, None, :] >= 0) & (cpos[:, None, :] <= pos1d[:, :, None])
        if cfg.attn_window is not None:
            ok &= cpos[:, None, :] > pos1d[:, :, None] - cfg.attn_window

        if absorbed_decode:
            q = tp.gather_sets(q_full, 2, heads, H)     # every head, S = 1
            q_nope, q_rope = q[..., :nd], q[..., nd:]
            r_sets = tp.range_sets(r)
            rl = cc.shape[-1]
            w_uk = tp.take(p["w_uk"]["w"], 0, r_sets).reshape(rl, H, nd)
            q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(),
                                 w_uk.float())
            ccf = cc.float()
            scores = torch.einsum("bshr,bkr->bhsk", q_lat, ccf)
            scores = scores + torch.einsum(
                "bshr,bkr->bhsk",
                q_rope[..., rd_own.start:rd_own.stop].float(), cr.float())
            scores = tp.all_reduce(scores)
            scores = torch.where(ok[:, None], scores * scale,
                                 torch.full_like(scores, NEG_INF))
            probs = torch.softmax(scores, dim=-1)
            ctx_lat = torch.einsum("bhsk,bkr->bshr", probs, ccf)
            w_uv = tp.take(p["w_uv"]["w"], 0, r_sets).reshape(rl, H, vd)
            out = torch.einsum("bshr,rhv->bshv", ctx_lat, w_uv.float())
            if H % tp.n == 0:
                out = tp.reduce_scatter(out, 2)
            else:
                out = tp.all_reduce(out)[:, :, mine.start:mine.stop]
            out = out.to(x.dtype)
        else:
            # the layer's latent window gathered, decompressed for the
            # rank's heads
            ccw, crw = tp.gather(cc, 2), tp.gather(cr, 2)
            k_nope = (ccw @ tp.take(p["w_uk"]["w"], -1,
                                    tp.head_sets(heads, nd))
                      ).reshape(B, -1, hl, nd)
            vv = (ccw @ tp.take(p["w_uv"]["w"], -1, o_sets)
                  ).reshape(B, -1, hl, vd)
            k_full = torch.cat([k_nope,
                                crw[:, :, None].expand(B, W, hl, rd)], dim=-1)
            out = sdpa(q_full, k_full, vv, ok, scale)
        y = out.reshape(B, S, hl * vd) @ tp.take(p["wo"]["w"], 0, o_sets)
        return tp.reduce_scatter(y), cache

    # ---- train / prefill: the rank's heads over the gathered latent
    c_kv = tp.gather_input(c_own)
    k_nope = (c_kv @ tp.take(p["w_uk"]["w"], -1, tp.head_sets(heads, nd))
              ).reshape(B, S, hl, nd)
    vv = (c_kv @ tp.take(p["w_uv"]["w"], -1, o_sets)).reshape(B, S, hl, vd)
    k_full = torch.cat([k_nope, k_rope.expand(B, S, hl, rd)], dim=-1)
    if S * S > BLOCKED_THRESHOLD:
        out = sdpa_causal_blocked(q_full, k_full, vv, pos1d, cfg.attn_window,
                                  scale)
    else:
        out = sdpa(q_full, k_full, vv,
                   causal_mask(pos1d, pos1d, cfg.attn_window), scale)
    if cache is not None:
        _fill_latent(cache, c_own, kr_own, pos1d)
    y = out.reshape(B, S, hl * vd) @ tp.take(p["wo"]["w"], 0, o_sets)
    return tp.reduce_scatter(y), cache


# =============================================================================
# Cross-attention (musicgen conditioning): static memory
# =============================================================================

def cross_forward(p: Params, cfg: ArchConfig, x: torch.Tensor,
                  memory: Optional[torch.Tensor],
                  cached_kv: Optional[Tuple[torch.Tensor,
                                            torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Cross-attention of ``x`` (B, S, d) over the conditioning memory
    (B, Tm, d): no mask, scale ``1 / sqrt(hd)``. With ``cached_kv`` (decode
    with ``cfg.cross_kv_cache``) the memory projections are skipped and the
    cached keys and values (B, Tm, H, hd) are read instead. Returns the
    output and the (k, v) attended to."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    if cached_kv is not None:
        k, v = cached_kv
    else:
        Tm = memory.shape[1]
        k = dense(p["wk"], memory).reshape(B, Tm, cfg.n_heads, hd)
        v = dense(p["wv"], memory).reshape(B, Tm, cfg.n_heads, hd)
    out = sdpa(q, k, v, None, 1.0 / np.sqrt(hd))
    return dense(p["wo"], out.reshape(B, S, cfg.n_heads * hd)), (k, v)


def cross_forward_tp(p: Params, cfg: ArchConfig, x: torch.Tensor,
                     memory: Optional[torch.Tensor], tp,
                     cached_kv: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                    torch.Tensor]]:
    """`cross_forward` from and to the d-sharded residual stream over the
    tensor group ``tp``: the heads split over the tensor ranks in floor
    ranges (musicgen's 24 heads on 16 ranks give 1 or 2), ``wq``, ``wk``
    and ``wv`` taken by head, ``wo`` re-laid to the rows of the rank's
    heads and its partial output reduce-scattered. ``memory`` is the whole
    conditioning memory of the rank's rows (the sharded step gathers its
    d shards once a forward, with the batch); ``cached_kv``, the cross K/V
    cache held whole over the tensor axis, is read at the rank's heads.
    Returns the output and the rank's heads of the (k, v) attended to.
    With one tensor rank, `cross_forward`'s arithmetic."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    if H < tp.n:
        raise ValueError(f"{H} heads over a {tp.n}-wide tensor axis")
    heads = tp.ranges(H)
    mine = heads[tp.rank]
    hl = len(mine)
    sets = tp.head_sets(heads, hd)
    q = dense_tp(p["wq"], tp.gather_input(x), tp, sets).reshape(B, S, hl, hd)
    if cached_kv is not None:
        k, v = (c[:, :, mine.start:mine.stop] for c in cached_kv)
    else:
        mem = tp.copy_to(memory)
        Tm = mem.shape[1]
        k = dense_tp(p["wk"], mem, tp, sets).reshape(B, Tm, hl, hd)
        v = dense_tp(p["wv"], mem, tp, sets).reshape(B, Tm, hl, hd)
    out = sdpa(q, k, v, None, 1.0 / np.sqrt(hd))
    y = out.reshape(B, S, hl * hd) @ tp.take(p["wo"]["w"], 0, sets)
    return tp.reduce_scatter(y), (k, v)
