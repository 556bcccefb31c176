"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the script on error:

1. Print the card (``nvidia-smi`` name and power limit) and the versions,
   then build every CUDA kernel of the port from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once) and print the build time.
2. Hold each kernel against its plain PyTorch version on the card: at the
   shapes the serving runs below give it, at larger chatglm3-6b shapes, and
   at ragged shapes (lengths that are not multiples of the tile, a row whose
   cache slots are all empty, int4 groups of 32, 24 and 8 rows, the MoE
   kernel test shapes of the reference). One JSON line per case with the
   largest error, the kernel's time, the plain version's and, where one
   PyTorch call computes the same function, that call's (``library_ms``,
   timed here as a yardstick; the port never calls it: ``torch.bmm`` for
   the grouped expert GEMM); the dequant-matmul cases add
   ``bf16_matmul_ms``, the bf16 product over the pre-dequantized weight that
   a quantized layer replaces.
3. Serve full-width, full-depth chatglm3-6b (random bf16 weights from
   ``--seed``) through ``ServingEngine.generate`` with the kernels on: 8
   prompts x 4 samples, prompt length 256, 32 new tokens; with the
   dense-slot backend and with the paged-block backend in bf16, then paged
   with the weights quantized on the card: int8, int4 (group 32), and int4
   over int8 KV pools. Then the same traffic through full-width, full-depth
   granite-moe-3b-a800m (dense and paged) and deepseek-v2-lite-16b (dense:
   its MLA cache has no paged layout). The launch counts are set to 0 just
   before each run and read just after; a run fails unless every kernel of
   its path launched, each dequant kernel exactly 196 times a forward (7
   linear layers x 28), over int8 pools the paged decode kernel not at all,
   and the MoE kernel exactly 3 times per MoE layer a forward (96 for
   granite, 78 for deepseek).
4. f32 parity at full width, 2 layers (3 for deepseek: its dense layer and
   2 MoE layers): the kernel path and the plain path (``use_kernel=False``)
   serve the same prompts greedily, chatglm3-6b dense and paged in f32
   weights, then int8 weights (dense) and int4 weights over int8 KV (paged)
   against the plain path over the dequantized weights, then granite (dense
   and paged) and deepseek (dense); each must give the same tokens and
   log-probabilities within 1e-3.
5. Print the script's wall time (the build included), the ``kernels``
   JSON line, the card again, and as the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, and prints no result, without a CUDA device or outside a
checkout of the repository.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and FLOP/s by type
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_BYTES = 50 * 2 ** 20

SERVE = dict(arch="chatglm3-6b", requests=8, samples=4, prompt_len=256,
             max_new=32, kv_block_size=16, temperature=0.8)
SOURCES = {
    "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:79"),
    "decode_attention": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:69"),
    "paged_decode_attention": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:164"),
    "dequant_matmul_int8": (
        "src/repro_torch/csrc/dequant_matmul.cu",
        "src/repro/kernels/dequant_matmul/dequant_matmul.py:54"),
    "dequant_matmul_int4": (
        "src/repro_torch/csrc/dequant_matmul.cu",
        "src/repro/kernels/dequant_matmul/dequant_matmul.py:108"),
    "moe_gemm": (
        "src/repro_torch/csrc/moe_gemm.cu",
        "src/repro/kernels/moe_gemm/moe_gemm.py:39"),
}
# chatglm3-6b linear layers (K, N) and the launches of one forward
D_MODEL, D_FF, KV_DIM = 4096, 13696, 256
LINEARS_PER_LAYER = 7                   # wq wk wv wo gate up down
QUANT_RUNS = {"int8": ("int8", "bf16"), "int4": ("int4", "bf16"),
              "int4+kv8": ("int4", "int8")}
# the MoE serves: arch -> (run-name prefix, backends); the MLA cache of
# deepseek has no paged layout
MOE_SERVES = {"granite-moe-3b-a800m": ("granite", ("dense", "paged")),
              "deepseek-v2-lite-16b": ("deepseek", ("dense",))}
ATTN_KERNELS = {"dense": ("flash_attention", "decode_attention"),
                "paged": ("flash_attention", "paged_decode_attention")}


def emit(tag: str, obj) -> None:
    print(f"[{tag}] " + json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing

def time_ms(fn, arg_sets, iters: int) -> float:
    """Mean device time of ``fn(*args)`` with CUDA events, cycling through
    ``arg_sets`` (copies of the inputs that together exceed L2, so each call
    finds its inputs cold, as a layer of the model does)."""
    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def copies_past_l2(args, cap: int = 64):
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    n = min(cap, max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args) for _ in range(n - 1)]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------ kernel cases

def randn(g, shape, dtype):
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def flash_case(g, B, S, H, Hkv, D, Dv, dtype, window=None):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    q, k = randn(g, (B, S, H, D), dtype), randn(g, (B, S, Hkv, D), dtype)
    v = randn(g, (B, S, Hkv, Dv), dtype)
    pairs = sum(min(i + 1, window or i + 1) for i in range(S))
    case = dict(args=(q, k, v), kw=dict(window=window),
                kernel=flash_attention, plain=flash_attention_ref,
                bytes=nbytes(q, k, v) + B * S * H * Dv * q.element_size(),
                flops=2 * B * H * pairs * (D + Dv),
                shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D, Dv=Dv, window=window))
    if window is None and D == Dv:
        case["library"] = lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)
    return case


def decode_case(g, B, W, H, Hkv, D, filled, dtype, empty_row=False,
                window=None):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention_cache
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    q = randn(g, (B, 1, H, D), dtype)
    kc, vc = randn(g, (B, W, Hkv, D), dtype), randn(g, (B, W, Hkv, D), dtype)
    pos = torch.full((B, W), -1, dtype=torch.int32, device="cuda")
    pos[:, :filled] = torch.arange(filled, dtype=torch.int32, device="cuda")
    if empty_row:
        pos[-1] = -1
    q_pos = torch.full((B,), filled - 1, dtype=torch.int32, device="cuda")
    valid = (pos >= 0) & (pos <= q_pos[:, None])
    if window is not None:
        valid &= pos > q_pos[:, None] - window
    n_valid = int(valid.sum())
    row = Hkv * D * kc.element_size()
    case = dict(args=(q, kc, vc, pos, q_pos), kw=dict(window=window),
                kernel=decode_attention_cache, plain=decode_attention_ref,
                bytes=2 * nbytes(q) + nbytes(pos, q_pos) + 2 * n_valid * row,
                flops=2 * n_valid * (H // Hkv) * Hkv * 2 * D,
                shape=dict(B=B, W=W, H=H, Hkv=Hkv, D=D, filled=filled,
                           empty_row=empty_row, window=window))
    if not empty_row and window is None:
        mask = valid[:, None, None, :]

        def library(q, kc, vc, pos, q_pos):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        case["library"] = library
    return case


def paged_case(g, B, H, Hkv, D, bs, plen, max_new, samples, step, dtype,
               empty_row=False):
    """Pools and tables laid out by the serving backend's own
    `build_paged_layout` (prefix blocks shared across ``samples`` repeats),
    filled up to position ``plen + step - 1``."""
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_ref
    from repro_torch.serving.backend import BlockAllocator, build_paged_layout
    n_req = B // samples
    alloc = BlockAllocator(10 ** 6, bs)
    lay = build_paged_layout(alloc, plen, max_new, [samples] * n_req)
    table = torch.as_tensor(lay.decode_table, device="cuda")
    nb = table.shape[1]
    P = lay.n_pool_blocks
    last = plen + step - 1
    pos = torch.full((P + nb, bs), -1, dtype=torch.int32, device="cuda")
    logical = torch.arange(nb * bs, device="cuda")
    keep = logical <= last
    for b in range(B):
        blk = table[b].long().repeat_interleave(bs)
        pos[blk[keep], (logical % bs)[keep]] = logical[keep].int()
    if empty_row:
        # the last sequence reads blocks of its own that hold no token
        table[-1] = torch.arange(P, P + nb, dtype=torch.int32, device="cuda")
    P += nb
    q = randn(g, (B, 1, H, D), dtype)
    kp, vp = randn(g, (P, bs, Hkv, D), dtype), randn(g, (P, bs, Hkv, D), dtype)
    q_pos = torch.full((B,), last, dtype=torch.int32, device="cuda")
    flat = pos[table.long()].reshape(B, -1)
    n_valid = int(((flat >= 0) & (flat <= q_pos[:, None])).sum())
    # bytes: every pool slot the tables reach read once, shared prefix
    # blocks included once
    used = torch.unique(table.long())
    n_slots = int(((pos[used] >= 0) & (pos[used] <= last)).sum())
    row = Hkv * D * kp.element_size()
    return dict(args=(q, kp, vp, pos, table, q_pos), kw={},
                kernel=paged_decode_attention,
                plain=paged_decode_attention_ref,
                bytes=2 * nbytes(q) + nbytes(table, q_pos)
                + used.numel() * bs * 4 + 2 * n_slots * row,
                flops=2 * n_valid * H * 2 * D,
                shape=dict(B=B, H=H, Hkv=Hkv, D=D, bs=bs, nb=nb,
                           pool_blocks=P, q_pos=last, empty_row=empty_row))


def int8pack_mm_on_cuda() -> bool:
    """Whether this PyTorch build registers a CUDA kernel for
    ``torch._weight_int8pack_mm`` (int8 weight-only matmul, weight stored
    (N, K)): the int8 kernel's library yardstick."""
    import re
    dump = torch._C._dispatch_dump("aten::_weight_int8pack_mm")
    return re.search(r"^CUDA:", dump, re.M) is not None


def dequant_case(g, fmt, M, K, N, dtype, gs=32):
    """x (M, K) @ a random (K, N) weight quantized on the card, int8 or
    int4 with groups of ``group_size_for(K, gs)`` rows."""
    from repro_torch.kernels.dequant_matmul.ops import (dequant_matmul_int4,
                                                        dequant_matmul_int8)
    from repro_torch.kernels.dequant_matmul.ref import (
        dequant_matmul_int4_ref, dequant_matmul_int8_ref, dequantize_int4,
        dequantize_int8)
    from repro_torch.quant.quantize import quantize_int4, quantize_int8
    x = randn(g, (M, K), dtype)
    # normal * K^-1/2, as the model draws a dense weight: outputs of order one
    w = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
    if fmt == "int8":
        qw, scale = quantize_int8(w)
        kern, plain, deq = (dequant_matmul_int8, dequant_matmul_int8_ref,
                            dequantize_int8)
    else:
        qw, scale = quantize_int4(w, gs)
        kern, plain, deq = (dequant_matmul_int4, dequant_matmul_int4_ref,
                            dequantize_int4)
    del w
    case = dict(args=(x, qw, scale), kw={}, kernel=kern, plain=plain,
                bytes=nbytes(x, qw, scale) + M * N * x.element_size(),
                flops=2 * M * K * N,
                shape=dict(M=M, K=K, N=N, fmt=fmt,
                           group=K // scale.shape[0] if fmt == "int4"
                           else None))
    if dtype == torch.bfloat16:
        # the product a quantized layer replaces: bf16 over the weight
        # dequantized beforehand
        case["bf16_matmul"] = (torch.matmul, (x, deq(qw, scale).to(dtype)))
    if fmt == "int4":
        case["library_note"] = (
            "none: torch._weight_int4pack_mm takes asymmetric zero-points "
            "in a tiled layout, another function")
    elif not int8pack_mm_on_cuda():
        case["library_note"] = ("none: this PyTorch build registers no CUDA "
                                "kernel for torch._weight_int8pack_mm")
    else:
        case["library"] = (torch._weight_int8pack_mm,
                           (x, qw.t().contiguous(), scale.to(dtype)))
    return case


def moe_case(g, E, C, D, F, dtype):
    """x (E, C, d) @ w (E, d, f) per expert, w drawn as the model draws an
    expert weight (normal * d^-1/2)."""
    from repro_torch.kernels.moe_gemm.ops import moe_gemm
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
    x = randn(g, (E, C, D), dtype)
    w = (torch.randn((E, D, F), generator=g, device="cuda")
         * D ** -0.5).to(dtype)
    return dict(args=(x, w), kw={}, kernel=moe_gemm, plain=moe_gemm_ref,
                bytes=nbytes(x, w) + E * C * F * x.element_size(),
                flops=2 * E * C * D * F, library=torch.bmm,
                shape=dict(E=E, C=C, d=D, f=F))


def run_case(name: str, label: str, case, dtype, iters: int) -> dict:
    kern, plain, kw = case["kernel"], case["plain"], case["kw"]
    args = case["args"]
    out = kern(*args, **kw)
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    tol = TOL[dtype]
    err = (out.float() - ref.float()).abs()
    ok = bool(torch.isfinite(out.float()).all()) and bool(
        (err <= tol + tol * ref.float().abs()).all())
    if case["shape"].get("empty_row"):
        ok = ok and bool((out[-1] == 0).all())
    sets = copies_past_l2(args)
    res = dict(kernel=name, case=label, dtype=str(dtype).split(".")[-1],
               shape=case["shape"], max_abs_err=float(err.max()), tol=tol,
               ok=ok,
               kernel_ms=time_ms(lambda *a: kern(*a, **kw), sets, iters),
               plain_ms=time_ms(lambda *a: plain(*a, **kw), sets,
                                max(2, iters // 4)),
               library_ms=None)
    for key in ("library", "bf16_matmul"):
        # a yardstick: one call over its own copies of its own arguments
        # (the weight in the layout it takes), or over the kernel's
        fn = case.get(key)
        if isinstance(fn, tuple):
            fn, lib_args = fn
            res[f"{key}_ms"] = time_ms(fn, copies_past_l2(lib_args), iters)
        elif fn is not None:
            res[f"{key}_ms"] = time_ms(fn, sets, iters)
    if "library_note" in case:
        res["library_note"] = case["library_note"]
    t_bytes = case["bytes"] / PEAK_BYTES_S * 1e3
    t_ops = case["flops"] / PEAK_FLOPS[dtype] * 1e3
    res.update(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=case["bytes"], flops=case["flops"])
    emit("kernel-check", res)
    if not ok:
        raise AssertionError(f"{name} {label} {res['dtype']}: kernel and "
                             f"plain version disagree (max abs err "
                             f"{res['max_abs_err']:.3e}, tol {tol})")
    return res


def check_kernels(seed: int) -> dict:
    """Phase 2. Returns the result of each kernel at its main-path shape."""
    from repro_torch.kernels import KERNELS
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32
    H, Hkv, D = 32, 2, 128                          # chatglm3-6b attention
    R, k, plen, new = (SERVE["requests"], SERVE["samples"],
                       SERVE["prompt_len"], SERVE["max_new"])
    B, W, bs = R * k, plen + new, SERVE["kv_block_size"]
    step = new // 2                                 # mid-decode fill level
    main = {}
    for dtype in (bf, f32):
        tag = "main" if dtype == bf else "main-f32"
        r = run_case("flash_attention", tag,
                     flash_case(g, B, plen, H, Hkv, D, D, dtype), dtype, 20)
        main.setdefault("flash_attention", r)
        r = run_case("decode_attention", tag,
                     decode_case(g, B, W, H, Hkv, D, plen + step, dtype),
                     dtype, 50)
        main.setdefault("decode_attention", r)
        r = run_case("paged_decode_attention", tag,
                     paged_case(g, B, H, Hkv, D, bs, plen, new, k, step,
                                dtype), dtype, 50)
        main.setdefault("paged_decode_attention", r)
    # larger chatglm3-6b shapes
    run_case("flash_attention", "S2048",
             flash_case(g, 4, 2048, H, Hkv, D, D, bf), bf, 5)
    run_case("decode_attention", "W2048",
             decode_case(g, 32, 2048, H, Hkv, D, 2048, bf), bf, 20)
    run_case("paged_decode_attention", "nb128",
             paged_case(g, 32, H, Hkv, D, 16, 2040, 9, 1, 8, bf), bf, 20)
    # ragged lengths, windows, Dv != D and all-empty rows
    for dtype in (bf, f32):
        run_case("flash_attention", "ragged",
                 flash_case(g, 2, 1000, H, Hkv, D, D, dtype), dtype, 5)
        run_case("flash_attention", "window",
                 flash_case(g, 2, 333, 8, 2, 64, 64, dtype, window=100),
                 dtype, 5)
        run_case("flash_attention", "dv!=d",
                 flash_case(g, 1, 200, 16, 1, 192, 128, dtype), dtype, 5)
        run_case("decode_attention", "ragged+empty",
                 decode_case(g, 5, 1001, H, Hkv, D, 777, dtype,
                             empty_row=True), dtype, 10)
        run_case("decode_attention", "window+empty",
                 decode_case(g, 3, 300, 8, 2, 64, 250, dtype, empty_row=True,
                             window=64), dtype, 10)
        run_case("paged_decode_attention", "ragged+empty",
                 paged_case(g, 6, H, Hkv, D, 16, 101, 30, 2, 7, dtype,
                            empty_row=True), dtype, 10)
    # dequant-matmul: decode (M = 32 rows) and prefill (M = 2048, the paged
    # prefill of 8 prompts x 256) at chatglm3-6b's widths, then ragged
    # shapes and int4 groups of 32, 24 and 8 rows
    rows = R * k
    for fmt in ("int8", "int4"):
        name = f"dequant_matmul_{fmt}"
        for dtype in (bf, f32):
            tag = "main" if dtype == bf else "main-f32"
            r = run_case(name, tag, dequant_case(g, fmt, rows, D_MODEL, D_FF,
                                                 dtype), dtype, 50)
            main.setdefault(name, r)
        run_case(name, "down", dequant_case(g, fmt, rows, D_FF, D_MODEL, bf),
                 bf, 50)
        run_case(name, "wk", dequant_case(g, fmt, rows, D_MODEL, KV_DIM, bf),
                 bf, 50)
        run_case(name, "prefill", dequant_case(g, fmt, R * plen, D_MODEL,
                                               D_FF, bf), bf, 10)
        for dtype in (bf, f32):
            for M, K, N, gs in ((5, 48, 19, 32), (1, 32, 130, 32),
                                (17, 96, 33, 8)):
                run_case(name, "ragged", dequant_case(g, fmt, M, K, N, dtype,
                                                      gs), dtype, 10)
    # the MoE serves' attention: granite (hd 64, 24 heads over 8 kv heads)
    # at its dense and paged shapes; deepseek's MLA prefill (D = 128 + 64,
    # Dv = 128, one query head a kv head)
    run_case("flash_attention", "granite",
             flash_case(g, B, plen, 24, 8, 64, 64, bf), bf, 20)
    run_case("flash_attention", "mla",
             flash_case(g, B, plen, 16, 16, 192, 128, bf), bf, 10)
    run_case("decode_attention", "granite",
             decode_case(g, B, W, 24, 8, 64, plen + step, bf), bf, 50)
    run_case("paged_decode_attention", "granite",
             paged_case(g, B, 24, 8, 64, bs, plen, new, k, step, bf), bf, 50)
    # the grouped expert GEMM at the serves' shapes (E, C, d, f): granite
    # gate/up at decode (C = 8 of 32 sequences x top-8 / 40 experts), its
    # down, paged prefill (C = 512) and dense prefill (C = 2048); deepseek
    # gate/up at decode (C = 6) and dense prefill (C = 960); then the
    # reference's kernel-test shapes, ragged in every dim
    for dtype in (bf, f32):
        tag = "main" if dtype == bf else "main-f32"
        r = run_case("moe_gemm", tag, moe_case(g, 40, 8, 1536, 512, dtype),
                     dtype, 50)
        main.setdefault("moe_gemm", r)
    for label, shape, iters in (("granite-down", (40, 8, 512, 1536), 50),
                                ("granite-paged-prefill",
                                 (40, 512, 1536, 512), 20),
                                ("granite-dense-prefill",
                                 (40, 2048, 1536, 512), 10),
                                ("deepseek-decode", (64, 6, 2048, 1408), 30),
                                ("deepseek-prefill", (64, 960, 2048, 1408),
                                 5)):
        run_case("moe_gemm", label, moe_case(g, *shape, bf), bf, iters)
    for dtype in (bf, f32):
        for shape in ((4, 32, 64, 128), (8, 100, 48, 96), (2, 8, 16, 8),
                      (3, 130, 130, 70)):
            run_case("moe_gemm", "ragged", moe_case(g, *shape, dtype), dtype,
                     10)
    assert set(main) == set(KERNELS), (sorted(main), sorted(KERNELS))
    return main


# ----------------------------------------------------------------- serving

def make_prompts(cfg, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(SERVE["prompt_len"],))
            .astype(np.int32) for _ in range(SERVE["requests"])]


def check_results(results, cfg, n_samples: int, max_new: int) -> None:
    assert len(results) == SERVE["requests"]
    for r in results:
        assert len(r.samples) == n_samples
        for s, lp in zip(r.samples, r.logprobs):
            assert s.shape == (max_new,), s.shape
            assert s.min() >= 0 and s.max() < cfg.vocab_size, s
            assert math.isfinite(lp) and lp <= 0.0, lp


def serve_run(model, params, prompts, seed: int, paged: bool,
              kv_format: str = "bf16"):
    """One timed serve run of the SERVE requests, after a warm-up request.
    Returns the launch counts, the sampled tokens, the model forwards and
    the run's numbers."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (ExecutionBackend, GumbelNoise,
                                     ServingEngine)
    R, k, new = SERVE["requests"], SERVE["samples"], SERVE["max_new"]
    kw = {}
    if paged:
        probe = ExecutionBackend(model, params, kv_blocks=1,
                                 kv_block_size=SERVE["kv_block_size"])
        kw = dict(kv_blocks=R * probe.request_blocks(SERVE["prompt_len"],
                                                     new, k),
                  kv_block_size=SERVE["kv_block_size"], kv_format=kv_format)
    backend = ExecutionBackend(model, params, **kw)
    engine = ServingEngine(model, params, max_new_tokens=new,
                           temperature=SERVE["temperature"], backend=backend)
    engine.generate(prompts[:1], n_samples=1, max_new_tokens=2)  # warm-up
    noise = GumbelNoise(torch.Generator(device="cuda").manual_seed(seed))
    forwards = [0]
    forward = model.forward

    def counted(*a, **kwa):
        forwards[0] += 1
        return forward(*a, **kwa)

    model.forward = counted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        results = engine.generate(prompts, n_samples=k, noise=noise)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        del model.forward
    check_results(results, model.cfg, k, new)
    tokens = np.stack([s for r in results for s in r.samples])
    n_tok = sum(r.decode_tokens for r in results)
    info = dict(requests=R, samples=k, prompt_len=SERVE["prompt_len"],
                max_new=new, kv_blocks=kw.get("kv_blocks"),
                kv_format=kv_format, tokens=n_tok, seconds=dt,
                tokens_per_s=n_tok / dt, forwards=forwards[0],
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=counts)
    return counts, tokens, forwards[0], info


def serve(seed: int) -> dict:
    """Phase 3: full chatglm3-6b, dense then paged in bf16, then paged with
    int8, int4 and int4 + int8-KV weights quantized on the card. Returns
    the launch counts of each run."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.quant.quantize import param_bytes, quantize_model
    cfg = get_config(SERVE["arch"])
    model = Model(cfg, dtype=torch.bfloat16, device="cuda", use_kernel=True)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    emit("model", dict(arch=cfg.name, layers=cfg.n_layers,
                       d_model=cfg.d_model, params=model.param_count(),
                       dtype="bfloat16", init_s=time.perf_counter() - t0,
                       weight_gb=param_bytes(params) / 1e9))
    prompts = make_prompts(cfg, seed)
    want = {"dense": ("flash_attention", "decode_attention"),
            "paged": ("flash_attention", "paged_decode_attention")}
    counts, tokens = {}, {}
    for mode in ("dense", "paged"):
        counts[mode], tokens[mode], _, info = serve_run(
            model, params, prompts, seed, paged=mode == "paged")
        emit("serve", dict(mode=mode, weights="bf16", **info))
        for name in want[mode]:
            if counts[mode][name] < 1:
                raise AssertionError(f"{mode} serving never launched {name}")
    emit("serve-agreement", dict(
        dense_vs_paged_token_match=float((tokens["dense"]
                                          == tokens["paged"]).mean())))

    per_forward = LINEARS_PER_LAYER * cfg.n_layers
    for run, (wfmt, kv_format) in QUANT_RUNS.items():
        t0 = time.perf_counter()
        qparams = quantize_model(params, wfmt, 32)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        c, toks, fwd, info = serve_run(model, qparams, prompts, seed,
                                       paged=True, kv_format=kv_format)
        counts[run] = c
        emit("serve", dict(mode="paged", weights=wfmt, quantize_s=quant_s,
                           weight_gb=param_bytes(qparams) / 1e9,
                           token_match_vs_bf16_paged=float(
                               (toks == tokens["paged"]).mean()), **info))
        name = f"dequant_matmul_{wfmt}"
        if c[name] != per_forward * fwd:
            raise AssertionError(f"{run}: {name} launched {c[name]} times, "
                                 f"want {per_forward} x {fwd} forwards")
        if c["flash_attention"] < 1:
            raise AssertionError(f"{run}: never launched flash_attention")
        paged_launches = c["paged_decode_attention"]
        if (kv_format == "int8") != (paged_launches == 0):
            raise AssertionError(
                f"{run}: paged_decode_attention launched {paged_launches} "
                f"times over {kv_format} pools (int8 pools take the plain "
                "path, bf16 pools the kernel)")
        del qparams
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return counts


def serve_moe(seed: int) -> dict:
    """Phase 3, MoE: full granite-moe-3b-a800m dense and paged, then full
    deepseek-v2-lite-16b dense, bf16, the chatglm traffic. Returns the
    launch counts of each run."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.quant.quantize import param_bytes
    counts = {}
    for arch, (short, modes) in MOE_SERVES.items():
        cfg = get_config(arch)
        model = Model(cfg, dtype=torch.bfloat16, device="cuda",
                      use_kernel=True)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        # gate, up and down: three grouped GEMMs in every MoE layer
        per_forward = 3 * sum(cfg.is_moe_layer(i)
                              for i in range(cfg.n_layers))
        emit("model", dict(arch=cfg.name, layers=cfg.n_layers,
                           d_model=cfg.d_model, params=model.param_count(),
                           active_params=model.active_param_count(),
                           dtype="bfloat16", init_s=time.perf_counter() - t0,
                           weight_gb=param_bytes(params) / 1e9,
                           moe_gemm_per_forward=per_forward))
        prompts = make_prompts(cfg, seed)
        tokens = {}
        for mode in modes:
            run = f"{short}-{mode}"
            c, tokens[mode], fwd, info = serve_run(
                model, params, prompts, seed, paged=mode == "paged")
            counts[run] = c
            emit("serve", dict(arch=cfg.name, mode=mode, weights="bf16",
                               **info))
            if c["moe_gemm"] != per_forward * fwd:
                raise AssertionError(f"{run}: moe_gemm launched "
                                     f"{c['moe_gemm']} times, want "
                                     f"{per_forward} x {fwd} forwards")
            # MLA decode has no kernel (as in the reference): its prefill
            # is the flash kernel at D = 192, Dv = 128
            want = ("flash_attention",) if cfg.mla else ATTN_KERNELS[mode]
            for name in want:
                if c[name] < 1:
                    raise AssertionError(f"{run}: never launched {name}")
        if len(modes) == 2:
            # information, not a gate: dense prefills the 32 tiled rows and
            # paged the 8 unique prompts, so capacity and drops differ
            emit("serve-agreement", dict(
                arch=cfg.name, dense_vs_paged_token_match=float(
                    (tokens["dense"] == tokens["paged"]).mean())))
        del params, model
        torch.cuda.empty_cache()
    return counts


def compare_paths(cfg, mk, mp, kparams, pparams, prompts, mode: str,
                  weights: str, kv_format: str = "bf16") -> None:
    """Greedy serve through the kernel path (``mk``) and the plain path
    (``mp``): the same tokens and log-probabilities within 1e-3, or raise.
    For an MoE arch the kernel path must have run the MoE kernel."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ExecutionBackend, ServingEngine
    k, new = 2, 16
    out = {}
    for tag, m, prm in (("kernel", mk, kparams), ("plain", mp, pparams)):
        kw = (dict(kv_blocks=512, kv_block_size=SERVE["kv_block_size"],
                   kv_format=kv_format) if mode == "paged" else {})
        eng = ServingEngine(m, prm, max_new_tokens=new, temperature=0.0,
                            backend=ExecutionBackend(m, prm, **kw))
        reset_launch_counts()
        out[tag] = eng.generate(prompts, n_samples=k)
        if tag == "kernel" and cfg.moe is not None \
                and launch_counts()["moe_gemm"] < 1:
            raise AssertionError(f"{cfg.name} parity: the kernel path never "
                                 "launched moe_gemm")
        check_results(out[tag], cfg, k, new)
    toks = [np.array_equal(a, b) for ra, rb in zip(out["kernel"],
                                                  out["plain"])
            for a, b in zip(ra.samples, rb.samples)]
    lp_err = max(abs(a - b) for ra, rb in zip(out["kernel"], out["plain"])
                 for a, b in zip(ra.logprobs, rb.logprobs))
    emit("parity-f32", dict(arch=cfg.name, mode=mode, weights=weights,
                            kv_format=kv_format, layers=cfg.n_layers,
                            sequences=len(toks), tokens_equal=sum(toks),
                            max_logprob_diff=lp_err, tol=1e-3))
    if not all(toks) or lp_err > 1e-3:
        raise AssertionError(f"f32 parity ({cfg.name} {mode}, {weights} "
                             f"weights, {kv_format} KV): {sum(toks)}/"
                             f"{len(toks)} sequences equal, logprob diff "
                             f"{lp_err:.3e}")


def parity(seed: int) -> None:
    """Phase 4: f32, full width, 2 layers; kernel path vs plain path, in
    f32 weights and, quantized, against the plain path over the dequantized
    weights (the reference's contract: quantized == dequantized)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.quant.quantize import dequantize_model, quantize_model
    cfg = dataclasses.replace(get_config(SERVE["arch"]), n_layers=2)
    mk = Model(cfg, dtype=torch.float32, device="cuda", use_kernel=True)
    mp = Model(cfg, dtype=torch.float32, device="cuda", use_kernel=False)
    params = mk.init(torch.Generator(device="cuda").manual_seed(seed + 1))
    prompts = make_prompts(cfg, seed + 1)
    for mode in ("dense", "paged"):
        compare_paths(cfg, mk, mp, params, params, prompts, mode, "f32")
    for wfmt, mode, kv_format in (("int8", "dense", "bf16"),
                                  ("int4", "paged", "int8")):
        qp = quantize_model(params, wfmt, 32)
        compare_paths(cfg, mk, mp, qp, dequantize_model(qp, torch.float32),
                      prompts, mode, wfmt, kv_format)
        del qp
    del params
    torch.cuda.empty_cache()
    # the MoE archs, full width: granite at 2 layers, deepseek at its dense
    # layer + 2 MoE layers
    for arch, (_, modes) in MOE_SERVES.items():
        full = get_config(arch)
        n_prefix = full.moe.first_dense
        cfg = dataclasses.replace(full, n_layers=n_prefix + 2)
        mk = Model(cfg, dtype=torch.float32, device="cuda", use_kernel=True)
        mp = Model(cfg, dtype=torch.float32, device="cuda", use_kernel=False)
        params = mk.init(torch.Generator(device="cuda").manual_seed(seed + 1))
        prompts = make_prompts(cfg, seed + 1)
        for mode in modes:
            compare_paths(cfg, mk, mp, params, params, prompts, mode, "f32")
        del params
        torch.cuda.empty_cache()


# -------------------------------------------------------------------- main

def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(src/repro_torch missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # exact f32 products for the f32 checks: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    card = card_line()
    print(card, flush=True)
    emit("env", dict(python=sys.version.split()[0], torch=torch.__version__,
                     cuda=torch.version.cuda,
                     device=torch.cuda.get_device_name(0),
                     count=torch.cuda.device_count(), tf32=False))
    t0 = time.perf_counter()
    secs = build.build(force=True)
    emit("build", dict(wall_s=time.perf_counter() - t0, per_source_s=secs,
                       nvcc=build.nvcc_path()))

    main_cases = check_kernels(args.seed)
    counts = serve(args.seed)
    counts.update(serve_moe(args.seed))
    parity(args.seed)

    kernels = []
    for name, r in main_cases.items():
        src, replaces = SOURCES[name]
        by_run = {run: c[name] for run, c in counts.items()}
        entry = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(by_run.values()), launches_by_run=by_run,
            max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"], dtype=r["dtype"])
        for key in ("bf16_matmul_ms", "library_note"):
            if key in r:
                entry[key] = r[key]
        kernels.append(entry)
    emit("done", dict(wall_s=time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
