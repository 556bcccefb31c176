"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the script on error:

1. Print the card (``nvidia-smi`` name and power limit) and the versions,
   then build every CUDA kernel of the port from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once) and print the build time. Count
   the tensor-core instructions (``HGMMA``, ``HMMA``) of each kernel in the
   libraries' SASS (``cuobjdump -sass``): the run fails if the bf16 flash
   kernel, the MoE or the int8 TMA + wgmma kernel has no ``HGMMA``, or the
   bf16 paged decode kernel or the SSD chunk's tensor-core kernel no
   ``HMMA``.
2. Hold each kernel against its plain PyTorch version on the card: at the
   shapes the serving runs below give it, at larger chatglm3-6b shapes, and
   at ragged shapes (lengths that are not multiples of the tile, sequence
   lengths at the flash kernel's 64-row tile edges, cache lengths and
   table widths where the dense and the paged decode kernel's planner
   changes its number of splits and splits that hold no valid slot, a row
   whose cache slots are all empty, int8 rows and widths about the split-K
   kernel's tiles, int4 groups of 32, 24 and 8 rows, the MoE kernel test
   shapes of the reference). The MoE, paged, dequant and SSD cases print
   the route the wrapper's planner took (``moe_gemm``: the TMA + wgmma
   kernel or the cp.async one, with its tiles; paged: its split; int8 and
   int4: the split-K kernel with its strips and slices, the TMA + wgmma
   kernel or the tiled one; ``ssd_scan``: the tensor-core kernel with its
   heads a block, or the scalar-FMA one). One JSON line per case with the
   largest error, the kernel's time, the plain version's and, where one
   PyTorch call computes the same function, that call's (``library_ms``,
   timed here as a yardstick; the port never calls it: ``torch.bmm`` for
   the grouped expert GEMM; none for the SSD chunk); the SSD chunk cases
   (the mamba2 and jamba serve shapes, the mamba2 shape with B and C drawn
   for every head, mamba2 heads over four chunks with a padded tail, the
   reference's ragged kernel-test shapes) draw their inputs as a Mamba-2
   layer makes them and hold bf16 inputs to the f32 tolerance too (both
   outputs are f32); the dequant-matmul cases add ``bf16_matmul_ms``, the bf16 product over the
   pre-dequantized weight that a quantized layer replaces.
3. Serve full-width, full-depth chatglm3-6b (random bf16 weights from
   ``--seed``) through ``ServingEngine.generate`` with the kernels on: 8
   prompts x 4 samples, prompt length 256, 32 new tokens; with the
   dense-slot backend and with the paged-block backend in bf16, then paged
   with the weights quantized on the card: int8, int4 (group 32), and int4
   over int8 KV pools. Then the same traffic through full-width, full-depth
   granite-moe-3b-a800m (dense and paged) and deepseek-v2-lite-16b (dense:
   its MLA cache has no paged layout). Then, dense only (an SSM layer has
   no paged layout, as in the reference), full-width, full-depth
   mamba2-370m (48 Mamba-2 layers) and full-width jamba-v0.1-52b cut to 16
   of its 32 layers (two of its four 8-layer super-blocks, about 52 GB of
   bf16 weights: the whole model does not fit one 80 GB card), every
   earlier model freed first. Each serve decodes through CUDA graphs (the
   backend's default on the card): its one batch runs its first decode
   step eagerly, captures the second and replays it, and replays every
   later step; a serve fails unless it made one capture and 30 replays.
   The launch counts are set to 0 just before each run and read just
   after; a replay adds the launches its graph captured, and a capture,
   which runs nothing, adds none. A forward is a ``model.forward`` call
   that ran on the card: the calls, less the captures, plus the replays. A
   run fails unless every kernel of its path launched, each dequant
   kernel exactly 196 times a forward (7 linear layers x 28), over int8
   pools the paged decode kernel not at all,
   and the MoE kernel exactly 3 times per MoE layer a forward (96 for
   granite, 78 for deepseek); the SSM serves fail unless the SSD kernel
   launched once per Mamba layer (at the one prefill: the decode steps take
   the recurrence), the flash kernel once per attention layer, the dense
   decode kernel once per attention layer a decode step and the MoE kernel
   3 times per MoE layer a forward: mamba2 48 SSD launches and no attention
   kernel, jamba 14 / 2 / 62 / 768. Then graphs against eager decoding
   (``cuda_graphs=False``) on the card, bf16, full width at 2 layers (2 MoE
   layers for granite): chatglm3-6b dense, paged and int4 paged,
   granite-moe paged and mamba2, the serve's traffic and noise; each must
   give identical tokens, and prints the largest log-probability
   difference.
4. f32 parity at full width, 2 layers (3 for deepseek: its dense layer and
   2 MoE layers): the kernel path and the plain path (``use_kernel=False``)
   serve the same prompts greedily, both decoding through CUDA graphs (one
   capture and 14 replays each, or the run fails), chatglm3-6b dense and
   paged in f32 weights, then int8 weights (dense) and int4 weights over
   int8 KV (paged)
   against the plain path over the dequantized weights, then granite (dense
   and paged) and deepseek (dense), then mamba2 (2 layers) and, last, jamba
   at one super-block (8 layers, about 53 GB of f32 weights), both over
   prompts of 300 tokens, which cross a 256-row chunk and pad a tail; each
   must give the same tokens and log-probabilities within 1e-3. Before
   them, as information and not a gate, the same greedy comparison in
   bf16, where the new tensor-core kernels run: granite at its 2 MoE
   layers (dense) and chatglm3-6b at 2 layers in int4 and in int8 weights
   (paged): the share of equal tokens, the equal sequences and the largest
   log-probability difference.
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
    "ssd_scan": (
        "src/repro_torch/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/ssd_scan.py:54"),
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
# the SSM serves (dense only): arch -> (run name, layers served; jamba's 32
# layers hold 103 GB of bf16 weights, so it serves 2 of its 4 super-blocks)
SSM_SERVES = {"mamba2-370m": ("mamba2-dense", 48),
              "jamba-v0.1-52b": ("jamba-dense", 16)}
# the f32 parity of the SSM archs: layers, and a prompt length that crosses
# a 256-row chunk and pads a tail
SSM_PARITY = {"mamba2-370m": 2, "jamba-v0.1-52b": 8}
SSM_PARITY_PROMPT = 300


def emit(tag: str, obj) -> None:
    print(f"[{tag}] " + json.dumps(obj), flush=True)


def tensor_core_sass(lib: Path) -> dict:
    """The tensor-core instructions (``HGMMA``: wgmma; ``HMMA``: mma.sync)
    of each kernel in a built library's SASS, by function."""
    import re
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            for op in counts[fn]:
                if re.search(rf"\b{op}\.", line):
                    counts[fn][op] += 1
    return counts


# (library, kernel, the tensor-core instruction each of its bf16
# instantiations must have)
SASS_CHECKS = (("flash_attention", "flash_attention_tc_kernel", "HGMMA"),
               ("moe_gemm", "moe_gemm_tc_kernel", "HGMMA"),
               ("decode_attention", "paged_decode_attention_split_kernel",
                "HMMA"),
               ("dequant_matmul", "dequant_matmul_int8_tc_kernel", "HGMMA"),
               ("ssd_scan", "ssd_scan_chunk_tc_kernel", "HMMA"))


def check_sass() -> dict:
    """Fail unless the bf16 flash kernel, the MoE and the int8 TMA + wgmma
    kernels run on wgmma (``HGMMA``) and the bf16 paged decode kernel and
    the SSD chunk's tensor-core kernel (bf16 only) on mma.sync (``HMMA``):
    every bf16 instantiation of each (the paged kernel's f32 ones compute
    on the CUDA cores)."""
    from repro_torch.kernels import build
    out = {}
    for lib, kernel, op in SASS_CHECKS:
        counts = tensor_core_sass(build.library_path(lib))
        tc = {fn: c for fn, c in counts.items() if kernel in fn
              and ("bfloat16" in fn or "paged" not in kernel)}
        res = dict(library=lib, kernel=kernel, op=op,
                   by_kernel={fn: c for fn, c in counts.items()
                              if kernel in fn},
                   count=[c[op] for c in tc.values()])
        emit("sass", res)
        if not tc or min(res["count"]) == 0:
            raise AssertionError(f"{kernel} has no {op} in its SASS")
        out[kernel] = res
    return out


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
                plain=paged_decode_attention_ref, route=paged_route,
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
                route=int4_route if fmt == "int4" else int8_route,
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


def int4_route(x, packed, scale) -> dict:
    """The int4 wrapper's plan: the split-K kernel and its split, or the
    tiled kernel."""
    from repro_torch.kernels.dequant_matmul.ops import int4_plan
    return int4_plan(x, packed, scale)._asdict()


def int8_route(x, qw, scale) -> dict:
    """The int8 wrapper's plan: the split-K kernel and its split, the TMA +
    wgmma kernel or the tiled one."""
    from repro_torch.kernels.dequant_matmul.ops import int8_plan
    return int8_plan(x, qw, scale)._asdict()


def paged_route(q, kp, vp, pos, table, q_pos) -> dict:
    """The paged wrapper's split: (n_split, split_slots, n_hb)."""
    from repro_torch.kernels.decode_attention.ops import paged_split_plan
    B, nb = table.shape
    plan = paged_split_plan(B, nb * kp.shape[1], q.shape[2], kp.shape[2],
                            q.shape[3], vp.shape[3], q.dtype, q.device)
    return dict(zip(("n_split", "split_slots", "n_hb"), plan))


def moe_route(x, w) -> dict:
    """The MoE wrapper's plan: the kernel and its tiles."""
    from repro_torch.kernels.moe_gemm.ops import moe_plan
    return moe_plan(x, w)._asdict()


def moe_case(g, E, C, D, F, dtype):
    """x (E, C, d) @ w (E, d, f) per expert, w drawn as the model draws an
    expert weight (normal * d^-1/2)."""
    from repro_torch.kernels.moe_gemm.ops import moe_gemm
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
    x = randn(g, (E, C, D), dtype)
    w = (torch.randn((E, D, F), generator=g, device="cuda")
         * D ** -0.5).to(dtype)
    return dict(args=(x, w), kw={}, kernel=moe_gemm, plain=moe_gemm_ref,
                route=moe_route,
                bytes=nbytes(x, w) + E * C * F * x.element_size(),
                flops=2 * E * C * D * F, library=torch.bmm,
                shape=dict(E=E, C=C, d=D, f=F))


def ssd_case(g, B, L, H, P, N, chunk, dtype, per_head=False):
    """The SSD chunk kernel's six inputs as a Mamba-2 layer makes them: x,
    B and C silu'd conv outputs (x a slice of the conv output, B and C one
    group broadcast over the heads by a stride-0 view, or with
    ``per_head`` drawn for every head), dt the softplus of a unit normal
    plus the model's dt_bias (the inverse softplus of a log-uniform dt in
    [1e-3, 0.1]), A = -exp(A_log) = -(1..H), so the decays underflow as in
    a real prefill; padded and cut into chunks as `ssd_chunked` does.
    Bytes count the B and C tensors once (one group's or every head's), dt
    and cs (dA is not read), and the f32 outputs; operations count the
    causal pairs of the valid rows (2N + 2P each) and the state (2PN a
    row)."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan.ops import ssd_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
    from repro_torch.models.ssm import _pad_rows
    xbc = F.silu(torch.randn((B, L, H * P + 2 * N), generator=g,
                             device="cuda")).to(dtype)
    x = xbc[..., :H * P].reshape(B, L, H, P)
    Bm = xbc[..., H * P:H * P + N][:, :, None].expand(B, L, H, N)
    Cm = xbc[..., H * P + N:][:, :, None].expand(B, L, H, N)
    if per_head:
        Bm, Cm = (F.silu(torch.randn((B, L, H, N), generator=g,
                                     device="cuda")).to(dtype)
                  for _ in range(2))
    lo, hi = math.log(1e-3), math.log(0.1)
    dt0 = torch.exp(torch.rand(H, generator=g, device="cuda") * (hi - lo)
                    + lo)
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = torch.logaddexp(torch.randn((B, L, H), generator=g, device="cuda")
                         + dt_bias, torch.zeros((), device="cuda"))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device="cuda")
    pad = (-L) % chunk
    if pad:
        x, dt = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)) for a in (x, dt))
        Bm, Cm = _pad_rows(Bm, pad), _pad_rows(Cm, pad)
    nc = x.shape[1] // chunk
    xc, dtc, Bc, Cc = (a.reshape((B, nc, chunk) + tuple(a.shape[2:]))
                       for a in (x, dt, Bm, Cm))
    dA = dtc * A
    dA_cs = torch.cumsum(dA, dim=2)
    el = xc.element_size()
    bc_heads = 1 if Bc.stride(3) == 0 else H
    valid = [min(chunk, L - c * chunk) for c in range(nc)]
    pairs = sum(q * (q + 1) // 2 for q in valid)
    return dict(args=(xc, dtc, dA, dA_cs, Bc, Cc), kw={}, kernel=ssd_chunk,
                plain=ssd_chunk_ref, route=ssd_route,
                bytes=(B * L * H * P + 2 * B * L * bc_heads * N) * el
                + 2 * 4 * B * L * H + 4 * B * nc * chunk * H * P
                + 4 * B * nc * H * P * N,
                flops=B * H * (pairs * (2 * N + 2 * P) + 2 * L * P * N),
                # both outputs are f32, and the bf16 route splits scores and
                # x * w into bf16 hi + lo: held to the f32 tolerance
                tol=TOL[torch.float32],
                library_note=("none: no one PyTorch call computes the "
                              "masked decay product"),
                shape=dict(B=B, L=L, H=H, P=P, N=N, chunk=chunk, nc=nc,
                           per_head=per_head))


def ssd_route(xc, dtc, dA, dA_cs, Bc, Cc) -> dict:
    """The SSD wrapper's plan: the tensor-core kernel with its heads a
    block, or the scalar-FMA one."""
    from repro_torch.kernels.ssd_scan.ops import ssd_plan
    return ssd_plan(xc, dtc, dA, dA_cs, Bc, Cc)._asdict()


def run_case(name: str, label: str, case, dtype, iters: int) -> dict:
    kern, plain, kw = case["kernel"], case["plain"], case["kw"]
    args = case["args"]
    out = kern(*args, **kw)
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    outs, refs = ((out, ref) if isinstance(out, tuple)
                  else ((out,), (ref,)))
    tol = case.get("tol", TOL[dtype])
    errs = [(o.float() - r.float()).abs() for o, r in zip(outs, refs)]
    err = torch.cat([e.flatten() for e in errs])
    ok = all(bool(torch.isfinite(o.float()).all())
             and bool((e <= tol + tol * r.float().abs()).all())
             for o, r, e in zip(outs, refs, errs))
    if case["shape"].get("empty_row"):
        ok = ok and bool((out[-1] == 0).all())
    sets = copies_past_l2(args)
    res = dict(kernel=name, case=label, dtype=str(dtype).split(".")[-1],
               shape=case["shape"], max_abs_err=float(err.max()), tol=tol,
               ok=ok,
               route=case["route"](*args) if case.get("route") else None,
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
               bytes=case["bytes"], flops=case["flops"],
               # the same operations at the f32 rate outside the tensor
               # cores, where a kernel computing in f32 FMAs runs
               f32_ops_ms=case["flops"] / PEAK_FLOPS[torch.float32] * 1e3)
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
    # the flash kernel's 64-row tile and two-stage ring edges, a window that
    # crosses kv tiles; the dense decode kernel at the serve batch where the
    # wrapper's planner changes its split (and one slot before), and with
    # splits that hold no valid slot (100 of 288 filled)
    from repro_torch.kernels.decode_attention.ops import split_plan
    for dtype in (bf, f32):
        plans = [split_plan(B, w, H, Hkv, D, D, dtype, torch.device("cuda"))
                 for w in range(1, W + 1)]
        edges = [w for w in range(2, W + 1) if plans[w - 1] != plans[w - 2]]
        emit("decode-split-edges", dict(dtype=str(dtype).split(".")[-1],
                                        edges={w: plans[w - 1]
                                               for w in edges}))
        for S in (1, 63, 65, 127, 129, 257):
            run_case("flash_attention", f"edge-S{S}",
                     flash_case(g, 2, S, 8, 2, D, D, dtype), dtype, 5)
        run_case("flash_attention", "window-crosses-tiles",
                 flash_case(g, 2, 300, 8, 2, D, D, dtype, window=100),
                 dtype, 5)
        for w in sorted({x for e in edges for x in (e - 1, e)}):
            run_case("decode_attention", f"split-W{w}",
                     decode_case(g, B, w, H, Hkv, D, w, dtype), dtype, 10)
        run_case("decode_attention", "empty-splits",
                 decode_case(g, B, W, H, Hkv, D, 100, dtype), dtype, 20)
    # the paged kernel likewise: every table width of the serve batch (8
    # prompts x 4 samples, blocks of 16) up to the serve's 18 blocks where
    # the wrapper's planner changes its split, and one before; the serve's
    # width filled to 40 of 288 slots, so that the later splits hold only
    # blocks with no token
    from repro_torch.kernels.decode_attention.ops import paged_split_plan
    nb_serve = -(-(plen + new - 1) // bs)
    for dtype in (bf, f32):
        plans = [paged_split_plan(B, n * bs, H, Hkv, D, D, dtype,
                                  torch.device("cuda"))
                 for n in range(1, nb_serve + 1)]
        edges = [n for n in range(2, nb_serve + 1)
                 if plans[n - 1] != plans[n - 2]]
        emit("paged-split-edges", dict(dtype=str(dtype).split(".")[-1],
                                       edges={n: plans[n - 1]
                                              for n in edges}))
        for n in sorted({x for e in edges for x in (e - 1, e)}):
            p_len = max(1, n * bs // 2)      # kv length p_len + max_new - 1
            run_case("paged_decode_attention", f"split-nb{n}",
                     paged_case(g, B, H, Hkv, D, bs, p_len, n * bs - p_len + 1,
                                k, n * bs - p_len, dtype), dtype, 10)
        run_case("paged_decode_attention", "empty-splits",
                 paged_case(g, B, H, Hkv, D, bs, 40, plen + new - 40, k, 1,
                            dtype), dtype, 20)
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
        # the split-K kernels' other row tiles: 16 rows (the parity runs
        # decode 16) and the most they take, 64
        for M in (16, 64):
            run_case(name, f"M{M}", dequant_case(g, fmt, M, D_MODEL, D_FF,
                                                 bf), bf, 50)
        if fmt == "int8":
            # K and N not whole 128-row tiles or 128-column strips, in the
            # split-K kernel and in the TMA + wgmma one
            for label, (M, K, N) in (("ragged-split", (32, 4104, 272)),
                                     ("ragged-wgmma", (300, 4096, 4160))):
                run_case(name, label, dequant_case(g, fmt, M, K, N, bf), bf,
                         20)
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
    # gate/up at decode (C = 6) and dense prefill (C = 960); jamba's at
    # decode (C = 5) and prefill (C = 1280); then the reference's
    # kernel-test shapes, ragged in every dim
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
                                 5),
                                ("jamba-decode", (16, 5, 4096, 14336), 20),
                                ("jamba-prefill", (16, 1280, 4096, 14336),
                                 3)):
        run_case("moe_gemm", label, moe_case(g, *shape, bf), bf, iters)
    for dtype in (bf, f32):
        for shape in ((4, 32, 64, 128), (8, 100, 48, 96), (2, 8, 16, 8),
                      (3, 130, 130, 70)):
            run_case("moe_gemm", "ragged", moe_case(g, *shape, dtype), dtype,
                     10)
    # the SSD chunk (B, L, H, P, N, chunk): the mamba2 serve's prefill (the
    # 32 tiled rows of 256 tokens, one chunk), jamba's (128 heads), the
    # mamba2 shape with B and C for every head (one head a block), mamba2
    # heads over four chunks with the last padded by 24, and the
    # reference's kernel-test shapes (the last ragged: H = 3, P = 8)
    for dtype in (bf, f32):
        tag = "main" if dtype == bf else "main-f32"
        r = run_case("ssd_scan", tag,
                     ssd_case(g, B, plen, 32, 64, 128, 256, dtype), dtype, 20)
        main.setdefault("ssd_scan", r)
    run_case("ssd_scan", "jamba", ssd_case(g, B, plen, 128, 64, 128, 256, bf),
             bf, 10)
    run_case("ssd_scan", "per-head-bc",
             ssd_case(g, B, plen, 32, 64, 128, 256, bf, per_head=True), bf, 10)
    run_case("ssd_scan", "4-chunks-padded",
             ssd_case(g, 4, 1000, 32, 64, 128, 256, bf), bf, 10)
    for dtype in (bf, f32):
        for shape in ((2, 32, 2, 16, 16, 8), (1, 64, 4, 32, 64, 16),
                      (2, 24, 3, 8, 16, 8)):
            run_case("ssd_scan", "ragged", ssd_case(g, *shape, dtype), dtype,
                     10)
    assert set(main) == set(KERNELS), (sorted(main), sorted(KERNELS))
    return main


# ----------------------------------------------------------------- serving

def make_prompts(cfg, seed: int, plen: int = SERVE["prompt_len"]):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(plen,)).astype(np.int32)
            for _ in range(SERVE["requests"])]


def check_results(results, cfg, n_samples: int, max_new: int) -> None:
    assert len(results) == SERVE["requests"]
    for r in results:
        assert len(r.samples) == n_samples
        for s, lp in zip(r.samples, r.logprobs):
            assert s.shape == (max_new,), s.shape
            assert s.min() >= 0 and s.max() < cfg.vocab_size, s
            assert math.isfinite(lp) and lp <= 0.0, lp


def paged_kw(model, params, kv_format: str = "bf16") -> dict:
    """Backend arguments of a paged serve of the SERVE requests: a block
    budget that holds all of them at once (one batch)."""
    from repro_torch.serving import ExecutionBackend
    probe = ExecutionBackend(model, params, kv_blocks=1,
                             kv_block_size=SERVE["kv_block_size"])
    return dict(kv_blocks=SERVE["requests"] * probe.request_blocks(
        SERVE["prompt_len"], SERVE["max_new"], SERVE["samples"]),
        kv_block_size=SERVE["kv_block_size"], kv_format=kv_format)


def check_graphs(run: str, stats, new: int) -> None:
    """One batch decoded through one captured graph: one capture, and a
    replay for every decode step after the first."""
    if (stats.captures, stats.replays) != (1, new - 2):
        raise AssertionError(f"{run}: {stats.captures} graph captures and "
                             f"{stats.replays} replays, want 1 and "
                             f"{new - 2}")


def serve_run(model, params, prompts, seed: int, paged: bool,
              kv_format: str = "bf16"):
    """One timed serve run of the SERVE requests, after a warm-up request
    (one decode step: eager, no capture). Returns the launch counts, the
    sampled tokens, the model forwards on the card and the run's
    numbers."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (ExecutionBackend, GumbelNoise,
                                     ServingEngine)
    R, k, new = SERVE["requests"], SERVE["samples"], SERVE["max_new"]
    kw = paged_kw(model, params, kv_format) if paged else {}
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
    stats = backend.graph_stats
    # a capture calls model.forward and runs nothing; a replay is a forward
    fwd = forwards[0] - stats.captures + stats.replays
    tokens = np.stack([s for r in results for s in r.samples])
    n_tok = sum(r.decode_tokens for r in results)
    info = dict(requests=R, samples=k, prompt_len=SERVE["prompt_len"],
                max_new=new, kv_blocks=kw.get("kv_blocks"),
                kv_format=kv_format, tokens=n_tok, seconds=dt,
                tokens_per_s=n_tok / dt, forwards=fwd,
                graph_captures=stats.captures,
                graph_capture_s=stats.capture_s, graph_replays=stats.replays,
                graph_pool_gb=stats.pool_bytes / 1e9,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=counts)
    check_graphs(f"{model.cfg.name} {'paged' if paged else 'dense'} "
                 f"{kv_format} KV", stats, new)
    return counts, tokens, fwd, info


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


def serve_ssm(seed: int) -> dict:
    """Phase 3, SSM: full mamba2-370m, then full-width jamba-v0.1-52b at 16
    layers, dense, bf16, the chatglm traffic. Returns the launch counts of
    each run."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.quant.quantize import param_bytes
    counts = {}
    for arch, (run, layers) in SSM_SERVES.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        model = Model(cfg, dtype=torch.bfloat16, device="cuda",
                      use_kernel=True)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        mixers = [cfg.pattern[i % len(cfg.pattern)]
                  for i in range(cfg.n_layers)]
        n_ssm, n_attn = mixers.count("m"), mixers.count("a")
        n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
        emit("model", dict(arch=cfg.name, layers=cfg.n_layers,
                           full_layers=get_config(arch).n_layers,
                           d_model=cfg.d_model, params=model.param_count(),
                           dtype="bfloat16", init_s=time.perf_counter() - t0,
                           weight_gb=param_bytes(params) / 1e9,
                           mamba_layers=n_ssm, attention_layers=n_attn,
                           moe_layers=n_moe))
        prompts = make_prompts(cfg, seed)
        c, _, fwd, info = serve_run(model, params, prompts, seed,
                                    paged=False)
        counts[run] = c
        emit("serve", dict(arch=cfg.name, mode="dense", weights="bf16",
                           layers=cfg.n_layers, **info))
        # one prefill forward, then decode forwards: the SSD kernel runs at
        # the prefill only, the decode kernel at every decode step
        want = {"ssd_scan": n_ssm, "flash_attention": n_attn,
                "decode_attention": n_attn * (fwd - 1),
                "moe_gemm": 3 * n_moe * fwd}
        for name, n in want.items():
            if c[name] != n:
                raise AssertionError(f"{run}: {name} launched {c[name]} "
                                     f"times over {fwd} forwards, want {n}")
        del params, model
        torch.cuda.empty_cache()
    return counts


def serve_both(cfg, mk, mp, kparams, pparams, prompts, mode: str,
               kv_format: str = "bf16") -> tuple:
    """Greedy serve through the kernel path (``mk``) and the plain path
    (``mp``). Returns (sequences with equal tokens, sequences, the largest
    log-probability difference, the share of equal tokens). For an MoE
    (SSM) arch the kernel path must have run the MoE (SSD) kernel."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ExecutionBackend, ServingEngine
    k, new = 2, 16
    out = {}
    for tag, m, prm in (("kernel", mk, kparams), ("plain", mp, pparams)):
        kw = (dict(kv_blocks=512, kv_block_size=SERVE["kv_block_size"],
                   kv_format=kv_format) if mode == "paged" else {})
        backend = ExecutionBackend(m, prm, **kw)
        eng = ServingEngine(m, prm, max_new_tokens=new, temperature=0.0,
                            backend=backend)
        reset_launch_counts()
        out[tag] = eng.generate(prompts, n_samples=k)
        check_graphs(f"{cfg.name} {mode} {tag} path", backend.graph_stats,
                     new)
        for name, used in (("moe_gemm", cfg.moe is not None),
                           ("ssd_scan", cfg.ssm is not None)):
            if tag == "kernel" and used and launch_counts()[name] < 1:
                raise AssertionError(f"{cfg.name} parity: the kernel path "
                                     f"never launched {name}")
        check_results(out[tag], cfg, k, new)
    pairs = [(a, b) for ra, rb in zip(out["kernel"], out["plain"])
             for a, b in zip(ra.samples, rb.samples)]
    lp_err = max(abs(a - b) for ra, rb in zip(out["kernel"], out["plain"])
                 for a, b in zip(ra.logprobs, rb.logprobs))
    same = np.stack([a == b for a, b in pairs])
    return int(same.all(axis=1).sum()), len(pairs), lp_err, float(same.mean())


def compare_paths(cfg, mk, mp, kparams, pparams, prompts, mode: str,
                  weights: str, kv_format: str = "bf16") -> None:
    """`serve_both` in f32: the same tokens and log-probabilities within
    1e-3, or raise."""
    equal, n, lp_err, _ = serve_both(cfg, mk, mp, kparams, pparams, prompts,
                                     mode, kv_format)
    emit("parity-f32", dict(arch=cfg.name, mode=mode, weights=weights,
                            kv_format=kv_format, layers=cfg.n_layers,
                            prompt_len=len(prompts[0]),
                            sequences=n, tokens_equal=equal,
                            max_logprob_diff=lp_err, tol=1e-3))
    if equal != n or lp_err > 1e-3:
        raise AssertionError(f"f32 parity ({cfg.name} {mode}, {weights} "
                             f"weights, {kv_format} KV): {equal}/{n} "
                             f"sequences equal, logprob diff {lp_err:.3e}")


# graphs against eager decoding, bf16, full width: (arch, mode, weights)
GRAPH_CHECKS = (("chatglm3-6b", "dense", "bf16"),
                ("chatglm3-6b", "paged", "bf16"),
                ("chatglm3-6b", "paged", "int4"),
                ("granite-moe-3b-a800m", "paged", "bf16"),
                ("mamba2-370m", "dense", "bf16"))


def graphs_vs_eager(seed: int) -> None:
    """The serve's traffic and noise, decoded through CUDA graphs and
    eagerly (``cuda_graphs=False``) on the card, bf16, full width at 2
    layers (granite's 2 are MoE layers): the tokens must be identical; the
    largest difference of the mean log-probabilities is printed."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.quant.quantize import quantize_model
    from repro_torch.serving import (ExecutionBackend, GumbelNoise,
                                     ServingEngine)
    k, new = SERVE["samples"], SERVE["max_new"]
    for arch, mode, wfmt in GRAPH_CHECKS:
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        model = Model(cfg, dtype=torch.bfloat16, device="cuda",
                      use_kernel=True)
        params = model.init(torch.Generator(device="cuda").manual_seed(
            seed + 3))
        if wfmt != "bf16":
            params = quantize_model(params, wfmt, 32)
        prompts = make_prompts(cfg, seed + 3)
        kw = paged_kw(model, params) if mode == "paged" else {}
        out, stats = {}, {}
        for graphs in (False, True):
            backend = ExecutionBackend(model, params, cuda_graphs=graphs,
                                       **kw)
            eng = ServingEngine(model, params, max_new_tokens=new,
                                temperature=SERVE["temperature"],
                                backend=backend)
            noise = GumbelNoise(torch.Generator(device="cuda").manual_seed(
                seed))
            out[graphs] = eng.generate(prompts, n_samples=k, noise=noise)
            check_results(out[graphs], cfg, k, new)
            stats[graphs] = backend.graph_stats
        run = f"graphs-vs-eager {cfg.name} {mode} {wfmt}"
        check_graphs(run, stats[True], new)
        if stats[False].captures or stats[False].replays:
            raise AssertionError(f"{run}: the eager backend captured")
        toks = {g: np.stack([s for r in out[g] for s in r.samples])
                for g in out}
        lp_err = max(abs(a - b) for ra, rb in zip(out[True], out[False])
                     for a, b in zip(ra.logprobs, rb.logprobs))
        equal = float((toks[True] == toks[False]).mean())
        emit("graphs-vs-eager", dict(arch=cfg.name, mode=mode, weights=wfmt,
                                     layers=cfg.n_layers,
                                     sequences=toks[True].shape[0],
                                     token_agreement=equal,
                                     max_logprob_diff=lp_err,
                                     graph_replays=stats[True].replays))
        if equal != 1.0:
            raise AssertionError(f"{run}: {equal:.4f} of the tokens equal")
        del params, model
        torch.cuda.empty_cache()


def agreement_bf16(seed: int) -> None:
    """Information, not a gate: `serve_both` in bf16, where the MoE TMA +
    wgmma kernel, the split-K and wgmma dequant kernels and the paged
    kernel's tensor-core path run (phase 4's f32 path runs none of them):
    granite at its 2 MoE layers, dense, and chatglm3-6b at 2 layers in
    int4 and in int8 weights, paged, against the plain path over the
    dequantized weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.quant.quantize import dequantize_model, quantize_model
    for arch, mode, wfmt in (("granite-moe-3b-a800m", "dense", "bf16"),
                             ("chatglm3-6b", "paged", "int4"),
                             ("chatglm3-6b", "paged", "int8")):
        full = get_config(arch)
        n_prefix = full.moe.first_dense if full.moe is not None else 0
        cfg = dataclasses.replace(full, n_layers=n_prefix + 2)
        mk = Model(cfg, dtype=torch.bfloat16, device="cuda", use_kernel=True)
        mp = Model(cfg, dtype=torch.bfloat16, device="cuda",
                   use_kernel=False)
        params = mk.init(torch.Generator(device="cuda").manual_seed(seed + 2))
        kparams = pparams = params
        if wfmt != "bf16":
            kparams = quantize_model(params, wfmt, 32)
            pparams = dequantize_model(kparams, torch.bfloat16)
        prompts = make_prompts(cfg, seed + 2)
        equal, n, lp_err, agree = serve_both(cfg, mk, mp, kparams, pparams,
                                             prompts, mode)
        emit("agreement-bf16", dict(arch=cfg.name, mode=mode, weights=wfmt,
                                    layers=cfg.n_layers, sequences=n,
                                    sequences_equal=equal,
                                    token_agreement=agree,
                                    max_logprob_diff=lp_err))
        del params, kparams, pparams
        torch.cuda.empty_cache()


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
    # the SSM archs, full width, dense, over prompts that cross a chunk:
    # mamba2 at 2 layers, then jamba at one super-block (about 53 GB of f32
    # weights, with nothing else left on the card)
    for arch, layers in SSM_PARITY.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        mk = Model(cfg, dtype=torch.float32, device="cuda", use_kernel=True)
        mp = Model(cfg, dtype=torch.float32, device="cuda", use_kernel=False)
        params = mk.init(torch.Generator(device="cuda").manual_seed(seed + 1))
        prompts = make_prompts(cfg, seed + 1, SSM_PARITY_PROMPT)
        compare_paths(cfg, mk, mp, params, params, prompts, "dense", "f32")
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
    check_sass()

    main_cases = check_kernels(args.seed)
    counts = serve(args.seed)
    counts.update(serve_moe(args.seed))
    counts.update(serve_ssm(args.seed))
    graphs_vs_eager(args.seed)
    agreement_bf16(args.seed)
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
