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
   whose cache slots are all empty, the paged kernel's grouped path at
   granite-moe-3b-a800m.longdoc's batch beside its per-row launch and at
   the backlog's, held to one bf16 rounding of the output (`PAGED_TOL`),
   int8 rows and widths about the split-K
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
   pre-dequantized weight that a quantized layer replaces. Then the
   attention kernels at phase 8's shapes, bf16 and f32: flash at
   musicgen-medium's prefill (32 x 256, 24 heads of 64, one query head a
   kv head) and qwen2-vl-7b's (28 heads over 4 of 128), the dense decode
   kernel at group 1 and group 7, the paged one at group 7 (its
   ``mma.sync`` tile pads the group to 16), and the windowed ring (64
   slots, window 64, mid-decode: wrapped, position p in slot p mod 64).
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
   Then chatglm3-6b in bf16 on the resident prefix pool (512 blocks of 16,
   LRU eviction): two rounds through ``ServingEngine.generate`` of the same
   traffic, every prompt a shared 192-token system prompt (12 blocks) and
   64 tokens of its own, new ones in round 2. The run fails unless round 1
   finds no cached block and round 2 finds 96 (12 a prompt), round 2 saves
   the prefill bytes of all but its 8 x 64 tail tokens, 76 blocks stay
   resident, and the two rounds make one graph capture and 61 replays (the
   second round replays from its first decode step), 1736 paged decode
   launches and no flash launch (a pooled prefill takes the tail path);
   then the same with ``prefill_chunk=64``: the same hits and one capture.
   It prints each round's wall time, tok/s, host ms a decode step and
   capture ms, and the bf16 token agreement of chunked against one-shot
   and of pooled against the per-batch paged serve of the same prompts.
   The launch counts are set to 0 just before each run and read just
   after; a replay adds the launches its graph captured, and a capture,
   which runs nothing, adds none. A forward is a ``model.forward`` call
   that ran on the card: the calls, less the captures, plus the replays. A
   run fails unless every kernel of its path launched, each dequant
   kernel exactly 196 times a forward (7 linear layers x 28), over int8
   pools the paged decode kernel not at all, its grouped path's prefix
   kernel never for chatglm3-6b (too few rows x kv heads) and once a paged
   call for granite-moe-3b-a800m, and the MoE kernel exactly 3 times per
   MoE layer a forward (96 for granite, 78 for deepseek); the SSM serves fail unless the SSD kernel
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
   must give the same tokens and log-probabilities within 1e-3. chatglm3-6b
   on the prefix pool, the pooled serve's prompts in two rounds (cold, then
   warm): the kernel path must equal the plain path (tokens, and
   log-probabilities within 1e-3), the per-batch paged serve (tokens) and
   the chunked serve (``prefill_chunk=64``: tokens, and log-probabilities
   within 1e-3), each with one graph capture for both rounds (the
   per-batch paged round 2 prefills into round 1's cache arena and replays
   its graph from its first decode step). Before
   them, as information and not a gate, the same greedy comparison in
   bf16, where the new tensor-core kernels run: granite at its 2 MoE
   layers (dense) and chatglm3-6b at 2 layers in int4 and in int8 weights
   (paged): the share of equal tokens, the equal sequences and the largest
   log-probability difference.
5. The scheduled stream: the reference's ``launch/serve.py --router``
   path on the card. A PGSAM anneal (v2 energy, 1500 iterations) builds the
   archive for chatglm3-6b, a `ParetoRouter` over one request of 4 samples
   x (256 + 32) tokens gets the scheduling bench's interactive, standard
   and economy tiers (caps off the frontier at batches of 4 and 8), and a
   ``ContinuousBatchingScheduler`` (batches of at most 4 requests, 2 in
   flight, tier preemption on) serves ``benchmarks/serving_schedule.py``'s
   stream shape at the serve's widths: 24 Poisson arrivals at an offered
   load of 1.6 on the router's simulated clock, tiers drawn 0.3 / 0.4 /
   0.3, 4 samples of 32 tokens at temperature 0.8, every prompt the pooled
   serve's shared 192-token system prompt and 64 tokens of its own, and
   CSVET early stops (from a batch's step 2, each request with probability
   0.5 releases samples 1..3). Full-width, full-depth chatglm3-6b in bf16
   serves it on the resident prefix pool (512 blocks of 16, LRU), then on
   per-batch paged caches. The pooled drain fails unless every request
   completes (4 samples of 32 in-vocabulary tokens, none cancelled), its
   batch records, blocks released early, preemptions and graph captures
   and replays equal the CPU rehearsal's (`STREAM_REHEARSAL`: 10 batches
   of 1, 4 and 3 requests at points 0 and 12, 468 pool hit blocks, 3 tier
   preemptions each resumed as a one-request economy batch, 144 blocks
   released early, 3 captures and 208 replays), every batch after the first
   hits the pool, the paged decode kernel launched and flash did not, and
   the allocator ends holding only the pool's resident blocks. The
   per-batch paged drain fails unless every request completes, flash and
   the paged decode kernel launched, no block stays in use, and its graph
   captures and replays equal the rehearsal's (4 and 207: one capture a
   shape, each later batch of a shape taking a retired batch's cache
   arena and graph; one capture a batch gave 7 for its 10 batches), and
   prints its wall beside the walls of one capture a batch. Each
   prints its wall time, tok/s, batches (point, energy, latency, caps),
   preemptions, blocks released early, pool hits, prefill bytes saved,
   graph captures, their ms and replays, and the F8 count (how often a
   block that an early-released row still writes into was held by a later
   batch). Then the stream in f32 at full width, 2 layers, greedy, on the
   pool, without early stops: the kernel path must equal the plain path
   (batch records, tokens, log-probabilities within 1e-3), the preempting
   drain the one that never preempts (each request's tokens,
   log-probabilities within 1e-3), and a drain with ``obs`` on the one
   with it off (bit-equal).
6. Speculative decode (`repro_torch.spec`): full-width, full-depth
   chatglm3-6b in bf16, kernels and CUDA graphs on, the serve's traffic (8
   prompts x 4 samples, prompt 256, 32 new tokens), draft depth 4. Prompt-
   lookup (``ngram``) drafting per-batch paged (224 blocks of 16: the
   speculative slack of 5 slots a sequence costs each request 28 blocks,
   so all 8 fit one batch) at temperature 0.8 and greedy, then phase 3's
   two pooled rounds (512 blocks, LRU), then paged in int4 weights; then
   a draft model (2 layers at chatglm3-6b's widths, weights of its own from
   ``--seed`` + 1) paged at 0.8. Each run fails unless every sample holds
   32 in-vocabulary tokens, no step decodes one token (no decode graph;
   neither decode kernel launched), flash launched 28 times a per-batch
   prefill and never on the pool, one verify graph was captured a shape,
   at the second verify of its first batch, and replayed for every later
   verify (on the pool one graph for both rounds, and round 2 found 96
   blocks cached), and only the pool's resident blocks stay in use; the
   int4 run unless
   ``dequant_matmul_int4`` launched 196 times a forward (its prefill and
   every verify). Each prints its wall, tok/s, verify forwards, tokens
   committed a forward, accept rate, host ms a verify and a ``propose``
   call. Then phase 5's scheduled stream on the pool with a `SpecPlanner`
   (``ngram``, depths 0, 2 and 4): every request completes, and the batch
   records with their draft depths and the graphs' captures and replays
   equal the CPU rehearsal's (`SPEC_STREAM_REHEARSAL`); it prints its wall
   and tok/s beside phase 5's. Then f32 at full width, 2 layers, greedy
   (2 samples, 16 new tokens), dense, per-batch paged and pooled (cold and
   warm), for ``ngram`` and for ``draft`` with the target as its own draft
   (which must accept every draft): the speculative serve must give plain
   greedy decode's tokens and the plain path's speculative serve's, with
   log-probabilities within 1e-3, and the eager verify's
   (``cuda_graphs=False``) tokens, its largest log-probability difference
   printed. Then MoE speculative decode: full-width, full-depth
   granite-moe-3b-a800m in bf16, ngram at depth 4, per-batch paged (224
   blocks), the serve's traffic at temperature 0.8 and greedy, each held
   to the gates above (flash 32 times at the prefill) and to ``moe_gemm``
   launching 96 times a forward (3 per MoE layer: the prefill and every
   verify); then f32 at full width and 2 MoE layers, greedy, dense and
   per-batch paged: the kernel path's speculative serve must equal the
   plain path's (tokens, log-probabilities within 1e-3) and the eager
   verify's (tokens); its agreement with plain greedy decode is printed,
   not gated (an MoE layer's expert capacity depends on the forward's
   token count, so a verify at S = 5 may drop other tokens than one-token
   steps).
7. The calibration loop on the card: `repro_torch.launch.profile` times
   the reference profile's five jobs (f32: flash attention on the scalar
   route, dense decode, the SSD chunk's scalar-FMA route, the tiled int8
   and int4 dequant-matmul), 5 reps each after a warm call, into a
   TraceStore JSONL; `repro_torch.launch.calibrate` fits it (``--trace``)
   and `CalibrationProfile.load` reads the profile; then phase 5's
   chatglm3-6b PGSAM anneal and router run without and with a
   `CalibratedSignalProvider` over it. It fails unless every record ran on
   the card in a positive time, the fit gives exactly the eta keys
   ``flash_attention``, ``decode_attention``, ``ssd_scan``,
   ``dequant_matmul:int8`` and ``dequant_matmul:int4``, and each of the
   five kernels launched reps + 1 times and no other kernel launched. It
   prints each key's mean and roofline us and fitted eta with its
   interval, and the interactive, standard and economy tiers' routed
   points without and with the profile (information: at these launch-bound
   shapes eta sits near its floor of 1e-3, and 1/eta stretches every
   measured stage).
8. The remaining archs, every earlier model freed first: full-width,
   full-depth musicgen-medium (48 layers, 4 EnCodec codebooks, about 1.84
   B parameters) in bf16 with prompts (256, 4) and a conditioning memory
   of 64 rows (random normal x 0.1 from ``--seed``, a request each),
   dense, without and then with ``cross_kv_cache`` (their bf16 token
   agreement printed), then full qwen2-vl-7b (28 layers, vocabulary
   152064, about 7.6 B parameters) with random vision embeddings (4 a
   request) dense, paged (192 blocks of 16) and on the resident prefix
   pool (phase 3's two rounds, 512 blocks, gated as phase 3 gates
   chatglm's). Each dense or paged serve fails unless it made one capture
   and 30 replays and launched flash once a layer and its decode kernel
   once a layer a decode step (musicgen 48 and 1488, qwen2-vl 28 and
   868), the other decode kernel never; each prints its wall, tok/s, host
   ms a decode step, capture ms and peak memory. Then f32 at full width
   and 2 layers, greedy: the kernel path must give the plain path's tokens
   and log-probabilities within 1e-3 for musicgen without and with the
   cross K/V cache (whose tokens must also equal each other's), qwen2-vl
   dense and paged, and chatglm3-6b with a sliding window of 64 (prompt
   256, 32 new tokens: the ring of 64 slots wraps at every step), dense.
9. Training (`repro_torch.training`), every earlier model freed first:
   the launcher's traffic (``launch/train.py``'s defaults: the markov
   corpus, batches of 8 x 64 tokens, AdamW at lr 1e-3 with 5 warmup steps
   and a cosine over the run), 8 steps from random bf16 weights drawn from
   ``--seed``, on the plain path (the hand-written kernels have no
   backward, nor have the reference's): full-width chatglm3-6b cut to 14
   of its 28 layers (3.39 B parameters: bf16 params and gradients and f32
   moments, 12 bytes a parameter, of all 28 layers would fill 75 of the
   card's 80 GB), then full granite-moe-3b-a800m, mamba2-370m and
   musicgen-medium (4 codebooks, a zero conditioning memory of 64 rows, as
   the launcher feeds it), each freed before the next. A run fails unless
   every loss and grad norm is finite, every leaf with a nonzero gradient
   moved at step 1 (a bf16 leaf whose update is below half its spacing,
   the norm scales at 1.0, is reported as held), params, gradients and
   moments are all on the card, the run's 8 batches, scored without a
   gradient, have a lower mean loss after the run than before it, and no
   port kernel launched. Each prints its step ms (the median of steps 2-8,
   synchronised) and the update's share, tok/s, peak memory, and its first
   and last loss. Then f32 at full width and 2 layers (granite: 2 MoE
   layers), one markov batch of 2 x 32 through the port on the card and on
   the CPU with the same weights: the loss within 1e-4 relative, each
   gradient leaf within 1e-3 x max|g_cpu| + 1e-6, and an AdamW update fed
   the CPU's gradients within 1e-6 of the CPU's. Then f32 chatglm3-6b at
   full width and 2 layers: ``microbatches=4`` equals 1 (loss within 1e-5
   relative, params within 2e-4), ``remat=True`` equals False (loss within
   1e-6, gradients within 1e-5), 4 steps, a checkpoint and its restore and
   4 more equal 8 uninterrupted steps (params within 1e-5), and a bf16
   checkpoint restores bit-equal; no port kernel may launch there either.
   Last, ``python -m repro_torch.launch.train --arch mamba2-370m --steps
   3`` runs as a subprocess on the card: it must exit 0, print its step
   lines and write a checkpoint that `restore_checkpoint` reads.
10. The distributed slice (`repro_torch.distributed`, `launch/mesh.py`,
   `launch/specs.py`, `launch/dryrun.py`), every earlier model freed
   first. The card is one, so no multi-rank exchange runs here: the sharded
   path runs at full width over a world-1 NCCL group (127.0.0.1, a free
   port) on ``make_debug_mesh(1, 1)``, every leaf a DTensor in the
   `ShardingPolicy`'s placements, the step's tensor-parallel compute
   (`repro_torch.distributed.tp`) over one-rank groups. f32 parity:
   full-width granite-moe-3b-a800m, chatglm3-6b, deepseek-v2-lite-16b,
   mamba2-370m and musicgen-medium (a random conditioning memory) at 2
   layers, three sharded steps (`make_sharded_train_step`) against three
   unsharded ones (`make_train_step`) on the same weights and phase 9's
   markov batches (granite at phase 9's lr, the others at 1e-4: chatglm's
   key bias's gradient is rounding noise, which Adam moves by up to the
   lr): each loss within 1e-5 relative, the params within 1e-5 after the
   three steps, and every param and moment a DTensor on the card in the
   policy's placements (the step counter replicated). Deepseek, mamba2 and
   musicgen (with its cross K/V cache) then run a sharded prefill of 4 x
   32 tokens and a decode step (`make_sharded_forward`) against the
   unsharded forward: logits and cache within 1e-5, the cache in the
   policy's placements. Then phase 9's granite run (full depth, bf16,
   8 steps of 8 x 64 tokens) sharded, held to phase 9's gates (finite,
   every leaf with a gradient moved or held by bf16 spacing, a lower mean
   loss over the run's batches, no port kernel launched); it prints its
   step ms and peak GB beside phase 9's unsharded granite, and fails if
   its peak is more than 1.5 GB above phase 9's. Then ``python -m
   repro_torch.launch.train --arch mamba2-370m --smoke --steps 3 --mesh
   debug`` as a subprocess: it must exit non-zero naming 4 ranks and 1
   card. Last, the dry-run on the host only (meta tensors under the fake
   process group, no card): ``python -m repro_torch.launch.dryrun`` for
   each arch and mesh kind (20 subprocesses, 8 at a time: the 80 pairs take
   about 780 s of one CPU core) into a temporary folder; it fails unless
   there are 80 artifacts, none with ``error``, each with ``flops > 0`` and
   ``n_chips`` 256 (single) or 512 (multi), and the train_4k artifacts of
   qwen2-72b, yi-34b, deepseek-coder-33b and chatglm3-6b on both meshes
   show at most 2x the ideal ``6 * N * tokens / n_chips`` FLOPs (N the
   active params), those of deepseek-v2-lite-16b, jamba-v0.1-52b and
   musicgen-medium at most 2.5x and mamba2-370m's 3x, and all hold under
   80 GB by their own accounting; each is printed beside the figures
   before MLA, Mamba-2 and cross-attention computed on their shards. It
   prints the phase's wall.
11. Print the script's wall time (the build included), the ``kernels``
   JSON line (its ``launches_by_run`` holds phases 9 and 10's runs, all 0),
   the card again, and as the last line ``{"ok": true, "device": {...}}``.

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
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# (atol, rtol) of the paged kernel's longdoc, backlog and grouped cases,
# whose outputs are averages over hundreds to thousands of slots (about
# 0.03-0.1 in size): one bf16 rounding of the output is up to 7.8e-3 of the
# value, and f32 read 1.7e-7 on an H100
PAGED_TOL = {torch.bfloat16: (5e-4, 8e-3), torch.float32: (1e-6, 1e-5)}
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
# the pooled serve: one resident cache of 512 blocks of 16 tokens; every
# prompt is a shared system prompt of 192 tokens (12 blocks) and 64 tokens
# of its own; two rounds, the second with new suffixes
POOL = dict(kv_blocks=512, kv_block_size=16, system_len=192, rounds=2)
# the scheduled stream (phase 5): benchmarks/serving_schedule.py's stream at
# the serve's widths: Poisson arrivals at an offered load of 1.6, tiers
# drawn 0.3 / 0.4 / 0.3, every prompt the pooled serve's shared system
# prompt and 64 tokens of its own; a scheduler of batches of at most 4
# requests, 2 in flight, that preempts; CSVET early stops from step 2 with
# probability 0.5
STREAM = dict(requests=24, offered_load=1.6, samples=4, max_new=32,
              temperature=0.8, max_batch=4, inflight=2)
# what the CPU rehearsal of phase 5's bf16 drains gave (a small f32 model
# of chatglm3-6b's vocabulary, the capture stand-in of
# .claude/skills/verify/SKILL.md; tests/test_torch_graph_arena.py reruns
# it): per batch of the pooled drain its request ids, tier counts
# (interactive, standard, economy), point index, pool hit blocks and
# preemption; its blocks released early, its preemptions and its graph
# captures and replays; and the per-batch paged drain's graph captures and
# replays, one capture a shape (its 10 batches made 7 before the cache
# arenas)
STREAM_REHEARSAL = dict(
    records=[[[0], [0, 0, 1], 0, 0, "tier"],
             [[1, 2, 3, 4], [0, 3, 1], 12, 48, None],
             [[0], [0, 0, 1], 0, 64, "tier"],
             [[5, 6, 7, 8], [2, 1, 1], 12, 48, None],
             [[0], [0, 0, 1], 0, 64, "tier"],
             [[9, 10, 11, 12], [3, 1, 0], 12, 48, None],
             [[0], [0, 0, 1], 0, 64, None],
             [[13, 14, 15, 16], [1, 2, 1], 12, 48, None],
             [[17, 18, 19, 20], [3, 1, 0], 12, 48, None],
             [[21, 22, 23], [0, 2, 1], 12, 36, None]],
    released=144, preemptions={"tier": 3}, graphs=[3, 208],
    paged_graphs=[4, 207])
# phase 6, speculative decode: the draft depth of every speculating serve,
# the depths the scheduled drain's planner prices, the layers of the draft
# model of the draft run
SPEC = dict(n=4, depths=(0, 2, 4), draft_layers=2)
# what the CPU rehearsal of phase 6's scheduled drain gave (as
# STREAM_REHEARSAL): per batch its request ids,
# tier counts, point index, pool hit blocks, preemption and draft depth;
# the decode and the verify graphs' captures and replays; and, not gated
# (a draft that a row of the card's bf16 model accepts changes them), the
# drafts proposed and accepted
SPEC_STREAM_REHEARSAL = dict(
    records=[[[0], [0, 0, 1], 0, 0, "tier", 4],
             [[1, 2, 3, 4], [0, 3, 1], 13, 48, None, 4],
             [[0], [0, 0, 1], 0, 64, "tier", 4],
             [[5, 6, 7], [1, 1, 1], 13, 36, None, 4],
             [[0], [0, 0, 1], 0, 64, "tier", 4],
             [[8, 9], [2, 0, 0], 13, 24, None, 4],
             [[0], [0, 0, 1], 0, 64, "tier", 4],
             [[10, 11, 12, 13], [2, 1, 1], 13, 48, None, 4],
             [[0], [0, 0, 1], 0, 64, None, 4],
             [[14, 15, 16, 17], [2, 2, 0], 13, 48, None, 4],
             [[18, 19, 20, 21], [2, 2, 0], 13, 48, None, 4],
             [[22], [0, 0, 1], 0, 12, "tier", 4],
             [[23], [0, 1, 0], 12, 12, None, 4],
             [[22], [0, 0, 1], 0, 64, None, 4]],
    graphs=[0, 0], verify_graphs=[4, 266], proposed=11744, accepted=0)
# phase 6's MoE speculating serves: the arch, and the MoE layers of its f32
# parity run
SPEC_MOE = dict(arch="granite-moe-3b-a800m", parity_layers=2)
# phase 7, the calibration loop: timed reps a profiled kernel (after one warm
# call each), the bootstrap resamples of the fit, and the eta keys it must
# fit
CALIBRATION = dict(reps=5, bootstrap=200,
                   eta_keys=("decode_attention", "dequant_matmul:int4",
                             "dequant_matmul:int8", "flash_attention",
                             "ssd_scan"),
                   kernels=("flash_attention", "decode_attention",
                            "ssd_scan", "dequant_matmul_int8",
                            "dequant_matmul_int4"))
# the f32 parity of the SSM archs: layers, and a prompt length that crosses
# a 256-row chunk and pads a tail
SSM_PARITY = {"mamba2-370m": 2, "jamba-v0.1-52b": 8}
SSM_PARITY_PROMPT = 300
# phase 8, the remaining archs: the bf16 serves (run name -> arch, modes,
# cross K/V cache), and the f32 parity's layers and the windowed
# chatglm3-6b's ring of 64 slots (a 256-token prompt wraps it at every
# decode step)
ARCH_SERVES = {"musicgen-dense": ("musicgen-medium", "dense", False),
               "musicgen-dense-xkv": ("musicgen-medium", "dense", True),
               "qwen2-vl-dense": ("qwen2-vl-7b", "dense", False),
               "qwen2-vl-paged": ("qwen2-vl-7b", "paged", False)}
ARCH_PARITY = dict(layers=2, window=64)
# phase 9, training: the launcher's defaults (markov corpus, batch 8 x 64
# tokens, lr 1e-3, 5 warmup steps, a cosine over the run's 8 steps); the
# bf16 runs (run name -> arch, layers: chatglm3-6b cut to 14 of its 28, as
# bf16 params and gradients and f32 moments, 12 bytes a parameter, of all
# 28 layers fill 75 of the card's 80 GB); the f32 checks' layers and batch
TRAIN = dict(batch=8, seq=64, lr=1e-3, warmup=5, steps=8)
TRAIN_RUNS = {"train-chatglm3-6b-14": ("chatglm3-6b", 14),
              "train-granite": ("granite-moe-3b-a800m", None),
              "train-mamba2": ("mamba2-370m", None),
              "train-musicgen": ("musicgen-medium", None)}
TRAIN_F32 = dict(layers=2, parity_batch=2, parity_seq=32)
# phase 10, the distributed slice: the arch of the sharded bf16 run (phase
# 9's, whose peak may exceed phase 9's by at most ``peak_over_gb``), the
# archs of the f32 parity at TRAIN_F32's 2 layers with their learning rates
# (chatglm's key bias has a gradient of rounding noise, which Adam moves by
# up to the lr whichever way it rounds: 1e-4 keeps that below the 1e-5
# gate), the archs of the sharded prefill and decode and their gate, the
# parity's steps, the dry-run's concurrent subprocesses (one per arch and
# mesh kind), and the archs whose train_4k artifacts must fit a card
# (``held_bytes`` under ``fit_gb``) with their bounds on ``flops_per_6NT``
# and, printed beside the dry-run's figures, the tree's figures before
# MLA, Mamba-2 and cross-attention computed on their shards
# (``flops_per_6NT`` over the active params, held GB single / multi; the
# dense four's from the dry-run's artifacts of the same tree)
DIST = dict(arch="granite-moe-3b-a800m", peak_over_gb=1.5,
            parity={"granite-moe-3b-a800m": TRAIN["lr"], "chatglm3-6b": 1e-4,
                    "deepseek-v2-lite-16b": 1e-4, "mamba2-370m": 1e-4,
                    "musicgen-medium": 1e-4},
            forward=("deepseek-v2-lite-16b", "mamba2-370m",
                     "musicgen-medium"), forward_tol=1e-5,
            parity_steps=3, dryrun_jobs=8, fit_gb=80.0,
            fit={"qwen2-72b": (2.0, (1.339, 25.11, 14.35)),
                 "yi-34b": (2.0, (1.343, 15.85, 8.77)),
                 "deepseek-coder-33b": (2.0, (1.361, 14.81, 8.21)),
                 "chatglm3-6b": (2.0, (1.467, 9.12, 4.73)),
                 "deepseek-v2-lite-16b": (2.5, (15.3, 69.6, 35.2)),
                 "jamba-v0.1-52b": (2.5, (10.9, 593.1, 294.2)),
                 "mamba2-370m": (3.0, (22.81, 21.7, 10.8)),
                 "musicgen-medium": (2.5, (3.863, 3.8, 1.9))})


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
               ("decode_attention", "paged_decode_attention_prefix_kernel",
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
    elif D == Dv:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        case["library"] = lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    return case


def decode_case(g, B, W, H, Hkv, D, filled, dtype, empty_row=False,
                window=None):
    """Positions 0 .. ``filled - 1`` written as the dense cache writes
    them, position p into slot p mod W (with ``filled > W`` the ring has
    wrapped: slot i holds the latest such p); the query at ``filled - 1``."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention_cache
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    q = randn(g, (B, 1, H, D), dtype)
    kc, vc = randn(g, (B, W, Hkv, D), dtype), randn(g, (B, W, Hkv, D), dtype)
    slot = torch.arange(W, dtype=torch.int32, device="cuda")
    latest = slot + (filled - 1 - slot).div(W, rounding_mode="floor") * W
    pos = torch.where(slot < filled, latest, -1).expand(B, W).contiguous()
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
    if not empty_row:
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


def paged_grouped_case(g, B, H, Hkv, D, bs, plen, max_new, samples, step,
                       dtype):
    """`paged_case` with the layout's group descriptor: the grouped path
    (the prefix kernel over the shared prompt blocks, then the per-row
    kernel over the tails), its route the per-row split and the prefix
    kernel's grid, splits and row tiles; held to `PAGED_TOL`."""
    from repro_torch.kernels.decode_attention.ops import (
        paged_decode_attention, paged_decode_attention_prefix, prefix_plan)
    from repro_torch.kernels.decode_attention.split import (
        group_prefix_splits, groups_engage, groups_taken, min_shared_blocks,
        prefix_groups, prefix_split_count, row_tiles)
    case = paged_case(g, B, H, Hkv, D, bs, plen, max_new, samples, step,
                      dtype)
    groups_np = prefix_groups([samples] * (B // samples), plen // bs)
    nb = case["args"][4].shape[1]
    assert groups_engage(H // Hkv, nb * bs, B * Hkv)
    assert (groups_taken(groups_np, min_shared_blocks(H // Hkv, bs))[:, 1]
            > 0).all()
    groups = torch.as_tensor(groups_np, device="cuda")

    def grouped(*args):
        return paged_decode_attention(*args, prefix_groups=groups)

    def route(*args):
        n0 = paged_decode_attention_prefix.launches
        grouped(*args)
        if paged_decode_attention_prefix.launches != n0 + 1:
            raise AssertionError("the grouped call launched no prefix "
                                 "kernel")
        r = paged_route(*args)
        grid, p_cap = prefix_plan(B, r["n_split"], D, D, dtype,
                                  torch.device("cuda"))
        tiles = len(row_tiles(groups_np, H // Hkv))
        n_ps = prefix_split_count(tiles, Hkv, grid, p_cap)
        return dict(r, prefix_grid=grid, row_tiles=tiles,
                    prefix_splits=group_prefix_splits(n_ps, plen // bs * bs))
    case.update(kernel=grouped, route=route, tol=PAGED_TOL[dtype],
                shape=dict(case["shape"], groups=B // samples))
    return case


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
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    errs = [(o.float() - r.float()).abs() for o, r in zip(outs, refs)]
    err = torch.cat([e.flatten() for e in errs])
    ok = all(bool(torch.isfinite(o.float()).all())
             and bool((e <= atol + rtol * r.float().abs()).all())
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
    # granite-moe-3b-a800m.longdoc's paged decode: 160 rows, 8 prompts of
    # 3840 tokens x 20 samples, 4096 slots a row, half the new tokens
    # decoded; per row (one launch a call) and grouped (two: the prefix
    # kernel, then the tails), bf16 and f32
    for dtype in (bf, f32):
        tag = "" if dtype == bf else "-f32"
        args = (g, 160, 24, 8, 64, 16, 3840, 256, 20, 128, dtype)
        run_case("paged_decode_attention", f"longdoc-per-row{tag}",
                 dict(paged_case(*args), tol=PAGED_TOL[dtype]), dtype, 10)
        run_case("paged_decode_attention", f"longdoc-grouped{tag}",
                 paged_grouped_case(*args), dtype, 20)
    # granite's backlog batch (8 prompts of 128 x 20 samples), and
    # chatglm3-6b's group of 16 (four rows a row tile) at a 1024-token
    # prompt, the shortest that planner groups is 512
    run_case("paged_decode_attention", "backlog-grouped",
             paged_grouped_case(g, 160, 24, 8, 64, 16, 128, 256, 20, 128,
                                bf), bf, 50)
    run_case("paged_decode_attention", "p1024-grouped",
             paged_grouped_case(g, 160, H, Hkv, D, 16, 1024, 256, 20, 128,
                                bf), bf, 50)
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
    check_arch_kernels(g)
    # the grouped path's prefix kernel runs inside the paged wrapper's
    # grouped cases: a launch count of its own, no main case
    assert set(main) | {"paged_decode_attention_prefix"} == set(KERNELS), \
        (sorted(main), sorted(KERNELS))
    return main


def check_arch_kernels(g) -> None:
    """Phase 2 at the shapes phase 8's serves give the attention kernels
    (32 rows, prompt 256, mid-decode): musicgen-medium's prefill and dense
    decode (24 heads of 64, one query head a kv head) and qwen2-vl-7b's
    prefill, dense and paged decode (28 heads over 4 of 128: group 7, which
    the paged kernel's ``mma.sync`` tile pads to 16); and the windowed
    chatglm3-6b's ring of 64 slots (window 64) mid-decode, wrapped as its
    dense cache lays it out: position p in slot p mod 64."""
    bf, f32 = torch.bfloat16, torch.float32
    R, k, plen, new = (SERVE["requests"], SERVE["samples"],
                       SERVE["prompt_len"], SERVE["max_new"])
    B, W, bs = R * k, plen + new, SERVE["kv_block_size"]
    step = new // 2
    for dtype in (bf, f32):
        for label, (H, Hkv, D) in (("musicgen", (24, 24, 64)),
                                   ("qwen2-vl", (28, 4, 128))):
            run_case("flash_attention", label,
                     flash_case(g, B, plen, H, Hkv, D, D, dtype), dtype, 20)
            run_case("decode_attention", f"{label}-g{H // Hkv}",
                     decode_case(g, B, W, H, Hkv, D, plen + step, dtype),
                     dtype, 50)
        run_case("paged_decode_attention", "qwen2-vl-g7",
                 paged_case(g, B, 28, 4, 128, bs, plen, new, k, step, dtype),
                 dtype, 50)
        run_case("decode_attention", "window-ring",
                 decode_case(g, B, ARCH_PARITY["window"], 32, 2, 128,
                             plen + step, dtype,
                             window=ARCH_PARITY["window"]), dtype, 50)


# ----------------------------------------------------------------- serving

def make_prompts(cfg, seed: int, plen: int = SERVE["prompt_len"]):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(plen,)).astype(np.int32)
            for _ in range(SERVE["requests"])]


def check_results(results, cfg, n_samples: int, max_new: int) -> None:
    assert len(results) == SERVE["requests"]
    # (max_new, K) with K codebooks
    want = (max_new,) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    for r in results:
        assert len(r.samples) == n_samples
        for s, lp in zip(r.samples, r.logprobs):
            assert s.shape == want, s.shape
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
              kv_format: str = "bf16", extras: Optional[dict] = None):
    """One timed serve run of the SERVE requests, after a warm-up request
    (one decode step: eager, no capture). ``extras`` are the requests'
    frontend inputs, a row a prompt. Returns the launch counts, the sampled
    tokens, the model forwards on the card and the run's numbers, the
    host's mean ms a decode step (the tracer's ``decode`` spans) among
    them."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import make_observability
    from repro_torch.serving import (ExecutionBackend, GumbelNoise,
                                     ServingEngine)
    R, k, new = SERVE["requests"], SERVE["samples"], SERVE["max_new"]
    extras = extras or {}
    kw = paged_kw(model, params, kv_format) if paged else {}
    backend = ExecutionBackend(model, params, **kw)
    engine = ServingEngine(model, params, max_new_tokens=new,
                           temperature=SERVE["temperature"], backend=backend)
    engine.generate(prompts[:1], n_samples=1, max_new_tokens=2,  # warm-up
                    extras={name: v[:1] for name, v in extras.items()})
    obs = make_observability()
    backend.set_obs(obs)
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
        results = engine.generate(prompts, n_samples=k, noise=noise,
                                  extras=extras)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        del model.forward
        backend.set_obs(None)
    check_results(results, model.cfg, k, new)
    stats = backend.graph_stats
    # a capture calls model.forward and runs nothing (twice with tracing on:
    # the graph and its timed copy); a replay is a forward
    fwd = (forwards[0] - stats.captures * (2 if obs.tracer.enabled else 1)
           + stats.replays)
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
                decode_step_ms=1e3 * np.mean([
                    sp.t1_s - sp.t0_s for sp in obs.tracer.spans
                    if sp.name == "decode"]),
                launches=counts)
    check_graphs(f"{model.cfg.name} {'paged' if paged else 'dense'} "
                 f"{kv_format} KV", stats, new)
    return counts, tokens, fwd, info


def pooled_rounds(cfg, seed: int) -> list:
    """The pooled serve's prompts, drawn from ``seed``: each round
    SERVE["requests"] prompts of one shared system prompt and a suffix of
    their own, new suffixes each round."""
    rng = np.random.default_rng(seed)
    plen, head = SERVE["prompt_len"], POOL["system_len"]
    system = rng.integers(0, cfg.vocab_size, head).astype(np.int32)
    return [[np.concatenate([system, rng.integers(
        0, cfg.vocab_size, plen - head).astype(np.int32)])
        for _ in range(SERVE["requests"])] for _ in range(POOL["rounds"])]


def serve_rounds(model, params, rounds, seed: int, backend_kw: dict, k: int,
                 new: int, temperature: float,
                 extras: Optional[dict] = None):
    """Serve each round of prompts through one ``ServingEngine.generate``,
    all rounds over one backend built with ``backend_kw`` (round r on
    Gumbel noise seeded ``seed + r``; ``extras`` are each round's frontend
    inputs, a row a prompt). Returns the backend and, per round,
    the results, the sampled tokens, the batch handles the round started,
    its wall seconds and tok/s, the host's mean ms a decode step (the
    tracer's ``decode`` spans), its prefill spans' ms (``start_batch``,
    and each chunked slice, through the first token's copy to the host),
    the host's ms in the tail prefill forwards, and its graph captures,
    their ms and its replays; speculating (``spec_policy`` in
    ``backend_kw``), also the host's mean ms a verify and a ``propose``
    call (the ``verify`` and ``draft`` spans) and its verify graphs'
    captures and replays."""
    from repro_torch.obs import make_observability
    from repro_torch.serving import (ExecutionBackend, GumbelNoise,
                                     ServingEngine)
    backend = ExecutionBackend(model, params, **backend_kw)
    engine = ServingEngine(model, params, max_new_tokens=new,
                           temperature=temperature, backend=backend)
    handles = []
    start = backend.start_batch

    def recorded(*a, **kw):
        handles.append(start(*a, **kw))
        return handles[-1]

    backend.start_batch = recorded
    # the host's time in the tail prefill's forwards (their enqueue: no
    # synchronisation inside), to weigh capturing them too
    tail_s = []
    tail = backend._tail_prefill

    def timed(*a, **kw):
        t = time.perf_counter()
        logits = tail(*a, **kw)
        tail_s.append(time.perf_counter() - t)
        return logits

    backend._tail_prefill = timed
    out = []
    for r, prompts in enumerate(rounds):
        tail_s.clear()
        obs = make_observability()
        backend.set_obs(obs)
        before = dataclasses.replace(backend.graph_stats)
        n0 = len(handles)
        noise = GumbelNoise(torch.Generator(device="cuda").manual_seed(
            seed + r))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.generate(prompts, n_samples=k, noise=noise,
                                  extras=extras)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        backend.set_obs(None)
        check_results(results, model.cfg, k, new)
        spans = {name: [sp.t1_s - sp.t0_s for sp in obs.tracer.spans
                        if sp.name == name]
                 for name in ("decode", "prefill", "verify", "draft")}
        steps, prefill = spans["decode"], spans["prefill"]
        st = backend.graph_stats
        n_tok = sum(res.decode_tokens for res in results)
        out.append(dict(
            results=results, handles=handles[n0:],
            tokens=np.stack([smp for res in results for smp in res.samples]),
            seconds=dt, tokens_per_s=n_tok / dt,
            decode_step_ms=1e3 * sum(steps) / len(steps),
            prefill_span_ms=1e3 * sum(prefill),
            tail_prefill_host_ms=1e3 * sum(tail_s),
            graph_captures=st.captures - before.captures,
            graph_capture_ms=1e3 * (st.capture_s - before.capture_s),
            graph_replays=st.replays - before.replays,
            verify_ms=(1e3 * sum(spans["verify"]) / len(spans["verify"])
                       if spans["verify"] else None),
            propose_ms=(1e3 * sum(spans["draft"]) / len(spans["draft"])
                        if spans["draft"] else None),
            verify_captures=st.verify_captures - before.verify_captures,
            verify_replays=st.verify_replays - before.verify_replays))
    del backend.start_batch, backend._tail_prefill    # the class's again
    return out, backend


def pooled_run(model, params, rounds, seed: int, run: str,
               chunk: Optional[int], extras: Optional[dict] = None):
    """Phase 3's two rounds on a resident prefix pool of their own (one-shot,
    or chunked with ``prefill_chunk=chunk``), gated: round 1 finds no cached
    block and round 2 the shared system prompt's blocks of every prompt,
    round 2 saves the prefill bytes of all but its tail tokens, the pool
    keeps the rounds' chains resident and nothing else, one graph capture
    and a replay for every other decode step, the paged decode kernel at
    every decode step and no flash launch. Returns the launch counts and
    each round's tokens."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    cfg = model.cfg
    k, new, R = SERVE["samples"], SERVE["max_new"], SERVE["requests"]
    plen, bs = SERVE["prompt_len"], POOL["kv_block_size"]
    pooled = dict(kv_blocks=POOL["kv_blocks"], kv_block_size=bs,
                  kv_pool=True, pool_evict="lru", prefill_chunk=chunk)
    system_blocks = POOL["system_len"] // bs
    suffix = plen - POOL["system_len"]
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    info, backend = serve_rounds(model, params, rounds, seed, pooled, k, new,
                                 SERVE["temperature"], extras)
    c = launch_counts()
    ktb = backend.kv_token_bytes
    for r, i in enumerate(info):
        hits = sum(h.pool_hit_blocks for h in i["handles"])
        saved = sum(h.prefill_bytes_saved for h in i["handles"])
        emit("serve-pooled", dict(
            run=run, arch=cfg.name, round=r + 1, prefill_chunk=chunk,
            batches=len(i["handles"]), pool_hit_blocks=hits,
            prefill_bytes_saved=saved,
            **{key: i[key] for key in (
                "seconds", "tokens_per_s", "decode_step_ms",
                "prefill_span_ms", "tail_prefill_host_ms",
                "graph_captures", "graph_capture_ms",
                "graph_replays")}))
        want = 0 if r == 0 else R * system_blocks
        if hits != want:
            raise AssertionError(f"{run} round {r + 1}: {hits} blocks "
                                 f"found in the pool, want {want}")
        if r == 1 and saved != (R * k * plen - R * suffix) * ktb:
            raise AssertionError(f"{run} round 2 saved {saved} prefill "
                                 "bytes, want the bytes of all but its "
                                 f"{R} x {suffix} tail tokens")
    resident = backend.prefix_pool.blocks_resident
    # round 1: one system chain + every suffix chain; round 2: its own
    # suffix chains
    want_resident = system_blocks + 2 * R * (plen // bs - system_blocks)
    stats = backend.graph_stats
    emit("serve-pooled", dict(
        run=run, arch=cfg.name, kv_blocks=POOL["kv_blocks"],
        kv_token_bytes=ktb, pool_gb=POOL["kv_blocks"] * bs * ktb / 1e9,
        blocks_in_use=backend.blocks_in_use, blocks_resident=resident,
        graph_captures=stats.captures, graph_replays=stats.replays,
        graph_pool_gb=stats.pool_bytes / 1e9,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=c))
    if backend.blocks_in_use != resident or resident != want_resident:
        raise AssertionError(f"{run}: {backend.blocks_in_use} blocks in "
                             f"use and {resident} resident, want "
                             f"{want_resident} each")
    if (stats.captures, stats.replays) != (1, 2 * (new - 1) - 1):
        raise AssertionError(f"{run}: {stats.captures} graph captures "
                             f"and {stats.replays} replays, want 1 and "
                             f"{2 * (new - 1) - 1}")
    want = {"paged_decode_attention": cfg.n_layers * 2 * (new - 1),
            "flash_attention": 0}
    for name, n in want.items():
        if c[name] != n:
            raise AssertionError(f"{run}: {name} launched {c[name]} "
                                 f"times, want {n}")
    return c, [i["tokens"] for i in info]


def warm_pool(model, params, rounds, extras: Optional[dict] = None) -> None:
    """Kernels and cuBLAS warm before the timed rounds: a prompt shorter
    than a block caches nothing in the trie."""
    from repro_torch.serving import ExecutionBackend, ServingEngine
    bs = POOL["kv_block_size"]
    warm = ExecutionBackend(model, params, kv_blocks=POOL["kv_blocks"],
                            kv_block_size=bs, kv_pool=True)
    ServingEngine(model, params, backend=warm).generate(
        [rounds[0][0][:bs - 1]], n_samples=1, max_new_tokens=2,
        extras={name: v[:1] for name, v in (extras or {}).items()})
    if warm.prefix_pool.blocks_resident:
        raise AssertionError("the warm-up cached a block")


def serve_pooled(model, params, seed: int) -> dict:
    """Phase 3, the resident prefix pool: full chatglm3-6b in bf16, two
    rounds one-shot and two chunked (``prefill_chunk=64``), each pair on a
    pool of its own (`pooled_run`); then the per-batch paged serve of the
    same rounds, for the token agreement. Returns the launch counts of each
    pooled run."""
    k, new = SERVE["samples"], SERVE["max_new"]
    rounds = pooled_rounds(model.cfg, seed)
    warm_pool(model, params, rounds)
    counts, tokens = {}, {}
    for run, chunk in (("chatglm-pooled", None),
                       ("chatglm-pooled-chunked", 64)):
        counts[run], tokens[run] = pooled_run(model, params, rounds, seed,
                                              run, chunk)
    paged, _ = serve_rounds(model, params, rounds, seed,
                            dict(kv_blocks=POOL["kv_blocks"],
                                 kv_block_size=POOL["kv_block_size"]),
                            k, new, SERVE["temperature"])
    # information, not a gate: bf16 sums the pooled tail prefill, the
    # chunked slices and the per-batch flash prefill in other orders
    emit("serve-agreement", dict(
        pooled_vs_paged_token_match=[
            float((a == b["tokens"]).mean())
            for a, b in zip(tokens["chatglm-pooled"], paged)],
        chunked_vs_one_shot_token_match=[
            float((a == b).mean()) for a, b in zip(
                tokens["chatglm-pooled-chunked"], tokens["chatglm-pooled"])]))
    torch.cuda.empty_cache()
    return counts


def serve(seed: int) -> dict:
    """Phase 3: full chatglm3-6b, dense then paged in bf16, then on the
    resident prefix pool (`serve_pooled`), then paged with int8, int4 and
    int4 + int8-KV weights quantized on the card. Returns the launch counts
    of each run."""
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
        # chatglm3-6b's 32 rows x 2 kv heads are too few (row, kv head)
        # pairs for the paged kernel's grouped path
        if counts[mode]["paged_decode_attention_prefix"]:
            raise AssertionError(
                f"{mode} serving launched paged_decode_attention_prefix "
                f"{counts[mode]['paged_decode_attention_prefix']} times")
    emit("serve-agreement", dict(
        dense_vs_paged_token_match=float((tokens["dense"]
                                          == tokens["paged"]).mean())))
    counts.update(serve_pooled(model, params, seed))

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
            # granite's 32 rows x 8 kv heads, 16 prompt blocks shared by 4
            # samples: every paged decode call takes the grouped path
            if mode == "paged" and c["paged_decode_attention_prefix"] != \
                    c["paged_decode_attention"]:
                raise AssertionError(
                    f"{run}: paged_decode_attention_prefix launched "
                    f"{c['paged_decode_attention_prefix']} times, want one "
                    f"a paged call ({c['paged_decode_attention']})")
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
               kv_format: str = "bf16", extras: Optional[dict] = None,
               new: int = 16) -> tuple:
    """Greedy serve (2 samples of ``new`` tokens) through the kernel path
    (``mk``) and the plain path (``mp``), with the frontend inputs
    ``extras``. Returns (sequences with equal tokens, sequences, the
    largest log-probability difference, the share of equal tokens, the
    kernel path's results). For an MoE (SSM) arch the kernel path must have
    run the MoE (SSD) kernel."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ExecutionBackend, ServingEngine
    k = 2
    out = {}
    for tag, m, prm in (("kernel", mk, kparams), ("plain", mp, pparams)):
        kw = (dict(kv_blocks=512, kv_block_size=SERVE["kv_block_size"],
                   kv_format=kv_format) if mode == "paged" else {})
        backend = ExecutionBackend(m, prm, **kw)
        eng = ServingEngine(m, prm, max_new_tokens=new, temperature=0.0,
                            backend=backend)
        reset_launch_counts()
        out[tag] = eng.generate(prompts, n_samples=k, extras=extras)
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
    same = np.stack([(a == b).reshape(-1) for a, b in pairs])
    return (int(same.all(axis=1).sum()), len(pairs), lp_err,
            float(same.mean()), out["kernel"])


def compare_paths(cfg, mk, mp, kparams, pparams, prompts, mode: str,
                  weights: str, kv_format: str = "bf16",
                  extras: Optional[dict] = None, new: int = 16) -> list:
    """`serve_both` in f32: the same tokens and log-probabilities within
    1e-3, or raise. Returns the kernel path's results."""
    equal, n, lp_err, _, results = serve_both(
        cfg, mk, mp, kparams, pparams, prompts, mode, kv_format, extras, new)
    emit("parity-f32", dict(arch=cfg.name, mode=mode, weights=weights,
                            kv_format=kv_format, layers=cfg.n_layers,
                            prompt_len=len(prompts[0]), max_new=new,
                            window=cfg.attn_window,
                            cross_kv_cache=cfg.cross_kv_cache,
                            sequences=n, tokens_equal=equal,
                            max_logprob_diff=lp_err, tol=1e-3))
    if equal != n or lp_err > 1e-3:
        raise AssertionError(f"f32 parity ({cfg.name} {mode}, {weights} "
                             f"weights, {kv_format} KV): {equal}/{n} "
                             f"sequences equal, logprob diff {lp_err:.3e}")
    return results


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
        equal, n, lp_err, agree, _ = serve_both(cfg, mk, mp, kparams,
                                                pparams, prompts, mode)
        emit("agreement-bf16", dict(arch=cfg.name, mode=mode, weights=wfmt,
                                    layers=cfg.n_layers, sequences=n,
                                    sequences_equal=equal,
                                    token_agreement=agree,
                                    max_logprob_diff=lp_err))
        del params, kparams, pparams
        torch.cuda.empty_cache()


def parity_pooled(cfg, mk, mp, params, seed: int) -> None:
    """Phase 4, the resident prefix pool in f32: the pooled serve's prompts
    in two rounds (cold, then warm), greedy, 2 samples, 16 new tokens,
    through the kernel path and the plain path on a pool each, the
    per-batch paged serve and the chunked one (``prefill_chunk=64``), all
    decoding through CUDA graphs, one capture for both rounds (the
    per-batch paged round 2 takes round 1's cache arena and graph). Raises
    unless the kernel path gives the
    plain path's tokens with log-probabilities within 1e-3, the paged
    serve's tokens and the chunked serve's tokens with log-probabilities
    within 1e-3."""
    k, new = 2, 16
    rounds = pooled_rounds(cfg, seed)
    base = dict(kv_blocks=POOL["kv_blocks"],
                kv_block_size=POOL["kv_block_size"])
    pooled = dict(base, kv_pool=True)
    runs = {}
    for name, model, kw, graphs in (
            ("kernel", mk, pooled, (1, 2 * (new - 1) - 1)),
            ("plain", mp, pooled, (1, 2 * (new - 1) - 1)),
            ("paged", mk, base, (1, 2 * (new - 1) - 1)),
            ("chunked", mk, dict(pooled, prefill_chunk=64),
             (1, 2 * (new - 1) - 1))):
        info, backend = serve_rounds(model, params, rounds, seed, kw, k, new,
                                     0.0)
        st = backend.graph_stats
        if (st.captures, st.replays) != graphs:
            raise AssertionError(f"pooled parity, {name}: {st.captures} "
                                 f"captures and {st.replays} replays, want "
                                 f"{graphs}")
        runs[name] = info
    for other, lp_tol in (("plain", 1e-3), ("paged", None),
                          ("chunked", 1e-3)):
        for r, (a, b) in enumerate(zip(runs["kernel"], runs[other])):
            equal = int((a["tokens"] == b["tokens"]).all(axis=1).sum())
            n = a["tokens"].shape[0]
            lp_err = max(abs(x - y) for ra, rb in zip(a["results"],
                                                       b["results"])
                         for x, y in zip(ra.logprobs, rb.logprobs))
            emit("parity-f32", dict(
                arch=cfg.name, mode=f"pooled vs {other}",
                round="cold" if r == 0 else "warm", weights="f32",
                layers=cfg.n_layers, prompt_len=len(rounds[r][0]),
                sequences=n, tokens_equal=equal, max_logprob_diff=lp_err,
                tol=lp_tol,
                pool_hit_blocks=sum(h.pool_hit_blocks for h in a["handles"])))
            if equal != n or (lp_tol is not None and lp_err > lp_tol):
                raise AssertionError(f"f32 pooled parity against {other}, "
                                     f"round {r + 1}: {equal}/{n} sequences "
                                     f"equal, logprob diff {lp_err:.3e}")


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
    parity_pooled(cfg, mk, mp, params, seed + 1)
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


# ------------------------------------------------------ the scheduled stream

def stream_setup(seed: int):
    """Phase 5's router and stream. The router is the scheduling bench's
    (`repro_torch.serving.stream.stream_router`) for full chatglm3-6b over
    one request of STREAM's shape; the stream is drawn from one
    ``default_rng(seed)``: the shared system prompt first, then for each
    request its exponential gap, its tier and its own tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core import Workload
    from repro_torch.serving.stream import poisson_stream, stream_router
    cfg = get_config(SERVE["arch"])
    router = stream_router(cfg, Workload(
        batch=1, prompt_tokens=SERVE["prompt_len"],
        decode_tokens=STREAM["max_new"], samples=STREAM["samples"]))
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab_size,
                          POOL["system_len"]).astype(np.int32)
    own = SERVE["prompt_len"] - POOL["system_len"]
    arrivals = poisson_stream(
        router, STREAM["requests"], STREAM["offered_load"], rng,
        lambda r: np.concatenate([system, r.integers(
            0, cfg.vocab_size, own).astype(np.int32)]))
    return router, arrivals


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_stream(model, params, router, arrivals, seed: int, backend_kw: dict,
               temperature: float, preempt: bool = True,
               early_stop: bool = True, obs=None,
               spec_planner=None) -> dict:
    """Serve ``arrivals`` once through a `ContinuousBatchingScheduler` over
    a new backend built with ``backend_kw`` (STREAM's scheduler settings;
    the batch noise seeded from ``seed``), with CSVET early stops drawn
    from ``default_rng(seed + 1)`` when ``early_stop``; with
    ``spec_planner`` the scheduler prices each batch's draft depth.
    Returns the scheduler, the backend, the wall seconds, the launch counts
    of the drain, the blocks released early and the F8 probe's count."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     ExecutionBackend, SchedulerConfig)
    from repro_torch.serving.stream import (CsvetStop, ReleasedWriteProbe,
                                            drive)
    backend = ExecutionBackend(model, params, obs=obs, **backend_kw)
    sched = ContinuousBatchingScheduler(
        backend, router,
        SchedulerConfig(max_batch_requests=STREAM["max_batch"],
                        max_inflight_batches=STREAM["inflight"],
                        max_new_tokens=STREAM["max_new"],
                        temperature=temperature, preempt=preempt, seed=seed),
        obs=obs, spec_planner=spec_planner)
    probe = ReleasedWriteProbe()
    stop = CsvetStop(np.random.default_rng(seed + 1), probe=probe)
    sync(backend.device)
    reset_launch_counts()
    wall = drive(sched, arrivals, STREAM["samples"],
                 [probe, stop] if early_stop else [])
    sync(backend.device)
    counts = launch_counts()
    return dict(sched=sched, backend=backend, wall_s=wall, launches=counts,
                released=stop.released, f8=probe.hits)


def stream_records(sched) -> list:
    """The scheduling decisions of a drain that phase 5 gates on: per batch
    its request ids, tier mix, point index, pool hit blocks and
    preemption, as plain lists."""
    return [[[e["id"] for e in r.request_entries],
             [r.tier_mix.get(t, 0) for t in ("interactive", "standard",
                                              "economy")],
             r.point_index, r.pool_hit_blocks, r.preempted]
            for r in sched.records]


def check_stream(run: str, out: dict, cfg, pooled: bool) -> dict:
    """Phase 5's gates on one sampled drain; returns its printed numbers."""
    sched, backend = out["sched"], out["backend"]
    st = sched.stats()
    if st["cancelled"] or st["completed"] != STREAM["requests"]:
        raise AssertionError(f"{run}: {st['completed']} requests completed "
                             f"and {st['cancelled']} cancelled, want "
                             f"{STREAM['requests']} and 0")
    for c in sched.completed.values():
        samples = c.result.samples
        if len(samples) != STREAM["samples"] or any(
                s.shape != (STREAM["max_new"],) or s.min() < 0
                or s.max() >= cfg.vocab_size for s in samples):
            raise AssertionError(f"{run}: request {c.request.id} gave "
                                 f"{[s.shape for s in samples]}")
    c = out["launches"]
    want = (("paged_decode_attention",) if pooled
            else ("paged_decode_attention", "flash_attention"))
    for name in want:
        if c[name] < 1:
            raise AssertionError(f"{run}: never launched {name}")
    if pooled and c["flash_attention"]:
        raise AssertionError(f"{run}: flash launched {c['flash_attention']} "
                             "times (a pooled prefill takes the tail path)")
    resident = (backend.prefix_pool.blocks_resident if pooled else 0)
    if backend.blocks_in_use != resident:
        raise AssertionError(f"{run}: {backend.blocks_in_use} blocks in use "
                             f"at the end, want the pool's {resident}")
    gs = backend.graph_stats
    n_tok = sum(c.result.decode_tokens for c in sched.completed.values())
    return dict(run=run, seconds=out["wall_s"],
                tokens_per_s=n_tok / out["wall_s"], batches=st["batches"],
                preemptions=st["preemptions"],
                released_early=out["released"], f8_hits=out["f8"],
                pool_hit_blocks=st["pool_hit_blocks"],
                prefill_bytes_saved=st["prefill_bytes_saved"],
                graph_captures=gs.captures,
                graph_capture_ms=1e3 * gs.capture_s,
                graph_replays=gs.replays, launches=c,
                records=[dict(batch=r.batch_id, requests=r.n_requests,
                              tiers=r.tier_mix, point=r.point_index,
                              energy_j=r.energy_j, latency_s=r.latency_s,
                              caps_met=r.meets_caps,
                              pool_hits=r.pool_hit_blocks,
                              preempted=r.preempted)
                         for r in sched.records])


def check_stream_rehearsal(run: str, out: dict, pooled: bool) -> None:
    """Hold a bf16 drain to the CPU rehearsal (STREAM_REHEARSAL): the
    per-batch paged drain's graph captures and replays; the pooled drain's
    batch records, blocks released early, preemptions and graph captures
    and replays, at least one tier preemption, whose requests resumed and
    completed, and every batch after the first a pool hit."""
    sched, gs = out["sched"], out["backend"].graph_stats
    if not pooled:
        got = [gs.captures, gs.replays]
        if got != STREAM_REHEARSAL["paged_graphs"]:
            raise AssertionError(f"{run}: graphs {got}, the CPU rehearsal "
                                 f"gave {STREAM_REHEARSAL['paged_graphs']}")
        return
    st = sched.stats()
    got = dict(records=stream_records(sched), released=out["released"],
               preemptions=st["preemptions"],
               graphs=[gs.captures, gs.replays])
    for k, v in got.items():
        if v != STREAM_REHEARSAL[k]:
            raise AssertionError(f"{run}: {k} {v}, the CPU rehearsal gave "
                                 f"{STREAM_REHEARSAL[k]}")
    if st["preemptions"].get("tier", 0) < 1:
        raise AssertionError(f"{run}: no tier preemption")
    resumed = {e["id"] for r in sched.records for e in r.request_entries
               if e["resumed"]}
    if not resumed or not resumed <= set(sched.completed):
        raise AssertionError(f"{run}: resumed requests {resumed} did not "
                             "all complete")
    if any(r.pool_hit_blocks < 1 for r in list(sched.records)[1:]):
        raise AssertionError(f"{run}: a batch after the first missed the "
                             "pool")


def stream_pair(out_a: dict, out_b: dict, records: bool,
                lp_tol: Optional[float]) -> dict:
    """Compare two greedy drains request by request: equal tokens, and
    log-probabilities within ``lp_tol`` (None: bit-equal); with
    ``records``, equal batch records too (ids, requests, point, energy,
    latency, caps)."""
    a, b = out_a["sched"], out_b["sched"]
    if records:
        ra = [(r.batch_id, [e["id"] for e in r.request_entries],
               r.point_index, r.energy_j, r.latency_s, r.meets_caps)
              for r in a.records]
        rb = [(r.batch_id, [e["id"] for e in r.request_entries],
               r.point_index, r.energy_j, r.latency_s, r.meets_caps)
              for r in b.records]
        if ra != rb:
            raise AssertionError(f"batch records differ: {ra} against {rb}")
    if set(a.completed) != set(b.completed):
        raise AssertionError("the drains completed different requests")
    equal = n = 0
    lp_err = 0.0
    for rid, ca in a.completed.items():
        cb = b.completed[rid]
        for sa, sb, la, lb in zip(ca.result.samples, cb.result.samples,
                                  ca.result.logprobs, cb.result.logprobs):
            n += 1
            equal += int(np.array_equal(sa, sb))
            lp_err = max(lp_err, abs(la - lb))
    ok = equal == n and (lp_err <= lp_tol if lp_tol is not None
                         else lp_err == 0.0)
    return dict(sequences=n, tokens_equal=equal, max_logprob_diff=lp_err,
                tol=lp_tol, ok=ok)


def serve_stream(seed: int) -> dict:
    """Phase 5: the scheduled stream (STREAM) through the PGSAM archive,
    the `ParetoRouter`'s tiers and the continuous-batching scheduler, on
    full chatglm3-6b in bf16 with the kernels and CUDA graphs on: once on
    the resident prefix pool and once on per-batch paged caches, each
    held to its gates and to the CPU rehearsal. Then the f32 parity of the
    stream at 2 layers (`parity_stream`). Returns the launch counts of the
    two bf16 drains, and the pooled drain's printed numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.obs import make_observability
    from repro_torch.serving import ExecutionBackend, ServingEngine
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    router, arrivals = stream_setup(seed)
    setup_s = time.perf_counter() - t0
    cfg = get_config(SERVE["arch"])
    model = Model(cfg, dtype=torch.bfloat16, device="cuda", use_kernel=True)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    base = dict(kv_blocks=POOL["kv_blocks"],
                kv_block_size=POOL["kv_block_size"])
    pooled = dict(base, kv_pool=True, pool_evict="lru")
    # kernels and cuBLAS warm before the timed drains: a prompt shorter
    # than a block caches nothing
    warm = ExecutionBackend(model, params, **pooled)
    ServingEngine(model, params, backend=warm).generate(
        [arrivals[0]["prompt"][:POOL["kv_block_size"] - 1]], n_samples=1,
        max_new_tokens=2)
    del warm
    counts, infos = {}, {}
    for run, kw, is_pooled in (("chatglm-stream-pooled", pooled, True),
                               ("chatglm-stream-paged", base, False)):
        out = run_stream(model, params, router, arrivals, seed, kw,
                         STREAM["temperature"])
        infos[run] = info = check_stream(run, out, cfg, is_pooled)
        if not is_pooled:
            # the walls this drain took on an H100 80GB HBM3 at 700 W when
            # each batch captured its own graph, beside this run's
            info["walls_before_arenas_s"] = [3.434, 3.675]
        emit("serve-stream", info)
        check_stream_rehearsal(run, out, is_pooled)
        counts[run] = out["launches"]
        del out
    del params
    torch.cuda.empty_cache()
    parity_stream(router, arrivals, seed)
    emit("serve-stream", dict(router_setup_s=setup_s,
                              phase_s=time.perf_counter() - t_phase))
    return counts, infos["chatglm-stream-pooled"]


def parity_stream(router, arrivals, seed: int) -> None:
    """Phase 5's f32 parity: the stream at full width, 2 layers, greedy, on
    the pool, with no early stop. The kernel path must equal the plain
    path (batch records, tokens, log-probabilities within 1e-3), the
    preempting drain the one that never preempts (each request's tokens,
    log-probabilities within 1e-3), and a drain with ``obs`` on the one
    with it off (bit-equal)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.obs import make_observability
    cfg = dataclasses.replace(get_config(SERVE["arch"]), n_layers=2)
    mk = Model(cfg, dtype=torch.float32, device="cuda", use_kernel=True)
    mp = Model(cfg, dtype=torch.float32, device="cuda", use_kernel=False)
    params = mk.init(torch.Generator(device="cuda").manual_seed(seed + 1))
    pooled = dict(kv_blocks=POOL["kv_blocks"],
                  kv_block_size=POOL["kv_block_size"], kv_pool=True)

    def drain(model, **kw):
        return run_stream(model, params, router, arrivals, seed, pooled,
                          0.0, early_stop=False, **kw)

    kernel = drain(mk)
    for name, other, records, tol in (
            ("kernel vs plain", drain(mp), True, 1e-3),
            ("preempt vs no preemption", drain(mk, preempt=False), False,
             1e-3),
            ("obs off vs on", drain(mk, obs=make_observability()), True,
             None)):
        res = stream_pair(kernel, other, records, tol)
        gs = kernel["backend"].graph_stats
        emit("parity-f32", dict(arch=cfg.name, mode=f"stream {name}",
                                layers=cfg.n_layers, weights="f32",
                                preemptions=kernel["sched"].stats()[
                                    "preemptions_total"],
                                graph_captures=gs.captures,
                                graph_replays=gs.replays, **res))
        if not res["ok"]:
            raise AssertionError(f"f32 stream parity, {name}: {res}")
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------ speculative decode

def spec_paged_kw(model, params) -> dict:
    """Per-batch paged arguments of a speculating serve of the SERVE
    requests in one batch: the slack of ``spec_n + 1`` token slots a
    sequence costs each request 4 more blocks of 16 (28, not 24), so 8 x 28
    = 224 blocks (192 would split the requests into batches of 6 and 2)."""
    from repro_torch.serving import ExecutionBackend
    from repro_torch.spec import NGramDraftPolicy
    probe = ExecutionBackend(model, params, kv_blocks=1,
                             kv_block_size=SERVE["kv_block_size"],
                             spec_policy=NGramDraftPolicy(),
                             spec_n=SPEC["n"])
    return dict(kv_blocks=SERVE["requests"] * probe.request_blocks(
        SERVE["prompt_len"], SERVE["max_new"], SERVE["samples"]),
        kv_block_size=SERVE["kv_block_size"])


def spec_serve(run: str, model, params, rounds, seed: int, backend_kw: dict,
               policy, temperature: float, k: int = SERVE["samples"],
               new: int = SERVE["max_new"], kernels: bool = True):
    """Serve ``rounds`` speculatively (``policy`` at depth SPEC["n"])
    through `serve_rounds`, the launch counts set to 0 just before and read
    just after, and hold the run to its gates: every sample ``new``
    in-vocabulary tokens (`serve_rounds`); no S = 1 decode step (no decode
    graph, and with ``kernels`` neither decode kernel launched) and flash
    launched once a layer a per-batch prefill and never on the pool; one
    verify graph captured a shape (rows and prompt length; off the pool,
    unique prompts too: they size a per-batch pool), and every other verify
    a replay; no block left in use but the pool's resident ones. Returns
    (the printed numbers, the per-round info, the backend)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    info, backend = serve_rounds(
        model, params, rounds, seed,
        dict(backend_kw, spec_policy=policy, spec_n=SPEC["n"]), k, new,
        temperature)
    c = launch_counts()
    cfg = model.cfg
    handles = [h for i in info for h in i["handles"]]
    steps = sum(h.spec.steps for h in handles)
    proposed = sum(h.spec.proposed for h in handles)
    accepted = sum(h.spec.accepted for h in handles)
    pooled = backend.prefix_pool is not None
    st = backend.graph_stats
    graphed = backend.cuda_graphs
    shapes = len({(h.n_sequences, h.plen) + (() if pooled else
                                             (len(h.repeats),))
                  for h in handles})
    want = dict(verify_captures=shapes * graphed,
                verify_replays=(steps - shapes) * graphed,
                captures=0, replays=0)
    got = dict(verify_captures=st.verify_captures,
               verify_replays=st.verify_replays, captures=st.captures,
               replays=st.replays)
    if got != want:
        raise AssertionError(f"{run}: graphs {got}, want {want}")
    if kernels:
        want_k = {"flash_attention": 0 if pooled else
                  cfg.n_layers * len(handles),
                  "decode_attention": 0, "paged_decode_attention": 0}
        for name, n in want_k.items():
            if c[name] != n:
                raise AssertionError(f"{run}: {name} launched {c[name]} "
                                     f"times, want {n}")
    resident = backend.prefix_pool.blocks_resident if pooled else 0
    if backend.blocks_in_use not in (None, resident):
        raise AssertionError(f"{run}: {backend.blocks_in_use} blocks in use "
                             f"at the end, want {resident}")
    rows = sum(h.n_sequences for h in handles)
    out = dict(
        run=run, policy=policy.name, n=SPEC["n"], temperature=temperature,
        layers=cfg.n_layers, batches=len(handles),
        kv_blocks=backend_kw.get("kv_blocks"),
        seconds=[i["seconds"] for i in info],
        tokens_per_s=[i["tokens_per_s"] for i in info],
        verify_forwards=steps,
        # the first token of a row comes from the prefill
        committed_per_forward=rows * (new - 1) / steps,
        accept_rate=accepted / proposed if proposed else None,
        proposed=proposed, accepted=accepted,
        verify_ms=[i["verify_ms"] for i in info],
        propose_ms=[i["propose_ms"] for i in info],
        decode_step_ms=[i["decode_step_ms"] for i in info],
        verify_captures=st.verify_captures,
        verify_capture_ms=1e3 * st.capture_s,
        verify_replays=st.verify_replays,
        pool_hit_blocks=[sum(h.pool_hit_blocks for h in i["handles"])
                         for i in info], launches=c)
    return out, info, backend


def spec_bf16(seed: int, phase5: dict) -> dict:
    """Phase 6 in bf16: full chatglm3-6b, kernels and graphs on, the
    serve's traffic, ngram drafting at depth 4, per-batch paged at
    temperature 0.8 and greedy, then phase 3's two pooled rounds, then in
    int4 weights (the dequant kernels launched 196 times a forward: one
    prefill and every verify); then draft-model drafting by a 2-layer
    chatglm3-6b-width draft with weights of its own; then phase 5's
    scheduled stream with a `SpecPlanner` (ngram, depths 0, 2, 4) on the
    pool, held to the CPU rehearsal's batch records. Returns the launch
    counts of each run."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.quant.quantize import quantize_model
    from repro_torch.spec import (DraftModelPolicy, NGramDraftPolicy,
                                  SpecPlanner)
    cfg = get_config(SERVE["arch"])
    model = Model(cfg, dtype=torch.bfloat16, device="cuda", use_kernel=True)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    prompts = make_prompts(cfg, seed)
    paged = spec_paged_kw(model, params)
    counts = {}

    def record(out):
        emit("spec", {k: v for k, v in out.items() if k != "launches"})
        counts[out["run"]] = out["launches"]

    for run, temp in (("spec-ngram-paged", SERVE["temperature"]),
                      ("spec-ngram-paged-greedy", 0.0)):
        record(spec_serve(run, model, params, [prompts], seed, paged,
                          NGramDraftPolicy(), temp)[0])
    pooled = dict(kv_blocks=POOL["kv_blocks"],
                  kv_block_size=POOL["kv_block_size"], kv_pool=True,
                  pool_evict="lru")
    out, _, backend = spec_serve("spec-ngram-pooled", model, params,
                                 pooled_rounds(cfg, seed), seed, pooled,
                                 NGramDraftPolicy(), SERVE["temperature"])
    want_hits = [0, SERVE["requests"] * POOL["system_len"]
                 // POOL["kv_block_size"]]
    if out["pool_hit_blocks"] != want_hits:
        raise AssertionError(f"spec-ngram-pooled: {out['pool_hit_blocks']} "
                             f"pool hits, want {want_hits}")
    record(out)
    del backend
    qparams = quantize_model(params, "int4", 32)
    out = spec_serve("spec-ngram-int4-paged", model, qparams, [prompts],
                     seed, paged, NGramDraftPolicy(),
                     SERVE["temperature"])[0]
    fwd = out["batches"] + out["verify_forwards"]
    per_forward = LINEARS_PER_LAYER * cfg.n_layers
    if out["launches"]["dequant_matmul_int4"] != per_forward * fwd:
        raise AssertionError(
            f"spec-ngram-int4-paged: dequant_matmul_int4 launched "
            f"{out['launches']['dequant_matmul_int4']} times, want "
            f"{per_forward} x {fwd} forwards")
    record(out)
    del qparams
    torch.cuda.empty_cache()
    dcfg = dataclasses.replace(cfg, n_layers=SPEC["draft_layers"])
    draft = Model(dcfg, dtype=torch.bfloat16, device="cuda", use_kernel=True)
    dparams = draft.init(torch.Generator(device="cuda").manual_seed(
        seed + 1))
    record(spec_serve("spec-draft-paged", model, params, [prompts], seed,
                      paged, DraftModelPolicy(draft, dparams),
                      SERVE["temperature"])[0])
    del dparams, draft
    torch.cuda.empty_cache()

    router, arrivals = stream_setup(seed)
    planner = SpecPlanner("ngram", depths=SPEC["depths"],
                          model_name=cfg.name)
    drain = run_stream(model, params, router, arrivals, seed,
                       dict(pooled, spec_policy=NGramDraftPolicy(),
                            spec_n=SPEC["n"]), STREAM["temperature"],
                       spec_planner=planner)
    emit("spec-stream", check_spec_stream("spec-stream-pooled", drain, cfg,
                                          phase5))
    counts["spec-stream-pooled"] = drain["launches"]
    del drain, params, model
    torch.cuda.empty_cache()
    return counts


def spec_stream_records(sched) -> list:
    """`stream_records` with each batch's draft depth."""
    return [r + [rec.spec_n] for r, rec in zip(stream_records(sched),
                                               sched.records)]


def check_spec_stream(run: str, out: dict, cfg, phase5: dict) -> dict:
    """Phase 6's gates on the scheduled drain with a `SpecPlanner`: every
    request completes with 4 samples of 32 in-vocabulary tokens, the batch
    records (with each batch's draft depth) and the decode and verify
    graphs' captures and replays equal the CPU rehearsal's, flash and the
    decode kernels never launched (a pooled prefill takes the tail path,
    and every batch speculates), and only the pool's resident blocks stay
    in use. Returns its printed numbers, beside phase 5's wall and tok/s
    and the rehearsal's drafts proposed and accepted."""
    sched, backend = out["sched"], out["backend"]
    st = sched.stats()
    if st["cancelled"] or st["completed"] != STREAM["requests"]:
        raise AssertionError(f"{run}: {st['completed']} requests completed "
                             f"and {st['cancelled']} cancelled, want "
                             f"{STREAM['requests']} and 0")
    for c in sched.completed.values():
        samples = c.result.samples
        if len(samples) != STREAM["samples"] or any(
                s.shape != (STREAM["max_new"],) or s.min() < 0
                or s.max() >= cfg.vocab_size for s in samples):
            raise AssertionError(f"{run}: request {c.request.id} gave "
                                 f"{[s.shape for s in samples]}")
    gs = backend.graph_stats
    got = dict(records=spec_stream_records(sched),
               graphs=[gs.captures, gs.replays],
               verify_graphs=[gs.verify_captures, gs.verify_replays])
    for k, v in got.items():
        if v != SPEC_STREAM_REHEARSAL[k]:
            raise AssertionError(f"{run}: {k} {v}, the CPU rehearsal gave "
                                 f"{SPEC_STREAM_REHEARSAL[k]}")
    for name in ("flash_attention", "decode_attention",
                 "paged_decode_attention"):
        if out["launches"][name]:
            raise AssertionError(f"{run}: {name} launched "
                                 f"{out['launches'][name]} times")
    resident = backend.prefix_pool.blocks_resident
    if backend.blocks_in_use != resident:
        raise AssertionError(f"{run}: {backend.blocks_in_use} blocks in use "
                             f"at the end, want the pool's {resident}")
    n_tok = sum(c.result.decode_tokens for c in sched.completed.values())
    return dict(run=run, seconds=out["wall_s"],
                tokens_per_s=n_tok / out["wall_s"],
                phase5_seconds=phase5.get("seconds"),
                phase5_tokens_per_s=phase5.get("tokens_per_s"),
                batches=st["batches"], preemptions=st["preemptions"],
                released_early=out["released"],
                spec_proposed=st["spec_proposed"],
                spec_accepted=st["spec_accepted"],
                rehearsal_proposed=SPEC_STREAM_REHEARSAL["proposed"],
                rehearsal_accepted=SPEC_STREAM_REHEARSAL["accepted"],
                graph_captures=gs.captures, graph_replays=gs.replays,
                verify_captures=gs.verify_captures,
                verify_replays=gs.verify_replays, launches=out["launches"],
                records=[dict(batch=r.batch_id, requests=r.n_requests,
                              point=r.point_index, spec_n=r.spec_n,
                              proposed=r.spec_proposed,
                              accepted=r.spec_accepted,
                              pool_hits=r.pool_hit_blocks,
                              preempted=r.preempted)
                         for r in sched.records])


def spec_parity(seed: int) -> None:
    """Phase 6 in f32: chatglm3-6b at full width, 2 layers, greedy, the
    serve's prompts (2 samples, 16 new tokens), dense, per-batch paged and
    on the pool (cold and warm rounds), for ``ngram`` and for ``draft``
    with the target as its own draft (which accepts every draft). The
    speculative serve must give plain greedy decode's tokens, the plain
    path's (``use_kernel=False``) speculative serve's and the eager
    verify's (``cuda_graphs=False``), with log-probabilities within 1e-3
    of the first two."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.spec import DraftModelPolicy, NGramDraftPolicy
    cfg = dataclasses.replace(get_config(SERVE["arch"]), n_layers=2)
    mk = Model(cfg, dtype=torch.float32, device="cuda", use_kernel=True)
    mp = Model(cfg, dtype=torch.float32, device="cuda", use_kernel=False)
    params = mk.init(torch.Generator(device="cuda").manual_seed(seed + 1))
    k, new = 2, 16
    prompts = make_prompts(cfg, seed + 1)
    bs = SERVE["kv_block_size"]
    modes = {"dense": ({}, [prompts]),
             "paged": (dict(kv_blocks=512, kv_block_size=bs), [prompts]),
             "pooled": (dict(kv_blocks=POOL["kv_blocks"], kv_block_size=bs,
                             kv_pool=True), pooled_rounds(cfg, seed + 1))}
    policies = {"ngram": lambda m: NGramDraftPolicy(),
                "draft": lambda m: DraftModelPolicy(m, params)}
    for mode, (kw, rounds) in modes.items():
        plain, _ = serve_rounds(mk, params, rounds, seed, kw, k, new, 0.0)
        for kind, make in policies.items():
            runs = {}
            for name, m, extra in (("kernel", mk, {}), ("plain", mp, {}),
                                   ("eager", mk, dict(cuda_graphs=False))):
                runs[name] = spec_serve(
                    f"spec-parity {mode} {kind} {name}", m, params, rounds,
                    seed, dict(kw, **extra), make(m), 0.0, k, new,
                    kernels=False)
            spec = runs["kernel"][0]
            if kind == "draft" and spec["accepted"] != spec["proposed"]:
                raise AssertionError(f"spec parity {mode}: the target as "
                                     f"its own draft accepted "
                                     f"{spec['accepted']} of "
                                     f"{spec['proposed']}")
            for other, ref, lp_tol in (("plain decode", plain, 1e-3),
                                       ("plain path", runs["plain"][1],
                                        1e-3),
                                       ("eager verify", runs["eager"][1],
                                        None)):
                spec_pair(cfg, f"spec {kind} {mode} vs {other}", spec,
                          runs["kernel"][1], ref, lp_tol)
    del params
    torch.cuda.empty_cache()


def spec_pair(cfg, label: str, spec: dict, runs_a, runs_b,
              lp_tol: Optional[float], gate: bool = True) -> None:
    """Print the agreement of two speculating serves' rounds (``spec``:
    the first's printed numbers): equal sequences and the largest
    log-probability difference. With ``gate``, raise unless every sequence
    is equal and, with ``lp_tol``, every log-probability within it."""
    for r, (a, b) in enumerate(zip(runs_a, runs_b)):
        equal = int((a["tokens"] == b["tokens"]).all(axis=1).sum())
        n = a["tokens"].shape[0]
        lp_err = max(abs(x - y) for ra, rb in zip(a["results"],
                                                   b["results"])
                     for x, y in zip(ra.logprobs, rb.logprobs))
        emit("parity-f32" if gate else "agreement-f32", dict(
            arch=cfg.name, mode=label, round=r + 1, layers=cfg.n_layers,
            weights="f32", sequences=n, tokens_equal=equal,
            token_share=float((a["tokens"] == b["tokens"]).mean()),
            max_logprob_diff=lp_err, tol=lp_tol if gate else None,
            verify_forwards=spec["verify_forwards"],
            accept_rate=spec["accept_rate"]))
        if gate and (equal != n or (lp_tol is not None and lp_err > lp_tol)):
            raise AssertionError(f"f32 spec parity ({label}), round "
                                 f"{r + 1}: {equal}/{n} sequences equal, "
                                 f"logprob diff {lp_err:.3e}")


def spec_moe(seed: int) -> dict:
    """Phase 6 on an MoE arch (SPEC_MOE): full-width, full-depth
    granite-moe-3b-a800m in bf16, kernels and graphs on, the serve's
    traffic, ngram drafting at depth 4, per-batch paged at temperature 0.8
    and greedy (`spec_serve`'s gates, and the MoE kernel launched 3 times
    per MoE layer a forward: its prefill and every verify). Then f32 at
    full width and 2 MoE layers, greedy, dense and per-batch paged: the
    kernel path's speculative serve must equal the plain path's and the
    eager verify's (tokens, and log-probabilities within 1e-3 of the plain
    path's); its agreement with plain greedy decode is printed, not gated
    (an MoE layer's capacity depends on the forward's token count, so a
    verify may drop other tokens than one-token steps). Returns the launch
    counts of the bf16 runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.spec import NGramDraftPolicy
    cfg = get_config(SPEC_MOE["arch"])
    model = Model(cfg, dtype=torch.bfloat16, device="cuda", use_kernel=True)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    prompts = make_prompts(cfg, seed)
    paged = spec_paged_kw(model, params)
    per_forward = 3 * sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    counts = {}
    for run, temp in (("spec-granite-paged", SERVE["temperature"]),
                      ("spec-granite-paged-greedy", 0.0)):
        out = spec_serve(run, model, params, [prompts], seed, paged,
                         NGramDraftPolicy(), temp)[0]
        fwd = out["batches"] + out["verify_forwards"]
        if out["launches"]["moe_gemm"] != per_forward * fwd:
            raise AssertionError(
                f"{run}: moe_gemm launched {out['launches']['moe_gemm']} "
                f"times, want {per_forward} x {fwd} forwards")
        emit("spec", dict({k: v for k, v in out.items() if k != "launches"},
                          moe_gemm_per_forward=per_forward))
        counts[run] = out["launches"]
    del params, model
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(cfg, n_layers=SPEC_MOE["parity_layers"])
    mk = Model(cfg, dtype=torch.float32, device="cuda", use_kernel=True)
    mp = Model(cfg, dtype=torch.float32, device="cuda", use_kernel=False)
    params = mk.init(torch.Generator(device="cuda").manual_seed(seed + 1))
    k, new = 2, 16
    prompts = make_prompts(cfg, seed + 1)
    for mode, kw in (("dense", {}),
                     ("paged", dict(kv_blocks=512,
                                    kv_block_size=SERVE["kv_block_size"]))):
        plain, _ = serve_rounds(mk, params, [prompts], seed, kw, k, new, 0.0)
        runs = {name: spec_serve(f"spec-parity granite {mode} {name}", m,
                                 params, [prompts], seed, dict(kw, **extra),
                                 NGramDraftPolicy(), 0.0, k, new,
                                 kernels=False)
                for name, m, extra in (("kernel", mk, {}), ("plain", mp, {}),
                                       ("eager", mk,
                                        dict(cuda_graphs=False)))}
        spec = runs["kernel"][0]
        for other, lp_tol in (("plain path", 1e-3), ("eager verify", None)):
            spec_pair(cfg, f"spec ngram {mode} vs {other}", spec,
                      runs["kernel"][1], runs[other.split()[0]][1], lp_tol)
        spec_pair(cfg, f"spec ngram {mode} vs plain decode", spec,
                  runs["kernel"][1], plain, None, gate=False)
    del params
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------- the remaining archs

def arch_prompts(cfg, seed: int, plen: int = SERVE["prompt_len"]):
    """SERVE's prompts for ``cfg`` from ``seed``: (plen, K) with K
    codebooks, each codebook's stream drawn on its own."""
    rng = np.random.default_rng(seed)
    tail = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    return [rng.integers(0, cfg.vocab_size, (plen,) + tail).astype(np.int32)
            for _ in range(SERVE["requests"])]


def arch_extras(cfg, seed: int) -> dict:
    """The frontends' stub inputs of SERVE's requests, a row a prompt,
    random normal x 0.1 from ``seed`` (the reference's launcher gives
    zeros, which would not test the cross-attention): 4 vision embeddings,
    or ``n_cond_tokens`` rows of conditioning memory."""
    rng = np.random.default_rng(seed)
    R, d = SERVE["requests"], cfg.d_model
    out = {}
    if cfg.frontend == "vision":
        out["vision_embeds"] = (rng.standard_normal((R, 4, d))
                                * 0.1).astype(np.float32)
    if cfg.cross_attention:
        out["cond_memory"] = (rng.standard_normal((R, cfg.n_cond_tokens, d))
                              * 0.1).astype(np.float32)
    return out


def serve_archs(seed: int) -> dict:
    """Phase 8, bf16: full musicgen-medium dense, with and without the
    cross K/V cache, then full qwen2-vl-7b dense, paged and on the resident
    prefix pool (`pooled_run`), every earlier model freed first. Returns
    the launch counts of each run."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.quant.quantize import param_bytes
    new = SERVE["max_new"]
    counts, tokens = {}, {}
    arch = None
    for run, (name, mode, cross_kv) in ARCH_SERVES.items():
        if name != arch:
            arch, model, params = name, None, None
            torch.cuda.empty_cache()
            cfg = get_config(arch)
            model = Model(cfg, dtype=torch.bfloat16, device="cuda",
                          use_kernel=True)
            t0 = time.perf_counter()
            params = model.init(torch.Generator(device="cuda").manual_seed(
                seed))
            torch.cuda.synchronize()
            emit("model", dict(arch=cfg.name, layers=cfg.n_layers,
                               d_model=cfg.d_model,
                               params=model.param_count(), dtype="bfloat16",
                               init_s=time.perf_counter() - t0,
                               weight_gb=param_bytes(params) / 1e9,
                               codebooks=cfg.n_codebooks))
            prompts, extras = arch_prompts(cfg, seed), arch_extras(cfg, seed)
        m = model
        if cross_kv:
            m = Model(dataclasses.replace(cfg, cross_kv_cache=True),
                      dtype=torch.bfloat16, device="cuda", use_kernel=True)
        c, tokens[run], fwd, info = serve_run(
            m, params, prompts, seed, paged=mode == "paged", extras=extras)
        counts[run] = c
        emit("serve", dict(arch=cfg.name, mode=mode, weights="bf16",
                           cross_kv_cache=cross_kv,
                           extras=sorted(extras), **info))
        decode = ATTN_KERNELS[mode][1]
        other = ATTN_KERNELS["paged" if mode == "dense" else "dense"][1]
        want = {"flash_attention": cfg.n_layers,
                decode: cfg.n_layers * (new - 1), other: 0}
        for name, n in want.items():
            if c[name] != n:
                raise AssertionError(f"{run}: {name} launched {c[name]} "
                                     f"times, want {n}")
    # information, not a gate: the cached K/V and the per-step projection of
    # the memory round alike in f32 (phase 8's parity), not in bf16
    emit("serve-agreement", dict(
        arch="musicgen-medium", cross_kv_vs_recompute_token_match=float(
            (tokens["musicgen-dense-xkv"]
             == tokens["musicgen-dense"]).mean())))
    rounds = pooled_rounds(cfg, seed)
    warm_pool(model, params, rounds, extras)
    counts["qwen2-vl-pooled"], _ = pooled_run(
        model, params, rounds, seed, "qwen2-vl-pooled", None, extras)
    del params, model
    torch.cuda.empty_cache()
    return counts


def parity_archs(seed: int) -> None:
    """Phase 8, f32 at full width and 2 layers, greedy: the kernel path
    against the plain path (`compare_paths`: the same tokens,
    log-probabilities within 1e-3) for musicgen-medium without and with
    the cross K/V cache (which must give the same tokens as each other),
    qwen2-vl-7b dense and paged, and chatglm3-6b with a sliding window of
    64 over prompts of 256 and 32 new tokens, dense: its ring of 64 slots
    wraps at every decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    layers = ARCH_PARITY["layers"]

    def pair(cfg):
        return (Model(cfg, dtype=torch.float32, device="cuda",
                      use_kernel=True),
                Model(cfg, dtype=torch.float32, device="cuda",
                      use_kernel=False))

    cfg = dataclasses.replace(get_config("musicgen-medium"), n_layers=layers)
    params = pair(cfg)[0].init(torch.Generator(device="cuda").manual_seed(
        seed + 1))
    prompts, extras = arch_prompts(cfg, seed + 1), arch_extras(cfg, seed + 1)
    outs = {}
    for cross_kv in (False, True):
        c = dataclasses.replace(cfg, cross_kv_cache=cross_kv)
        outs[cross_kv] = compare_paths(c, *pair(c), params, params, prompts,
                                       "dense", "f32", extras=extras)
    toks = [np.stack([s for r in outs[x] for s in r.samples])
            for x in (False, True)]
    lp_err = max(abs(a - b) for ra, rb in zip(outs[False], outs[True])
                 for a, b in zip(ra.logprobs, rb.logprobs))
    equal = int((toks[0] == toks[1]).reshape(len(toks[0]), -1).all(1).sum())
    emit("parity-f32", dict(arch=cfg.name, mode="cross-kv vs recompute",
                            weights="f32", layers=layers,
                            sequences=len(toks[0]), tokens_equal=equal,
                            max_logprob_diff=lp_err))
    if equal != len(toks[0]):
        raise AssertionError(f"{cfg.name}: the cross K/V cache changed the "
                             f"tokens of {len(toks[0]) - equal} sequences")
    del params
    cfg = dataclasses.replace(get_config("qwen2-vl-7b"), n_layers=layers)
    mk, mp = pair(cfg)
    params = mk.init(torch.Generator(device="cuda").manual_seed(seed + 1))
    prompts, extras = arch_prompts(cfg, seed + 1), arch_extras(cfg, seed + 1)
    for mode in ("dense", "paged"):
        compare_paths(cfg, mk, mp, params, params, prompts, mode, "f32",
                      extras=extras)
    del params
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=layers,
                              attn_window=ARCH_PARITY["window"])
    mk, mp = pair(cfg)
    params = mk.init(torch.Generator(device="cuda").manual_seed(seed + 1))
    compare_paths(cfg, mk, mp, params, params, make_prompts(cfg, seed + 1),
                  "dense", "f32", new=SERVE["max_new"])
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------- the calibration loop

def route_points(router) -> dict:
    """The point each tier of ``router`` routes to: its frontier index,
    whether it meets the tier's caps, its energy and latency, and its
    devices."""
    out = {}
    for tier in ("interactive", "standard", "economy"):
        d = router.route(tier)
        out[tier] = dict(point=d.point_index, meets_caps=d.meets_caps,
                         energy_j=d.assignment.energy_j,
                         latency_s=d.assignment.latency_s,
                         devices=d.assignment.device_names())
    return out


def calibration_loop(seed: int) -> dict:
    """Phase 7, the calibration loop on the card: `repro_torch.launch.profile`
    over its five jobs (CALIBRATION's reps each, after a warm call) into a
    TraceStore JSONL, fitted by `repro_torch.launch.calibrate` (``--trace``)
    and loaded with `CalibrationProfile.load`; then phase 5's chatglm3-6b
    router (PGSAM anneal, v2 energy, 1500 iterations) without and with a
    `CalibratedSignalProvider` over the fitted profile. Raises unless every
    record ran on the card in a positive time, the fit gives exactly the
    five eta keys, and each of the five kernels launched reps + 1 times
    (the hand-written kernels ran, not their plain versions) and no other
    kernel launched. Prints each eta key's mean and roofline us and fitted
    eta with its interval, and the routed points of the three tiers without
    and with the profile (information, not a gate). Returns the launch
    counts of the profile."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core import Workload
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import calibrate, profile
    from repro_torch.qeil2.telemetry import (CalibratedSignalProvider,
                                             CalibrationProfile, TraceStore)
    from repro_torch.qeil2.telemetry.fit import _eta_key
    from repro_torch.serving.stream import stream_router
    reps = CALIBRATION["reps"]
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        t0 = time.perf_counter()
        reset_launch_counts()
        res = profile.run(verbose=True, reps=reps, device="cuda")
        torch.cuda.synchronize()
        counts = launch_counts()
        profile_s = time.perf_counter() - t0
        TraceStore(path=str(d / "kernels.jsonl")).ingest_many(
            res["records"])
        t0 = time.perf_counter()
        calibrate.main(["--trace", str(d / "kernels.jsonl"),
                        "--seed", str(seed),
                        "--bootstrap", str(CALIBRATION["bootstrap"]),
                        "--out", str(d / "profile.json"),
                        "--report", str(d / "report.json")])
        fit_s = time.perf_counter() - t0
        fitted = CalibrationProfile.load(str(d / "profile.json"))
        report = json.loads((d / "report.json").read_text())
    bad = [r for r in res["records"]
           if r["backend"] != "cuda" or not r["measured_us"] > 0]
    if bad:
        raise AssertionError(f"calibration: records not timed on the card: "
                             f"{bad[:2]}")
    keys = tuple(sorted(k for k, _ in fitted.kernel_eta))
    if keys != CALIBRATION["eta_keys"]:
        raise AssertionError(f"calibration: fitted eta keys {keys}, want "
                             f"{CALIBRATION['eta_keys']}")
    want = {name: reps + 1 if name in CALIBRATION["kernels"] else 0
            for name in counts}
    if counts != want:
        raise AssertionError(f"calibration: launches {counts}, want {want}")
    by_key = {}
    for r in res["records"]:
        by_key.setdefault(_eta_key(r), []).append(r)
    for key in keys:
        recs = by_key[key]
        row = report["kernel_eta"][key]
        emit("calibration", dict(
            key=key, reps=len(recs),
            mean_us=float(np.mean([r["measured_us"] for r in recs])),
            roofline_us=recs[0]["roofline_us"], eta=row["fitted"],
            eta_ci=row["ci"], route="f32"))
    cfg = get_config(SERVE["arch"])
    workload = Workload(batch=1, prompt_tokens=SERVE["prompt_len"],
                        decode_tokens=STREAM["max_new"],
                        samples=STREAM["samples"])
    routes = {}
    for name, provider in (("analytic", None),
                           ("calibrated",
                            CalibratedSignalProvider(fitted))):
        t0 = time.perf_counter()
        router = stream_router(cfg, workload, provider=provider)
        routes[name] = route_points(router)
        emit("calibration-route", dict(
            profile=name, anneal_s=time.perf_counter() - t0,
            frontier=len(router.frontier), tiers=routes[name]))
    emit("calibration", dict(profile_s=profile_s, fit_s=fit_s,
                             records=res["n_records"],
                             rmse_default=report["rmse_default"],
                             rmse_fitted=report["rmse_fitted"],
                             launches=counts))
    return counts


# ------------------------------------------------------- phase 9: training

def train_setup(cfg, dtype, seed: int, remat: bool = False):
    """A plain-path model (training refuses the kernels: they have no
    backward), its random params from ``seed`` on the card, a fresh AdamW
    state, and the launcher's optimizer config."""
    from repro_torch.models import Model
    from repro_torch.training import AdamWConfig, init_opt_state
    model = Model(cfg, dtype=dtype, device="cuda", use_kernel=False,
                  remat=remat)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    opt_cfg = AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                          total_steps=TRAIN["steps"])
    return model, params, init_opt_state(params), opt_cfg


def train_batches(cfg, dtype, batch: int, seq: int, start: int = 0,
                  device="cuda"):
    """The launcher's markov batches, with its zero frontend inputs."""
    from repro_torch.data import DataConfig, data_iterator
    it = data_iterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  batch_size=batch, kind="markov",
                                  n_codebooks=cfg.n_codebooks),
                       start_step=start, device=device)
    for b in it:
        if cfg.frontend == "vision":
            b["vision_embeds"] = torch.zeros((batch, 4, cfg.d_model),
                                             dtype=dtype, device=device)
        if cfg.cross_attention:
            b["cond_memory"] = torch.zeros(
                (batch, cfg.n_cond_tokens, cfg.d_model), dtype=dtype,
                device=device)
        yield b


def leaves_of(tree) -> list:
    from repro_torch.training.tree import flatten
    return flatten(tree)


class UpdateProbe:
    """Wraps the train step's `adamw_update`. Every call is timed between
    two synchronisations (``update_ms``: the update's share of a step). The
    first call also records which leaves got a nonzero gradient, the
    gradients' devices, and which leaves the update moved. A bf16 leaf
    whose step-1 update (at most lr x (1 + weight decay x max|p|): Adam's
    first step is +-1 an element) is below half the bf16 spacing at its
    smallest |p| cannot move (the norm scales at 1.0); it counts as held,
    not as a fault."""

    def __init__(self, module=None):
        """``module``: the step's module whose ``adamw_update`` to wrap
        (default `repro_torch.training.loop`)."""
        if module is None:
            from repro_torch.training import loop as module
        self.loop, self.real = module, module.adamw_update
        self.report = None
        self.update_ms = []
        module.adamw_update = self

    def __call__(self, cfg, params, grads, state, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if self.report is not None:
            out = self.real(cfg, params, grads, state, **kw)
            torch.cuda.synchronize()
            self.update_ms.append(1e3 * (time.perf_counter() - t))
            return out
        before = [p.clone() for _, p in leaves_of(params)]
        out = self.real(cfg, params, grads, state, **kw)
        lr = float(out[2]["lr"])
        rows = []
        for (path, p), p0, (_, g) in zip(leaves_of(params), before,
                                         leaves_of(grads)):
            moved, held = bool((p != p0).any()), False
            if not moved and p.dtype == torch.bfloat16:
                a = p0.abs()
                smallest = float(torch.where(a > 0, a, a.max()).min())
                bound = lr * (1 + cfg.weight_decay * float(a.max()))
                held = smallest > 0 and bound < 0.5 * 2.0 ** (
                    math.floor(math.log2(smallest)) - 7)
            rows.append(dict(path=path, nonzero=bool((g != 0).any()),
                             moved=moved, held=held, device=g.device.type))
        del before
        self.report = rows
        return out

    def close(self) -> None:
        self.loop.adamw_update = self.real


def train_run(run: str, arch: str, layers: Optional[int], seed: int,
              policy=None) -> tuple:
    """One bf16 training run of ``TRAIN["steps"]`` steps through
    `make_train_step`; fails unless every loss and grad norm is finite,
    every leaf with a nonzero gradient moved at step 1 (or its update was
    below bf16's spacing), params, gradients and moments are on the card,
    the run's 8 batches, scored without a gradient before and after it,
    have a lower mean loss after, and no port kernel launched. (Each step
    trains on a new batch, and over 8 steps at lr <= 1e-3 one step's loss
    moves less than batches differ: musicgen-medium's went from 8.171 at
    step 1 to 8.208 at step 8 on an H100 while the mean over its batches
    fell from 8.139 to 7.747.) With ``policy`` (phase 10) the params and
    moments are DTensors in its placements and each step is
    `make_sharded_train_step`'s on batches in its placements. Returns the
    launch counts and the printed record."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.training import make_train_step
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, params, opt_state, opt_cfg = train_setup(cfg, torch.bfloat16,
                                                    seed)
    data = train_batches(cfg, torch.bfloat16, TRAIN["batch"], TRAIN["seq"])
    batches = [next(data) for _ in range(TRAIN["steps"])]
    if policy is None:
        step_fn = make_train_step(model, opt_cfg)
        inputs, probe_of = batches, None

        def whole(tree):
            return tree
    else:
        from repro_torch.distributed import step as dstep
        params = dstep.shard_params(params, policy)
        opt_state = dstep.init_sharded_opt_state(params)
        step_fn = dstep.make_sharded_train_step(model, opt_cfg, policy)
        inputs = [dstep.shard_batch(b, policy) for b in batches]
        probe_of, whole = dstep, dstep.full_tree
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    probe = UpdateProbe(probe_of)
    losses, norms, step_ms = [], [], []
    try:
        reset_launch_counts()
        with torch.no_grad():
            scored_before = [float(model.loss(whole(params), b))
                             for b in batches]
        for i, batch in enumerate(inputs):
            torch.cuda.synchronize()
            if i == 1:         # steps 2-8: the step-1 check copies every leaf
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        peak = torch.cuda.max_memory_allocated() / 1e9
        with torch.no_grad():
            scored_after = [float(model.loss(whole(params), b))
                            for b in batches]
        counts = launch_counts()
    finally:
        probe.close()
    rows = probe.report
    bad = []
    if not all(math.isfinite(x) for x in losses + norms):
        bad.append(f"losses {losses}, grad norms {norms}")
    stuck = [r["path"] for r in rows
             if r["nonzero"] and not r["moved"] and not r["held"]]
    if stuck:
        bad.append(f"leaves with a gradient that did not move: {stuck}")
    places = {r["device"] for r in rows} | {
        t.device.type for tree in (params, opt_state)
        for _, t in leaves_of(tree)}
    if places != {"cuda"}:
        bad.append(f"tensors on {sorted(places)}")
    mean_before = float(np.mean(scored_before))
    mean_after = float(np.mean(scored_after))
    if not mean_after < mean_before:
        bad.append(f"the run's batches score {mean_after} after it, not "
                   f"below {mean_before} before it")
    if any(counts.values()):
        bad.append(f"port kernels launched in training: {counts}")
    med = float(np.median(step_ms[1:]))
    tokens = TRAIN["batch"] * TRAIN["seq"]
    record = dict(
        run=run, arch=cfg.name, layers=cfg.n_layers, dtype="bfloat16",
        params=model.param_count(), init_s=init_s, steps=TRAIN["steps"],
        batch=TRAIN["batch"], seq=TRAIN["seq"], step_ms=step_ms,
        step_ms_median_2_8=med, tokens_per_s=tokens / (med / 1e3),
        update_ms=probe.update_ms,
        update_ms_median_2_8=float(np.median(probe.update_ms)),
        peak_gb_steps_2_8=peak, first_loss=losses[0], last_loss=losses[-1],
        losses=losses, grad_norms=norms, scored_before=scored_before,
        scored_after=scored_after, mean_scored_before=mean_before,
        mean_scored_after=mean_after,
        leaves=len(rows), leaves_with_grad=sum(r["nonzero"] for r in rows),
        leaves_moved=sum(r["moved"] for r in rows),
        leaves_held_by_bf16=[r["path"] for r in rows
                             if r["nonzero"] and not r["moved"]],
        launches=counts)
    emit("train", record)
    if bad:
        raise AssertionError(f"{run}: " + "; ".join(bad))
    del params, opt_state, model, step_fn, probe, inputs
    torch.cuda.empty_cache()
    return counts, record


def train_bf16(seed: int) -> tuple:
    """Phase 9's bf16 runs (`TRAIN_RUNS`), each freed before the next.
    Returns their launch counts and records, by run."""
    runs = {run: train_run(run, arch, layers, seed)
            for run, (arch, layers) in TRAIN_RUNS.items()}
    return ({run: c for run, (c, _) in runs.items()},
            {run: r for run, (_, r) in runs.items()})


def f32_cfg(arch: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=TRAIN_F32["layers"])


def grads_of(model, params, batch) -> tuple:
    """The loss and every leaf's gradient, by path."""
    from repro_torch.training.loop import value_and_grad
    loss, grads = value_and_grad(model.loss, params, batch)
    return float(loss), dict(leaves_of(grads))


def train_parity(seed: int) -> None:
    """Phase 9, f32 at full width and 2 layers (granite: 2 MoE layers): one
    markov batch of 2 x 32 through the port on the card and on the CPU with
    the same weights. The loss must agree within 1e-4 relative, each
    gradient leaf within 1e-3 x max|g_cpu| + 1e-6, and an AdamW update fed
    the CPU's gradients within 1e-6 of the CPU's."""
    from repro_torch.models import Model
    from repro_torch.training import adamw_update, init_opt_state
    from repro_torch.training.tree import unflatten
    for arch in ("chatglm3-6b", "granite-moe-3b-a800m"):
        cfg = f32_cfg(arch)
        model, params, _, opt_cfg = train_setup(cfg, torch.float32, seed + 2)
        cpu_model = Model(cfg, dtype=torch.float32, device="cpu")
        cpu_params = unflatten(params, [t.cpu() for _, t in
                                        leaves_of(params)])
        batch = next(train_batches(cfg, torch.float32,
                                   TRAIN_F32["parity_batch"],
                                   TRAIN_F32["parity_seq"]))
        t0 = time.perf_counter()
        l_gpu, g_gpu = grads_of(model, params, batch)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        l_cpu, g_cpu = grads_of(cpu_model, cpu_params,
                                {k: v.cpu() for k, v in batch.items()})
        cpu_s = time.perf_counter() - t0
        worst, worst_path = 0.0, None
        for path, gc in g_cpu.items():
            tol = 1e-3 * float(gc.abs().max()) + 1e-6
            err = float((g_gpu[path].cpu() - gc).abs().max())
            if err / tol > worst:
                worst, worst_path = err / tol, path
        # the update: both sides fed the CPU's gradients
        grads_cpu = unflatten(cpu_params, [g_cpu[p] for p, _ in
                                           leaves_of(cpu_params)])
        grads_gpu = unflatten(params, [g_cpu[p].cuda() for p, _ in
                                       leaves_of(params)])
        adamw_update(opt_cfg, params, grads_gpu, init_opt_state(params))
        adamw_update(opt_cfg, cpu_params, grads_cpu,
                     init_opt_state(cpu_params))
        upd_err = max(float((p.cpu() - q).abs().max()) for (_, p), (_, q) in
                      zip(leaves_of(params), leaves_of(cpu_params)))
        loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        emit("train-parity-f32", dict(
            arch=cfg.name, layers=cfg.n_layers, batch=TRAIN_F32[
                "parity_batch"], seq=TRAIN_F32["parity_seq"],
            loss_card=l_gpu, loss_cpu=l_cpu, loss_rel_diff=loss_rel,
            worst_grad_err_over_tol=worst, worst_grad_leaf=worst_path,
            update_max_abs_diff=upd_err, card_grad_s=gpu_s,
            cpu_grad_s=cpu_s))
        if loss_rel > 1e-4 or worst > 1 or upd_err > 1e-6:
            raise AssertionError(
                f"{cfg.name} f32 card vs CPU: loss {l_gpu} vs {l_cpu}, "
                f"gradient {worst_path} at {worst} x its tolerance, update "
                f"{upd_err}")
        del params, cpu_params, g_gpu, g_cpu, grads_cpu, grads_gpu, model
        torch.cuda.empty_cache()


def max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for (_, x), (_, y) in
               zip(leaves_of(a), leaves_of(b)))


def train_invariants(seed: int) -> None:
    """Phase 9, f32 chatglm3-6b at full width and 2 layers, the launcher's
    batches: microbatches=4 equals 1 (loss within 1e-5 relative, params
    within 2e-4 after a step), remat equals no remat (loss within 1e-6,
    gradients within 1e-5), 4 steps, a checkpoint and a restore, then 4
    more, equal 8 uninterrupted steps (params within 1e-5), and a bf16
    save and restore is bit-equal."""
    import tempfile
    from repro_torch.models import Model
    from repro_torch.training import (make_train_step, opt_state_shapes,
                                      restore_checkpoint, save_checkpoint)
    cfg = f32_cfg("chatglm3-6b")
    B, S = TRAIN["batch"], TRAIN["seq"]
    out = {}
    # microbatches
    batch = next(train_batches(cfg, torch.float32, B, S))
    runs = {}
    for mb in (1, 4):
        model, params, opt, opt_cfg = train_setup(cfg, torch.float32, seed)
        params, _, m = make_train_step(model, opt_cfg, microbatches=mb)(
            params, opt, batch)
        runs[mb] = (float(m["loss"]), params)
        del opt
    out["microbatch_loss_rel"] = abs(runs[4][0] - runs[1][0]) / abs(
        runs[1][0])
    out["microbatch_param_diff"] = max_diff(runs[4][1], runs[1][1])
    del runs
    torch.cuda.empty_cache()
    # remat
    model, params, _, _ = train_setup(cfg, torch.float32, seed)
    remat_model = Model(cfg, dtype=torch.float32, device="cuda", remat=True)
    l0, g0 = grads_of(model, params, batch)
    l1, g1 = grads_of(remat_model, params, batch)
    out["remat_loss_diff"] = abs(l1 - l0)
    out["remat_grad_diff"] = max(float((g1[p] - g).abs().max())
                                 for p, g in g0.items())
    del g0, g1, params
    torch.cuda.empty_cache()
    # checkpoint resume
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        model, p8, o8, opt_cfg = train_setup(cfg, torch.float32, seed)
        step_fn = make_train_step(model, opt_cfg)
        data = train_batches(cfg, torch.float32, B, S)
        for i in range(TRAIN["steps"]):
            p8, o8, _ = step_fn(p8, o8, next(data))
            if i == 3:
                t1 = time.perf_counter()
                path = save_checkpoint(d, 4, p8, o8)
                out["save_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        shapes = model.param_shapes()
        step, p4, o4 = restore_checkpoint(path, shapes,
                                          opt_state_shapes(shapes),
                                          device="cuda")
        out["restore_s"] = time.perf_counter() - t1
        data = train_batches(cfg, torch.float32, B, S, start=step)
        for _ in range(TRAIN["steps"] - step):
            p4, o4, _ = step_fn(p4, o4, next(data))
        out["resume_param_diff"] = max_diff(p4, p8)
        out["resume_steps"] = [int(o4["step"]), int(o8["step"])]
        del p4, o4, p8, o8
        torch.cuda.empty_cache()
        # bf16 save and restore
        bmodel = Model(cfg, dtype=torch.bfloat16, device="cuda")
        bp = bmodel.init(torch.Generator(device="cuda").manual_seed(seed))
        path = save_checkpoint(d, 1, bp)
        _, rp, _ = restore_checkpoint(path, bmodel.param_shapes(),
                                      device="cuda")
        out["bf16_bit_equal"] = all(
            x.dtype == torch.bfloat16 and torch.equal(
                x.view(torch.int16), y.view(torch.int16))
            for (_, x), (_, y) in zip(leaves_of(rp), leaves_of(bp)))
        out["wall_s"] = time.perf_counter() - t0
        del bp, rp
    torch.cuda.empty_cache()
    emit("train-invariants-f32", dict(arch=cfg.name, layers=cfg.n_layers,
                                      batch=B, seq=S, **out))
    bad = [k for k, lim in (("microbatch_loss_rel", 1e-5),
                            ("microbatch_param_diff", 2e-4),
                            ("remat_loss_diff", 1e-6),
                            ("remat_grad_diff", 1e-5),
                            ("resume_param_diff", 1e-5)) if out[k] > lim]
    if out["resume_steps"] != [TRAIN["steps"]] * 2:
        bad.append("resume_steps")
    if not out["bf16_bit_equal"]:
        bad.append("bf16_bit_equal")
    if bad:
        raise AssertionError(f"phase 9 f32 invariants failed: {bad}")


def train_launcher() -> None:
    """Phase 9: ``python -m repro_torch.launch.train --arch mamba2-370m
    --steps 3`` on the card as a subprocess; it must exit 0, print its step
    lines and write a checkpoint that `restore_checkpoint` reads."""
    import os
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.training import restore_checkpoint
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "mamba2-370m", "--steps", "3", "--checkpoint-dir", d],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        lines = res.stdout.splitlines()
        steps = [line for line in lines if line.startswith("step ")]
        emit("train-launcher", dict(rc=res.returncode, wall_s=wall,
                                    lines=lines[-6:],
                                    stderr=res.stderr[-2000:]))
        if res.returncode != 0 or [s.split()[1] for s in steps] != ["0",
                                                                     "2"]:
            raise AssertionError(f"launch.train exited {res.returncode}: "
                                 f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
        path = lines[-1].split("checkpoint: ")[1]
        shapes = Model(get_config("mamba2-370m"), device="cuda").param_shapes()
        step, params, _ = restore_checkpoint(path, shapes, device="cuda")
        if step != 3 or not all(bool(torch.isfinite(t.float()).all())
                                for _, t in leaves_of(params)):
            raise AssertionError(f"launch.train's checkpoint {path}: step "
                                 f"{step} or non-finite params")
        del params
    torch.cuda.empty_cache()


def training(seed: int) -> tuple:
    """Phase 9. Returns the launch counts of the bf16 runs and of the f32
    checks (each must be all zeros), and the bf16 runs' records."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    counts, records = train_bf16(seed)
    reset_launch_counts()
    train_parity(seed)
    train_invariants(seed)
    c = launch_counts()
    if any(c.values()):
        raise AssertionError(f"phase 9 f32 checks launched kernels: {c}")
    counts["train-f32-checks"] = c
    train_launcher()
    return counts, records


# -------------------------------------------------- phase 10: distributed

def dist_world():
    """Joins a world-1 NCCL process group (127.0.0.1, a free port) and
    returns its (1, 1) debug mesh over ("data", "model")."""
    import socket
    from repro_torch.launch.mesh import init_world, make_debug_mesh
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_world(0, 1, f"tcp://127.0.0.1:{port}", "cuda")
    return make_debug_mesh(1, 1, device="cuda")


def placed(tree, want) -> bool:
    """Every leaf a DTensor on the card in ``want``'s placements."""
    from torch.distributed.tensor import DTensor
    got = leaves_of(tree)
    return len(got) == len(leaves_of(want)) and all(
        isinstance(t, DTensor) and t.device.type == "cuda"
        and tuple(t.placements) == pl
        for (_, t), (_, pl) in zip(got, leaves_of(want)))


def dist_parity(seed: int, policy, arch: str, lr: float) -> dict:
    """Phase 10, f32 at full width and 2 layers: three sharded steps
    against three unsharded steps on the same weights and batches, at
    ``lr``; losses within 1e-5 relative, params within 1e-5, params and
    moments DTensors in the policy's placements. Returns the launch counts
    (all must be 0)."""
    from repro_torch.distributed.step import (full_tree,
                                              init_sharded_opt_state,
                                              make_sharded_train_step,
                                              shard_batch, shard_params)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.training import make_train_step
    cfg = f32_cfg(arch)
    model, params, opt, opt_cfg = train_setup(cfg, torch.float32, seed)
    opt_cfg = dataclasses.replace(opt_cfg, lr=lr)
    data = train_batches(cfg, torch.float32, TRAIN["batch"], TRAIN["seq"])
    batches = [next(data) for _ in range(DIST["parity_steps"])]
    if cfg.cross_attention:
        # a random memory: the launcher's zeros give the cross-attention's
        # projections no gradient
        g = torch.Generator(device="cuda").manual_seed(seed)
        for b in batches:
            b["cond_memory"] = torch.randn(b["cond_memory"].shape,
                                           generator=g, device="cuda")
    reset_launch_counts()
    sp = shard_params(params, policy)
    so = init_sharded_opt_state(sp)
    step = make_sharded_train_step(model, opt_cfg, policy)
    t0 = time.perf_counter()
    s_loss = []
    for b in batches:
        sp, so, m = step(sp, so, shard_batch(b, policy))
        s_loss.append(float(m["loss"]))
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    u_step = make_train_step(model, opt_cfg)
    up = params                  # shard_params copied what it kept
    u_loss = []
    for b in batches:
        up, opt, m = u_step(up, opt, b)
        u_loss.append(float(m["loss"]))
    counts = launch_counts()
    want = policy.param_shardings(up)
    placements_ok = (placed(sp, want) and placed(so["m"], want)
                     and placed(so["v"], want)
                     and tuple(so["step"].placements) == policy.scalar())
    diff = max_diff(full_tree(sp), up)
    rel = max(abs(a - b) / abs(b) for a, b in zip(s_loss, u_loss))
    emit("dist-parity-f32", dict(
        arch=cfg.name, layers=cfg.n_layers, lr=lr,
        steps=DIST["parity_steps"],
        batch=TRAIN["batch"], seq=TRAIN["seq"], sharded_losses=s_loss,
        unsharded_losses=u_loss, loss_rel_diff=rel, param_max_diff=diff,
        placements_ok=placements_ok, sharded_s=sharded_s, launches=counts))
    if rel > 1e-5 or diff > 1e-5 or not placements_ok or any(
            counts.values()):
        raise AssertionError(
            f"phase 10 f32 parity of {arch}: loss rel {rel}, params {diff}, "
            f"placements {placements_ok}, launches {counts}")
    del sp, so, up, opt, model
    torch.cuda.empty_cache()
    return counts


def dist_forward(seed: int, policy, arch: str) -> dict:
    """Phase 10, f32 at full width and 2 layers: the sharded prefill
    (``make_sharded_forward``, 4 x 32 tokens) and a decode step against the
    unsharded forward on the same weights and a whole cache; the logits
    and the cache (gathered) within ``DIST["forward_tol"]``, the cache in
    the policy's placements. Musicgen keeps its cross K/V cache (its
    decode step reads it, with no memory). Returns the launch counts (all
    must be 0)."""
    from repro_torch.distributed.step import (full_tree, make_sharded_forward,
                                              shard_batch, shard_params,
                                              sharded_cache)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    cfg = f32_cfg(arch)
    if cfg.cross_attention:
        cfg = cfg.with_overrides(cross_kv_cache=True)
    model = Model(cfg, dtype=torch.float32, device="cuda", use_kernel=False)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    rows, n = 4, 32
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()

    def tokens(s):
        return torch.randint(0, cfg.vocab_size, (rows, s) + books,
                             generator=g, device="cuda", dtype=torch.int32)
    prompt = {"tokens": tokens(n)}
    if cfg.cross_attention:
        prompt["cond_memory"] = torch.randn(rows, cfg.n_cond_tokens,
                                            cfg.d_model, generator=g,
                                            device="cuda")
    step = {"tokens": tokens(1),
            "positions": torch.full((rows, 1), n, dtype=torch.int32,
                                    device="cuda")}
    cache = model.init_cache(rows, n + 16)
    reset_launch_counts()
    sp = shard_params(params, policy)
    sc = sharded_cache(cache, policy)
    t0 = time.perf_counter()
    s1, sc = make_sharded_forward(model, policy, -1)(
        sp, shard_batch(prompt, policy), sc)
    s2, sc = make_sharded_forward(model, policy, 0)(
        sp, shard_batch(step, policy), sc)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    with torch.no_grad():
        u1 = model.forward(params, prompt, cache)[0][:, -1]
        u2 = model.forward(params, step, cache)[0][:, 0]
    counts = launch_counts()
    logits = max(float((a.full_tensor() - b).abs().max())
                 for a, b in ((s1, u1), (s2, u2)))
    cache_diff = max_diff(full_tree(sc), cache)
    placements_ok = placed(sc, policy.cache_shardings(cache))
    emit("dist-forward-f32", dict(
        arch=cfg.name, layers=cfg.n_layers, rows=rows, prompt=n,
        cross_kv_cache=cfg.cross_kv_cache, logits_max_diff=logits,
        cache_max_diff=cache_diff, placements_ok=placements_ok,
        sharded_s=sharded_s, launches=counts))
    if logits > DIST["forward_tol"] or cache_diff > DIST["forward_tol"] \
            or not placements_ok or any(counts.values()):
        raise AssertionError(
            f"phase 10 sharded forward of {arch}: logits {logits}, cache "
            f"{cache_diff}, placements {placements_ok}, launches {counts}")
    del sp, sc, params, cache, model
    torch.cuda.empty_cache()
    return counts


def dist_launcher() -> None:
    """Phase 10: ``launch.train --mesh debug`` needs 4 ranks, one a card;
    on this one card it must exit non-zero and say so."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-370m", "--smoke", "--steps", "3", "--mesh", "debug"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    said = (res.stdout + res.stderr).strip().splitlines()
    emit("dist-launcher", dict(rc=res.returncode, said=said[-3:]))
    text = " ".join(said[-3:])
    if res.returncode == 0 or "4 ranks" not in text or "1 card" not in text:
        raise AssertionError(f"--mesh debug on one card: rc "
                             f"{res.returncode}, {text}")


def dist_dryrun() -> dict:
    """Phase 10: ``launch.dryrun`` for every arch and mesh kind, one
    subprocess each, `DIST["dryrun_jobs"]` at a time, on the host only
    (meta tensors, the fake process group). Fails unless the 80 artifacts
    are there, none with ``error``, each with ``flops > 0`` and its mesh's
    ``n_chips``, and the train_4k artifacts of `DIST`'s ``fit`` archs on
    both meshes show at most their bound times the ideal ``6 * N * tokens
    / n_chips`` (N the active params) and hold under ``fit_gb`` by their
    own accounting; each beside the figures before this slice's mixers
    computed on their shards."""
    import os
    import tempfile
    from repro_torch.configs import ASSIGNED_ARCHS
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    with tempfile.TemporaryDirectory() as d:
        # the deepest archs first: they take longest
        from repro_torch.configs import get_config
        archs = sorted(ASSIGNED_ARCHS, key=lambda a: -get_config(a).n_layers)
        todo = [(a, m) for a in archs for m in ("single", "multi")]
        running, failed, job_s = [], [], {}
        t0 = time.perf_counter()
        while todo or running:
            while todo and len(running) < DIST["dryrun_jobs"]:
                arch, mesh = todo.pop(0)
                log = open(os.path.join(d, f"{arch}__{mesh}.log"), "w")
                proc = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--mesh", mesh, "--out", d],
                    cwd=ROOT, env=env, stdout=log, stderr=log)
                running.append((arch, mesh, proc, log, time.perf_counter()))
            time.sleep(0.5)
            for job in list(running):
                arch, mesh, proc, log, t = job
                if proc.poll() is None:
                    if time.perf_counter() - t > 600:
                        proc.kill()
                    continue
                running.remove(job)
                log.close()
                job_s[f"{arch}/{mesh}"] = time.perf_counter() - t
                if proc.returncode != 0:
                    failed.append((arch, mesh, proc.returncode, Path(
                        log.name).read_text()[-1000:]))
        wall = time.perf_counter() - t0
        arts = [json.loads(p.read_text()) for p in Path(d).glob("*.json")]
    bad = [(a.get("arch"), a.get("shape"), a.get("mesh")) for a in arts
           if "error" in a or not a["cost_analysis"].get("flops", 0) > 0
           or a["n_chips"] != (512 if a["mesh"] == "multi" else 256)]
    fit = {}
    for a in arts:
        if "error" in a or a["shape"] != "train_4k" or \
                a["arch"] not in DIST["fit"]:
            continue
        bound, (flops0, single0, multi0) = DIST["fit"][a["arch"]]
        fit[f"{a['arch']}/{a['mesh']}"] = dict(
            flops_per_6NT=a["cost_analysis"]["flops_per_6NT"],
            flops_bound=bound, flops_per_6NT_before=flops0,
            held_gb=a["memory_analysis"]["held_bytes"] / 1e9,
            held_gb_before=single0 if a["mesh"] == "single" else multi0,
            saved_gb=a["memory_analysis"]["saved_bytes"] / 1e9,
            gathered_gb=a["memory_analysis"]["gathered_param_bytes"] / 1e9)
    bad += [k for k, v in fit.items()
            if v["flops_per_6NT"] > v["flops_bound"]
            or not v["held_gb"] < DIST["fit_gb"]]
    if len(fit) != 2 * len(DIST["fit"]):
        bad.append(f"train_4k fit records: {sorted(fit)}")
    out = dict(host_only=True, artifacts=len(arts), bad=bad, failed=failed,
               wall_s=wall, jobs=DIST["dryrun_jobs"], job_s=job_s,
               trace_s=sum(a.get("lower_s", 0) for a in arts if
                           "error" not in a), train_4k_fit=fit)
    emit("dist-dryrun", out)
    if len(arts) != 80 or bad or failed:
        raise AssertionError(f"phase 10 dry-run: {len(arts)} artifacts, "
                             f"bad {bad}, failed {failed}")
    return out


def distributed(seed: int, train_records: dict) -> dict:
    """Phase 10. Returns the launch counts of the sharded runs (all 0)."""
    import torch.distributed as dist
    from repro_torch.distributed import ShardingPolicy
    mesh = dist_world()
    try:
        policy = ShardingPolicy(mesh)
        counts = {f"dist-f32-{arch}": dist_parity(seed + 3, policy, arch, lr)
                  for arch, lr in DIST["parity"].items()}
        counts.update({f"dist-fwd-{arch}": dist_forward(seed + 5, policy,
                                                        arch)
                       for arch in DIST["forward"]})
        c, rec = train_run("dist-train-granite", DIST["arch"], None, seed,
                           policy=policy)
        counts["dist-train-granite"] = c
        base = train_records["train-granite"]
        over = rec["peak_gb_steps_2_8"] - base["peak_gb_steps_2_8"]
        emit("dist-vs-phase9", dict(
            arch=DIST["arch"], mesh=dict(zip(mesh.mesh_dim_names,
                                             mesh.shape)),
            card=card_line(),
            sharded_step_ms_median_2_8=rec["step_ms_median_2_8"],
            unsharded_step_ms_median_2_8=base["step_ms_median_2_8"],
            sharded_peak_gb=rec["peak_gb_steps_2_8"],
            unsharded_peak_gb=base["peak_gb_steps_2_8"],
            peak_over_gb=over,
            sharded_update_ms=rec["update_ms_median_2_8"],
            unsharded_update_ms=base["update_ms_median_2_8"]))
        if over > DIST["peak_over_gb"]:
            raise AssertionError(
                f"phase 10: the sharded bf16 step's peak is {over} GB above "
                f"phase 9's (at most {DIST['peak_over_gb']})")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    dist_launcher()
    dist_dryrun()
    return counts


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
    stream_counts, phase5 = serve_stream(args.seed)
    counts.update(stream_counts)
    t_phase = time.perf_counter()
    counts.update(spec_bf16(args.seed, phase5))
    spec_parity(args.seed)
    counts.update(spec_moe(args.seed))
    emit("spec", dict(phase_s=time.perf_counter() - t_phase))
    t_phase = time.perf_counter()
    counts["calibration"] = calibration_loop(args.seed)
    emit("calibration", dict(phase_s=time.perf_counter() - t_phase))
    t_phase = time.perf_counter()
    counts.update(serve_archs(args.seed))
    parity_archs(args.seed)
    emit("archs", dict(phase_s=time.perf_counter() - t_phase))
    t_phase = time.perf_counter()
    train_counts, train_records = training(args.seed)
    counts.update(train_counts)
    emit("training", dict(phase_s=time.perf_counter() - t_phase))
    t_phase = time.perf_counter()
    counts.update(distributed(args.seed, train_records))
    emit("distributed", dict(phase_s=time.perf_counter() - t_phase))

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
        if name == "paged_decode_attention":
            # the grouped path's second kernel, launched beside the first
            by_run = {run: c.get("paged_decode_attention_prefix", 0)
                      for run, c in counts.items()}
            entry.update(prefix_launches=sum(by_run.values()),
                         prefix_launches_by_run=by_run)
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
