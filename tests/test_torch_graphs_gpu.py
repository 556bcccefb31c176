"""The decode step as a CUDA graph on the card (`repro_torch.serving.graphs`):
a graphed serve against the eager one on reduced configs of every arch and
format the serves of ``chip_smoke.py`` run (bf16 weights, kernels on). Marked
``gpu``: they skip without a CUDA device. Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_graphs_gpu.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention.ops import \
    decode_attention_cache  # noqa: E402
from repro_torch.kernels.dequant_matmul.ops import \
    dequant_matmul_int4  # noqa: E402
from repro_torch.launch.profile_serve import profile_summary  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.quant.quantize import (  # noqa: E402
    quantize_int4, quantize_model)
from repro_torch.serving import ExecutionBackend, GumbelNoise  # noqa: E402

pytestmark = pytest.mark.gpu

PAGED = dict(kv_blocks=64, kv_block_size=16)
NEW = 8            # 7 decode steps: one eager, a capture and 6 replays
#: case -> (arch, layers (None: the reduced config's), backend kwargs,
#: weight format)
CASES = {
    "chatglm-dense": ("chatglm3-6b", None, {}, None),
    "chatglm-paged": ("chatglm3-6b", None, PAGED, None),
    "int8-paged": ("chatglm3-6b", None, PAGED, "int8"),
    "int4-paged": ("chatglm3-6b", None, PAGED, "int4"),
    "int4-kv8-paged": ("chatglm3-6b", None, dict(PAGED, kv_format="int8"),
                       "int4"),
    "granite-dense": ("granite-moe-3b-a800m", None, {}, None),
    "granite-paged": ("granite-moe-3b-a800m", None, PAGED, None),
    "deepseek-dense": ("deepseek-v2-lite-16b", None, {}, None),
    "mamba2-dense": ("mamba2-370m", None, {}, None),
    "jamba-dense": ("jamba-v0.1-52b", 8, {}, None),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(case):
    arch, layers, kw, fmt = CASES[case]
    cfg = get_config(arch).reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = Model(cfg, dtype=torch.bfloat16, device="cuda", use_kernel=True)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    if fmt is not None:
        params = quantize_model(params, fmt, 32)
    return model, params, kw


def _prompts(cfg, n=3, plen=40):
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32)
            for _ in range(n)]


def _serve(model, params, kw, graphs, between=None):
    """One batch of 3 prompts x 4 samples, temperature 0.8, drained;
    ``between(step)`` runs after each decode step. Returns (per-step
    tokens, per-step logprobs, the cache after the last step, launch
    counts, graph stats)."""
    be = ExecutionBackend(model, params, cuda_graphs=graphs, **kw)
    noise = GumbelNoise(torch.Generator(device="cuda").manual_seed(3))
    kernels.reset_launch_counts()
    h = be.start_batch(_prompts(model.cfg), 4, NEW, 0.8, noise)
    while be.decode_step(h):
        if between is not None:
            between(h.step)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    cache = [t.clone() for t in _leaves(h.cache)]
    toks, lps = np.stack(h.out_toks), np.stack(h.out_lps)
    be.finalize(h)
    return toks, lps, cache, counts, be.graph_stats


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_serve_equals_the_eager_serve(cuda, case):
    """Tokens and logprobs of every step equal (max abs logprob difference
    printed; 0 expected: the same kernels on the same inputs), the caches
    (KV, SSM state, conv tail) equal after the last step, one capture and
    NEW - 2 replays, and the launch counts of the eager serve."""
    model, params, kw = _model(case)
    eager = _serve(model, params, kw, graphs=False)
    graphed = _serve(model, params, kw, graphs=True)
    diff = float(np.abs(graphed[1] - eager[1]).max())
    print(f"[graphs-vs-eager] {case}: max logprob diff {diff}")
    np.testing.assert_array_equal(graphed[0], eager[0])
    assert diff == 0.0
    assert len(graphed[2]) == len(eager[2])
    for a, b in zip(graphed[2], eager[2]):
        assert torch.equal(a, b)
    assert graphed[3] == eager[3]
    assert (eager[4].captures, eager[4].replays) == (0, 0)
    assert (graphed[4].captures, graphed[4].replays) == (1, NEW - 2)
    assert graphed[4].pool_bytes > 0


def test_a_larger_eager_call_between_replays_does_not_corrupt_the_next(cuda):
    """After each replay, calls at larger shapes grow the decode-attention
    and dequant-matmul workspaces the graph captured, and fresh allocations
    filled with NaN take whatever the allocator freed: the graphed serve
    still equals the eager one."""
    model, params, kw = _model("int4-paged")
    g = torch.Generator(device="cuda").manual_seed(9)
    junk = []

    def grow(step):
        # more merge counters and partials than any call before, at every
        # step: each call replaces the workspace the last one left
        B, W, H, Hkv, D = 128 + 32 * step, 512, 16, 8, 64
        bf = torch.bfloat16
        q = torch.randn((B, 1, H, D), generator=g, device="cuda").to(bf)
        kc = torch.randn((B, W, Hkv, D), generator=g, device="cuda").to(bf)
        pos = torch.arange(W, dtype=torch.int32,
                           device="cuda").repeat(B, 1)
        decode_attention_cache(q, kc, kc.clone(), pos,
                               torch.full((B,), W - 1, dtype=torch.int32,
                                          device="cuda"))
        w = torch.randn((4096, 2048 * step), generator=g, device="cuda")
        x = torch.randn((64, 4096), generator=g, device="cuda").to(bf)
        dequant_matmul_int4(x, *quantize_int4(w, 32))
        del q, kc, pos, w, x
        torch.cuda.empty_cache()
        junk.append(torch.full((1 << 26,), float("nan"), device="cuda"))

    eager = _serve(model, params, kw, graphs=False)
    graphed = _serve(model, params, kw, graphs=True, between=grow)
    np.testing.assert_array_equal(graphed[0], eager[0])
    np.testing.assert_array_equal(graphed[1], eager[1])


def test_a_capture_that_fails_raises(cuda):
    """A host synchronisation inside the step is refused by the capture:
    the decode step raises, and nothing carries on eagerly."""
    model, params, kw = _model("chatglm-dense")
    be = ExecutionBackend(model, params)
    forward = model.forward

    def syncing(*a, **k):
        torch.cuda.synchronize()
        return forward(*a, **k)

    model.forward = syncing
    try:
        h = be.start_batch(_prompts(model.cfg), 2, NEW, 0.0, None)
        assert be.decode_step(h)                # step 1: eager, may sync
        with pytest.raises(RuntimeError):
            be.decode_step(h)
        assert h.graph is None and h.step == 2
        be.release(h)
    finally:
        del model.forward
    torch.cuda.synchronize()


def test_profile_attributes_replayed_kernels_by_name(cuda):
    """`profile_summary` over a graphed serve counts each port kernel's
    launches as the wrappers' counts do, replays included."""
    model, params, kw = _model("granite-paged")
    _serve(model, params, kw, graphs=True)                 # warm
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, _, _, counts, stats = _serve(model, params, kw, graphs=True)
    assert stats.replays == NEW - 2
    port = profile_summary(prof, 1.0)["port_kernels"]
    for src, names in (("decode_attention", ("paged_decode_attention",)),
                       ("moe_gemm", ("moe_gemm",)),
                       ("flash_attention", ("flash_attention",))):
        assert port[src]["count"] == sum(counts[n] for n in names), src
