"""The decode step as a CUDA graph on the card (`repro_torch.serving.graphs`):
a graphed serve against the eager one on reduced configs of every arch and
format the serves of ``chip_smoke.py`` run (bf16 weights, kernels on), and
two rounds on the resident prefix pool, where one graph serves both. Marked
``gpu``: they skip without a CUDA device. Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_graphs_gpu.py
"""
import dataclasses
import gc

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
from repro_torch.serving.graphs import StaticDecodeStep  # noqa: E402

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
    "musicgen-dense": ("musicgen-medium", None, {}, None),
    "musicgen-xkv-dense": ("musicgen-medium", None, {}, None),
    "qwen2-vl-dense": ("qwen2-vl-7b", None, {}, None),
    "qwen2-vl-paged": ("qwen2-vl-7b", None, PAGED, None),
    "window-dense": ("chatglm3-6b", None, {}, None),
}
#: case -> config fields it replaces: the cross K/V cache; a window of 16
#: slots, which the 40-token prompts wrap
OVERRIDES = {"musicgen-xkv-dense": dict(cross_kv_cache=True),
             "window-dense": dict(attn_window=16)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(case):
    arch, layers, kw, fmt = CASES[case]
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              **OVERRIDES.get(case, {}))
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = Model(cfg, dtype=torch.bfloat16, device="cuda", use_kernel=True)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    if fmt is not None:
        params = quantize_model(params, fmt, 32)
    return model, params, kw


def _prompts(cfg, n=3, plen=40):
    """``n`` prompts, (plen, K) with K codebooks."""
    rng = np.random.default_rng(1)
    tail = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    return [rng.integers(0, cfg.vocab_size, (plen,) + tail).astype(np.int32)
            for _ in range(n)]


def _extras(cfg, n=3):
    """The frontends' stub inputs, random: 4 vision embeddings, or 8 rows
    of conditioning memory, a prompt."""
    rng = np.random.default_rng(2)
    if cfg.frontend == "vision":
        return {"vision_embeds": (rng.standard_normal((n, 4, cfg.d_model))
                                  * 0.1).astype(np.float32)}
    if cfg.cross_attention:
        return {"cond_memory": (rng.standard_normal((n, 8, cfg.d_model))
                                * 0.1).astype(np.float32)}
    return {}


def _serve(model, params, kw, graphs, between=None, n=3):
    """One batch of ``n`` prompts x 4 samples, temperature 0.8, drained;
    ``between(step)`` runs after each decode step. Returns (per-step
    tokens, per-step logprobs, the cache after the last step, launch
    counts, graph stats)."""
    be = ExecutionBackend(model, params, cuda_graphs=graphs, **kw)
    noise = GumbelNoise(torch.Generator(device="cuda").manual_seed(3))
    kernels.reset_launch_counts()
    h = be.start_batch(_prompts(model.cfg, n), 4, NEW, 0.8, noise,
                       _extras(model.cfg, n))
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


@pytest.mark.parametrize("case", ["chatglm-dense", "chatglm-paged",
                                  "int4-kv8-paged", "granite-paged",
                                  "mamba2-dense"])
def test_a_batch_on_a_retired_arena_equals_an_eager_one(cuda, case):
    """A second batch of one shape, at another temperature, prefills into
    the first's cache arena and replays its graph from its first decode
    step (one capture for both); its tokens and logprobs equal a fresh
    backend's eager serve of it, bit for bit."""
    model, params, kw = _model(case)

    def serve(be, seed, temperature):
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, model.cfg.vocab_size, (40,)).astype(
            np.int32) for _ in range(3)]
        noise = GumbelNoise(torch.Generator(device="cuda").manual_seed(seed))
        h = be.start_batch(prompts, 4, NEW, temperature, noise)
        while be.decode_step(h):
            pass
        out = np.stack(h.out_toks), np.stack(h.out_lps)
        be.finalize(h)
        return out

    be = ExecutionBackend(model, params, **kw)
    serve(be, 5, 0.8)
    second = serve(be, 6, 1.3)
    eager = serve(ExecutionBackend(model, params, cuda_graphs=False, **kw),
                  6, 1.3)
    np.testing.assert_array_equal(second[0], eager[0])
    np.testing.assert_array_equal(second[1], eager[1])
    st = be.graph_stats
    assert (st.captures, st.replays) == (1, (NEW - 2) + (NEW - 1))


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
    launches as the wrappers' counts do, replays included; a grouped paged
    call (8 prompts x 4 samples: 32 rows x 4 kv heads, each prompt's two
    full blocks shared) launches the prefix kernel besides the per-row
    one."""
    model, params, kw = _model("granite-paged")
    _serve(model, params, kw, graphs=True, n=8)            # warm
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, _, _, counts, stats = _serve(model, params, kw, graphs=True, n=8)
    assert stats.replays == NEW - 2
    port = profile_summary(prof, 1.0)["port_kernels"]
    by_kernel = port["decode_attention"]["by_kernel"]
    assert by_kernel["paged_decode_attention_split_kernel"]["count"] == \
        counts["paged_decode_attention"]
    assert by_kernel["paged_decode_attention_prefix_kernel"]["count"] == \
        counts["paged_decode_attention_prefix"] > 0
    for src, names in (
            ("decode_attention", ("paged_decode_attention",
                                  "paged_decode_attention_prefix")),
            ("moe_gemm", ("moe_gemm",)),
            ("flash_attention", ("flash_attention",))):
        assert port[src]["count"] == sum(counts[n] for n in names), src


@pytest.mark.parametrize("chunk", [None, 16])
def test_pooled_graphed_rounds_equal_the_eager_rounds(cuda, chunk):
    """Two rounds of 3 prompts x 4 samples on one resident prefix pool (a
    shared 32-token head and 8 tokens of each prompt's own; the second
    round hits the head's 2 blocks a prompt), one-shot or in slices of 16
    tokens: one graph, captured in the first round and replayed from the
    second round's first decode step, gives the eager rounds' tokens,
    logprobs, cache and launch counts bit for bit."""
    model, params, _ = _model("chatglm-paged")
    rng = np.random.default_rng(4)
    v = model.cfg.vocab_size
    head = rng.integers(0, v, 32).astype(np.int32)
    rounds = [[np.concatenate([head, rng.integers(0, v, 8).astype(np.int32)])
               for _ in range(3)] for _ in range(2)]
    out = {}
    for graphs in (False, True):
        be = ExecutionBackend(model, params, cuda_graphs=graphs, kv_blocks=64,
                              kv_block_size=16, kv_pool=True,
                              prefill_chunk=chunk)
        kernels.reset_launch_counts()
        steps = []
        for r, prompts in enumerate(rounds):
            noise = GumbelNoise(torch.Generator(device="cuda").manual_seed(r))
            h = be.start_batch(prompts, 4, NEW, 0.8, noise)
            while be.decode_step(h):
                pass
            steps.append((np.stack(h.out_toks), np.stack(h.out_lps),
                          h.pool_hit_blocks))
            be.finalize(h)
        torch.cuda.synchronize()
        out[graphs] = (steps, [t.clone() for t in _leaves(be._pool_cache)],
                       kernels.launch_counts(), be.graph_stats)
    (es, ec, en, est), (gs, gc, gn, gst) = out[False], out[True]
    for (et, el, eh), (gt, gl, gh) in zip(es, gs):
        np.testing.assert_array_equal(gt, et)
        np.testing.assert_array_equal(gl, el)
        assert gh == eh
    assert [s[2] for s in gs] == [0, 6]
    for a, b in zip(gc, ec):
        assert torch.equal(a, b)
    assert gn == en and gn["flash_attention"] == 0
    assert (est.captures, est.replays) == (0, 0)
    assert (gst.captures, gst.replays) == (1, 2 * NEW - 3)


def test_no_automatic_garbage_collection_inside_a_capture(cuda, monkeypatch):
    """A collection inside a capture could destroy a graph that only a
    reference cycle held, which invalidates the capture: the capture turns
    automatic collection off, and back on after it."""
    model, params, kw = _model("chatglm-paged")
    seen = []
    body = StaticDecodeStep.__call__

    def call(self):
        seen.append((torch.cuda.is_current_stream_capturing(),
                     gc.isenabled()))
        return body(self)

    monkeypatch.setattr(StaticDecodeStep, "__call__", call)
    _serve(model, params, kw, graphs=True)
    assert seen == [(True, False)] and gc.isenabled()


@pytest.mark.parametrize("case", ["chatglm-paged", "granite-paged",
                                  "mamba2-dense"])
def test_a_timed_graph_samples_alike_and_times_its_segments(cuda, case,
                                                           monkeypatch):
    """With the tracer on, the decode graph has a timed copy, captured
    with a timing event at each segment mark (`repro_torch.obs.segments`),
    which one replay in `DEVICE_TIME_EVERY` (8 here, so that the batch's
    blocks fit `PAGED`) takes: the tokens and logprobs equal an untimed
    serve's bit for bit, and each ``device_time`` holds the model's
    segments, summing to within 5% of its ``total_ms``, which lies inside
    the timed replay's ``enqueue`` to ``sync`` window."""
    from repro_torch.obs import make_observability
    from repro_torch.obs.segments import SEGMENTS
    from repro_torch.serving import backend as backend_mod
    monkeypatch.setattr(backend_mod, "DEVICE_TIME_EVERY", 8)
    model, params, kw = _model(case)
    steps = 2 * 8 + 4
    runs = []
    for obs in (None, make_observability()):
        be = ExecutionBackend(model, params, obs=obs, **kw)
        noise = GumbelNoise(torch.Generator(device="cuda").manual_seed(3))
        h = be.start_batch(_prompts(model.cfg), 4, steps, 0.8, noise,
                           _extras(model.cfg))
        while be.decode_step(h):
            pass
        runs.append((np.stack(h.out_toks), np.stack(h.out_lps), obs,
                     h.graph.timer))
        be.finalize(h)
    (toks, lps, _, untimed), (ttoks, tlps, obs, timer) = runs
    np.testing.assert_array_equal(ttoks, toks)
    np.testing.assert_array_equal(tlps, lps)
    assert untimed is None and timer is not None
    spans = obs.tracer.spans
    by_id = {s.span_id: s for s in spans}
    times = [s for s in spans if s.name == "device_time"]
    assert len(times) == 2
    for t in times:
        segs = {k: v for k, v in t.attrs.items() if k != "total_ms"}
        total = t.attrs["total_ms"]
        print(f"[device-time] {case}: total {total:.4f} ms, " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(segs.items())))
        assert set(segs) <= set(SEGMENTS) and total > 0
        assert abs(sum(segs.values()) - total) <= 0.05 * total
        dec = by_id[t.parent_id]
        mine = [s for s in spans if s.parent_id == dec.span_id]
        (enq,) = [s for s in mine if s.name == "enqueue"]
        (sync,) = [s for s in mine if s.name == "sync"]
        assert total <= 1e3 * (sync.t1_s - enq.t0_s)
