"""The decode step as a CUDA graph (`repro_torch.serving.graphs`), on the
CPU: the static-buffer body that a graph captures, run eagerly through the
backend's own capture-and-replay loop, against the eager decode step (tokens
equal, logprobs bit-equal) and against the reference backend on the same
weights (tokens equal, logprobs within 1e-4, as tests/test_torch_serving.py
holds them); the launch accounting of replays; the workspaces a capture
holds; that a capture that fails raises; and, on the resident prefix pool,
one graph shared by every batch of a shape (a later batch replays it from
its first decode step, bit-equal to eager decoding) over a cache whose
tensors never move. Reduced configs: chatglm3-6b dense, paged, int4 paged
and pooled, granite-moe paged, mamba2 (f32).""" 
import gc
import time
import weakref

import numpy as np
import pytest

from _torch_parity import jax, models, torch
from test_torch_serving import JaxGumbel, _prompts, _same

from repro.quant import quantize as jq  # noqa: E402
from repro.serving import ExecutionBackend as JBackend  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.obs.segments import SegmentTimer  # noqa: E402
from repro_torch.quant import quantize as tq  # noqa: E402
from repro_torch.serving import ExecutionBackend as TBackend  # noqa: E402
from repro_torch.serving import GumbelNoise  # noqa: E402
from repro_torch.serving import backend as backend_mod  # noqa: E402
from repro_torch.serving.graphs import (  # noqa: E402
    DecodeGraph, StaticDecodeStep)

TOL = 1e-4
GS = 16
PAGED = dict(kv_blocks=96, kv_block_size=4)
NEW = 8             # 7 decode steps: one eager, then a capture and 6 replays
#: case -> (arch, backend kwargs, weight format, prompt length); mamba2's
#: 40 tokens cross its reduced 32-row chunk
CASES = {
    "chatglm-dense": ("chatglm3-6b", {}, None, 13),
    "chatglm-paged": ("chatglm3-6b", PAGED, None, 13),
    "int4-paged": ("chatglm3-6b", PAGED, "int4", 13),
    "granite-paged": ("granite-moe-3b-a800m", PAGED, None, 13),
    "mamba2": ("mamba2-370m", {}, None, 40),
}
_MODELS = {}


def _pair(case):
    """(reference model, its params, port model, its params) of a case,
    quantized alike where the case says so."""
    arch, _, fmt, _ = CASES[case]
    if arch not in _MODELS:
        _MODELS[arch] = models(arch, seed=1)
    if fmt is not None and (arch, fmt) not in _MODELS:
        jm, jp, tm, tp = _MODELS[arch]
        _MODELS[arch, fmt] = (jm, jq.quantize_model(jp, fmt, GS), tm,
                              tq.quantize_model(tp, fmt, GS))
    return _MODELS[arch] if fmt is None else _MODELS[arch, fmt]


class HostEvent:
    """A timing event on the host's clock, for a timed `EagerGraph`."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, later) -> float:
        return (later.t - self.t) * 1e3


class EagerGraph:
    """Stands in for a captured graph on the CPU: each replay runs the
    static-buffer body eagerly. One captured ``timed`` holds a `timer`; a
    replay with ``timed`` runs under a fresh `SegmentTimer` of
    `HostEvent`s, which becomes ``timer``."""
    pool_bytes = 0

    def __init__(self, step: StaticDecodeStep, timed: bool = False):
        self.step = step
        self.timer = SegmentTimer(HostEvent) if timed else None

    @classmethod
    def capture(cls, step, timed=False):
        return cls(step, timed)

    def replay(self, step_pos, noise, timed=False, **batch):
        if not timed:
            return self.step.run(step_pos, noise, **batch)
        self.timer = SegmentTimer(HostEvent)
        with self.timer.recording():
            return self.step.run(step_pos, noise, **batch)


@pytest.fixture
def eager_graphs(monkeypatch):
    """Make the backend take its graph path on CPU tensors, with
    `EagerGraph` in place of the capture."""
    monkeypatch.setattr(TBackend, "_graphs_on", lambda self, h: True)
    monkeypatch.setattr(backend_mod, "DecodeGraph", EagerGraph)


def _decode(tm, tp, kw, prompts, noise, max_new=NEW):
    """Start one batch (3 samples a prompt, temperature 0.8) and drain it;
    returns (per-step tokens, per-step logprobs, results, graph stats)."""
    be = TBackend(tm, tp, **kw)
    h = be.start_batch(prompts, 3, max_new, 0.8, noise)
    while be.decode_step(h):
        pass
    toks, lps = np.stack(h.out_toks), np.stack(h.out_lps)
    results = be.finalize(h)
    assert h.graph is None and h.cache is None
    return toks, lps, results, be.graph_stats


@pytest.mark.parametrize("case", list(CASES))
def test_graph_body_equals_the_eager_step(case, monkeypatch):
    _, _, tm, tp = _pair(case)
    _, kw, _, plen = CASES[case]
    prompts = _prompts(tm.cfg.vocab_size, lens=(plen, plen))
    out = {}
    for graphed in (False, True):
        if graphed:
            monkeypatch.setattr(TBackend, "_graphs_on", lambda self, h: True)
            monkeypatch.setattr(backend_mod, "DecodeGraph", EagerGraph)
        out[graphed] = _decode(tm, tp, kw, prompts,
                               GumbelNoise(torch.Generator().manual_seed(5)))
    (et, el, _, es), (gt, gl, _, gs) = out[False], out[True]
    np.testing.assert_array_equal(gt, et)
    np.testing.assert_array_equal(gl, el)
    assert (es.captures, es.replays) == (0, 0)
    assert (gs.captures, gs.replays) == (1, NEW - 2)


@pytest.mark.parametrize("case", list(CASES))
def test_graph_body_matches_the_reference(case, eager_graphs):
    jm, jp, tm, tp = _pair(case)
    _, kw, _, plen = CASES[case]
    prompts = _prompts(jm.cfg.vocab_size, lens=(plen, plen))
    key = jax.random.key(7)
    jb = JBackend(jm, jp, **kw)
    jh = jb.start_batch(prompts, 3, NEW, 0.8, key)
    while jb.decode_step(jh):
        pass
    _, _, tr, stats = _decode(tm, tp, kw, prompts, JaxGumbel(key))
    _same(jb.finalize(jh), tr, TOL)
    assert stats.replays == NEW - 2


def test_a_batch_with_one_decode_step_is_not_captured(eager_graphs):
    _, _, tm, tp = _pair("chatglm-dense")
    _, _, _, stats = _decode(tm, tp, {}, _prompts(tm.cfg.vocab_size,
                                                  lens=(9,)),
                             GumbelNoise(torch.Generator().manual_seed(0)), 2)
    assert (stats.captures, stats.replays) == (0, 0)


def test_a_failed_capture_raises_and_decodes_nothing(monkeypatch):
    class Refused:
        @classmethod
        def capture(cls, step, timed=False):
            raise RuntimeError("capture refused")

    monkeypatch.setattr(TBackend, "_graphs_on", lambda self, h: True)
    monkeypatch.setattr(backend_mod, "DecodeGraph", Refused)
    _, _, tm, tp = _pair("chatglm-dense")
    be = TBackend(tm, tp)
    h = be.start_batch(_prompts(tm.cfg.vocab_size, lens=(9,)), 2, NEW, 0.0,
                       None)
    assert be.decode_step(h)                    # step 1 runs eagerly
    with pytest.raises(RuntimeError, match="capture refused"):
        be.decode_step(h)
    assert h.step == 2 and len(h.out_toks) == 2 and h.graph is None
    assert be.graph_stats.captures == 0
    be.release(h)


class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replays_add_the_captured_launches_once_each():
    draws = []

    def noise(shape, device):
        draws.append(shape)
        return torch.full(shape, float(len(draws)))

    step = StaticDecodeStep(lambda tok, pos, nz, t: (tok[:, 0], pos[:, 0]),
                            torch.tensor([3, 4]), vocab=5, sampled=True)
    fake = FakeGraph()
    captured = {"moe_gemm": 3, "decode_attention": 2}
    g = DecodeGraph(step, fake, ("tok", "lp"), captured, held=[])
    before = kernels.launch_counts()
    for i in range(5):
        assert g.replay(10 + i, noise) == ("tok", "lp")
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: 5 * captured.get(k, 0) for k in after}
    assert fake.replays == 5
    # each replay loaded its position and one draw of the batch's noise
    assert step.pos.tolist() == [[14], [14]]
    assert draws == [(2, 5)] * 5 and float(step.noise[0, 0]) == 5.0


def test_static_noise_refuses_a_draw_of_another_shape():
    step = StaticDecodeStep(lambda tok, pos, nz, t: (nz((2, 7), None), pos),
                            torch.tensor([1, 2]), vocab=5, sampled=True)
    with pytest.raises(ValueError, match="static buffer"):
        step()


def test_workspace_growth_keeps_what_a_holder_holds():
    dev, owner = torch.device("cpu"), "test_torch_graphs"
    try:
        c0, p0 = common.workspace(owner, dev, 8, 8)
        gone = weakref.ref(c0)
        del c0, p0
        common.workspace(owner, dev, 4096, 8)     # growth drops the pair
        gc.collect()
        assert gone() is None
        with common.holding_workspaces() as held:
            c1, p1 = common.workspace(owner, dev, 8, 8)
        c1.fill_(7)
        kept = weakref.ref(c1)
        del c1
        c2, _ = common.workspace(owner, dev, 1 << 14, 1 << 20)
        gc.collect()
        assert kept() is not None and kept() is not c2
        assert set(map(id, held.values())) == {id(kept()), id(p1)}
        assert bool((kept() == 7).all())
    finally:
        common._workspaces.pop((owner, dev), None)


# ================================= one graph a shape on the resident pool

POOLED = dict(kv_blocks=96, kv_block_size=4, kv_pool=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _pooled_serve(tm, tp, kw, batches, interleave=False):
    """Serve ``batches`` [(prompts, temperature)] on one pooled backend, 3
    samples a prompt, each batch on its own seeded noise: one after another,
    or all started at once and decoded in turns. Returns per batch (step
    tokens, step logprobs), the resident cache's tensor addresses after
    each start, and the backend."""
    be = TBackend(tm, tp, **kw)
    handles, ptrs = [], []

    def start(i):
        prompts, temp = batches[i]
        noise = GumbelNoise(torch.Generator().manual_seed(5 + i))
        handles.append(be.start_batch(prompts, 3, NEW, temp, noise))
        ptrs.append([t.data_ptr() for t in _leaves(be._pool_cache)])

    out = {}

    def drain(i):
        h = handles[i]
        out[i] = (np.stack(h.out_toks), np.stack(h.out_lps))
        be.finalize(h)

    if interleave:
        for i in range(len(batches)):
            start(i)
        while any(not h.done for h in handles):
            for h in handles:
                be.decode_step(h)
        for i in range(len(batches)):
            drain(i)
    else:
        for i in range(len(batches)):
            start(i)
            while be.decode_step(handles[i]):
                pass
            drain(i)
    return [out[i] for i in range(len(batches))], ptrs, be


@pytest.mark.parametrize("chunk", [None, 3])
def test_pooled_batches_of_one_shape_share_one_graph(chunk, monkeypatch):
    """Two batches of one shape: one capture, at the first batch's second
    decode step; the second replays from its first. Greedy decoding (the
    temperature itself is a buffer) and a new row count each capture
    their own. Every step bit-equal to
    ``cuda_graphs=False``; the resident cache's tensors never move."""
    _, _, tm, tp = _pair("chatglm-paged")
    v = tm.cfg.vocab_size
    kw = dict(POOLED, prefill_chunk=chunk)
    p = [_prompts(v, lens=(13, 13), seed=s) for s in range(4)]
    batches = [(p[0], 0.8), (p[1], 0.8), (p[2], 0.0), (p[3][:1], 0.8)]
    eager, _, _ = _pooled_serve(tm, tp, dict(kw, cuda_graphs=False), batches)
    monkeypatch.setattr(TBackend, "_graphs_on", lambda self, h: True)
    monkeypatch.setattr(backend_mod, "DecodeGraph", EagerGraph)
    graphed, ptrs, be = _pooled_serve(tm, tp, kw, batches)
    for (gt, gl), (et, el) in zip(graphed, eager):
        np.testing.assert_array_equal(gt, et)
        np.testing.assert_array_equal(gl, el)
    stats = be.graph_stats
    assert stats.captures == len(be._pool_graphs) == 3
    assert stats.replays == 3 * (NEW - 2) + (NEW - 1)
    assert all(q == ptrs[0] for q in ptrs)
    assert [t.data_ptr() for t in _leaves(be._pool_cache)] == ptrs[0]


def test_interleaved_batches_of_one_shape_share_one_graph(monkeypatch):
    """Two pooled batches of one shape decoded in turns through the one
    graph they share: each replay loads its batch's tokens and block
    table, so both equal their eager decoding bit for bit."""
    _, _, tm, tp = _pair("chatglm-paged")
    v = tm.cfg.vocab_size
    batches = [(_prompts(v, lens=(9, 9), seed=s), 0.8) for s in (7, 8)]
    eager, _, _ = _pooled_serve(tm, tp, dict(POOLED, cuda_graphs=False),
                                batches, interleave=True)
    monkeypatch.setattr(TBackend, "_graphs_on", lambda self, h: True)
    monkeypatch.setattr(backend_mod, "DecodeGraph", EagerGraph)
    graphed, _, be = _pooled_serve(tm, tp, POOLED, batches, interleave=True)
    for (gt, gl), (et, el) in zip(graphed, eager):
        np.testing.assert_array_equal(gt, et)
        np.testing.assert_array_equal(gl, el)
    # the second batch's step 2 came after the first's capture
    assert (be.graph_stats.captures, be.graph_stats.replays) == \
        (1, 2 * (NEW - 2))
