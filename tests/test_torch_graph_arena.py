"""One decode graph and one verify graph a shape, in every cache mode
(`repro_torch.serving.backend` `CacheArena`), on the CPU with the capture
stand-in of tests/test_torch_graphs.py.

* A dense, a per-batch paged (bf16 and int8 KV) and an SSM batch that
  reuse a retired batch's cache arena and its graph give tokens and
  logprobs bit-equal to a fresh batch and to the eager step, and replay
  from their first decode step; the arena's tensors never move.
* The verify graph likewise.
* The temperature is a 0-dim buffer: batches of several temperatures share
  one graph (greedy has its own), bit-equal to eager; dividing by a float
  and by the buffer gives the same bits.
* Idle arenas stay within the KV budget, least recently retired dropped
  first, and go with the backend.
* The scheduled streams of ``chip_smoke.py`` phases 5 and 6, rehearsed on
  a small model at chatglm3-6b's vocabulary, give the records and graph
  counts that ``STREAM_REHEARSAL`` and ``SPEC_STREAM_REHEARSAL`` hold the
  card to.
"""
import dataclasses
import importlib.util
import weakref
from pathlib import Path

import numpy as np
import pytest

from _torch_parity import models, torch
from test_torch_graphs import EagerGraph

from repro_torch.serving import ExecutionBackend as TBackend  # noqa: E402
from repro_torch.serving import GumbelNoise  # noqa: E402
from repro_torch.serving import backend as backend_mod  # noqa: E402
from repro_torch.serving.backend import sample_tokens  # noqa: E402
from repro_torch.spec import NGramDraftPolicy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NEW = 8             # 7 decode steps
PAGED = dict(kv_blocks=96, kv_block_size=4)
#: case -> (arch, backend kwargs, prompt length)
CASES = {
    "chatglm-dense": ("chatglm3-6b", {}, 13),
    "chatglm-paged": ("chatglm3-6b", PAGED, 13),
    "int8kv-paged": ("chatglm3-6b", dict(PAGED, kv_format="int8"), 13),
    "mamba2-dense": ("mamba2-370m", {}, 40),
}
_MODELS = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's small tensors: the suite runs in
    several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch):
    if arch not in _MODELS:
        _MODELS[arch] = models(arch, seed=1)[2:]
    return _MODELS[arch]


def _prompts(vocab, plen, seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (plen,)).astype(np.int32)
            for _ in range(n)]


def _graphs_on(monkeypatch):
    monkeypatch.setattr(TBackend, "_graphs_on",
                        lambda self, h: self.cuda_graphs)
    monkeypatch.setattr(backend_mod, "DecodeGraph", EagerGraph)


def _leaves(cache):
    for entry in list(cache["prefix"]) + list(cache["blocks"].values()):
        for k in sorted(entry):
            yield entry[k]


def _drain(be, prompts, temperature, seed, k=3):
    """One batch of ``prompts`` x ``k`` through ``be``: (per-row tokens,
    per-row logprobs, the addresses of its cache's tensors, its verify
    forwards or None)."""
    noise = (GumbelNoise(torch.Generator().manual_seed(seed))
             if temperature > 0 else None)
    h = be.start_batch(prompts, k, NEW, temperature, noise)
    ptrs = [t.data_ptr() for t in _leaves(h.cache)]
    while be.decode_step(h):
        pass
    if h.spec is not None:
        out = ([list(r) for r in h.spec.toks], [list(r) for r in h.spec.lps],
               ptrs, h.spec.steps)
    else:
        out = (np.stack(h.out_toks).tolist(), np.stack(h.out_lps).tolist(),
               ptrs, None)
    be.finalize(h)
    assert h.cache is None and h.graph is None and h.verify_graph is None
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_a_batch_on_a_retired_arena_equals_a_fresh_batch(case, monkeypatch):
    """Batch B, after batch A of its shape retired, prefills into A's
    cache tensors and replays A's graph from its first decode step: one
    capture for both. B's tokens and logprobs equal B's on a fresh backend,
    graphed and eager, bit for bit."""
    arch, kw, plen = CASES[case]
    tm, tp = _model(arch)
    a = _prompts(tm.cfg.vocab_size, plen, 0)
    b = _prompts(tm.cfg.vocab_size, plen, 1)
    eager = _drain(TBackend(tm, tp, cuda_graphs=False, **kw), b, 0.8, 6)
    _graphs_on(monkeypatch)
    fresh = _drain(TBackend(tm, tp, **kw), b, 0.8, 6)
    be = TBackend(tm, tp, **kw)
    first = _drain(be, a, 0.8, 5)
    second = _drain(be, b, 0.8, 6)
    assert second[:2] == fresh[:2] == eager[:2]
    assert second[2] == first[2]                     # the same tensors
    st = be.graph_stats
    assert (st.captures, st.replays) == (1, (NEW - 2) + (NEW - 1))
    [arena] = be._idle_arenas
    assert len(arena.graphs) == 1


def test_temperatures_share_one_graph_and_greedy_has_its_own(monkeypatch):
    """Four batches of one shape at T 0.8, 1.3, 0 and 0.5 on one backend:
    two captures (sampled and greedy) and every later step a replay; each
    batch bit-equal to its eager decoding."""
    tm, tp = _model("chatglm3-6b")
    kw = CASES["chatglm-paged"][1]
    runs = [(_prompts(tm.cfg.vocab_size, 13, s), t, s)
            for s, t in enumerate((0.8, 1.3, 0.0, 0.5))]
    eager_be = TBackend(tm, tp, cuda_graphs=False, **kw)
    eager = [_drain(eager_be, *r)[:2] for r in runs]
    _graphs_on(monkeypatch)
    be = TBackend(tm, tp, **kw)
    assert [_drain(be, *r)[:2] for r in runs] == eager
    st = be.graph_stats
    assert (st.captures, st.replays) == (2, 2 * (NEW - 2) + 2 * (NEW - 1))
    [arena] = be._idle_arenas
    assert sorted(k[-2:] for k in arena.graphs) == [("decode", False),
                                                   ("decode", True)]


@pytest.mark.parametrize("seed", range(3))
def test_dividing_by_the_temperature_buffer_gives_the_float_bits(seed):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((16, 1000), generator=g) * 8
    noise = torch.randn((16, 1000), generator=g)
    for t in (0.8, 0.5, 1.7, 0.3, 1e-3):
        buf = torch.full((), t, dtype=torch.float32)
        assert torch.equal(logits / t, logits / buf)
        a = sample_tokens(logits, t, lambda s, d: noise)
        b = sample_tokens(logits, buf, lambda s, d: noise, sampled=True)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", ["chatglm-dense", "chatglm-paged"])
def test_a_speculating_batch_replays_the_verify_graph_from_its_first(
        case, monkeypatch):
    _, kw, plen = CASES[case]
    tm, tp = _model("chatglm3-6b")
    a = _prompts(tm.cfg.vocab_size, plen, 2)
    b = _prompts(tm.cfg.vocab_size, plen, 3)

    def backend(**extra):
        return TBackend(tm, tp, spec_policy=NGramDraftPolicy(), spec_n=3,
                        **kw, **extra)

    eager = _drain(backend(cuda_graphs=False), b, 0.8, 6)
    _graphs_on(monkeypatch)
    fresh = _drain(backend(), b, 0.8, 6)
    be = backend()
    first = _drain(be, a, 0.8, 5)
    second = _drain(be, b, 0.8, 6)
    assert second[:2] == fresh[:2] == eager[:2]
    assert second[2] == first[2] and second[3] >= 2
    st = be.graph_stats
    assert (st.verify_captures, st.verify_replays) == \
        (1, (first[3] - 1) + second[3])
    assert (st.captures, st.replays) == (0, 0)


def _sizes(be):
    return [(a.key, a.size) for a in be._idle_arenas]


def test_idle_arenas_stay_within_the_slot_budget_lru():
    tm, tp = _model("chatglm3-6b")
    v = tm.cfg.vocab_size
    be = TBackend(tm, tp, max_slots=6)

    def serve(plen, rows):
        h = be.start_batch(_prompts(v, plen, plen, n=1), rows, 3, 0.0, None)
        while be.decode_step(h):
            pass
        be.finalize(h)
        return h

    serve(9, 2)                                   # A: 2 rows
    serve(10, 3)                                  # B: 3 rows
    assert _sizes(be) == [(("dense", 2, 12), 2), (("dense", 3, 13), 3)]
    serve(9, 2)                                   # A again: retired last
    assert _sizes(be) == [(("dense", 3, 13), 3), (("dense", 2, 12), 2)]
    serve(11, 2)                                  # C: 7 rows > 6, drop B
    assert _sizes(be) == [(("dense", 2, 12), 2), (("dense", 2, 14), 2)]
    unbounded = TBackend(tm, tp)
    be = unbounded
    serve(9, 3)
    serve(9, 2)                                   # peak 3 rows: drop the 3
    assert _sizes(be) == [(("dense", 2, 12), 2)]


def test_idle_arenas_stay_within_the_block_budget_and_go_with_the_backend(
        monkeypatch):
    _graphs_on(monkeypatch)
    tm, tp = _model("chatglm3-6b")
    v = tm.cfg.vocab_size
    be = TBackend(tm, tp, kv_blocks=24, kv_block_size=4)
    sizes = []
    for plen in (9, 13, 9):
        h = be.start_batch(_prompts(v, plen, plen), 2, 4, 0.0, None)
        sizes.append(h.paged.n_pool_blocks)
        be.finalize(h)
    # a prompt's full prefix blocks once, then per sample its partial and
    # decode blocks: plen 9, 2 + 2 x 1 a prompt = 8; 13: 3 + 2 x 1 = 10;
    # the third batch took the first's arena, so 10 + 8 <= 24 stay idle
    assert sizes == [8, 10, 8]
    assert _sizes(be) == [(("paged", 10), 10), (("paged", 8), 8)]
    h = be.start_batch(_prompts(v, 17, 17), 2, 4, 0.0, None)
    be.finalize(h)                                # 12 more: 30 > 24
    assert _sizes(be) == [(("paged", 8), 8), (("paged", 12), 12)]
    leaf = weakref.ref(next(_leaves(be._idle_arenas[0].cache)))
    del be, h
    assert leaf() is None


# ============================================ chip_smoke.py's rehearsals

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def stream():
    """chip_smoke.py's stream and router, and a one-layer model of
    chatglm3-6b's vocabulary (the prompt draws depend on it; the
    scheduling decisions and graph counts depend on shapes, not on the
    model's widths)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=1,
                              d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                              head_dim=16)
    model = Model(cfg, dtype=torch.float32, device="cpu", use_kernel=False)
    params = model.init(torch.Generator().manual_seed(0))
    router, arrivals = cs.stream_setup(0)
    return cs, model, params, router, arrivals


@pytest.mark.parametrize("pooled", [True, False])
def test_the_stream_rehearsal_gives_chip_smokes_counts(stream, pooled,
                                                       monkeypatch):
    cs, model, params, router, arrivals = stream
    _graphs_on(monkeypatch)
    kw = dict(kv_blocks=cs.POOL["kv_blocks"],
              kv_block_size=cs.POOL["kv_block_size"])
    if pooled:
        kw.update(kv_pool=True, pool_evict="lru")
    out = cs.run_stream(model, params, router, arrivals, 0, kw,
                        cs.STREAM["temperature"])
    gs = out["backend"].graph_stats
    want = cs.STREAM_REHEARSAL
    got_graphs = [gs.captures, gs.replays]
    if pooled:
        assert cs.stream_records(out["sched"]) == want["records"]
        assert out["released"] == want["released"]
        assert out["sched"].stats()["preemptions"] == want["preemptions"]
        assert got_graphs == want["graphs"]
    else:
        assert got_graphs == want["paged_graphs"]
        # one capture a key, not one a batch
        assert gs.captures < len(out["sched"].records)


def test_the_spec_stream_rehearsal_gives_chip_smokes_counts(stream,
                                                            monkeypatch):
    from repro_torch.spec import SpecPlanner
    cs, model, params, router, arrivals = stream
    _graphs_on(monkeypatch)
    planner = SpecPlanner("ngram", depths=cs.SPEC["depths"],
                          model_name="chatglm3-6b")
    kw = dict(kv_blocks=cs.POOL["kv_blocks"],
              kv_block_size=cs.POOL["kv_block_size"], kv_pool=True,
              pool_evict="lru", spec_policy=NGramDraftPolicy(),
              spec_n=cs.SPEC["n"])
    out = cs.run_stream(model, params, router, arrivals, 0, kw,
                        cs.STREAM["temperature"], spec_planner=planner)
    gs = out["backend"].graph_stats
    st = out["sched"].stats()
    want = cs.SPEC_STREAM_REHEARSAL
    assert cs.spec_stream_records(out["sched"]) == want["records"]
    assert [gs.captures, gs.replays] == want["graphs"]
    assert [gs.verify_captures, gs.verify_replays] == want["verify_graphs"]
    assert (st["spec_proposed"], st["spec_accepted"]) == \
        (want["proposed"], want["accepted"])
