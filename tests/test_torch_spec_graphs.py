"""The speculative verify step as a CUDA graph (`repro_torch.serving.graphs`
`StaticVerifyStep`), on the CPU: the static-buffer body a verify graph
captures, run eagerly through the backend's own capture-and-replay loop with
the stand-in of tests/test_torch_graphs.py, against the eager verify
(``cuda_graphs=False``: tokens and logprobs bit-equal) and against the
reference's speculative serve (tokens equal, logprobs within 1e-4); verify
captures and replays counted apart from decode ones; on the resident prefix
pool one verify graph a shape and draft depth, shared by batches decoded one
after another or in turns; a capture that fails raises. Reduced chatglm3-6b
(f32): dense, paged, int4 paged and pooled. tests/test_torch_spec_gpu.py
runs the graphs themselves on the card.
"""
import numpy as np
import pytest

from _torch_parity import jax, models, torch
from test_torch_graphs import EagerGraph
from test_torch_spec import JaxSpecNoise

from repro.quant import quantize as jq  # noqa: E402
from repro.serving import ExecutionBackend as JBackend  # noqa: E402
from repro.spec import make_draft_policy as jpolicy  # noqa: E402
from repro_torch.quant import quantize as tq  # noqa: E402
from repro_torch.serving import ExecutionBackend as TBackend  # noqa: E402
from repro_torch.serving import GumbelNoise  # noqa: E402
from repro_torch.serving import backend as backend_mod  # noqa: E402
from repro_torch.serving.graphs import StaticVerifyStep  # noqa: E402
from repro_torch.spec import make_draft_policy as tpolicy  # noqa: E402

TOL = 1e-4
GS = 16
N = 3
NEW = 9
PAGED = dict(kv_blocks=96, kv_block_size=4)
POOLED = dict(PAGED, kv_pool=True)
#: case -> (backend kwargs, weight format)
CASES = {"dense": ({}, None), "paged": (PAGED, None),
         "int4-paged": (PAGED, "int4"), "pooled": (POOLED, None)}
_MODELS = {}

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's small tensors: the suite runs in
    several processes at once, and idle-spinning thread pools around tiny
    ops oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(fmt=None):
    if None not in _MODELS:
        _MODELS[None] = models("chatglm3-6b", seed=1)
    if fmt is not None and fmt not in _MODELS:
        jm, jp, tm, tp = _MODELS[None]
        _MODELS[fmt] = (jm, jq.quantize_model(jp, fmt, GS), tm,
                        tq.quantize_model(tp, fmt, GS))
    return _MODELS[fmt]


def _prompts(vocab, n=2, plen=13, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (plen,)).astype(np.int32)
            for _ in range(n)]


@pytest.fixture
def eager_graphs(monkeypatch):
    """The backend's graph path on CPU tensors, `EagerGraph` in place of
    the capture (for decode and verify steps alike)."""
    monkeypatch.setattr(TBackend, "_graphs_on", lambda self, h: True)
    monkeypatch.setattr(backend_mod, "DecodeGraph", EagerGraph)


def _spec_backend(tm, tp, kind, kw, **extra):
    return TBackend(tm, tp, spec_policy=tpolicy(kind, draft_model=tm,
                                                draft_params=tp),
                    spec_n=N, **kw, **extra)


def _serve(be, prompts, temperature, noise, k=3, max_new=NEW):
    h = be.start_batch(prompts, k, max_new, temperature, noise)
    while be.decode_step(h):
        pass
    toks = [list(r) for r in h.spec.toks]
    lps = [list(r) for r in h.spec.lps]
    results = be.finalize(h)
    assert h.verify_graph is None
    return toks, lps, results, h.spec.steps


def _noise(temperature, seed=5):
    return (GumbelNoise(torch.Generator().manual_seed(seed))
            if temperature > 0 else None)


@pytest.mark.parametrize("case,kind,temperature", [
    ("dense", "ngram", 0.8), ("dense", "draft", 0.0),
    ("paged", "ngram", 0.0), ("paged", "draft", 0.8),
    ("int4-paged", "ngram", 0.8), ("int4-paged", "draft", 0.0),
    ("pooled", "ngram", 0.0), ("pooled", "draft", 0.8)])
def test_verify_graph_body_equals_the_eager_verify(case, kind, temperature,
                                                   monkeypatch):
    """Each cache mode with each policy and temperature once."""
    kw, fmt = CASES[case]
    _, _, tm, tp = _pair(fmt)
    prompts = _prompts(tm.cfg.vocab_size)
    eager = _serve(_spec_backend(tm, tp, kind, kw, cuda_graphs=False),
                   prompts, temperature, _noise(temperature))
    monkeypatch.setattr(TBackend, "_graphs_on", lambda self, h: True)
    monkeypatch.setattr(backend_mod, "DecodeGraph", EagerGraph)
    be = _spec_backend(tm, tp, kind, kw)
    graphed = _serve(be, prompts, temperature, _noise(temperature))
    assert graphed[0] == eager[0]
    assert graphed[1] == eager[1]                    # bit-equal logprobs
    steps = graphed[3]
    assert steps == eager[3] >= 2
    st = be.graph_stats
    assert (st.verify_captures, st.verify_replays) == (1, steps - 1)
    assert (st.captures, st.replays) == (0, 0)       # no S = 1 step ran


@pytest.mark.parametrize("case", ["dense", "paged", "int4-paged", "pooled"])
def test_verify_graph_body_matches_the_reference(case, eager_graphs):
    kw, fmt = CASES[case]
    jm, jp, tm, tp = _pair(fmt)
    prompts = _prompts(jm.cfg.vocab_size)
    key = jax.random.key(9)
    jb = JBackend(jm, jp, spec_policy=jpolicy("draft", draft_model=jm,
                                              draft_params=jp),
                  spec_n=N, **kw)
    jh = jb.start_batch(prompts, 3, NEW, 0.8, key)
    while jb.decode_step(jh):
        pass
    be = _spec_backend(tm, tp, "draft", kw)
    _, _, tr, steps = _serve(be, prompts, 0.8, JaxSpecNoise(key))
    jr = jb.finalize(jh)
    for a, b in zip(jr, tr):
        for x, y in zip(a.samples, b.samples):
            np.testing.assert_array_equal(y, x)
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=0, atol=TOL)
    assert steps == jh.spec.steps
    assert be.graph_stats.verify_replays == steps - 1


def _pooled(tm, tp, batches, interleave=False, **kw):
    """Serve ``batches`` [(prompts, temperature, depth)] on one pooled
    speculating backend, each batch on its own seeded noise: one after
    another, or all started at once and decoded in turns. Returns per batch
    (tokens, logprobs) and the backend."""
    be = _spec_backend(tm, tp, "ngram", POOLED, **kw)
    out = []

    def start(i):
        prompts, temp, depth = batches[i]
        be.note_spec(depth)
        return be.start_batch(prompts, 3, NEW, temp, _noise(temp, 5 + i))

    def drain(h):
        out.append(([list(r) for r in h.spec.toks],
                    [list(r) for r in h.spec.lps]))
        be.finalize(h)

    if interleave:
        handles = [start(i) for i in range(len(batches))]
        while any(not h.done for h in handles):
            for h in handles:
                be.decode_step(h)
        for h in handles:
            drain(h)
    else:
        for i in range(len(batches)):
            h = start(i)
            while be.decode_step(h):
                pass
            drain(h)
    return out, be


@pytest.mark.parametrize("interleave", [False, True])
def test_pooled_batches_of_one_shape_share_one_verify_graph(interleave,
                                                            monkeypatch):
    """Batches of one shape and depth share one verify graph: one capture,
    at the first batch's second verify, and every later verify replays it
    (the later batch from its first). A new depth and greedy verifying
    each capture their own. Bit-equal to ``cuda_graphs=False``."""
    _, _, tm, tp = _pair()
    v = tm.cfg.vocab_size
    batches = [(_prompts(v, seed=1), 0.8, N), (_prompts(v, seed=2), 0.8, N)]
    if not interleave:
        batches += [(_prompts(v, seed=3), 0.8, 2),
                    (_prompts(v, seed=4), 0.0, N)]
    eager, _ = _pooled(tm, tp, batches, interleave, cuda_graphs=False)
    monkeypatch.setattr(TBackend, "_graphs_on", lambda self, h: True)
    monkeypatch.setattr(backend_mod, "DecodeGraph", EagerGraph)
    graphed, be = _pooled(tm, tp, batches, interleave)
    assert graphed == eager
    st = be.graph_stats
    assert st.verify_captures == len(be._pool_graphs) == len(batches) - 1
    assert st.captures == 0
    assert {k[-3:] for k in be._pool_graphs} == (
        {("verify", N, False)} if interleave else
        {("verify", N, False), ("verify", 2, False), ("verify", N, True)})


def test_a_failed_verify_capture_raises(monkeypatch):
    class Refused:
        @classmethod
        def capture(cls, step):
            raise RuntimeError("capture refused")

    monkeypatch.setattr(TBackend, "_graphs_on", lambda self, h: True)
    monkeypatch.setattr(backend_mod, "DecodeGraph", Refused)
    _, _, tm, tp = _pair()
    be = _spec_backend(tm, tp, "ngram", PAGED)
    h = be.start_batch(_prompts(tm.cfg.vocab_size), 2, NEW, 0.0, None)
    assert be.decode_step(h)                    # the first verify is eager
    with pytest.raises(RuntimeError, match="capture refused"):
        be.decode_step(h)
    assert h.spec.steps == 1 and h.verify_graph is None
    assert be.graph_stats.verify_captures == 0
    be.release(h)
    assert be.allocator.blocks_in_use == 0


def test_a_depth_zero_batch_decodes_through_the_decode_graph(eager_graphs):
    _, _, tm, tp = _pair()
    be = _spec_backend(tm, tp, "ngram", PAGED)
    be.note_spec(0)
    h = be.start_batch(_prompts(tm.cfg.vocab_size), 2, NEW, 0.8,
                       _noise(0.8))
    while be.decode_step(h):
        pass
    assert h.spec is None
    be.finalize(h)
    st = be.graph_stats
    assert (st.captures, st.replays) == (1, NEW - 2)
    assert (st.verify_captures, st.verify_replays) == (0, 0)


def test_static_verify_step_refuses_draws_of_the_other_kind():
    calls = []
    step = StaticVerifyStep(lambda *a: calls.append(a) or a[:3], rows=2, n=3,
                            vocab=7, device=torch.device("cpu"),
                            sampled=False)
    toks = torch.ones((2, 4), dtype=torch.int32)
    pos = torch.tensor([5, 9], dtype=torch.int32)
    with pytest.raises(ValueError, match="draws"):
        step.load(toks, pos, u=torch.zeros(2, 3), g=torch.zeros(2, 7))
    step.run(toks, pos)
    assert step.base_pos.tolist() == [5, 9] and calls[0][2] is None
    sampled = StaticVerifyStep(lambda *a: a, rows=2, n=3, vocab=7,
                               device=torch.device("cpu"), sampled=True)
    with pytest.raises(ValueError, match="draws"):
        sampled.load(toks, pos)
    out = sampled.run(toks, pos, u=torch.full((2, 3), 0.5),
                      g=torch.ones(2, 7))
    assert float(out[2][0, 0]) == 0.5 and out[3].shape == (2, 7)
