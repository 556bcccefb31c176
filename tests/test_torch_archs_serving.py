"""Serving the remaining archs through the port's backend and engine, on
the CPU, against the reference's: musicgen-medium reduced (4 codebooks,
cross-attention to a conditioning memory, with and without the cross K/V
cache) dense; qwen2-vl-7b reduced with vision embeddings dense, per-batch
paged and pooled; a windowed fixture dense past its window. Greedy tokens
equal and logprobs within 1e-4; sampled likewise with the reference's
``jax.random.gumbel`` draws injected. Inside the port the cross K/V cache
gives the recomputed serve's tokens (logprobs within 1e-5), and the
multi-codebook decode graph's body, run eagerly through the backend's
capture-and-replay loop, is bit-equal to the eager step, also for a second
batch on a retired batch's cache arena. Then the launcher."""
import dataclasses

import numpy as np
import pytest

from _torch_parity import jax, jnp, models, torch
from test_torch_graphs import EagerGraph
from test_torch_serving import JaxGumbel, _same

from repro.models import Model as JModel  # noqa: E402
from repro.serving import ExecutionBackend as JBackend  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.serving import ExecutionBackend as TBackend  # noqa: E402
from repro_torch.serving import GumbelNoise  # noqa: E402
from repro_torch.serving import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving import backend as backend_mod  # noqa: E402

TOL = 1e-4
IN_PORT = 1e-5
NEW = 6
PAGED = dict(kv_blocks=64, kv_block_size=4)
MODES = {"dense": {}, "paged": PAGED, "pooled": dict(PAGED, kv_pool=True)}
_MODELS = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's small tensors: the suite runs in
    several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, cross_kv=False, **over):
    """(reference model, params, port model, params); the cross K/V cache
    variant shares the weights of the model without it."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        _MODELS[key] = models(arch, seed=0, **over)
    jm, jp, tm, tp = _MODELS[key]
    if cross_kv:
        jm = JModel(dataclasses.replace(jm.cfg, cross_kv_cache=True),
                    dtype=jnp.float32)
        tm = TModel(dataclasses.replace(tm.cfg, cross_kv_cache=True),
                    dtype=torch.float32, device="cpu")
    return jm, jp, tm, tp


def _prompts(cfg, lens, seed=0):
    """One prompt a length; (L, K) with K codebooks."""
    rng = np.random.default_rng(seed)
    tail = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    return [rng.integers(0, cfg.vocab_size, (n,) + tail).astype(np.int32)
            for n in lens]


def _extras(cfg, n, seed=1):
    """Random stub frontend inputs, one row a prompt: 4 vision embeddings,
    or 8 rows of conditioning memory."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "vision":
        return {"vision_embeds": (rng.standard_normal((n, 4, cfg.d_model))
                                  * 0.1).astype(np.float32)}
    if cfg.cross_attention:
        return {"cond_memory": (rng.standard_normal((n, 8, cfg.d_model))
                                * 0.1).astype(np.float32)}
    return {}


def _serve_both(pair, kw, prompts, extras, temperature, n_samples=2,
                max_new=NEW, seed=7):
    """One batch through each package's backend: (reference results, port
    results, port backend, port handle). Sampled, the port draws the
    reference's Gumbel noise."""
    jm, jp, tm, tp = pair
    key = jax.random.key(seed)
    jb, tb = JBackend(jm, jp, **kw), TBackend(tm, tp, **kw)
    jh = jb.start_batch(prompts, n_samples, max_new, temperature, key,
                        extras)
    th = tb.start_batch(prompts, n_samples, max_new, temperature,
                        JaxGumbel(key) if temperature > 0 else None, extras)
    while jb.decode_step(jh):
        assert tb.decode_step(th)
    assert not tb.decode_step(th)
    return jb.finalize(jh), tb.finalize(th), tb, th


# ---------------------------------------------------------------- musicgen

@pytest.mark.parametrize("cross_kv", [False, True], ids=["recompute",
                                                         "cross-kv"])
def test_musicgen_greedy_generate_matches_the_reference(cross_kv):
    """Two prompt lengths (two batches), 2 samples each: samples (T, K)."""
    jm, jp, tm, tp = _pair("musicgen-medium", cross_kv)
    cfg = tm.cfg
    prompts = _prompts(cfg, (9, 9, 7))
    extras = _extras(cfg, 3)
    jr = JEngine(jm, jp, max_new_tokens=NEW, temperature=0.0).generate(
        prompts, 2, extras=extras)
    tr = TEngine(tm, tp, max_new_tokens=NEW, temperature=0.0).generate(
        prompts, 2, extras=extras)
    _same(jr, tr)
    assert tr[0].samples[0].shape == (NEW, cfg.n_codebooks)
    assert tr[0].decode_tokens == 2 * NEW


@pytest.mark.parametrize("cross_kv", [False, True], ids=["recompute",
                                                         "cross-kv"])
def test_musicgen_sampling_with_the_reference_gumbel_noise(cross_kv):
    pair = _pair("musicgen-medium", cross_kv)
    cfg = pair[2].cfg
    jr, tr, _, _ = _serve_both(pair, {}, _prompts(cfg, (8, 8)),
                               _extras(cfg, 2), 0.8, n_samples=3)
    _same(jr, tr)
    assert any(not np.array_equal(r.samples[0], r.samples[1]) for r in tr)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_the_cross_kv_cache_serves_the_recomputed_tokens(temperature):
    """Inside the port: the serve that keeps the memory's K/V in the cache
    and the one that projects the memory every step, on the same noise."""
    out = []
    for cross_kv in (False, True):
        _, _, tm, tp = _pair("musicgen-medium", cross_kv)
        be = TBackend(tm, tp)
        h = be.start_batch(_prompts(tm.cfg, (8, 8)), 2, NEW, temperature,
                           GumbelNoise(torch.Generator().manual_seed(3)),
                           _extras(tm.cfg, 2))
        assert ("xk" in h.cache["blocks"]["l0"]) == cross_kv
        while be.decode_step(h):
            pass
        out.append(be.finalize(h))
    _same(out[0], out[1], IN_PORT)


def test_multi_codebook_samples_are_not_cut_at_eos():
    """EOS truncation is off with several codebooks, as in the reference."""
    _, _, tm, tp = _pair("musicgen-medium")
    prompts, extras = _prompts(tm.cfg, (8,)), _extras(tm.cfg, 1)
    r, = TEngine(tm, tp, max_new_tokens=NEW, temperature=0.0).generate(
        prompts, 1, extras=extras)
    eos = int(r.samples[0][1, 0])
    r2, = TEngine(tm, tp, max_new_tokens=NEW, temperature=0.0,
                  eos_token=eos).generate(prompts, 1, extras=extras)
    np.testing.assert_array_equal(r2.samples[0], r.samples[0])


# ---------------------------------------------------------------- qwen2-vl

@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("mode", list(MODES))
def test_qwen2_vl_serving_matches_the_reference(mode, temperature):
    """Vision embeddings over the first 4 prompt positions (the pooled
    prefill takes the tail path with ``decode=True``, which, as in the
    reference, does not place them), M-RoPE positions at every step; 11
    tokens a prompt, so each repeat copies a partial block."""
    pair = _pair("qwen2-vl-7b")
    cfg = pair[2].cfg
    jr, tr, tb, _ = _serve_both(pair, MODES[mode], _prompts(cfg, (11, 11)),
                                _extras(cfg, 2), temperature)
    _same(jr, tr)
    if mode != "dense":
        assert tb.blocks_in_use == (tb.prefix_pool.blocks_resident
                                    if mode == "pooled" else 0)


# ------------------------------------------------------------------ window

@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_windowed_serving_past_the_window(temperature):
    """A ring of 4 slots: 9 prompt tokens and 8 new ones, every decode step
    past the window."""
    pair = _pair("fixture", attn_window=4)
    jr, tr, tb, th = _serve_both(pair, {}, _prompts(pair[2].cfg, (9, 9)),
                                 {}, temperature, max_new=8)
    _same(jr, tr)


# ------------------------------------------------------------------ graphs

def _graphs_on(monkeypatch):
    monkeypatch.setattr(TBackend, "_graphs_on",
                        lambda self, h: self.cuda_graphs)
    monkeypatch.setattr(backend_mod, "DecodeGraph", EagerGraph)


def _drain(be, prompts, extras, seed):
    """One batch of ``prompts`` x 3 at T 0.8: (per-step tokens (T, B, K),
    per-step logprobs, the addresses of its cache's tensors)."""
    h = be.start_batch(prompts, 3, NEW, 0.8,
                       GumbelNoise(torch.Generator().manual_seed(seed)),
                       extras)
    ptrs = [t.data_ptr() for e in h.cache["blocks"].values()
            for t in e.values()]
    while be.decode_step(h):
        pass
    out = np.stack(h.out_toks), np.stack(h.out_lps), ptrs
    be.finalize(h)
    return out


@pytest.mark.parametrize("cross_kv", [False, True], ids=["recompute",
                                                         "cross-kv"])
def test_the_multi_codebook_graph_body_equals_the_eager_step(cross_kv,
                                                             monkeypatch):
    """Batch B after batch A of its shape: B prefills into A's retired
    cache arena (its cross K/V entries in place) and replays A's graph,
    whose static buffers hold (B, 1, K) tokens, (B, K, vocab) noise and
    the conditioning memory; B's tokens and logprobs are bit-equal to B's
    eager serve."""
    _, _, tm, tp = _pair("musicgen-medium", cross_kv)
    a = _prompts(tm.cfg, (8, 8), seed=4), _extras(tm.cfg, 2, seed=5)
    b = _prompts(tm.cfg, (8, 8), seed=6), _extras(tm.cfg, 2, seed=7)
    eager = _drain(TBackend(tm, tp, cuda_graphs=False), *b, 9)
    _graphs_on(monkeypatch)
    be = TBackend(tm, tp)
    first = _drain(be, *a, 8)
    second = _drain(be, *b, 9)
    np.testing.assert_array_equal(second[0], eager[0])
    np.testing.assert_array_equal(second[1], eager[1])
    assert second[0].shape == (NEW, 6, tm.cfg.n_codebooks)
    assert second[2] == first[2]                     # the same tensors
    st = be.graph_stats
    assert (st.captures, st.replays) == (1, (NEW - 2) + (NEW - 1))
    [arena] = be._idle_arenas
    [graph] = arena.graphs.values()
    step = graph.step
    assert step.tok.shape == (6, 1, tm.cfg.n_codebooks)
    assert step.noise.shape == (6, tm.cfg.n_codebooks, tm.cfg.padded_vocab)
    assert step.inputs["cond_memory"].shape == (6, 8, tm.cfg.d_model)


def test_a_memory_of_another_length_takes_another_arena(monkeypatch):
    """The dense cache's cross K/V entries are sized to the batch's memory,
    so a batch with a longer memory gets a cache of its own (a budget of
    12 rows keeps both arenas idle)."""
    _graphs_on(monkeypatch)
    _, _, tm, tp = _pair("musicgen-medium", cross_kv=True)
    be = TBackend(tm, tp, max_slots=12)
    prompts = _prompts(tm.cfg, (8, 8))
    short = _extras(tm.cfg, 2)
    long = {"cond_memory": np.concatenate([short["cond_memory"]] * 2, 1)}
    for extras in (short, long):
        _drain(be, prompts, extras, 3)
    assert [a.key[-1] for a in be._idle_arenas] == [8, 16]
    assert be.graph_stats.captures == 2


# ---------------------------------------------------------------- launcher

@pytest.mark.parametrize("arch,paged", [
    ("musicgen-medium", False), ("qwen2-vl-7b", False),
    ("qwen2-vl-7b", True)])
def test_launcher_serves_the_arch_on_the_cpu(capsys, arch, paged):
    from repro_torch.launch.serve import main
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
            "--samples", "2", "--prompt-len", "7", "--max-new", "3"]
    if paged:
        argv += ["--kv-blocks", "32", "--kv-block-size", "4", "--kv-pool"]
    main(argv)
    out = capsys.readouterr().out
    assert "kernels=off" in out
    assert "[serve] 2 requests x 2 samples, 12 tokens" in out
    assert ("[kv] resident prefix pool" in out) == paged


def test_launcher_refuses_paging_musicgen():
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit, match="unsupported for paging"):
        main(["--arch", "musicgen-medium", "--smoke", "--device", "cpu",
              "--kv-blocks", "32"])
