"""The port's serving slice end to end on the CPU, against the reference:
`ServingEngine.generate` over the dense-slot and the paged-block backend,
greedy and sampled, plus the paged backend's block accounting and the
launcher."""
import numpy as np
import pytest

from _torch_parity import jax, models, torch

from repro.serving import ExecutionBackend as JBackend  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.serving import ExecutionBackend as TBackend  # noqa: E402
from repro_torch.serving import ServingEngine as TEngine  # noqa: E402

TOL = 1e-4
BS = 4
PAGED = dict(kv_blocks=96, kv_block_size=BS)


@pytest.fixture(scope="module", params=["fixture", "chatglm3-6b"])
def pair(request):
    return models(request.param, seed=0)


@pytest.fixture(scope="module")
def fixture_pair():
    return models("fixture", seed=0)


def _prompts(vocab, lens=(13, 13, 13, 9, 9), seed=0):
    """Prompt lengths that are not multiples of the block size, so each
    repeat gets a copy-on-write copy of the partial last prefix block; two
    lengths, so `generate` forms two batches."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _generate(engine_cls, backend_cls, model, params, prompts, backend_kw):
    eng = engine_cls(model, params, max_new_tokens=5, temperature=0.0,
                     backend=backend_cls(model, params, **backend_kw))
    return eng.generate(prompts, n_samples=2), eng


def _same(jr, tr, tol=TOL):
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        assert len(a.samples) == len(b.samples)
        for sa, sb in zip(a.samples, b.samples):
            np.testing.assert_array_equal(sb, sa)
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=tol,
                                   atol=tol)
        assert (a.prefill_tokens, a.decode_tokens) == \
            (b.prefill_tokens, b.decode_tokens)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_greedy_generate_matches_the_reference(pair, mode):
    jm, jp, tm, tp = pair
    kw = PAGED if mode == "paged" else {}
    prompts = _prompts(jm.cfg.vocab_size)
    jr, _ = _generate(JEngine, JBackend, jm, jp, prompts, kw)
    tr, eng = _generate(TEngine, TBackend, tm, tp, prompts, kw)
    _same(jr, tr)
    if mode == "paged":
        assert eng.backend.blocks_in_use == 0


def test_paged_equals_dense_inside_the_port(pair):
    """Token for token, with uneven sample counts per prompt."""
    _, _, tm, tp = pair
    prompts = _prompts(tm.cfg.vocab_size, lens=(11, 11, 11))
    out = {}
    for mode, kw in (("dense", {}), ("paged", PAGED)):
        be = TBackend(tm, tp, **kw)
        h = be.start_batch(prompts, [1, 3, 2], 6, 0.0, noise=None)
        while be.decode_step(h):
            pass
        out[mode] = be.finalize(h)
    _same(out["dense"], out["paged"], tol=1e-6)


class JaxGumbel:
    """The reference's sampling noise, replayed: each draw splits the batch
    key as `repro.serving.backend` does before ``jax.random.categorical``
    (which is ``argmax(logits + gumbel(key))``)."""

    def __init__(self, key):
        self.key = key

    def __call__(self, shape, device):
        self.key, sub = jax.random.split(self.key)
        g = jax.random.gumbel(sub, shape, jax.numpy.float32)
        return torch.from_numpy(np.array(g)).to(device)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_sampling_with_the_reference_gumbel_noise(pair, mode):
    jm, jp, tm, tp = pair
    kw = PAGED if mode == "paged" else {}
    prompts = _prompts(jm.cfg.vocab_size, lens=(10, 10))
    key = jax.random.key(7)
    jb, tb = JBackend(jm, jp, **kw), TBackend(tm, tp, **kw)
    jh = jb.start_batch(prompts, 3, 4, 0.8, key)
    th = tb.start_batch(prompts, 3, 4, 0.8, JaxGumbel(key))
    while jb.decode_step(jh):
        assert tb.decode_step(th)
    assert not tb.decode_step(th)
    jr, tr = jb.finalize(jh), tb.finalize(th)
    _same(jr, tr)
    # the noise did its work: repeats of one prompt diverge
    assert any(not np.array_equal(r.samples[0], r.samples[1]) for r in tr)


def test_port_sampling_draws_from_its_generator(pair):
    _, _, tm, tp = pair
    prompts = _prompts(tm.cfg.vocab_size, lens=(8, 8))
    from repro_torch.serving import GumbelNoise
    runs = []
    for seed in (0, 0, 1):
        eng = TEngine(tm, tp, max_new_tokens=6, temperature=1.0)
        noise = GumbelNoise(torch.Generator().manual_seed(seed))
        runs.append([s for r in eng.generate(prompts, 4, noise=noise)
                     for s in r.samples])
    assert all(np.array_equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not all(np.array_equal(a, b) for a, b in zip(runs[0], runs[2]))


def test_block_refcounts_return_to_zero_after_finalize(pair):
    _, _, tm, tp = pair
    be = TBackend(tm, tp, **PAGED)
    prompts = _prompts(tm.cfg.vocab_size, lens=(13, 13))
    h = be.start_batch(prompts, 3, 5, 0.0, noise=None)
    cost = 2 * be.request_blocks(13, 5, 3)
    assert be.blocks_in_use == cost == len(set(
        g for gids in h.paged.seq_gids for g in gids))
    shared = h.paged.seq_gids[0][0]
    assert be.allocator.refcount(shared) == 3       # one prefix, 3 repeats
    assert len(h.paged.copy_src) == 2 * 2           # CoW for repeats 2, 3
    # an early-released sequence returns its private blocks only
    freed = be.release_sequences(h, [0])
    assert freed == cost // 2 - be.request_blocks(13, 5, 2)
    assert be.allocator.refcount(shared) == 2
    while be.decode_step(h):
        pass
    be.finalize(h)
    assert be.blocks_in_use == 0 and be.blocks_free == PAGED["kv_blocks"]
    assert all(be.allocator.refcount(g) == 0 for g in range(96))
    with pytest.raises(RuntimeError, match="already-released"):
        be.release(h)


def test_budget_chunks_and_eos_like_the_reference(fixture_pair):
    """A budget that fits two requests splits one length group into
    batches as the reference does; eos truncates the samples alike."""
    jm, jp, tm, tp = fixture_pair
    prompts = _prompts(jm.cfg.vocab_size, lens=(9,) * 5)
    kw = dict(kv_blocks=2 * TBackend(tm, tp, **PAGED).request_blocks(9, 5, 2),
              kv_block_size=BS)
    jr, _ = _generate(JEngine, JBackend, jm, jp, prompts, kw)
    eos = int(jr[0].samples[0][2])
    kw["eos_token"] = eos
    jr, _ = _generate(JEngine, JBackend, jm, jp, prompts, kw)
    tr, _ = _generate(TEngine, TBackend, tm, tp, prompts, kw)
    _same(jr, tr)
    assert len(tr[0].samples[0]) <= 2
    with pytest.raises(ValueError, match="KV budget"):
        TEngine(tm, tp, max_new_tokens=50,
                backend=TBackend(tm, tp, kv_blocks=4, kv_block_size=BS)
                ).generate(prompts[:1], 2)


def test_metrics_and_spans_count_the_work(pair):
    from repro_torch.obs import make_observability
    _, _, tm, tp = pair
    obs = make_observability()
    be = TBackend(tm, tp, obs=obs, **PAGED)
    TEngine(tm, tp, max_new_tokens=4, temperature=0.0, backend=be).generate(
        _prompts(tm.cfg.vocab_size, lens=(10, 10)), 3)
    reg = obs.metrics
    # paged mode prefills each unique prompt once; 2 x 3 sequences x 4 tokens
    assert reg.get("serving_tokens_in_total").value() == 2 * 10
    assert reg.get("serving_tokens_out_total").value() == 2 * 3 * 4
    assert reg.get("serving_kv_blocks_in_use").value() == 0
    assert reg.get("serving_kv_blocks_high_water").value() == \
        2 * be.request_blocks(10, 4, 3)
    names = [s.name for s in obs.tracer.spans]
    assert names.count("prefill") == 1 and names.count("decode") == 3


def test_a_draft_depth_without_a_draft_policy_is_ignored(pair):
    """As in the reference (speculative decode is ported:
    tests/test_torch_spec.py)."""
    _, _, tm, tp = pair
    assert TBackend(tm, tp, spec_n=2)._spec_slack() == 0


@pytest.mark.parametrize("paged", [False, True])
def test_launcher_serves_on_the_cpu(capsys, paged):
    from repro_torch.launch.serve import main
    argv = ["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
            "--requests", "2", "--samples", "2", "--prompt-len", "7",
            "--max-new", "3"]
    if paged:
        argv += ["--kv-blocks", "32", "--kv-block-size", "4"]
    main(argv)
    out = capsys.readouterr().out
    assert "kernels=off" in out and "[orchestrator] devices=" in out
    assert "[serve] 2 requests x 2 samples, 12 tokens" in out
    assert ("[kv] paged cache: 32 blocks" in out) == paged
    assert "[profile]" not in out


def test_launcher_serves_int4_weights_and_int8_kv_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
          "--requests", "2", "--samples", "2", "--prompt-len", "7",
          "--max-new", "3", "--quant", "int4", "--group-size", "16",
          "--kv-int8", "--kv-blocks", "32", "--kv-block-size", "4"])
    out = capsys.readouterr().out
    assert "[quant] weights int4: " in out and " MB -> " in out
    assert "[kv] paged cache: 32 blocks x 4 slots (int8, " in out
    assert "[serve] 2 requests x 2 samples, 12 tokens" in out
    with pytest.raises(SystemExit, match="--kv-blocks"):
        main(["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
              "--kv-int8"])


def test_profile_serve_takes_the_launcher_flags_on_the_cpu(capsys):
    from repro_torch.launch.profile_serve import main
    main(["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
          "--requests", "2", "--samples", "2", "--prompt-len", "7",
          "--max-new", "3", "--kv-blocks", "32", "--kv-block-size", "4"])
    out = capsys.readouterr().out
    assert "[serve] 2 requests x 2 samples, 12 tokens" in out
    # a CPU run has no device time to report, and decodes eagerly
    assert '"device_busy_s": 0.0' in out
    assert '"graph_captures": 0, "graph_capture_ms": 0.0, "graph_replays": 0, ' \
        '"decode_steps": 2' in out


@pytest.mark.parametrize("entry", ["serve", "profile_serve"])
def test_launchers_serve_pooled_and_chunked_on_the_cpu(capsys, entry):
    import importlib
    main = importlib.import_module(f"repro_torch.launch.{entry}").main
    argv = ["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
            "--requests", "2", "--samples", "2", "--prompt-len", "7",
            "--max-new", "3", "--kv-blocks", "32", "--kv-block-size", "4"]
    main(argv + ["--kv-pool", "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "[kv] resident prefix pool: cross-batch block reuse, evict=lru" \
        in out
    assert "[kv] chunked prefill: <= 4 tokens per slice" in out
    assert "[serve] 2 requests x 2 samples, 12 tokens" in out
    if entry == "profile_serve":
        # the cold pass fills the pool; the timed pass hits one block a
        # prompt ((7 - 1) // 4) and prefills each 3-token tail in one slice
        assert "[cold] [serve] 2 requests x 2 samples, 12 tokens" in out
        assert '"pool_hit_blocks": 2.0' in out
        assert '"cold": {"wall_s": ' in out and '"pool_hit_blocks": 0.0' in out
    for flag in (["--kv-pool"], ["--prefill-chunk", "4"]):
        with pytest.raises(SystemExit, match="requires --kv-blocks"):
            main(argv[:-4] + flag)
