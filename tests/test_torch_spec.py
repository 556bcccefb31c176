"""Speculative decode in the port (`repro_torch.spec` and the backend's
speculative path) against the reference (`repro.spec`), on the reference's
fixture (2 layers, d 64, 4/2 heads, d_ff 128, vocab 64, f32), with the
reference's weights converted.

* `verify_tokens`: greedy exact; sampled with the reference's uniform and
  Gumbel draws injected: tokens exact, logprobs within 1e-6; the accept
  rule's marginal (`emission_distribution`, and the port's own sampled
  draws against the tempered target).
* The policies: `NGramDraftPolicy` proposals equal over seeded histories;
  `DraftModelPolicy` proposals equal on ragged, left-padded contexts, also
  when the target model has its kernels on (the rollout takes the masked
  plain path).
* `spec_workload`, `expected_tokens_per_step` and `SpecPlanner` depth
  choices equal over each package's router.
* Greedy speculative serving of granite-moe (reduced) at depths 2 and 4,
  dense and per-batch paged: tokens equal to the reference's speculative
  serve in the same mode (logprobs within 1e-4).
* Greedy speculative serving for both policies, dense, per-batch paged,
  pooled (cold and warm), chunked and pooled chunked: tokens equal to the
  reference's speculative serve (logprobs within 1e-4) and to the port's
  plain greedy decode (logprobs within the reference's ``LOGPROB_ATOL``,
  3e-5). Sampled speculative serving with the reference's keys replayed:
  tokens equal.
* Rollback under sampled accepts with a mid-flight `release_sequences`,
  slack priced into admission, `note_spec`, and the scheduler path with a
  `SpecPlanner` (batch records and "spec" trace records equal to the
  reference's).
* The launcher's ``--spec`` lines and checks, and the port's replay of
  ``benchmarks/spec_decode.py`` against its baseline.
"""
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from _torch_parity import jax, models, torch
from test_torch_serving import JaxGumbel

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.qeil2 as JQ  # noqa: E402
import repro.serving as JS  # noqa: E402
import repro.spec as JSP  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.qeil2 as TQ  # noqa: E402
import repro_torch.serving as TS  # noqa: E402
import repro_torch.spec as TSP  # noqa: E402
from repro_torch.serving import GumbelNoise  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
LOGPROB_ATOL = 3e-5     # the reference's: one verify vs n decode forwards
PLEN, MAX_NEW, SPEC_N = 8, 6, 3
BS = 4
PKG = {"ref": (J, JQ, JS, JSP), "port": (T, TQ, TS, TSP)}
MODES = {
    "dense": {},
    "paged": dict(kv_blocks=96, kv_block_size=BS),
    "chunked": dict(kv_blocks=96, kv_block_size=BS, prefill_chunk=3),
    "pooled": dict(kv_blocks=96, kv_block_size=BS, kv_pool=True),
    "pooled-chunked": dict(kv_blocks=96, kv_block_size=BS, kv_pool=True,
                           prefill_chunk=5),
}

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's small tensors: the suite runs in
    several processes at once, and idle-spinning thread pools around tiny
    ops oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxSpecNoise(JaxGumbel):
    """The reference's randomness, replayed: `JaxGumbel` for the sampled
    first token, and for each verify step the reference's key schedule
    (`ExecutionBackend._spec_decode_step` splits the batch key once, and
    `verify_tokens` splits that into the uniform key and the categorical
    key, whose draw is ``argmax(scores + gumbel)``)."""

    def verify_draws(self, rows, n, vocab, device):
        self.key, sub = jax.random.split(self.key)
        u_key, cat_key = jax.random.split(sub)
        u = jax.random.uniform(u_key, (rows, n))
        g = jax.random.gumbel(cat_key, (rows, vocab), jnp.float32)
        return (torch.from_numpy(np.array(u)).to(device),
                torch.from_numpy(np.array(g)).to(device))


@pytest.fixture(scope="module")
def pair():
    return models("fixture", seed=0)


def _prompts(n, seed=0, plen=PLEN, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(plen,)).astype(np.int32)
            for _ in range(n)]


def _policy(side, kind, model, params):
    return PKG[side][3].make_draft_policy(kind, draft_model=model,
                                          draft_params=params)


def _backend(side, model, params, kind=None, mode="paged", spec_n=SPEC_N,
             **kw):
    spec = ({} if kind is None else
            dict(spec_policy=_policy(side, kind, model, params),
                 spec_n=spec_n))
    return PKG[side][2].ExecutionBackend(model, params, **MODES[mode],
                                         **spec, **kw)


def _drain(backend, prompts, temperature, noise, n_samples=1,
           max_new=MAX_NEW):
    h = backend.start_batch(prompts, n_samples, max_new, temperature, noise,
                            {})
    while backend.decode_step(h):
        pass
    return backend.finalize(h), h


def _same(a_results, b_results, tol):
    assert len(a_results) == len(b_results)
    for a, b in zip(a_results, b_results):
        assert len(a.samples) == len(b.samples)
        for x, y in zip(a.samples, b.samples):
            np.testing.assert_array_equal(y, x)
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=0, atol=tol)
        assert (a.prefill_tokens, a.decode_tokens) == \
            (b.prefill_tokens, b.decode_tokens)


# ============================================================ verify_tokens

def _verify_case(seed, B=6, n=4, V=40):
    """Logits whose argmax chain the drafts follow for a random prefix."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, n + 1, V)) * 2.0).astype(np.float32)
    top = logits.argmax(-1)
    drafts = rng.integers(0, V, size=(B, n)).astype(np.int32)
    for b in range(B):
        keep = rng.integers(0, n + 1)
        drafts[b, :keep] = top[b, :keep]
    return logits, drafts


@pytest.mark.parametrize("seed", range(4))
def test_greedy_verify_matches_the_reference(seed):
    logits, drafts = _verify_case(seed)
    ja, jt, jl = JSP.verify_tokens(jnp.asarray(logits), jnp.asarray(drafts),
                                   jax.random.key(seed), 0.0, True)
    ta, tt, tl = TSP.verify_tokens(torch.from_numpy(logits),
                                   torch.from_numpy(drafts), 0.0, True)
    ja = np.asarray(ja)
    np.testing.assert_array_equal(ta.numpy(), ja)
    for b in range(len(ja)):
        e = ja[b] + 1
        np.testing.assert_array_equal(tt.numpy()[b, :e], np.asarray(jt)[b, :e])
        np.testing.assert_allclose(tl.numpy()[b, :e], np.asarray(jl)[b, :e],
                                   rtol=0, atol=1e-6)
    assert 0 < ja.sum() < ja.size * drafts.shape[1]


@pytest.mark.parametrize("seed,temperature", [(0, 0.8), (1, 0.5), (2, 1.7),
                                              (3, 1.0)])
def test_sampled_verify_with_the_reference_draws(seed, temperature):
    logits, drafts = _verify_case(seed, B=64)
    # temperature-flattened logits so that some drafts are accepted
    logits = logits * 0.3
    rng = jax.random.key(100 + seed)
    # the backend splits the batch key once a step before `verify_tokens`
    # splits it again; JaxSpecNoise replays both splits
    u, g = JaxSpecNoise(rng).verify_draws(*drafts.shape, logits.shape[-1],
                                          "cpu")
    ja, jt, jl = JSP.verify_tokens(jnp.asarray(logits), jnp.asarray(drafts),
                                   jax.random.split(rng)[1], temperature,
                                   False)
    ta, tt, tl = TSP.verify_tokens(torch.from_numpy(logits),
                                   torch.from_numpy(drafts), temperature,
                                   False, u, g)
    ja = np.asarray(ja)
    np.testing.assert_array_equal(ta.numpy(), ja)
    for b in range(len(ja)):
        e = ja[b] + 1
        np.testing.assert_array_equal(tt.numpy()[b, :e], np.asarray(jt)[b, :e])
        np.testing.assert_allclose(tl.numpy()[b, :e], np.asarray(jl)[b, :e],
                                   rtol=0, atol=1e-6)
    assert 0 < ja.sum() and (ja < drafts.shape[1]).any()


def test_sampled_verify_needs_its_draws():
    logits, drafts = _verify_case(0)
    with pytest.raises(ValueError, match="draws"):
        TSP.verify_tokens(torch.from_numpy(logits), torch.from_numpy(drafts),
                          0.8, False)


def test_emission_distribution_equals_the_reference_and_the_target():
    rng = np.random.default_rng(1)
    p = rng.dirichlet(np.ones(16))
    for d in (0, 3, int(p.argmax())):
        got = TSP.emission_distribution(p, d)
        np.testing.assert_array_equal(got, JSP.emission_distribution(p, d))
        np.testing.assert_allclose(got, p, atol=1e-12)


@pytest.mark.parametrize("seed,d,temperature", [(0, 3, 1.0), (1, 0, 0.5),
                                                (2, 7, 1.7)])
def test_sampled_verify_preserves_the_target_distribution(seed, d,
                                                          temperature):
    """The first emitted token of the sampled rule, over the port's own
    draws (`GumbelNoise.verify_draws`), is distributed as the tempered
    target."""
    V, B = 12, 8000
    rng = np.random.default_rng(seed)
    row = torch.from_numpy((rng.normal(size=(V,)) * 2.0).astype(np.float32))
    logits = row[None, None].expand(B, 2, V)
    drafts = torch.full((B, 1), d, dtype=torch.int64)
    noise = GumbelNoise(torch.Generator().manual_seed(seed))
    u, g = noise.verify_draws(B, 1, V, torch.device("cpu"))
    _, toks, _ = TSP.verify_tokens(logits, drafts, temperature, False, u, g)
    hist = np.bincount(toks[:, 0].numpy(), minlength=V) / B
    target = torch.softmax(row / temperature, -1).double().numpy()
    assert 0.5 * np.abs(hist - target).sum() < 0.05       # total variation
    se = np.sqrt(target[d] * (1 - target[d]) / B)
    assert abs(hist[d] - target[d]) < 5 * se + 1e-3


# ================================================================ policies

@pytest.mark.parametrize("seed", range(3))
def test_ngram_proposals_equal_the_reference(seed):
    """The port scans the earlier start positions with numpy at once, the
    reference one at a time: the same proposals, over histories with many
    repeats (small vocabularies) and with few."""
    rng = np.random.default_rng(seed)
    hists = [rng.integers(0, v, size=rng.integers(0, 60))
             for v in (2, 3, 6, 6, 20, 64, 65024) for _ in range(4)]
    for kw in ({}, dict(max_ngram=1), dict(max_ngram=2),
               dict(max_ngram=5, min_ngram=2)):
        for n in (1, 3, 6):
            np.testing.assert_array_equal(
                TSP.NGramDraftPolicy(**kw).propose(hists, n),
                JSP.NGramDraftPolicy(**kw).propose(hists, n))
    assert TSP.NGramDraftPolicy(max_ngram=3).propose(
        [np.array([5, 6, 7, 9, 5, 6, 7])], 2).tolist() == [[9, 5]]
    with pytest.raises(ValueError):
        TSP.NGramDraftPolicy(max_ngram=0)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_draft_model_proposals_equal_the_reference(use_kernel):
    """Ragged contexts, left-padded into one bucket (pad columns at
    negative positions): the same proposals as the reference's rollout. A
    target with its kernels on would send a cache-free forward to the
    flash kernel, which takes positions as an iota from 0; the policy's
    own model takes the masked plain path."""
    jm, jp, tm, tp = models("fixture", seed=3, use_kernel=use_kernel)
    rng = np.random.default_rng(5)
    hists = [rng.integers(0, 64, size=L) for L in (1, 9, 17, 30, 63)]
    for bucket, n in ((64, 4), (8, 2), (16, 5)):
        got = TSP.DraftModelPolicy(tm, tp, bucket=bucket).propose(hists, n)
        want = JSP.DraftModelPolicy(jm, jp, bucket=bucket).propose(hists, n)
        assert got.dtype == np.int32 and got.shape == (5, n)
        np.testing.assert_array_equal(got, want)
    assert TSP.DraftModelPolicy(tm, tp).model.use_kernel is False


def test_make_draft_policy_and_spec_supported(pair):
    _, _, tm, tp = pair
    assert TSP.make_draft_policy("off") is None
    assert TSP.make_draft_policy("ngram").name == "ngram"
    assert TSP.make_draft_policy("draft", draft_model=tm,
                                 draft_params=tp).name == "draft"
    with pytest.raises(ValueError, match="draft_model"):
        TSP.make_draft_policy("draft")
    with pytest.raises(ValueError, match="unknown"):
        TSP.make_draft_policy("medusa")
    from _torch_parity import configs
    import dataclasses
    for name, over in (("fixture", {}), ("fixture", dict(attn_window=4)),
                       ("fixture", dict(n_codebooks=2)),
                       ("mamba2-370m", {}), ("deepseek-v2-lite-16b", {}),
                       ("granite-moe-3b-a800m", {}), ("jamba-v0.1-52b", {})):
        jc, tc = configs(name)
        jc, tc = (dataclasses.replace(c, **over) for c in (jc, tc))
        assert TSP.spec_supported(tc) == JSP.spec_supported(jc)
    assert TSP.spec_supported(tm.cfg)


def test_spec_package_exports_the_reference_names():
    assert TSP.__all__ == JSP.__all__
    assert TSP.DEFAULT_DEPTHS == JSP.DEFAULT_DEPTHS
    assert TSP.DEFAULT_ACCEPT_RATE == JSP.DEFAULT_ACCEPT_RATE


# ================================================================ routing

def test_expected_tokens_and_spec_workload_equal_the_reference():
    for n in range(0, 6):
        for a in (0.0, 0.2, 0.5, 0.7, 0.99, 1.0, 1.3):
            assert TSP.expected_tokens_per_step(n, a) == \
                JSP.expected_tokens_per_step(n, a)
    jw = J.Workload(batch=2, prompt_tokens=8, decode_tokens=16, samples=3)
    tw = T.Workload(batch=2, prompt_tokens=8, decode_tokens=16, samples=3)
    assert TSP.spec_workload(tw, 0, 0.9) is tw
    for n, a in ((3, 0.5), (4, 0.7), (2, 1.0)):
        assert vars(TSP.spec_workload(tw, n, a)) == \
            vars(JSP.spec_workload(jw, n, a))
    plan = TSP.SpecPlan("ngram", 4, 0.5)
    assert plan.tokens_per_step == JSP.SpecPlan("ngram", 4, 0.5
                                                ).tokens_per_step
    assert plan.enabled and not TSP.SpecPlan("off", 0, 1.0).enabled


def _bench_router(side, cfg):
    """`benchmarks/spec_decode.py`'s router, built by each package."""
    core, q2 = PKG[side][:2]
    w = core.Workload(batch=1, prompt_tokens=PLEN, decode_tokens=MAX_NEW,
                      samples=1)
    orch = q2.PGSAMOrchestrator(
        core.EDGE_PLATFORM, core.Constraints(latency_budget_factor=None),
        config=q2.PGSAMConfig(seed=0, iters_max=600, incremental=True),
        energy_model="v2")
    router = q2.ParetoRouter(orch, cfg, w)
    c8 = min(router.recost(a, router.batch_workload(8)).makespan_s
             for a in router.frontier)
    router.add_tier(q2.SLATier("interactive", latency_p99_s=1.05 * c8,
                               energy_weight=0.0, latency_weight=1.0))
    router.add_tier(q2.SLATier("standard", latency_p99_s=1.25 * c8,
                               energy_weight=0.5, latency_weight=0.5))
    router.add_tier(q2.SLATier("economy", energy_weight=1.0,
                               latency_weight=0.0))
    return router


@pytest.fixture(scope="module")
def routers(pair):
    jm, _, tm, _ = pair
    return {"ref": _bench_router("ref", jm.cfg),
            "port": _bench_router("port", tm.cfg)}


def test_spec_planner_depths_equal_the_reference(routers):
    seen = set()
    for rate in (0.0, 0.05, 0.3, 0.7, 0.95, 1.0):
        for tiers in (["economy"] * 4, ["interactive", "standard"],
                      ["standard"] * 3):
            got = {}
            for side, (_, _, _, spec) in PKG.items():
                planner = spec.SpecPlanner("ngram", depths=(0, 2, 4),
                                           accept_rate=rate,
                                           model_name="fixture")
                d = planner.route_batch(routers[side], tiers, samples=2,
                                        prompt_tokens=64, decode_tokens=64)
                got[side] = (d.spec.n, d.spec.accept_rate, d.point_index,
                             d.energy_j, d.latency_s, d.meets_caps,
                             list(d.notes))
            assert got["port"] == got["ref"], (rate, tiers)
            seen.add(got["port"][0])
    assert {0, 4} <= seen


def test_spec_planner_refresh_takes_fitted_rates(routers):
    store = {}
    for side, (_, q2, _, spec) in PKG.items():
        trace = q2.TraceStore()
        for t, pol, prop, acc, tier in ((0.1, "ngram", 60, 6, "economy"),
                                        (0.2, "draft", 50, 45, "economy")):
            trace.ingest({"kind": "spec", "t_s": t, "policy": pol, "n": 4,
                          "proposed": prop, "accepted": acc, "model": "m",
                          "tier": tier})
        profile, _ = q2.CalibrationFitter(trace, n_bootstrap=0).fit()
        out = []
        for pol in ("ngram", "draft"):
            planner = spec.SpecPlanner(pol, depths=(0, 2, 4), model_name="m")
            planner.refresh(profile)
            d = planner.route_batch(routers[side], ["economy"] * 4,
                                    samples=1, prompt_tokens=64,
                                    decode_tokens=64)
            out.append((planner.accept_rate_for("economy"), d.spec.n))
        store[side] = out
    assert store["port"] == store["ref"]
    assert store["port"][0][1] == 0 and store["port"][1][1] == 4


# ======================================================= serving parity

def _pooled_rounds(vocab=64):
    """Two rounds of 3 prompts sharing a 9-token head (2 full blocks of 4)
    with 4 tokens of their own: round 2 hits the pool."""
    rng = np.random.default_rng(11)
    head = rng.integers(0, vocab, 9).astype(np.int32)
    return [[np.concatenate([head, rng.integers(0, vocab, 4).astype(
        np.int32)]) for _ in range(3)] for _ in range(2)]


def _rounds(mode):
    return _pooled_rounds() if mode.startswith("pooled") else \
        [_prompts(3, seed=2)]


@pytest.fixture(scope="module")
def greedy_plain(pair):
    """The port's plain greedy decode of each mode's rounds."""
    _, _, tm, tp = pair
    out = {}
    for mode in MODES:
        be = _backend("port", tm, tp, mode=mode)
        out[mode] = [_drain(be, p, 0.0, None, n_samples=2)[0]
                     for p in _rounds(mode)]
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["ngram", "draft"])
def test_greedy_spec_matches_the_reference_and_plain_decode(
        pair, greedy_plain, kind, mode):
    jm, jp, tm, tp = pair
    jb = _backend("ref", jm, jp, kind, mode)
    tb = _backend("port", tm, tp, kind, mode)
    for r, prompts in enumerate(_rounds(mode)):
        jr, jh = _drain(jb, prompts, 0.0, jax.random.key(r), n_samples=2)
        tr, th = _drain(tb, prompts, 0.0, None, n_samples=2)
        _same(jr, tr, TOL)
        _same(greedy_plain[mode][r], tr, LOGPROB_ATOL)
        assert (th.spec.steps, th.spec.proposed, th.spec.accepted) == \
            (jh.spec.steps, jh.spec.proposed, jh.spec.accepted)
        if kind == "draft":
            # draft == target at temperature 0 accepts every draft
            assert th.spec.accepted == th.spec.proposed > 0
        if mode.startswith("pooled"):
            assert th.pool_hit_blocks == jh.pool_hit_blocks == 6 * r
    if tb.allocator is not None:
        resident = (tb.prefix_pool.blocks_resident
                    if tb.prefix_pool is not None else 0)
        assert tb.allocator.blocks_in_use == resident


@pytest.mark.parametrize("mode", ["dense", "paged", "pooled", "chunked"])
@pytest.mark.parametrize("kind", ["ngram", "draft"])
def test_sampled_spec_with_the_reference_keys(pair, kind, mode):
    jm, jp, tm, tp = pair
    jb = _backend("ref", jm, jp, kind, mode)
    tb = _backend("port", tm, tp, kind, mode)
    for r, prompts in enumerate(_rounds(mode)):
        key = jax.random.key(40 + r)
        jr, jh = _drain(jb, prompts, 0.8, key, n_samples=3)
        tr, th = _drain(tb, prompts, 0.8, JaxSpecNoise(key), n_samples=3)
        _same(jr, tr, TOL)
        assert (th.spec.proposed, th.spec.accepted) == \
            (jh.spec.proposed, jh.spec.accepted)
        # the draws did their work: the draft (= target) rows accept some
        # drafts and reject others, and repeats diverge
        if kind == "draft":
            assert 0 < th.spec.accepted < th.spec.proposed
        assert any(not np.array_equal(x.samples[0], x.samples[1])
                   for x in tr)


def test_sampled_spec_with_a_plain_noise_callable(pair):
    """A noise source without ``verify_draws`` still speculates: its
    uniforms are Gumbel draws through the Gumbel CDF."""
    _, _, tm, tp = pair
    gen = torch.Generator().manual_seed(3)

    def noise(shape, device):
        return GumbelNoise(gen)(shape, device)

    be = _backend("port", tm, tp, "draft", "paged")
    res, h = _drain(be, _prompts(2), 0.8, noise, n_samples=2)
    assert all(len(s) == MAX_NEW for r in res for s in r.samples)
    assert 0 < h.spec.accepted <= h.spec.proposed


def test_pooled_spec_repeat_prompt_pins_f1(pair):
    """The reference's ``test_spec_decode_composes_with_pool`` (F1: it asks
    a warm pooled batch for bits that the tail prefill's summation order
    does not keep): one 16-token prompt twice on the pool, ngram drafting
    at depth 2, greedy. The warm batch finds 3 blocks, and gives the cold
    batch's tokens and the reference's, logprobs within f32 tolerance."""
    jm, jp, tm, tp = pair
    p = _prompts(1, seed=21, plen=16)
    out = {}
    for side, (m, prm) in (("ref", (jm, jp)), ("port", (tm, tp))):
        be = PKG[side][2].ExecutionBackend(
            m, prm, kv_blocks=96, kv_block_size=BS, kv_pool=True,
            spec_policy=PKG[side][3].make_draft_policy("ngram"), spec_n=2)
        noise = jax.random.key(0) if side == "ref" else None
        out[side] = [_drain(be, p, 0.0, noise, max_new=5) for _ in range(2)]
        assert out[side][1][1].pool_hit_blocks == 3
        assert be.allocator.blocks_in_use == be.prefix_pool.blocks_resident
    (c, _), (w, _) = out["port"]
    _same(c, w, 1e-5)
    for (jr, _), (tr, _) in zip(out["ref"], out["port"]):
        _same(jr, tr, TOL)


# ================================================== rollback and budget

@pytest.mark.parametrize("seed", range(6))
def test_rollback_with_a_midflight_release_leaves_the_allocator_clean(
        pair, seed):
    _, _, tm, tp = pair
    be = _backend("port", tm, tp, "ngram", "paged")
    h = be.start_batch(_prompts(3, seed=seed), 1, MAX_NEW, 0.7,
                       GumbelNoise(torch.Generator().manual_seed(seed)), {})
    rng = np.random.default_rng(seed)
    released = False
    while be.decode_step(h):
        if not released and rng.random() < 0.5:
            be.release_sequences(h, [int(rng.integers(0, 3))])
            released = True
    res = be.finalize(h)
    alloc = be.allocator
    assert alloc.blocks_in_use == 0
    assert alloc.blocks_in_use + alloc.blocks_free == alloc.n_blocks
    for r in res:
        assert all(len(s) == MAX_NEW for s in r.samples)
        assert np.all(np.isfinite(r.logprobs))
    with pytest.raises(RuntimeError):
        be.release(h)           # finalize already returned the budget


@pytest.mark.parametrize("mode", ["paged", "pooled"])
def test_spec_slack_is_priced_into_admission(pair, mode):
    jm, jp, tm, tp = pair
    plain = _backend("port", tm, tp, mode=mode)
    spec = _backend("port", tm, tp, "ngram", mode)
    ref = _backend("ref", jm, jp, "ngram", mode)
    for plen, new, k in ((PLEN, MAX_NEW, 1), (13, 5, 3), (4, 1, 2)):
        assert spec.request_blocks(plen, new, k) == \
            ref.request_blocks(plen, new, k)
    rb_spec = spec.request_blocks(PLEN, MAX_NEW, 1)
    assert rb_spec > plain.request_blocks(PLEN, MAX_NEW, 1)
    h = spec.start_batch(_prompts(1), 1, MAX_NEW, 0.0, None, {})
    assert spec.allocator.blocks_in_use == rb_spec
    assert h.paged.kv_len == PLEN + MAX_NEW + SPEC_N + 1
    spec.finalize(h)


@pytest.fixture(scope="module")
def granite():
    return models("granite-moe-3b-a800m", seed=1)


@pytest.mark.parametrize("mode", ["dense", "paged"])
@pytest.mark.parametrize("depth", [2, 4])
def test_granite_moe_greedy_spec_matches_the_reference_spec(granite, depth,
                                                            mode):
    """An MoE layer's expert capacity depends on the forward's token count
    (`repro.models.moe`), so a verify at S = n + 1 may drop other tokens
    than n + 1 one-token steps: the port's MoE speculative serve is held to
    the reference's speculative serve in the same mode, not to plain
    decode."""
    jm, jp, tm, tp = granite
    prompts = _prompts(2, seed=4, plen=9, vocab=jm.cfg.vocab_size)
    jb = _backend("ref", jm, jp, "ngram", mode, spec_n=depth)
    tb = _backend("port", tm, tp, "ngram", mode, spec_n=depth)
    jr, jh = _drain(jb, prompts, 0.0, jax.random.key(0), n_samples=2,
                    max_new=8)
    tr, th = _drain(tb, prompts, 0.0, None, n_samples=2, max_new=8)
    _same(jr, tr, TOL)
    assert (th.spec.steps, th.spec.proposed, th.spec.accepted) == \
        (jh.spec.steps, jh.spec.proposed, jh.spec.accepted)
    assert th.spec.n == depth and th.spec.steps >= 2


def test_dense_cache_holds_the_slack(pair):
    _, _, tm, tp = pair
    be = _backend("port", tm, tp, "ngram", "dense")
    h = be.start_batch(_prompts(2), 1, MAX_NEW, 0.0, None, {})
    # (super-blocks, rows, slots, kv heads, head dim)
    assert h.cache["blocks"]["l0"]["k"].shape[2] == \
        PLEN + MAX_NEW + SPEC_N + 1
    be.finalize(h)


def test_note_spec_validation_and_one_shot_consumption(pair):
    _, _, tm, tp = pair
    plain = _backend("port", tm, tp)
    spec = _backend("port", tm, tp, "ngram")
    with pytest.raises(RuntimeError, match="no draft policy"):
        plain.note_spec(1)
    with pytest.raises(ValueError, match="outside"):
        spec.note_spec(SPEC_N + 1)
    with pytest.raises(ValueError, match="outside"):
        spec.note_spec(-1)
    spec.note_spec(0)
    h0 = spec.start_batch(_prompts(1), 1, MAX_NEW, 0.0, None, {})
    assert h0.spec is None
    spec.release(h0)
    spec.note_spec(2)
    h2 = spec.start_batch(_prompts(1), 1, MAX_NEW, 0.0, None, {})
    assert h2.spec is not None and h2.spec.n == 2
    spec.release(h2)
    h3 = spec.start_batch(_prompts(1), 1, MAX_NEW, 0.0, None, {})
    assert h3.spec is not None and h3.spec.n == SPEC_N
    spec.release(h3)


def test_constructor_checks(pair):
    _, _, tm, tp = pair
    with pytest.raises(ValueError, match="spec_n >= 1"):
        TS.ExecutionBackend(tm, tp, spec_policy=TSP.NGramDraftPolicy())
    import dataclasses
    from repro_torch.models import Model
    windowed = Model(dataclasses.replace(tm.cfg, attn_window=4),
                     dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        TS.ExecutionBackend(windowed, tp, spec_policy=TSP.NGramDraftPolicy(),
                            spec_n=2)


def test_spec_metrics_and_spans(pair):
    from repro_torch.obs import make_observability
    _, _, tm, tp = pair
    obs = make_observability()
    be = _backend("port", tm, tp, "draft", "paged", obs=obs)
    _, h = _drain(be, _prompts(2), 0.0, None)
    m = obs.metrics
    assert m.counter("serving_spec_proposed_total").value() == \
        h.spec.proposed > 0
    assert m.counter("serving_spec_accepted_total").value() == \
        h.spec.accepted
    names = [s.name for s in obs.tracer.spans]
    assert names.count("draft") == names.count("verify") == h.spec.steps


# ================================================== the scheduler path

def _sched(side, model, params, router, kind, mode, temperature, trace):
    core, q2, serving, spec = PKG[side]
    backend = _backend(side, model, params, kind, mode, spec_n=4)
    kw = {}
    if side == "port":
        def noise_for_batch(batch_id, requests):
            base = jax.random.fold_in(jax.random.key(0), batch_id)
            return JaxSpecNoise(jax.random.split(base)[1])
        kw["noise_for_batch"] = noise_for_batch
    sched = serving.ContinuousBatchingScheduler(
        backend, router,
        serving.SchedulerConfig(max_batch_requests=3, max_inflight_batches=2,
                                max_new_tokens=MAX_NEW,
                                temperature=temperature, seed=0),
        trace=trace,
        spec_planner=spec.SpecPlanner(kind, depths=(0, 2, 4),
                                      model_name=model.cfg.name), **kw)
    return sched


def _record(r) -> dict:
    d = dict(vars(r))
    d["request_entries"] = [dict(e) for e in r.request_entries]
    return d


@pytest.mark.parametrize("kind,mode,temperature", [
    ("draft", "paged", 0.0), ("ngram", "pooled", 0.8),
    ("draft", "dense", 0.8)])
def test_scheduler_with_a_spec_planner_matches_the_reference(
        pair, routers, kind, mode, temperature):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(7)
    tiers = ["interactive", "standard", "economy"]
    stream = [(float(t), tiers[i % 3], p) for i, (t, p) in enumerate(zip(
        np.cumsum(rng.exponential(0.02, 9)), _prompts(9, seed=8)))]
    out = {}
    for side, (m, p) in (("ref", (jm, jp)), ("port", (tm, tp))):
        trace = PKG[side][1].TraceStore()
        sched = _sched(side, m, p, routers[side], kind, mode, temperature,
                       trace)
        ids = []
        for t, tier, prompt in stream:
            ids.append(sched.submit(prompt, tier=tier, n_samples=2,
                                    arrival_s=t).request_id)
        done = sched.run_until_idle()
        out[side] = SimpleNamespace(
            records=[_record(r) for r in sched.records],
            spec=trace.records("spec"),
            results=[done[i].result for i in ids])
    assert out["port"].records == out["ref"].records
    assert out["port"].spec == out["ref"].spec
    _same(out["ref"].results, out["port"].results, TOL)
    assert {r["spec_n"] for r in out["port"].records} & {2, 4}
    assert out["port"].spec


# ================================================== launcher and bench

def test_launcher_spec_lines_and_checks(capsys):
    from repro.launch.serve import main as jmain
    from repro_torch.launch.serve import main as tmain
    argv = ["--arch", "chatglm3-6b", "--smoke", "--requests", "4",
            "--samples", "2", "--prompt-len", "8", "--max-new", "6",
            "--router", "--mixed", "--max-batch", "2", "--kv-blocks", "48",
            "--kv-block-size", "4", "--spec", "ngram"]
    import sys
    old = sys.argv
    sys.argv = ["serve"] + argv
    try:
        jmain()
    finally:
        sys.argv = old
    ref = capsys.readouterr().out
    tmain(argv + ["--device", "cpu"])
    port = capsys.readouterr().out

    def lines(out):
        # the measured accept rate depends on the weights, which differ
        return [ln.split(" a=")[0] for ln in out.splitlines()
                if ln.startswith(("[spec]", "[scheduler]"))]

    assert lines(port) == lines(ref)
    assert "spec=ngram:4" in port
    assert "[serve] 4 requests x 2 samples, 48 tokens" in port
    tmain(["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
           "--requests", "2", "--samples", "1", "--prompt-len", "8",
           "--max-new", "5", "--spec", "draft", "--spec-n", "2"])
    assert "[spec] policy draft depth 2" in capsys.readouterr().out


def test_launcher_refuses_what_the_reference_refuses():
    import argparse
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import draft_policy
    from repro_torch.models import Model
    args = argparse.Namespace(spec="draft", spec_n=4, draft_model=None,
                              arch="chatglm3-6b")
    full = get_config("chatglm3-6b")           # vocab 65024, no weights made
    model = Model(full, dtype=torch.float32, device="cpu")
    with pytest.raises(SystemExit, match="vocab 512 != target vocab 65024"):
        draft_policy(args, full, model, torch.device("cpu"))
    ssm = get_config("mamba2-370m").reduced()
    with pytest.raises(SystemExit, match="unsupported"):
        draft_policy(args, ssm, Model(ssm, device="cpu"),
                     torch.device("cpu"))


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_replay_of_the_spec_bench_passes_its_baseline():
    res = _load(ROOT / "scripts" / "port_spec_decode.py").run("cpu")
    compare = _load(ROOT / "benchmarks" / "compare.py").compare
    base = json.loads((ROOT / "benchmarks" / "baselines" /
                       "spec_decode.json").read_text())
    assert compare(base, res, "spec_decode") == []
    assert res["acceptance_all"] and res["device"] == "cpu"
    for kind in ("off", "ngram", "draft"):
        assert res["variants"][kind]["completed"] == \
            base["variants"][kind]["completed"]
