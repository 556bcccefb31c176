"""The port's continuous-batching scheduler (`repro_torch.serving.scheduler`)
against the reference's, and its invariants inside the port.

* Parity over the scheduling bench's stream shape (Poisson arrivals on the
  router's simulated clock, three tiers, a shared system prompt, tier
  preemption and CSVET early stops) on the 2-layer fixture and reduced
  chatglm3-6b, dense, per-batch paged and on the resident prefix pool: the
  reference's scheduler over its backend and the port's over its own, the
  port replaying the reference's per-batch keys through ``noise_for_batch``.
  Batch records and ``stats()`` equal, tokens identical, logprobs within
  1e-4 (F1: the pooled tail prefill sums in other orders), and the blocks
  released early and the F8 probe's count equal.
* Policy, on the stub backends of tests/test_serving_scheduler.py in both
  packages: FIFO within a tier and bucket, no bucket mixing, admission, and
  a batch that shrinks to meet a tight cap, decided alike.

tests/test_torch_preemption.py holds the rest: preemption, obs, noise,
early stops, faults and F8.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from _torch_parity import jax, models
from test_torch_serving import JaxGumbel

import repro.core as J  # noqa: E402
import repro.qeil2 as JQ  # noqa: E402
import repro.serving as JS  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.qeil2 as TQ  # noqa: E402
import repro_torch.serving as TS  # noqa: E402
from repro_torch.serving.stream import (CsvetStop,  # noqa: E402
                                        ReleasedWriteProbe, drive,
                                        poisson_stream, stream_router)

TOL = 1e-4
SEED = 0
BS = 4
SYSTEM, OWN, NEW, K = 8, 8, 8, 2
PKG = {"ref": (J, JQ, JS), "port": (T, TQ, TS)}
BACKENDS = {"dense": dict(max_slots=16),
            "paged": dict(kv_blocks=48, kv_block_size=BS),
            "pooled": dict(kv_blocks=48, kv_block_size=BS, kv_pool=True)}


def _router(side: str, cfg):
    """The scheduling bench's router (`stream_router`), built by each
    package from its own modules."""
    core, q2, _ = PKG[side]
    w = core.Workload(batch=1, prompt_tokens=SYSTEM + OWN,
                      decode_tokens=NEW, samples=K)
    orch = q2.PGSAMOrchestrator(
        core.EDGE_PLATFORM, core.Constraints(latency_budget_factor=None),
        config=q2.PGSAMConfig(seed=SEED, iters_max=1500, incremental=True),
        energy_model="v2")
    router = q2.ParetoRouter(orch, cfg, w)
    c4 = min(router.recost(a, router.batch_workload(4)).makespan_s
             for a in router.frontier)
    c8 = min(router.recost(a, router.batch_workload(8)).makespan_s
             for a in router.frontier)
    router.add_tier(q2.SLATier("interactive", latency_p99_s=1.01 * c4,
                               energy_weight=0.0, latency_weight=1.0))
    router.add_tier(q2.SLATier("standard", latency_p99_s=1.05 * c8,
                               energy_weight=0.5, latency_weight=0.5))
    router.add_tier(q2.SLATier("economy", energy_weight=1.0,
                               latency_weight=0.0))
    return router


def _arrivals(router, vocab: int, n: int = 10):
    rng = np.random.default_rng(SEED)
    system = rng.integers(0, vocab, SYSTEM).astype(np.int32)
    return poisson_stream(router, n, 1.6, rng, lambda r: np.concatenate(
        [system, r.integers(0, vocab, OWN).astype(np.int32)]))


def reference_noise(seed: int):
    """The reference scheduler's per-batch key, as `JaxGumbel` noise."""
    def noise(batch_id, requests):
        base = jax.random.fold_in(jax.random.key(seed), batch_id)
        return JaxGumbel(jax.random.split(base)[1])
    return noise


def _record(r) -> dict:
    d = dict(vars(r))
    d["request_entries"] = [dict(e) for e in r.request_entries]
    return d


def _serve(side, model, params, router, arrivals, mode, *, early_stop=True,
           temperature=0.8, preempt=True, obs=None, **sched_kw):
    core, q2, serving = PKG[side]
    backend = serving.ExecutionBackend(model, params, obs=obs,
                                       **BACKENDS[mode])
    if side == "port":
        sched_kw.setdefault("noise_for_batch", reference_noise(SEED))
    sched = serving.ContinuousBatchingScheduler(
        backend, router,
        serving.SchedulerConfig(max_batch_requests=4, max_inflight_batches=2,
                                max_new_tokens=NEW, temperature=temperature,
                                preempt=preempt, seed=SEED), obs=obs,
        **sched_kw)
    probe = ReleasedWriteProbe()
    stop = CsvetStop(np.random.default_rng(SEED + 1), probe=probe)
    drive(sched, arrivals, K, [probe, stop] if early_stop else [])
    return SimpleNamespace(sched=sched, backend=backend,
                           released=stop.released, f8=probe.hits)


def _same_results(a, b, tol):
    assert set(a.completed) == set(b.completed)
    for rid, ca in a.completed.items():
        ra, rb = ca.result, b.completed[rid].result
        assert len(ra.samples) == len(rb.samples) == K
        for x, y in zip(ra.samples, rb.samples):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(ra.logprobs, rb.logprobs, rtol=tol,
                                   atol=tol)
        assert (ra.prefill_tokens, ra.decode_tokens) == \
            (rb.prefill_tokens, rb.decode_tokens)


@pytest.fixture(scope="module", params=["fixture", "chatglm3-6b"])
def pair(request):
    return models(request.param, seed=0)


@pytest.fixture(scope="module")
def routers(pair):
    jm, _, tm, _ = pair
    return _router("ref", jm.cfg), _router("port", tm.cfg)


@pytest.mark.parametrize("mode", ["dense", "paged", "pooled"])
def test_scheduled_stream_matches_the_reference(pair, routers, mode):
    jm, jp, tm, tp = pair
    arrivals = _arrivals(routers[1], tm.cfg.vocab_size)
    ref = _serve("ref", jm, jp, routers[0], arrivals, mode)
    port = _serve("port", tm, tp, routers[1], arrivals, mode)
    assert [_record(r) for r in ref.sched.records] == \
        [_record(r) for r in port.sched.records]
    assert ref.sched.stats() == port.sched.stats()
    assert (ref.released, ref.f8) == (port.released, port.f8)
    _same_results(ref.sched, port.sched, TOL)
    st = port.sched.stats()
    assert st["completed"] == len(arrivals) and st["cancelled"] == 0
    assert st["preemptions"].get("tier", 0) >= 1
    if mode != "dense":
        assert port.released > 0
    if mode == "pooled":
        assert st["pool_hit_blocks"] > 0
        assert port.backend.blocks_in_use == \
            port.backend.prefix_pool.blocks_resident
    else:
        assert port.backend.capacity_free == \
            port.backend.capacity_total


def test_stream_router_is_the_bench_router(pair, routers):
    """`repro_torch.serving.stream.stream_router` builds the router the
    parity tests build by hand."""
    _, _, tm, _ = pair
    built = stream_router(tm.cfg, T.Workload(
        batch=1, prompt_tokens=SYSTEM + OWN, decode_tokens=NEW, samples=K))
    for name in ("interactive", "standard", "economy"):
        assert built.tiers[name] == routers[1].tiers[name]
    assert built.route_all().keys() == routers[1].route_all().keys()


# ------------------------------------------------------------------ policy

class _StubRouter:
    """Fixed-latency routing double (tests/test_preemption.py's)."""

    def __init__(self, base_latency_s=1.0, per_request_s=0.25, device=None):
        self.tiers = {t.name: t for t in (
            TQ.SLATier("interactive", energy_weight=0.0, latency_weight=1.0),
            TQ.SLATier("standard", energy_weight=0.5, latency_weight=0.5),
            TQ.SLATier("economy", energy_weight=1.0, latency_weight=0.0))}
        self.base = base_latency_s
        self.per_request = per_request_s
        self.device = device

    def resolve_tier(self, tier):
        return self.tiers[tier] if isinstance(tier, str) else tier

    def required_samples(self, tier):
        return None

    def route_batch(self, tiers, **kw):
        members = [self.resolve_tier(t) for t in tiers]
        dev = self.device
        assignment = (SimpleNamespace(device_names=lambda: [dev])
                      if dev is not None else object())
        return SimpleNamespace(
            tier=TQ.merge_tiers(members), tier_counts={},
            assignment=assignment, point_index=0, meets_caps=True,
            batch_costs=None, energy_j=1.0 * len(members),
            latency_s=self.base + self.per_request * len(members), notes=[])


class _StubBackend:
    """tests/test_serving_scheduler.py's scheduling double."""

    def __init__(self, max_slots=None):
        self.max_slots = max_slots
        self.slots_in_use = 0
        self.batches = []

    @property
    def slots_free(self):
        return None if self.max_slots is None else \
            self.max_slots - self.slots_in_use

    def note_placement(self, placement):
        pass

    def start_batch(self, prompts, n_samples, max_new, temperature, rng,
                    extras=None):
        assert len({len(p) for p in prompts}) == 1
        h = SimpleNamespace(prompts=list(prompts), repeats=list(n_samples),
                            steps_left=max_new - 1, done=max_new <= 1)
        self.slots_in_use += sum(n_samples)
        self.batches.append(([len(p) for p in prompts], list(n_samples)))
        return h

    def decode_step(self, h):
        h.steps_left -= 1
        h.done = h.steps_left <= 0
        return not h.done

    def finalize(self, h):
        self.slots_in_use -= sum(h.repeats)
        return [SimpleNamespace(prompt=p, samples=[], logprobs=[])
                for p in h.prompts]


def _policy_run(side, tiers, plens, router=None, max_batch=4, max_slots=None,
                n_samples=1, **submit_kw):
    _, _, serving = PKG[side]
    sched = serving.ContinuousBatchingScheduler(
        _StubBackend(max_slots), router or _StubRouter(),
        serving.SchedulerConfig(max_batch_requests=max_batch,
                                max_new_tokens=4))
    adm = [sched.submit(np.arange(1, p + 1, dtype=np.int32), tier=t,
                        n_samples=n_samples, **submit_kw)
           for t, p in zip(tiers, plens)]
    sched.run_until_idle()
    order = [(c.batch_id, c.request.seq, c.request.tier_name)
             for c in sorted(sched.completed.values(),
                             key=lambda c: (c.batch_id, c.request.seq))]
    return ([(a.admitted, a.request_id, a.reason_code) for a in adm], order,
            sched.backend.batches, [_record(r) for r in sched.records],
            sched.stats())


def test_fifo_buckets_and_slots_decided_alike():
    rng = np.random.default_rng(0)
    tiers = [["interactive", "standard", "economy"][i]
             for i in rng.integers(0, 3, 24)]
    plens = [int(p) for p in rng.choice([4, 8, 16], 24)]
    for kw in (dict(max_batch=4), dict(max_batch=8, max_slots=6,
                                       n_samples=2)):
        ref = _policy_run("ref", tiers, plens, **kw)
        port = _policy_run("port", tiers, plens, **kw)
        assert ref == port
        # FIFO within (tier, bucket), and no batch mixes buckets
        seen = {}
        for _, seq, tier in port[1]:
            key = (tier, plens[seq])
            assert seq > seen.get(key, -1)
            seen[key] = seq
        assert all(len(set(b)) == 1 and sum(r) <= kw.get("max_slots", 99)
                   for b, r in port[2])


def test_admission_decided_alike(pair, routers):
    out = {}
    for side, router in zip(("ref", "port"), routers):
        _, q2, serving = PKG[side]
        q = serving.RequestQueue(router, max_queue_depth=2)
        floor = q2.SLATier("quality", min_quality=0.95, energy_weight=1.0)
        res = [q.submit(np.arange(1, 5, dtype=np.int32), t, n_samples=1)
               for t in ("no-such-tier", "economy", "economy", "economy",
                         "standard", floor)]
        out[side] = ([(r.admitted, r.request_id, r.reason_code,
                       r.raised_samples) for r in res],
                     [r.reason_code for r in q.rejections],
                     [(r.id, r.n_samples) for r in q.pop_batch(8)])
        sched = serving.ContinuousBatchingScheduler(
            _StubBackend(max_slots=4), _StubRouter(),
            serving.SchedulerConfig(max_new_tokens=4))
        bad = sched.submit(np.arange(8, dtype=np.int32), "economy",
                           n_samples=5)
        out[side] += ((bad.admitted, bad.reason_code),)
    assert out["ref"] == out["port"]
    assert out["port"][0][5][3] is not None          # the floor raised k


def test_batch_shrinks_to_meet_a_tight_cap_alike(pair, routers):
    out = {}
    for side, router in zip(("ref", "port"), routers):
        _, q2, _ = PKG[side]
        c1 = min(router.recost(a, router.batch_workload(1)).makespan_s
                 for a in router.frontier)
        c8 = min(router.recost(a, router.batch_workload(8)).makespan_s
                 for a in router.frontier)
        router.add_tier(q2.SLATier("tight", latency_p99_s=(c1 + c8) / 2,
                                   energy_weight=0.0, latency_weight=1.0))
        try:
            out[side] = _policy_run(side, ["tight"] * 8,
                                    [SYSTEM + OWN] * 8, router=router,
                                    max_batch=8, n_samples=K,
                                    max_new_tokens=NEW)
        finally:
            router.tiers.pop("tight")
    assert out["ref"] == out["port"]
    records = out["port"][3]
    assert len(records) > 1 and all(r["meets_caps"] for r in records)
