"""The port's copy of the planning layer's numpy modules decides exactly as
the reference's: fitting, metrics, roofline, the DASI / CPQ / Phi signals,
the v2 energy model (`plan_costs(model="v2")`), the verification cascade
with and without CSVET early stopping, and `run_pass_at_k` on the 2-layer
fixture with the reference's sampling noise replayed. Both packages get
the same numpy inputs and must give equal outputs (``==``), except the
pass@k run's log-probabilities, which the two frameworks sum apart."""
import dataclasses

import numpy as np
import pytest

from _torch_parity import DENSE_GQA, jax, models
from test_torch_core import WORKLOADS
from test_metrics_pareto_roofline import HLO_SAMPLE

import repro.core as J  # noqa: E402
import repro.qeil2 as JQ  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.quant import quant_workload as j_quant_workload  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.qeil2 as TQ  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.quant import quant_workload as t_quant_workload  # noqa: E402
from repro_torch.serving import ServingEngine as TEngine  # noqa: E402
from test_torch_serving import JaxGumbel  # noqa: E402

FORMATS = ["bf16", "int8", "int4"]
SIDES = ((J, JQ, jget, j_quant_workload), (T, TQ, tget, t_quant_workload))


def _fields(obj) -> dict:
    return dataclasses.asdict(obj)


def _exec(e) -> tuple:
    sig = getattr(e, "signals", None)
    return (e.stage.name, e.device.name, e.time_s, e.energy_j, e.bound,
            sig.as_dict() if sig is not None else None)


def _costs(pc) -> tuple:
    return ([_exec(e) for e in pc.executions], pc.transfer_bytes,
            pc.transfer_time_s, pc.transfer_energy_j, pc.energy_j,
            pc.makespan_s, pc.busy_time_s, pc.avg_power_w,
            pc.per_device_energy(), pc.phase_energy(),
            [d.name for d in pc.devices])


# ------------------------------------------------------------ fitting
def test_power_law_and_joint_fits_are_equal():
    rng = np.random.default_rng(0)
    S = np.array([1, 2, 4, 8, 16, 32, 64], float)
    C = np.clip(1 - np.exp(-0.2 * S ** 0.7) + rng.normal(0, 0.01, S.size),
                1e-3, 0.999)
    a, b = J.fit_power_law(S, C, 200, 3), T.fit_power_law(S, C, 200, 3)
    assert _fields(a) == _fields(b)
    assert np.array_equal(a.predict(S), b.predict(S))
    N = np.repeat([124.0, 1100.0, 6200.0], S.size)
    SS = np.tile(S, 3)
    CC = np.clip(1 - np.exp(-0.01 * N ** 0.3 * SS ** 0.7), 1e-3, 0.999)
    ja, ta = J.fit_coverage_joint(N, SS, CC), T.fit_coverage_joint(N, SS, CC)
    assert _fields(ja) == _fields(ta)
    assert np.array_equal(ja.predict(N, SS), ta.predict(N, SS))


@pytest.mark.parametrize("n_bootstrap", [0, 50])
def test_empirical_coverage_is_equal(n_bootstrap):
    outcomes = J.simulate_outcomes(40, 20, seed=2)
    assert np.array_equal(outcomes, T.simulate_outcomes(40, 20, seed=2))
    budgets = (1, 2, 5, 10, 20)
    assert J.empirical_coverage(outcomes, budgets, n_bootstrap, 1) == \
        T.empirical_coverage(outcomes, budgets, n_bootstrap, 1)


# ------------------------------------------------------------ metrics
def test_run_metrics_and_improvement_are_equal():
    base = dict(coverage=0.6, accuracy=0.3, energy_j=1000.0, latency_s=1.0,
                power_w=100.0, throughput_tps=1000.0, cost_usd_per_1k=1.0)
    new = dict(base, coverage=0.7, energy_j=500.0, latency_s=0.8,
               power_w=50.0)
    jb, jn = J.RunMetrics(**base), J.RunMetrics(**new)
    tb, tn = T.RunMetrics(**base), T.RunMetrics(**new)
    assert jn.as_dict() == tn.as_dict()
    assert (jn.ipw, jn.ece, jn.ppp) == (tn.ipw, tn.ece, tn.ppp)
    assert J.improvement(jb, jn) == T.improvement(tb, tn)


# ------------------------------------------------------------ roofline
def test_roofline_terms_and_hlo_collectives_are_equal():
    for flops, moved, coll, n in ((197e12 * 256, 819e9 * 256,
                                   50e9 * 256 * 10, 256),
                                  (3e12, 9e12, 0.0, 1), (5e15, 1e12, 1e9, 8)):
        a = J.terms_from_counts(flops, moved, coll, n, J.TPU_V5E)
        b = T.terms_from_counts(flops, moved, coll, n, T.TPU_V5E)
        assert a.as_dict() == b.as_dict()
        assert (a.dominant, a.bound_time_s, a.overlap_time_s,
                a.serial_time_s) == (b.dominant, b.bound_time_s,
                                     b.overlap_time_s, b.serial_time_s)
        assert J.arithmetic_intensity(flops, moved) == \
            T.arithmetic_intensity(flops, moved)
        assert J.is_memory_bound(flops, moved, J.TPU_V5E) == \
            T.is_memory_bound(flops, moved, T.TPU_V5E)
        assert J.stage_time(flops, moved, J.TPU_V5E) == \
            T.stage_time(flops, moved, T.TPU_V5E)
    assert J.collective_bytes_from_hlo(HLO_SAMPLE) == \
        T.collective_bytes_from_hlo(HLO_SAMPLE)


# ------------------------------------------------------- signals, v2 energy
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", DENSE_GQA)
def test_signals_and_v2_plan_costs_are_equal(name, fmt):
    for w in WORKLOADS:
        out = []
        for core, q2, get, qw in SIDES:
            cfg = get(name)
            wl = qw(core.Workload(**w), fmt)
            stages = core.decompose(cfg, wl)
            sig = [(q2.dasi(s, d), q2.memory_saturation(s, d),
                    q2.signals_for(s, d, s.param_bytes, 70.0).as_dict())
                   for s in stages[:4] + stages[-2:]
                   for d in core.EDGE_PLATFORM]
            plans = []
            for dev in core.EDGE_PLATFORM:
                assign = {s.name: dev for s in stages}
                plans.append(_costs(core.plan_costs(
                    stages, assign, fmt, wl, model="v2",
                    temps={dev.name: 61.0}, headroom=0.8)))
            # a heterogeneous split: embed + prefill on the first device,
            # decode and head on the last
            split = {s.name: core.EDGE_PLATFORM[0 if s.phase in
                                                ("embed", "prefill") else -1]
                     for s in stages}
            plans.append(_costs(core.plan_costs(stages, split, fmt, wl,
                                                model="v2")))
            out.append((sig, plans))
        assert out[0] == out[1]
    assert [JQ.cpq(x, J.EDGE_PLATFORM[0]) for x in (0.0, 1e9, 1e12)] == \
        [TQ.cpq(x, T.EDGE_PLATFORM[0]) for x in (0.0, 1e9, 1e12)]
    assert [(JQ.phi(t), JQ.cpq_power_factor(c))
            for t, c in ((25.0, 0.2), (80.0, 1.3))] == \
        [(TQ.phi(t), TQ.cpq_power_factor(c))
         for t, c in ((25.0, 0.2), (80.0, 1.3))]


# ------------------------------------------------------------ cascade
@pytest.mark.parametrize("early_stop", [False, True])
def test_cascade_verdicts_and_stats_are_equal(early_stop):
    rng = np.random.default_rng(0)
    calls = {"ref": [], "port": []}
    cascades = {}
    for side, core in (("ref", J), ("port", T)):
        cascades[side] = core.VerifierCascade(
            lambda s, side=side: calls[side].append(int(s[0])) or
            bool(s[0] % 3 == 0), logprob_quantile=0.3, early_stop=early_stop)
    for _ in range(30):
        n = int(rng.integers(1, 12))
        samples = [rng.integers(0, 10, (3,)) for _ in range(n)]
        lps = rng.normal(size=n).tolist()
        assert cascades["ref"].verify(samples, lps) == \
            cascades["port"].verify(samples, lps)
    assert calls["ref"] == calls["port"]
    assert _fields(cascades["ref"].stats) == _fields(cascades["port"].stats)
    assert cascades["ref"].stats.verification_savings == \
        cascades["port"].stats.verification_savings
    assert (cascades["port"].stats.skipped > 0) == early_stop


def test_adaptive_sample_budget_is_equal():
    for N, T_, cov in ((2600, 256, 0.6), (124, 256, 0.6), (124, 256, 0.9),
                       (6200, 2048, 0.5)):
        assert J.adaptive_sample_budget(N, T_, cov) == \
            T.adaptive_sample_budget(N, T_, cov)


def test_run_pass_at_k_with_the_reference_noise():
    """The fixture samples 6 tasks x 8 samples of 4 tokens at temperature 1
    in both packages, the port on the reference's Gumbel draws: the same
    outcomes, coverage and cascade stats."""
    jm, jp, tm, tp = models("fixture", seed=3)
    rng = np.random.default_rng(4)
    tasks = [(rng.integers(0, 64, (9,)).astype(np.int32),
              lambda s, m=m: bool(int(s[0]) % 4 == m)) for m in range(6)]
    key = jax.random.key(5)
    budgets = (1, 2, 4, 8)
    ref = J.run_pass_at_k(JEngine(jm, jp, max_new_tokens=4,
                                  temperature=1.0), tasks, 8, rng=key,
                          budgets=budgets)
    # the reference engine splits the call key once for its one batch
    port = T.run_pass_at_k(TEngine(tm, tp, max_new_tokens=4,
                                   temperature=1.0), tasks, 8,
                           noise=JaxGumbel(jax.random.split(key)[1]),
                           budgets=budgets)
    assert np.array_equal(ref.outcomes, port.outcomes)
    assert ref.outcomes.any() and not ref.outcomes.all()
    assert ref.coverage_by_k == port.coverage_by_k
    assert _fields(ref.cascade) == _fields(port.cascade)
    assert (ref.decode_tokens, ref.prefill_tokens) == \
        (port.decode_tokens, port.prefill_tokens)
