"""The port's telemetry and calibration (`repro_torch.qeil2.telemetry`)
fits exactly as the reference's: a `TraceStore` written by one package
loads in the other with the same records, the synthetic trace generator
draws the same traces, `CalibrationFitter` gives the same coefficients,
duty factors and bootstrap CIs, and a `CalibratedSignalProvider` over the
fitted profile gives the same signals, plan costs and PGSAM plan. The
cases are those of tests/test_telemetry.py; every comparison is ``==``."""
import pytest

import repro.core as J  # noqa: E402
import repro.qeil2 as JQ  # noqa: E402
from repro.configs.paper_models import GPT2_125M as J_GPT2  # noqa: E402
from repro.qeil2.telemetry.provider import \
    kernel_for_stage as j_kernel  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.qeil2 as TQ  # noqa: E402
from repro_torch.configs.paper_models import GPT2_125M as T_GPT2  # noqa: E402
from repro_torch.qeil2.telemetry.provider import \
    kernel_for_stage as t_kernel  # noqa: E402

SIDES = {"ref": (J, JQ, J_GPT2, j_kernel), "port": (T, TQ, T_GPT2, t_kernel)}
HETERO = dict(batch=1, prompt_tokens=128, decode_tokens=256, samples=20)


def _records(side: str, **kw):
    _, q2, _, _ = SIDES[side]
    return q2.synthetic_trace_store(**kw).records()


def test_trace_store_round_trips_between_packages(tmp_path):
    """Records written by the reference load in the port and back."""
    records = _records("ref", seed=0, n_energy=40)
    assert records == _records("port", seed=0, n_energy=40)
    records += [{"kind": "kernel", "kernel": "flash_attention", "rep": 0,
                 "flops": 1.0, "bytes": 2.0, "measured_us": 10.0,
                 "roofline_us": 8.0},
                {"kind": "dryrun", "arch": "a", "shape": "s", "flops": 3.0}]
    path = str(tmp_path / "ref.jsonl")
    JQ.TraceStore(path=path).ingest_many(records)
    port = TQ.TraceStore.load(path)
    assert port.records() == JQ.TraceStore.load(path).records()
    assert port.counts() == JQ.TraceStore.load(path).counts()
    back = str(tmp_path / "port.jsonl")
    port.save(back)
    assert JQ.TraceStore.load(back).records() == port.records()
    for side in SIDES:
        with pytest.raises(ValueError, match="unknown trace record kind"):
            SIDES[side][1].TraceStore().ingest({"kind": "mystery"})


@pytest.mark.parametrize("seed, n_bootstrap", [(0, 40), (3, 0)])
def test_calibration_fit_is_equal(seed, n_bootstrap):
    out = {}
    for side, (_, q2, _, _) in SIDES.items():
        store = q2.synthetic_trace_store(seed=seed)
        profile, report = q2.CalibrationFitter(
            store, n_bootstrap=n_bootstrap, seed=0).fit()
        out[side] = (profile.to_dict(), report.to_dict(),
                     profile.coefficients(), hash(profile),
                     profile.is_identity)
    assert out["ref"] == out["port"]
    assert not out["port"][4]


def test_kernel_only_fit_is_equal():
    out = {}
    for side, (_, q2, _, _) in SIDES.items():
        store = q2.TraceStore()
        for rep in range(5):
            store.ingest({"kind": "kernel", "kernel": "ssd_scan", "rep": rep,
                          "flops": 1e9, "bytes": 1e7,
                          "measured_us": 200.0 + rep, "roofline_us": 120.0})
        profile, report = q2.CalibrationFitter(store, n_bootstrap=20,
                                               seed=0).fit()
        out[side] = (profile.to_dict(), report.to_dict())
    assert out["ref"] == out["port"]


def test_calibrated_provider_signals_and_plans_are_equal():
    out = {}
    for side, (core, q2, gpt2, kernel_for) in SIDES.items():
        profile, _ = q2.CalibrationFitter(
            q2.synthetic_trace_store(seed=1, n_energy=120), n_bootstrap=0,
            seed=0).fit()
        prov = q2.CalibratedSignalProvider(profile)
        w = core.Workload(**HETERO)
        stages = core.decompose(gpt2, w)
        rows = [(kernel_for(st), prov.eta(st), prov.time_scale(st),
                 prov.signals_for(st, d, st.param_bytes, 60.0).as_dict())
                for st in stages for d in core.EDGE_PLATFORM]
        rows += [(prov.phi(t), prov.cpq_power_factor(c))
                 for t, c in ((30.0, 0.1), (90.0, 0.9))]
        assign = {st.name: core.EDGE_PLATFORM[i % 4]
                  for i, st in enumerate(stages)}
        temps = {d.name: 35.0 + 10.0 * i
                 for i, d in enumerate(core.EDGE_PLATFORM)}
        pc = core.plan_costs(stages, assign, workload=w, model="v2",
                             temps=temps, provider=prov)
        rows.append([(e.time_s, e.energy_j, e.signals.as_dict())
                     for e in pc.executions])
        orch = q2.PGSAMOrchestrator(
            core.EDGE_PLATFORM, core.Constraints(latency_budget_factor=None),
            config=q2.PGSAMConfig(seed=0, iters_max=400), energy_model="v2",
            provider=prov)
        a = orch.assign(gpt2, w)
        rows.append((sorted((k, d.name) for k, d in a.mapping.items()),
                     a.energy_j, a.latency_s))
        out[side] = rows
    assert out["ref"] == out["port"]
