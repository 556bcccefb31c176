"""The port's Pareto-routed runtime (`repro_torch.qeil2.runtime`) decides
exactly as the reference's: the `ParetoRouter`'s ``route``,
``route_all``, ``route_batch``, ``recost``, ``add_tier``, ``set_healthy``
and ``required_samples``, and a `ControlLoop` driven through a heat ramp,
a device failure and a recovery, with its trace records. The cases are
those of tests/test_runtime_router.py and tests/test_control_loop.py;
both packages run the same numpy and must give equal decisions and
events (``==``)."""
import importlib.util
import json
from dataclasses import asdict
from pathlib import Path

import pytest

import repro.core as J  # noqa: E402
import repro.qeil2 as JQ  # noqa: E402
from repro.configs.paper_models import GPT2_125M as J_GPT2  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.qeil2 as TQ  # noqa: E402
from repro_torch.configs.paper_models import GPT2_125M as T_GPT2  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SIDES = {"ref": (J, JQ, J_GPT2, jget), "port": (T, TQ, T_GPT2, tget)}
HETERO = dict(batch=1, prompt_tokens=128, decode_tokens=256, samples=20)
GPU = "nvidia-rtx-pro-5000"


def _routing(d) -> tuple:
    return (asdict(d.tier),
            sorted((k, v.name) for k, v in d.assignment.mapping.items()),
            d.point_index, d.meets_caps, d.quality, d.samples, list(d.notes),
            d.energy_j, d.latency_s, d.avg_power_w)


def _batch(d) -> tuple:
    return (asdict(d.tier), d.tier_counts, d.point_index, d.meets_caps,
            asdict(d.workload),
            d.batch_costs.energy_j, d.batch_costs.makespan_s,
            d.per_tier_energy_j, list(d.notes), d.n_requests, d.energy_j,
            d.latency_s, d.avg_power_w)


def _router(side: str, arch: str):
    core, q2, gpt2, get = SIDES[side]
    cfg = gpt2 if arch == "gpt2-125m" else get(arch)
    orch = q2.PGSAMOrchestrator(
        core.EDGE_PLATFORM, core.Constraints(latency_budget_factor=None),
        config=q2.PGSAMConfig(seed=0, iters_max=1500, incremental=True),
        energy_model="v2")
    w = core.Workload(**HETERO)
    placed = [a for a in orch.pareto_frontier(cfg, w) if a.mapping]
    base = min(a.latency_s for a in placed) / 0.9
    return core, q2, q2.ParetoRouter(orch, cfg, w,
                                     tiers=q2.default_tiers(base))


def _routes(side: str, arch: str) -> list:
    core, q2, router = _router(side, arch)
    out = [sorted((n, _routing(d)) for n, d in router.route_all().items())]
    tiers = [q2.SLATier("lat", energy_weight=0.0, latency_weight=1.0),
             q2.SLATier("eco", energy_weight=1.0, latency_weight=0.0),
             q2.SLATier("impossible", latency_p99_s=1e-9, energy_cap_w=1e-9),
             q2.SLATier("quality", min_quality=0.95, energy_weight=1.0),
             q2.SLATier("capped", energy_cap_w=40.0, energy_weight=0.3,
                        latency_weight=0.7)]
    out += [_routing(router.route(t)) for t in tiers]
    out += [router.required_samples(t) for t in
            ["interactive", "standard", "economy"] + tiers]
    router.add_tier(tiers[3])
    out.append(router.required_samples("quality"))
    for mix in (["interactive"], ["economy", "standard", "standard"],
                ["interactive", "economy"] * 4):
        for kw in ({}, dict(samples=4, prompt_tokens=256, decode_tokens=32)):
            out.append(_batch(router.route_batch(mix, **kw)))
    for n in (1, 4, 8):
        wl = router.batch_workload(n)
        out.append(asdict(wl))
        out += [(c.energy_j, c.makespan_s)
                for c in (router.recost(a, wl) for a in router.frontier)]
    router.set_healthy([d.name for d in core.EDGE_PLATFORM
                        if d.name != GPU])
    out += [(len(router.frontier), _routing(router.route(t)))
            for t in ("interactive", "economy")]
    router.set_healthy(None)
    out.append(_routing(router.route("standard")))
    return out


@pytest.mark.parametrize("arch", ["gpt2-125m", "chatglm3-6b"])
def test_router_decisions_are_equal(arch):
    ref, port = _routes("ref", arch), _routes("port", arch)
    assert ref == port
    # three tiers over at least two distinct operating points
    assert len({r[2] for _, r in port[0]}) >= 2


def _loop_events(side: str, adaptive: bool) -> list:
    core, q2, gpt2, _ = SIDES[side]
    sm = core.SafetyMonitor(core.EDGE_PLATFORM)
    orch = q2.PGSAMOrchestrator(
        core.EDGE_PLATFORM, core.Constraints(latency_sla_s=0.15),
        config=q2.PGSAMConfig(seed=0, iters_max=1200, incremental=True),
        energy_model="v2", safety=sm)
    trace = q2.TraceStore()
    w = core.Workload(**HETERO)
    loop = q2.ControlLoop(orch, sm, gpt2, w,
                          q2.LoopConfig(dt_s=10.0, reanneal_iters=300,
                                        adaptive=adaptive), trace=trace)
    out = []

    def note(r):
        out.append((r.t_s, r.load, r.temps, r.powers,
                    [(e.t_s, e.device, e.kind, e.value, e.detail)
                     for e in r.drift], r.reannealed, r.served, r.inferences,
                    r.energy_j, r.throttle_events, r.excluded,
                    loop.assignment.device_names(), loop.assignment.energy_j))

    for _ in range(20):                      # an exogenous heat ramp
        note(loop.step(load=1.5, extra_power={GPU: 255.0}))
    for _ in range(20):                      # the ramp off: the GPU cools
        note(loop.step(load=1.0))
    victim = loop.assignment.device_names()[0]
    sm.health.fail_device(victim, now_s=loop.t_s)
    for _ in range(3):
        note(loop.step(load=1.0))
    sm.health.recover_device(victim)
    note(loop.step(load=1.0))
    out.append((loop.reanneals, sorted(loop._excluded),
                loop.allowed_devices(), sm.total_throttle_events()))
    out.append([{k: v for k, v in r.items() if not k.endswith("wall_s")}
                for r in trace.records()])
    return out


@pytest.mark.parametrize("adaptive", [True, False])
def test_control_loop_events_are_equal(adaptive):
    ref, port = _loop_events("ref", adaptive), _loop_events("port", adaptive)
    assert ref == port
    reanneals = port[-2][0]
    assert (reanneals > 0) == adaptive


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_replay_of_the_scheduling_bench_passes_its_baseline():
    """scripts/port_serving_schedule.py replays the scheduling bench's
    stream through the port's router, scheduler and CPU backend; its
    artifact passes benchmarks/compare.py against the bench's baseline."""
    res = _load(ROOT / "scripts" / "port_serving_schedule.py").run("cpu")
    compare = _load(ROOT / "benchmarks" / "compare.py").compare
    base = json.loads((ROOT / "benchmarks" / "baselines" /
                       "serving_schedule.json").read_text())
    assert compare(base, res, "serving_schedule") == []
    assert res["acceptance_all"] and res["obs"]["parity_ok"]
    assert (res["scheduler"]["completed"], res["scheduler"]["batches"]) == \
        (base["scheduler"]["completed"], base["scheduler"]["batches"])


ROUTER_ARGV = ["--arch", "chatglm3-6b", "--smoke", "--requests", "6",
               "--samples", "2", "--prompt-len", "8", "--max-new", "4",
               "--router", "--mixed", "--preempt", "--max-batch", "2",
               "--kv-blocks", "48", "--kv-block-size", "4", "--kv-pool",
               "--deadline", "1000"]
TAGS = ("[router]", "[orchestrator]", "[scheduler]", "[robustness]",
        "[kv] prefix pool", "[chaos]", "[admission]")


def _lines(out: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith(TAGS)]


def test_router_launcher_prints_the_reference_lines(capsys, monkeypatch,
                                                    tmp_path):
    """``serve --router --mixed --preempt --chaos`` on the CPU prints the
    reference launcher's ``[router]``, ``[scheduler]``, ``[robustness]``,
    ``[kv]`` and ``[chaos]`` lines, and writes metrics and spans."""
    from repro.launch.serve import main as jmain
    from repro_torch.launch.serve import main as tmain
    from repro_torch.serving.chaos import FaultAction, FaultPlan
    plan = str(tmp_path / "plan.json")
    FaultPlan(seed=1, actions=[
        FaultAction(0.0, "kv_squeeze", value=2.0),
        FaultAction(0.0, "slow_kernel", value=1.25)]).save(plan)
    argv = ROUTER_ARGV + ["--chaos", plan]
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    jmain()
    ref = capsys.readouterr().out
    metrics, spans = str(tmp_path / "m.json"), str(tmp_path / "s.jsonl")
    tmain(argv + ["--device", "cpu", "--metrics-out", metrics,
                  "--spans-out", spans, "--metrics-interval", "0"])
    port = capsys.readouterr().out
    assert _lines(port) == _lines(ref)
    assert any(ln.startswith("[scheduler] batch ") for ln in _lines(port))
    assert any(ln.startswith("[chaos] t=0.00s kv_squeeze")
               for ln in _lines(port))
    assert "[serve] 6 requests x 2 samples, 48 tokens" in port
    assert json.loads(Path(metrics).read_text())
    assert Path(metrics).with_suffix(".prom").is_file()
    assert len(Path(spans).read_text().splitlines()) > 6
    with pytest.raises(SystemExit, match="need --router"):
        tmain(["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
               "--preempt"])


def test_profile_serve_takes_the_router_on_the_cpu(capsys):
    from repro_torch.launch.profile_serve import main
    main(ROUTER_ARGV + ["--device", "cpu"])
    out = capsys.readouterr().out
    summary = json.loads(out.split("[profile] ", 1)[1].splitlines()[0])
    st = summary["scheduler"]
    assert st["completed"] == 6 and st["cancelled"] == 0
    assert st["batches"] >= 3 and st["pool_hit_blocks"] > 0
    assert summary["cold"]["decode_steps"] > 0
    assert "[scheduler] batch 0: " in out
