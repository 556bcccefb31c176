"""The port's PGSAM (`repro_torch.qeil2.pgsam`) and its incremental costing
(`DeltaEvaluator`) anneal exactly as the reference's: both run the same
numpy on the same seeds, so archives, frontiers, re-anneals and every
delta-cost step are equal with ``==``. The cases are those of
tests/test_qeil2.py and tests/test_incremental.py, on full chatglm3-6b and
the 2-layer fixture."""
import numpy as np
import pytest

from _torch_parity import configs

import repro.core as J  # noqa: E402
import repro.qeil2 as JQ  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.qeil2 as TQ  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402

W = dict(batch=1, prompt_tokens=256, decode_tokens=32, samples=4)
SIDES = {"ref": (J, JQ), "port": (T, TQ)}


def _cfg(side: str, arch: str):
    if arch == "fixture":
        return configs("fixture")[0 if side == "ref" else 1]
    return (jget if side == "ref" else tget)(arch)


def _assignment(a) -> tuple:
    return (sorted((k, d.name) for k, d in a.mapping.items()), a.energy_j,
            a.latency_s, a.feasible, list(a.violations), list(a.notes))


def _result(r) -> tuple:
    return ([(e.objectives, e.mapping, e.costs.energy_j,
              e.costs.makespan_s) for e in r.archive],
            r.best_energy.objectives, r.iterations, r.accepted,
            r.hypervolume, r.hv_ref)


def _anneal(side, arch, energy, incremental, iters):
    core, q2 = SIDES[side]
    orch = q2.PGSAMOrchestrator(
        core.EDGE_PLATFORM, core.Constraints(latency_budget_factor=None),
        config=q2.PGSAMConfig(seed=0, iters_max=iters,
                              incremental=incremental),
        energy_model=energy)
    cfg, w = _cfg(side, arch), core.Workload(**W)
    frontier = orch.pareto_frontier(cfg, w)
    out = [[_assignment(a) for a in frontier], _result(orch.last_result)]
    # a re-anneal warm-started from the archive, without the first device
    healthy = [d.name for d in core.EDGE_PLATFORM][1:]
    out.append(_assignment(orch.reanneal(
        cfg, w, [a.mapping for a in frontier if a.mapping], healthy=healthy,
        iters_max=iters // 2)))
    out.append(_assignment(orch.reassign_on_failure(
        cfg, w, [core.EDGE_PLATFORM[-1].name])))
    return out


@pytest.mark.parametrize("incremental", [False, True])
@pytest.mark.parametrize("energy", ["v1", "v2"])
@pytest.mark.parametrize("arch", ["fixture", "chatglm3-6b"])
def test_pgsam_archives_are_equal(arch, energy, incremental):
    iters = 1500 if incremental else 300
    ref = _anneal("ref", arch, energy, incremental, iters)
    port = _anneal("port", arch, energy, incremental, iters)
    assert ref == port
    assert len(port[0]) > 1 and port[1][4] > 0.0     # a frontier, a volume


def test_pgsam_with_a_hot_device_and_a_safety_monitor_is_equal():
    """v2 anneals read the monitor's RC temperatures (Phi)."""
    out = []
    for side, (core, q2) in SIDES.items():
        mon = core.SafetyMonitor(core.EDGE_PLATFORM)
        gpu = core.EDGE_PLATFORM[-1].name
        mon.thermal[gpu].state.temp_c = 88.0
        orch = q2.PGSAMOrchestrator(
            core.EDGE_PLATFORM, core.Constraints(latency_sla_s=0.5),
            config=q2.PGSAMConfig(seed=4, iters_max=600, incremental=True),
            energy_model="v2", safety=mon)
        a = orch.assign(_cfg(side, "chatglm3-6b"), core.Workload(**W))
        out.append((_assignment(a), _result(orch.last_result)))
    assert out[0] == out[1]


@pytest.mark.parametrize("model", ["v1", "v2"])
def test_delta_evaluator_moves_and_undo_are_equal(model):
    """A seeded move sequence of applies, reverts, peeks and capacity
    checks: every objective triple equal in both packages."""
    out = {}
    for side, (core, q2) in SIDES.items():
        cfg, w = _cfg(side, "chatglm3-6b"), core.Workload(**W)
        stages = core.decompose(cfg, w)
        devices = core.EDGE_PLATFORM
        rng = np.random.default_rng(0)
        mapping = list(rng.integers(0, len(devices), len(stages)))
        temps = {devices[-1].name: 83.0} if model == "v2" else None
        ev = q2.DeltaEvaluator(stages, devices, mapping, "bf16", w,
                               model=model, temps=temps)
        trail = [ev.objectives()]
        tokens = []
        for i in range(150):
            si = int(rng.integers(len(stages)))
            di = int(rng.integers(len(devices)))
            if i % 3 == 0:
                trail.append(ev.peek(si, di))
            else:
                tokens.append(ev.apply(si, di))
            trail.append(ev.move_fits(si, di, devices[di].mem_cap * 0.9))
            if i % 7 == 6 and tokens:
                ev.revert(tokens.pop())
            trail.append(ev.objectives())
        trail.append(list(ev.mapping))
        out[side] = trail
    assert out["ref"] == out["port"]
