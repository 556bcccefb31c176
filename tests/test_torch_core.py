"""The port's copy of the planning layer (`repro_torch.core`) decides exactly
as the reference's (`repro.core`): both run the same numpy, so plans,
energies, latencies and the KV-cache byte counts they price are equal."""
import numpy as np
import pytest

from _torch_parity import DENSE_GQA

import repro.core as J  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.quant import quant_workload as j_quant_workload  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.quant import quant_workload as t_quant_workload  # noqa: E402

WORKLOADS = [
    dict(batch=8, prompt_tokens=256, decode_tokens=32, samples=4),
    dict(batch=1, prompt_tokens=2048, decode_tokens=512, samples=1),
    dict(batch=32, prompt_tokens=64, decode_tokens=16, samples=10),
]


def _plan(mod, get, quant_workload, w, fmt, factor, healthy=None,
          kv_format="bf16"):
    wl = quant_workload(mod.Workload(**w), fmt, kv_format)
    orch = mod.GreedyOrchestrator(
        mod.EDGE_PLATFORM, mod.Constraints(latency_budget_factor=factor))
    return orch.assign(get("chatglm3-6b"), wl, healthy=healthy)


def _same_plan(a, b):
    assert a.device_names() == b.device_names()
    assert {k: d.name for k, d in a.mapping.items()} == \
        {k: d.name for k, d in b.mapping.items()}
    assert a.energy_j == b.energy_j and a.latency_s == b.latency_s
    assert a.feasible == b.feasible and a.violations == b.violations


@pytest.mark.parametrize("w", WORKLOADS)
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("factor", [1.0, None])
def test_greedy_orchestrator_assigns_chatglm_exactly_as_the_reference(
        w, fmt, factor):
    _same_plan(_plan(T, tget, t_quant_workload, w, fmt, factor),
               _plan(J, jget, j_quant_workload, w, fmt, factor))


@pytest.mark.parametrize("w", WORKLOADS)
def test_int4_weights_int8_kv_plan_equals_the_reference(w):
    """The plan the launcher prices for ``--quant int4 --kv-int8``."""
    _same_plan(_plan(T, tget, t_quant_workload, w, "int4", 1.0,
                     kv_format="int8"),
               _plan(J, jget, j_quant_workload, w, "int4", 1.0,
                     kv_format="int8"))


def test_reassignment_without_a_failed_device():
    w = WORKLOADS[0]
    healthy = [d.name for d in J.EDGE_PLATFORM][1:]
    _same_plan(_plan(T, tget, t_quant_workload, w, "bf16", 1.0, healthy),
               _plan(J, jget, j_quant_workload, w, "bf16", 1.0, healthy))


def test_exhaustive_oracle_and_pareto_frontier():
    w = dict(batch=4, prompt_tokens=128, decode_tokens=16, samples=2)
    cfg_t, cfg_j = tget("chatglm3-6b"), jget("chatglm3-6b")
    # the oracle is exponential in the stage count: the 2-layer model
    _same_plan(T.exhaustive_oracle(cfg_t.reduced(), T.Workload(**w),
                                   T.EDGE_PLATFORM),
               J.exhaustive_oracle(cfg_j.reduced(), J.Workload(**w),
                                   J.EDGE_PLATFORM))
    ft = T.ParetoOrchestrator(T.EDGE_PLATFORM).frontier(cfg_t,
                                                        T.Workload(**w))
    fj = J.ParetoOrchestrator(J.EDGE_PLATFORM).frontier(cfg_j,
                                                        J.Workload(**w))
    assert [(p["samples"], p["energy_j"], p["latency_s"], p["coverage"])
            for p in ft] == \
        [(p["samples"], p["energy_j"], p["latency_s"], p["coverage"])
         for p in fj]
    with pytest.raises(NotImplementedError, match="v2"):
        T.plan_costs(T.decompose(cfg_t, T.Workload(**w)),
                     {s.name: T.EDGE_PLATFORM[0]
                      for s in T.decompose(cfg_t, T.Workload(**w))},
                     model="v2")


def test_safety_monitor_validates_alike():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 65024, (n,)).astype(np.int32)
               for n in (16, 300, 1200)]
    prompts.append(np.asarray([1, 2, 70000], np.int32))   # out of vocab
    prompts.append(np.zeros((0,), np.int32))               # empty
    mt = T.SafetyMonitor(T.EDGE_PLATFORM, max_seq_len=1024, vocab_size=65024)
    mj = J.SafetyMonitor(J.EDGE_PLATFORM, max_seq_len=1024, vocab_size=65024)
    for i, p in enumerate(prompts):
        a = mt.validator.validate(p, now_s=0.001 * i)
        b = mj.validator.validate(p, now_s=0.001 * i)
        assert (a.ok, a.reason) == (b.ok, b.reason)


@pytest.mark.parametrize("name", DENSE_GQA)
def test_kv_cache_byte_counts(name):
    ct, cj = tget(name), jget(name)
    assert tcache.kv_bytes_per_token(ct) == jcache.kv_bytes_per_token(cj)
    assert tcache.paged_cache_bytes(ct, 256, 16) == \
        jcache.paged_cache_bytes(cj, 256, 16)
    assert tcache.cache_bytes(ct, 4, 1000) == jcache.cache_bytes(cj, 4, 1000)
    assert tcache.paged_supported(ct) and jcache.paged_supported(cj)
    assert tcache.n_scanned_super_blocks(ct) == \
        jcache.n_scanned_super_blocks(cj)


def test_chatglm_kv_bytes_per_token():
    """28 layers x (k + v: 2 kv heads x 128 x 2 B, + a 4 B position)."""
    assert tcache.kv_bytes_per_token(tget("chatglm3-6b")) == \
        28 * (2 * 2 * 128 * 2 + 4)
