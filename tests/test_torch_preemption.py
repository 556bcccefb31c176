"""The port's scheduler beyond plain parity: preemption, obs, the batch
noise stream, CSVET early stops, faults and F8, on the 2-layer fixture and
reduced chatglm3-6b (the stream and helpers of
tests/test_torch_scheduler.py).

* Preempted-then-resumed == uninterrupted inside the port, greedy, dense,
  per-batch paged and pooled, 2 samples a request; on the pool a resumed
  batch replays the decode graph of its shape (the CPU stand-in of the
  capture).
* obs on == off (bit-equal), and the traced drain emits the reference's
  spans and counters.
* The scheduler's own noise: deterministic in (seed, batch id), a
  single-request batch follows the request's noise.
* ``early_stop`` accounting and a `FaultPlan` replayed through `attach`,
  decided alike in both packages.
* F8: the released-write probe finds the same handoffs in both packages.
"""
import dataclasses

import numpy as np
import pytest

from _torch_parity import torch
from test_torch_graphs import EagerGraph
from test_torch_scheduler import (BACKENDS, NEW, PKG, _StubRouter, _arrivals,
                                  _record, _same_results, _serve)
from test_torch_scheduler import pair, routers  # noqa: F401 (fixtures)

from repro.serving import chaos as jchaos  # noqa: E402
import repro_torch.serving as TS  # noqa: E402
from repro_torch.serving import backend as backend_mod  # noqa: E402
from repro_torch.serving import chaos as tchaos  # noqa: E402

def test_f8_probe_counts_released_writes_alike(pair, routers):
    """On the pool a released row's blocks go to later batches; the probe
    finds the same handoffs in both packages (and none off the pool)."""
    jm, jp, tm, tp = pair
    arrivals = _arrivals(routers[1], tm.cfg.vocab_size)
    counts = [_serve(side, m, p, r, arrivals, "pooled").f8
              for side, m, p, r in (("ref", jm, jp, routers[0]),
                                    ("port", tm, tp, routers[1]))]
    assert counts[0] == counts[1] > 0
    assert _serve("port", tm, tp, routers[1], arrivals, "paged").f8 == 0




@pytest.mark.parametrize("mode", ["dense", "paged", "pooled"])
def test_preemption_changes_no_token_inside_the_port(pair, routers, mode,
                                                     monkeypatch):
    """Preempted-then-resumed == uninterrupted: the stream greedy, without
    early stops, with tier preemption on and off. The backend takes its
    graph path (the CPU stand-in of the capture): on the pool one graph a
    decode shape serves every batch of it, the resumed ones included."""
    _, _, tm, tp = pair
    monkeypatch.setattr(TS.ExecutionBackend, "_graphs_on",
                        lambda self, h: True)
    monkeypatch.setattr(backend_mod, "DecodeGraph", EagerGraph)
    arrivals = _arrivals(routers[1], tm.cfg.vocab_size)
    runs = {preempt: _serve("port", tm, tp, routers[1], arrivals, mode,
                            early_stop=False, temperature=0.0,
                            preempt=preempt, noise_for_batch=None)
            for preempt in (True, False)}
    on, off = runs[True], runs[False]
    assert on.sched.stats()["preemptions"].get("tier", 0) >= 1
    assert off.sched.stats()["preemptions_total"] == 0
    _same_results(on.sched, off.sched, 1e-5)
    assert any(r.resume_requests for r in on.sched.records)
    gs = on.backend.graph_stats
    if mode == "pooled":
        # the parked chains came back as trie hits
        assert 0 < on.sched.resume_tail_tokens < on.sched.resume_full_tokens
        assert gs.captures == len(on.backend._pool_graphs)
        assert gs.captures < len(on.sched.records)
    else:
        # off the pool the graphs live in the backend's cache arenas
        assert gs.captures >= 1 and not on.backend._pool_graphs


#: attributes the port's ``decode`` spans carry beyond the reference's:
#: where the paged kernel reads shared prompt blocks once a group
#: (`test_wall_spans_of_a_drain` pins them)
PORT_ATTRS = ("prefix_groups", "prefix_slot_share")


def _spans(obs, names=None) -> list:
    """The spans of a drain, less their wall-clock times and the port's own
    attributes; with ``names``, only the spans of those names (the port also
    emits wall-clock spans of its own, which the reference does not:
    `test_wall_spans_of_a_drain` pins them)."""
    return [(sp.name, sp.clock, sp.request_id, sp.batch_id, sp.sample,
             {k: v for k, v in sp.attrs.items() if k not in PORT_ATTRS},
             (sp.t0_s, sp.t1_s) if sp.clock == "sim" else None)
            for sp in obs.tracer.spans if names is None or sp.name in names]


def test_obs_changes_nothing_and_traces_as_the_reference(pair, routers):
    """obs on == off inside the port (records, tokens and logprobs
    bit-equal), and the traced drain emits the reference's spans (names,
    ids, attributes, simulated times) and counters."""
    jm, jp, tm, tp = pair
    arrivals = _arrivals(routers[1], tm.cfg.vocab_size)
    from repro.obs import make_observability as jobs
    from repro_torch.obs import make_observability as tobs
    off = _serve("port", tm, tp, routers[1], arrivals, "pooled")
    port_obs, ref_obs = tobs(), jobs()
    on = _serve("port", tm, tp, routers[1], arrivals, "pooled", obs=port_obs)
    _serve("ref", jm, jp, routers[0], arrivals, "pooled", obs=ref_obs)
    assert [_record(r) for r in off.sched.records] == \
        [_record(r) for r in on.sched.records]
    _same_results(off.sched, on.sched, 0.0)
    ref_names = {sp.name for sp in ref_obs.tracer.spans}
    assert _spans(port_obs, ref_names) == _spans(ref_obs)
    assert {"preempt", "resume", "early_stop"} <= \
        {sp.name for sp in port_obs.tracer.spans}
    for name, labels in (("serving_preemptions_total", dict(reason="tier")),
                         ("serving_early_stop_released_total", {}),
                         ("serving_prefix_pool_hits_total", {})):
        got, want = (obs.metrics.counter(name, labelnames=tuple(labels))
                     .value(**labels) for obs in (port_obs, ref_obs))
        assert got == want > 0


def test_wall_spans_of_a_drain(pair, routers, monkeypatch):
    """The port's own wall-clock spans of a per-batch paged drain through
    the graph path (the CPU stand-in, timed when tracing is on): one
    ``step`` a ``step()`` call with its phases inside it, one ``step.form``
    a batch holding its ``prefill``, one ``queued`` an admitted request
    (its tier and first batch, ending where that batch's formation
    starts), an ``enqueue`` and a ``sync`` in every ``decode``, and a
    ``readout`` and a ``device_time`` of one replay in
    `DEVICE_TIME_EVERY` (4 here), at the next decode step. Tokens and
    logprobs bit-equal to tracing off."""
    from repro_torch.obs import make_observability
    from repro_torch.obs.segments import SEGMENTS
    _, _, tm, tp = pair
    monkeypatch.setattr(TS.ExecutionBackend, "_graphs_on",
                        lambda self, h: True)
    monkeypatch.setattr(backend_mod, "DecodeGraph", EagerGraph)
    # time one replay in 4: the fixture's drain replays a few dozen steps
    monkeypatch.setattr(backend_mod, "DEVICE_TIME_EVERY", 4)
    arrivals = _arrivals(routers[1], tm.cfg.vocab_size)
    off = _serve("port", tm, tp, routers[1], arrivals, "paged")
    calls = []
    step = TS.ContinuousBatchingScheduler.step
    monkeypatch.setattr(TS.ContinuousBatchingScheduler, "step",
                        lambda self: calls.append(1) or step(self))
    obs = make_observability()
    on = _serve("port", tm, tp, routers[1], arrivals, "paged", obs=obs)
    _same_results(off.sched, on.sched, 0.0)

    spans = [s for s in obs.tracer.spans if s.clock == "wall"]
    by_id = {s.span_id: s for s in spans}
    kids = {}
    for s in spans:
        kids.setdefault(s.parent_id, []).append(s)
    named = lambda n: [s for s in spans if s.name == n]   # noqa: E731

    def inside(child, parent):
        return parent.t0_s <= child.t0_s <= child.t1_s <= parent.t1_s

    steps = named("step")
    assert len(steps) == len(calls) > 0
    assert all(s.parent_id is None for s in steps)
    for name in ("step.policy", "step.form", "step.retire", "decode"):
        assert named(name)
        for s in named(name):
            assert by_id[s.parent_id].name == "step", name
            assert inside(s, by_id[s.parent_id]), name
    assert len(named("step.policy")) == len(steps)
    records = list(on.sched.records)
    forms = named("step.form")
    assert [f.batch_id for f in forms] == [r.batch_id for r in records]
    assert [f.attrs["requests"] for f in forms] == \
        [r.n_requests for r in records]
    assert sum(s.attrs["formed"] for s in steps) == len(forms)
    # a preempted batch returns its requests to the queue: it retires not
    assert len(named("step.retire")) == \
        len(records) - sum(on.sched.preemptions.values())
    for f in forms:
        (pre,) = [c for c in kids[f.span_id] if c.name == "prefill"]
        assert pre.batch_id == f.batch_id and inside(pre, f)
    # a paged decode step: the groups of rows sharing prompt blocks (which
    # the kernel reads once a group where it takes the group), and the
    # share of the rows' valid slots those blocks hold
    for dec in named("decode"):
        groups, share = (dec.attrs[k] for k in PORT_ATTRS)
        assert 0 <= share < 1 and (groups > 0) == (share > 0)
    assert any(dec.attrs["prefix_groups"] > 0 for dec in named("decode"))
    for fwd in named("prefill") + named("decode"):
        mine = kids[fwd.span_id]
        enq = [c for c in mine if c.name == "enqueue"]
        (sync,) = [c for c in mine if c.name == "sync"]
        assert enq and all(inside(c, fwd) for c in enq + [sync])
        assert max(c.t1_s for c in enq) <= sync.t0_s
    # one queued span an admitted request: its tier, the first batch that
    # placed it, from its submit to the start of that batch's formation
    first = {}
    for r in records:
        for e in r.request_entries:
            first.setdefault(e["id"], (r.batch_id, e["tier"]))
    queued = named("queued")
    assert sorted(q.request_id for q in queued) == sorted(first) == \
        sorted(on.sched.completed)
    form_t0 = {f.batch_id: f.t0_s for f in forms}
    for q in queued:
        assert (q.batch_id, q.attrs["tier"]) == first[q.request_id]
        assert q.t0_s <= q.t1_s == form_t0[q.batch_id]
    # one replay in 4 takes the timed stand-in; the next decode step reads
    # its segments (the drain's last timed replay may stay unread)
    times = named("device_time")
    replays = on.backend.graph_stats.replays
    unread = on.backend._timed_replay is not None
    assert replays >= 8 and len(times) + unread == replays // 4
    readouts = named("readout")
    assert [r.parent_id for r in readouts] == [t.parent_id for t in times]
    for r, t in zip(readouts, times):
        assert by_id[t.parent_id].name == "decode"
        assert by_id[t.parent_id].t1_s <= r.t0_s <= r.t1_s <= t.t0_s
        segs = {k: v for k, v in t.attrs.items() if k != "total_ms"}
        assert set(segs) <= set(SEGMENTS) and "attn.core" in segs
        assert sum(segs.values()) == pytest.approx(t.attrs["total_ms"])


def test_batch_noise_stream(pair):
    """The scheduler's own per-batch noise: deterministic in (seed, batch
    id), different between batches and seeds; a single-request batch
    follows the request's own noise, a batch of several varies with it."""
    _, _, tm, tp = pair

    def run(seed=0, rng=None, n=3, batch=4):
        sched = TS.ContinuousBatchingScheduler(
            TS.ExecutionBackend(tm, tp), _StubRouter(),
            TS.SchedulerConfig(max_batch_requests=batch, seed=seed))
        ids = [sched.submit(np.arange(1, 5, dtype=np.int32) + i,
                            tier="economy", n_samples=2, max_new_tokens=4,
                            temperature=1.0,
                            rng=None if rng is None else rng()).request_id
               for i in range(n)]
        done = sched.run_until_idle()
        return np.stack([s for i in ids for s in done[i].result.samples])

    gen = lambda s: TS.GumbelNoise(torch.Generator().manual_seed(s))  # noqa
    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # batches of one: each batch draws its own stream
    one = run(0, batch=1)
    assert not np.array_equal(one[0:2], one[2:4])
    # caller noise: one request follows it exactly (the engine's draws)
    [want] = TS.ServingEngine(tm, tp, max_new_tokens=4,
                              temperature=1.0).generate(
        [np.arange(1, 5, dtype=np.int32)], n_samples=2, noise=gen(7))
    got = run(rng=lambda: gen(7), n=1)
    np.testing.assert_array_equal(got, np.stack(want.samples))
    # several requests: the caller's noise and the batch id seed the batch
    x, y, z = (run(rng=lambda: gen(s)) for s in (7, 7, 8))
    np.testing.assert_array_equal(x, y)
    assert not np.array_equal(x, z)


@pytest.mark.parametrize("mode", ["dense", "pooled"])
def test_early_stop_accounting_matches_the_reference(pair, mode):
    """`early_stop` returns the budget units it freed, rejects indices out
    of range, and frees the same units in both packages."""
    jm, jp, tm, tp = pair
    out = {}
    for side, m, p in (("ref", jm, jp), ("port", tm, tp)):
        _, _, serving = PKG[side]
        backend = serving.ExecutionBackend(m, p, **BACKENDS[mode])
        sched = serving.ContinuousBatchingScheduler(
            backend, _StubRouter(),
            serving.SchedulerConfig(max_batch_requests=2, max_new_tokens=NEW,
                                    temperature=0.0))
        ids = [sched.submit(np.arange(1, 11, dtype=np.int32) * (i + 1) % 50,
                            tier="economy", n_samples=3).request_id
               for i in range(2)]
        sched.step()
        sched.step()
        trail = [sched._capacity_free()]
        with pytest.raises(ValueError, match="out of range"):
            sched.early_stop(ids[0], [3])
        trail.append(sched.early_stop(ids[0], [1, 2]))
        trail.append(sched.early_stop(ids[0], [1, 2]))   # already released
        trail.append(sched.early_stop(ids[1]))
        trail.append(sched.early_stop(99))
        trail.append(sched._capacity_free())
        sched.run_until_idle()
        trail.append(sched._capacity_free())
        trail.append([list(map(list, c.result.samples))
                      for c in sched.completed.values()])
        out[side] = trail
    assert out["ref"] == out["port"]
    assert out["port"][1] > 0


def test_fault_plan_replays_through_attach_alike(pair):
    """A seeded `FaultPlan` (failure, recovery, KV squeeze, slow kernel)
    replayed through `attach` into a live scheduler: the same plan, the
    same preemptions, retries and records in both packages."""
    jm, jp, tm, tp = pair
    out = {}
    for side, m, p, mod in (("ref", jm, jp, jchaos), ("port", tm, tp,
                                                       tchaos)):
        core, _, serving = PKG[side]
        devs = [d.name for d in core.EDGE_PLATFORM]
        plan = mod.FaultPlan.random(7, devs, horizon_s=3.0, n_failures=2,
                                    n_spikes=1, kv_squeeze_blocks=2,
                                    slow_factor=1.5)
        dev = devs[0]
        plan = mod.FaultPlan(seed=plan.seed, actions=[
            mod.FaultAction(0.2, "kv_squeeze", value=2.0),
            mod.FaultAction(0.5, "device_fail", device=dev),
            mod.FaultAction(1.5, "device_recover", device=dev),
            mod.FaultAction(2.0, "slow_kernel", value=1.5)] + plan.actions)
        plan.actions.sort(key=lambda a: a.t_s)
        safety = core.SafetyMonitor(core.EDGE_PLATFORM)
        sched = serving.ContinuousBatchingScheduler(
            serving.ExecutionBackend(m, p, **BACKENDS["pooled"]),
            _StubRouter(device=dev),
            serving.SchedulerConfig(max_batch_requests=2, max_new_tokens=NEW,
                                    temperature=0.0, preempt=True,
                                    retry_backoff_s=0.05, max_retries=10))
        driver = mod.attach(plan, safety, sched)
        ids = [sched.submit(np.arange(1, 9, dtype=np.int32) + i,
                            tier=("interactive", "economy")[i % 2],
                            arrival_s=0.1 * i).request_id for i in range(6)]
        fired = []
        t = 0.0
        while sched.queue.pending or sched.inflight:
            fired += [(a.t_s, a.kind, a.device) for a in
                      driver.apply_due(t)]
            sched.step()
            t += 0.25
        fired += [(a.t_s, a.kind, a.device) for a in driver.apply_due(1e9)]
        out[side] = ([dataclasses.astuple(a) for a in plan.actions], fired,
                     sched.stats(), [_record(r) for r in sched.records],
                     sorted(sched.completed) == sorted(ids),
                     [list(map(list, sched.completed[i].result.samples))
                      for i in ids])
    assert out["ref"] == out["port"]
    assert out["port"][2]["preemptions"].get("fault", 0) >= 1
    assert out["port"][4]
