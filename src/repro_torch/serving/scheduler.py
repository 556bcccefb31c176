"""Scheduler-centric serving: admission -> mixed-tier batching -> backend.

The pre-refactor serving stack picked one operating point per blocking
``generate`` call, so mixed-tier request streams serialized and prefill /
weight-streaming energy was never amortized across tiers. This module is the
policy layer that closes that gap:

* ``RequestQueue`` — tier-aware admission control: unknown tiers are
  rejected at the door, per-tier queue depth is bounded, and a tier's
  coverage floor (``SLATier.min_quality``) raises the request's sampling
  budget on admission. Admitted requests wait in per-bucket FIFO order
  (bucket = prompt length x decode horizon x temperature — the static
  shapes the backend jits on).
* ``ContinuousBatchingScheduler`` — forms mixed-tier batches from the
  oldest bucket, routes each batch to ONE shared operating point via the
  router's batch-aware ``route_batch`` (caps merge to the tightest member
  tier; every frontier point is re-costed under the batch workload, so
  decode weight-streaming amortization is priced in), and interleaves
  prefill of new batches with decode steps of in-flight ones. Batches
  shrink until the merged caps are satisfiable whenever the frontier admits
  any feasible point at that size — a tight-SLA member caps how much
  batching its batch can absorb instead of silently blowing its cap.

Admission is costed in the backend's own KV currency: a paged backend
prices a request in *blocks* at shared-prefix cost (`request_cost` — the
k repeats a tier's coverage floor demands share their prefix blocks, so a
raised sampling budget is far cheaper than k dense slots), a dense backend
in sequence slots; `early_stop` releases a request's remaining samples'
blocks the moment a CSVET verifier confirms a pass, instead of waiting for
batch retirement.

Routing happens only at batch *formation*: a drift-triggered re-anneal
(`ControlLoop` calls ``on_reorchestrate``) therefore takes effect at the
next batch boundary — in-flight batches finish on the plan they were priced
against, *unless* the drift is a device failure: ``on_drift`` (subscribed
to the `SafetyMonitor` event bus) preempts every in-flight batch whose
routed assignment includes the failed device and re-queues its requests
with retry backoff, so nothing runs to completion against a dead placement.

Preemption (``SchedulerConfig.preempt``)
----------------------------------------
``preempt(entry)`` snapshots a victim batch at a decode-step boundary: each
member request's generated tokens/logprobs become a `ResumeState` (its
per-sample histories are the new effective prompts), the backend parks the
victim's filled KV blocks in the resident `PrefixPool` (``park_batch`` —
resume is then a trie hit that prefills only the post-preemption tail) or
releases them, and the requests return to the queue head with their
original ``arrival_s``/``seq`` (queue delay stays total wall time).
Victim selection is by tier scalarization — a waiting request whose tier's
``latency_weight`` outranks every member of the simulated-pipeline tail
entry may cut it — bounded by a per-request preemption cap and an optional
age bound so economy work cannot starve. Lifecycle policies ride the same
machinery: per-tier deadlines cancel overdue queued requests, device-fault
evictions retry with exponential backoff, and queue-depth / KV-watermark
load shedding drops the oldest lowest-priority work first.

Simulated time: placement is the orchestrator's simulated stage->device
plan, so service time is simulated too (execution itself runs on the
backend's device). Batches serialize on one simulated pipeline: a batch
formed at clock ``t`` starts at ``max(t, pipeline_free_t)`` and occupies the
pipeline for its re-costed makespan. Per-request queue delay and latency in
`CompletedRequest` are in this simulated clock, which is what the SLA caps
and `benchmarks/serving_schedule.py` measure. The real decode interleaving
across in-flight batches exists so wall-clock work overlaps; it does not
change simulated accounting.

The backend is duck-typed (``start_batch`` / ``decode_step`` / ``finalize``
/ ``slots_free`` / ``note_placement``), so pure scheduling-policy tests run
against a stub without touching JAX; the router likewise only needs
``route_batch`` / ``resolve_tier`` / ``required_samples``.

Copied from ``repro.serving.scheduler``. Where the reference hands each
batch a jax PRNG key, the port hands it a noise source (`_batch_noise`): a
`GumbelNoise` over a ``torch.Generator`` on the backend's device, seeded
from ``(SchedulerConfig.seed, batch id)``, or whatever the constructor's
``noise_for_batch`` hook returns (a parity test replays the reference's
per-batch keys through it).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.obs import NULL_OBS
from repro_torch.serving.backend import (GenerationResult, GumbelNoise,
                                         NoiseSource)
from repro_torch.serving.backend import bucket_key as _default_bucket_key

_MISSING = object()    # getattr sentinel: absent attr vs attr that is None


def tier_priority(tier) -> float:
    """Scalarized service priority of a request class: its latency weight
    (interactive = 1.0 outranks economy = 0.0). Used for preemption victim
    selection and load-shedding order — economy before interactive."""
    return float(getattr(tier, "latency_weight", 0.0))


@dataclass
class ResumeState:
    """Decode-boundary snapshot of a preempted request.

    ``prompts[i]`` is sample *i*'s full token history (original prompt +
    every committed token) — the effective prompt a resumed run prefills;
    with the resident prefix pool the parked chain makes that prefill a
    trie hit on everything but the tail. ``toks``/``lps`` are the committed
    decode tokens and their logprobs, merged back into the final
    `GenerationResult` at retirement. Speculative victims are trimmed to
    the request's minimum committed count so the resumed bucket stays
    rectangular (greedy regenerates the trimmed tail identically)."""
    prompts: List[np.ndarray]          # per-sample history, equal lengths
    toks: List[np.ndarray]             # committed tokens per sample
    lps: List[np.ndarray]              # committed logprobs per sample


@dataclass
class ServeRequest:
    id: int
    prompt: np.ndarray
    tier: Any                          # resolved SLATier
    n_samples: int
    max_new_tokens: int
    temperature: float
    rng: Optional[NoiseSource] = None  # caller's noise (single-request parity)
    extras: Optional[Dict[str, np.ndarray]] = None   # per-request rows
    arrival_s: float = 0.0
    seq: int = 0                       # admission order (FIFO key)
    deadline_s: Optional[float] = None     # sim-clock completion deadline
    resume: Optional[ResumeState] = None   # set while preempted/resumed
    preemptions: int = 0               # times evicted mid-decode
    retries: int = 0                   # fault-eviction retry count
    not_before_s: float = 0.0          # retry backoff: earliest re-service

    @property
    def tier_name(self) -> str:
        return self.tier.name

    @property
    def effective_prompt(self) -> np.ndarray:
        """The prompt a (re)formed batch actually prefills: the original
        prompt, or the preemption snapshot's per-sample history."""
        return self.prompt if self.resume is None else self.resume.prompts[0]

    @property
    def emitted_tokens(self) -> int:
        return 0 if self.resume is None else len(self.resume.toks[0])

    @property
    def remaining_new(self) -> int:
        return self.max_new_tokens - self.emitted_tokens


@dataclass
class AdmissionResult:
    admitted: bool
    request_id: Optional[int] = None
    reason: str = ""                   # human-readable rejection detail
    reason_code: str = "ok"            # stable label: ok | unknown_tier |
    #                                    queue_full | kv_budget (metrics key)
    raised_samples: Optional[int] = None   # coverage floor raised the budget


@dataclass(frozen=True)
class SchedulerConfig:
    max_batch_requests: int = 8        # requests per formed batch
    max_inflight_batches: int = 2      # prefill/decode interleave width
    max_queue_depth: Optional[int] = 256   # per-tier admission bound
    max_new_tokens: int = 32           # defaults mirror ServingEngine
    temperature: float = 0.8
    seed: int = 0                      # batch noise stream (multi-request)
    respect_caps: bool = True          # shrink batches to keep caps feasible
    # --- decode-boundary preemption (off by default: legacy run-to-
    # completion scheduling is the baseline every earlier bench pins) ---
    preempt: bool = False              # tier-priority pipeline-tail cutting
    preempt_min_gain_s: float = 0.0    # only cut when the projected wait
    #                                    behind the tail exceeds this
    preempt_max_per_request: int = 4   # no-starvation cap per victim
    preempt_age_bound_s: Optional[float] = None  # victims older than this
    #                                    (sim wait) are preemption-exempt
    # --- request lifecycle policies ---
    deadline_factor: Optional[float] = None   # deadline = arrival +
    #                                    factor * tier.latency_p99_s
    retry_backoff_s: float = 0.05      # fault-eviction backoff base (2^k)
    max_retries: int = 3               # fault retries before the request
    #                                    is cancelled as failed
    shed_queue_depth: Optional[int] = None    # total-queued shed watermark
    shed_kv_free_frac: Optional[float] = None  # KV free-fraction watermark


@dataclass(eq=False)
class BatchRecord:
    """One formed batch — the scheduler's telemetry unit (`TraceStore`
    kind ``"serve"`` via `ingest_serve`)."""
    batch_id: int
    t_s: float                         # simulated service start
    bucket: int                        # prompt length
    n_requests: int
    n_sequences: int
    tier_mix: Dict[str, int]
    queue_delay_s: float               # max member wait before service
    point_index: int
    energy_j: float                    # batch energy at the routed point
    latency_s: float                   # batch service makespan
    meets_caps: bool
    reroute: bool                      # first batch after a re-anneal
    kv_blocks_in_use: Optional[int] = None   # paged backend occupancy
    prefill_bytes_saved: float = 0.0   # KV bytes prefix sharing avoided
    # resident prefix pool (cross-batch block reuse): trie-cached blocks
    # this batch reused / idle blocks it evicted to fit its tails.
    # stats() accumulates these (and prefill_bytes_saved) across batches.
    pool_hit_blocks: int = 0
    pool_evictions: int = 0
    quant: str = "bf16"                # weight serving format (repro_torch.quant)
    kv_format: str = "bf16"            # KV-cache element format
    weight_bytes: Optional[int] = None       # resident (packed) weight bytes
    kv_bytes_in_use: Optional[int] = None    # occupied KV bytes at service
    # speculative decode: the routed plan at formation, measured counts
    # filled in at retirement (the "spec" trace record the accept-rate
    # fitter reads carries the measured pair)
    spec_policy: str = "off"           # draft policy name ("off" = none)
    spec_n: int = 0                    # draft depth this batch ran at
    spec_accept_rate: Optional[float] = None   # planned -> measured
    spec_proposed: int = 0             # draft tokens offered to verify
    spec_accepted: int = 0             # draft tokens verify accepted
    # preemption: set when this batch was cut at a decode boundary instead
    # of retiring (reason: tier | fault | shed); the pipeline clock rolls
    # back to the preemption instant, so latency_s overstates what ran
    preempted: Optional[str] = None
    preempted_t_s: Optional[float] = None
    # resume accounting: requests in this batch re-admitted after a
    # preemption, and their history prefill split (full = what a pool-less
    # re-prefill would move, tail = what was actually prefilled after
    # parked-chain trie hits)
    resume_requests: int = 0
    resume_full_tokens: int = 0
    resume_tail_tokens: int = 0
    # per-member accounting on the simulated clock: queue_delay_s above is
    # the max over members; p95 queue delay needs every member's own wait
    request_entries: List[Dict[str, Any]] = field(default_factory=list)


@dataclass(eq=False)
class CompletedRequest:
    request: ServeRequest
    result: Any                        # GenerationResult
    batch_id: int
    queue_delay_s: float
    latency_s: float                   # simulated completion - arrival
    decision: Any                      # BatchRoutingDecision


class RequestQueue:
    """Tier-aware admission + per-bucket FIFO.

    ``router`` supplies the tier registry (`resolve_tier`) and the coverage
    floor (`required_samples`); pass None for a policy-free queue (any tier
    object accepted verbatim).
    """

    def __init__(self, router=None, max_queue_depth: Optional[int] = 256,
                 bucket_key=None, obs=None,
                 deadline_factor: Optional[float] = None):
        self.router = router
        self.max_queue_depth = max_queue_depth
        self.bucket_key = bucket_key or _default_bucket_key
        # per-tier deadline: arrival + factor * tier.latency_p99_s (tiers
        # without a latency cap are deadline-exempt)
        self.deadline_factor = deadline_factor
        self.obs = obs if obs is not None else NULL_OBS
        self._buckets: Dict[Tuple, Deque[ServeRequest]] = {}
        self._depth: Dict[str, int] = {}
        self._seq = 0
        self._next_id = 0
        # bounded: rejections are diagnostics, not an audit log
        self.rejections: Deque[AdmissionResult] = deque(maxlen=256)
        self._m = None
        if self.obs.metrics.enabled:
            reg = self.obs.metrics
            self._m = {
                "admissions": reg.counter(
                    "serving_admission_total",
                    "Admission outcomes by rejection reason code",
                    labelnames=("outcome", "reason")),
                "depth": reg.gauge(
                    "serving_queue_depth",
                    "Admitted requests waiting, per tier",
                    labelnames=("tier",)),
            }

    def _reject(self, reason: str, code: str,
                arrival_s: float, tier_name: Optional[str]) -> AdmissionResult:
        res = AdmissionResult(False, reason=reason, reason_code=code)
        self.rejections.append(res)
        if self._m is not None:
            self._m["admissions"].inc(outcome="rejected", reason=code)
        if self.obs.tracer.enabled:
            self.obs.tracer.emit("admit", arrival_s, admitted=False,
                                 reason=code, tier=tier_name)
        return res

    def _note_depth(self, tier_name: str) -> None:
        if self._m is not None:
            self._m["depth"].set(self._depth.get(tier_name, 0),
                                 tier=tier_name)

    # ----------------------------------------------------------- admission
    def submit(self, prompt: np.ndarray, tier, n_samples: int = 1,
               max_new_tokens: int = 32, temperature: float = 0.8,
               rng=None, extras: Optional[Dict] = None,
               arrival_s: float = 0.0,
               budget: Optional[int] = None,
               cost=None) -> AdmissionResult:
        """``budget``/``cost`` bound admission in the backend's KV currency:
        ``cost(plen, max_new, n_samples)`` (default: ``n_samples``, the
        dense slot count) is priced *after* any coverage-floor raise and
        rejected at the door when it can never fit ``budget``."""
        if n_samples < 1:
            raise ValueError(f"n_samples must be >= 1 (got {n_samples})")
        if self.router is not None and isinstance(tier, str):
            try:
                tier = self.router.resolve_tier(tier)
            except KeyError:
                return self._reject(f"unknown tier {tier!r}", "unknown_tier",
                                    arrival_s, str(tier))
        elif isinstance(tier, str):
            raise ValueError("string tier names need a router to resolve")
        name = tier.name
        if self.max_queue_depth is not None and \
                self._depth.get(name, 0) >= self.max_queue_depth:
            return self._reject(
                f"tier {name!r} queue full ({self.max_queue_depth})",
                "queue_full", arrival_s, name)
        raised = None
        if self.router is not None:
            floor = self.router.required_samples(tier)
            if floor is not None and floor > n_samples:
                n_samples, raised = floor, floor
        if budget is not None:
            c = (cost(len(prompt), max_new_tokens, n_samples)
                 if cost is not None else n_samples)
            if c > budget:
                # a request that can never fit the backend's KV budget is
                # rejected at the door instead of wedging the batch former
                return self._reject(
                    f"admission cost {c} (n_samples={n_samples}) exceeds "
                    f"the KV budget ({budget})", "kv_budget", arrival_s,
                    name)
        deadline = None
        if self.deadline_factor is not None:
            cap = getattr(tier, "latency_p99_s", None)
            if cap is not None:
                deadline = arrival_s + self.deadline_factor * cap
        req = ServeRequest(self._next_id, prompt, tier, n_samples,
                           max_new_tokens, temperature, rng=rng,
                           extras=extras, arrival_s=arrival_s,
                           seq=self._seq, deadline_s=deadline)
        self._next_id += 1
        self._seq += 1
        self._depth[name] = self._depth.get(name, 0) + 1
        self._buckets.setdefault(self._key(req), deque()).append(req)
        if self._m is not None:
            self._m["admissions"].inc(outcome="admitted", reason="ok")
            self._note_depth(name)
        if self.obs.tracer.enabled:
            # the request's root span (a point on the sim clock); queue /
            # release spans auto-parent under it via request_id
            self.obs.tracer.emit("admit", arrival_s, request_id=req.id,
                                 admitted=True, tier=name,
                                 n_samples=n_samples)
        return AdmissionResult(True, req.id, raised_samples=raised)

    # ------------------------------------------------------------- queries
    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._buckets.values())

    def __len__(self) -> int:
        return self.pending

    def depth(self, tier_name: str) -> int:
        return self._depth.get(tier_name, 0)

    def _key(self, req: ServeRequest) -> Tuple:
        """A request's current bucket: the *effective* prompt length and
        remaining decode horizon — a resumed request lives in the bucket of
        its history, not its original shape."""
        return self.bucket_key(req.effective_prompt, req.remaining_new,
                               req.temperature)

    def _oldest_bucket(self, now: Optional[float] = None) -> Optional[Tuple]:
        live = {k: q for k, q in self._buckets.items()
                if q and (now is None or q[0].not_before_s <= now)}
        if not live:
            return None
        return min(live, key=lambda k: live[k][0].seq)

    def peek_ready(self, now: Optional[float] = None
                   ) -> Optional[ServeRequest]:
        """Highest-priority serviceable bucket head (ties: oldest), or None.
        Priority is the tier's latency-weight scalarization — the same key
        preemption victim selection uses."""
        heads = [q[0] for q in self._buckets.values()
                 if q and (now is None or q[0].not_before_s <= now)]
        if not heads:
            return None
        return max(heads, key=lambda r: (tier_priority(r.tier), -r.seq))

    def earliest_not_before(self) -> Optional[float]:
        """Soonest retry-backoff release among queued requests (idle-clock
        target when everything pending is backoff-blocked)."""
        ts = [r.not_before_s for q in self._buckets.values() for r in q
              if r.not_before_s > 0.0]
        return min(ts) if ts else None

    # ----------------------------------------------------------- batching
    def pop_batch(self, max_requests: int,
                  budget: Optional[int] = None,
                  cost=None, now: Optional[float] = None,
                  bucket: Optional[Tuple] = None) -> List[ServeRequest]:
        """Pop the next batch: oldest bucket first, FIFO within it (which is
        FIFO within every tier), bounded by request count and the backend's
        free KV budget — ``cost(req)`` prices each member (default: its
        sample count, the dense slot cost; a paged backend prices blocks at
        shared-prefix cost). Never mixes buckets. ``now`` respects retry
        backoff (a head whose ``not_before_s`` is in the future blocks its
        bucket, preserving FIFO); ``bucket`` targets a specific bucket (the
        preemption path forms the preempting tier's batch first)."""
        if bucket is not None and self._buckets.get(bucket):
            key: Optional[Tuple] = bucket
        else:
            key = self._oldest_bucket(now)
        if key is None:
            return []
        q = self._buckets[key]
        out: List[ServeRequest] = []
        used = 0
        while q and len(out) < max_requests:
            head = q[0]
            if now is not None and head.not_before_s > now:
                break      # backoff: FIFO within the bucket is preserved
            c = cost(head) if cost is not None else head.n_samples
            if budget is not None and used + c > budget:
                break      # head waits for budget to free (retiring batches)
            out.append(q.popleft())
            used += c
            self._depth[head.tier_name] -= 1
            self._note_depth(head.tier_name)
        return out

    def push_front(self, requests: Sequence[ServeRequest]) -> None:
        """Return popped requests to the head of their bucket, order
        preserved (cap-aware batch shrinking, preemption re-admission).
        Requests keep their original ``arrival_s``/``seq``, so FIFO age,
        deadline math and queue-delay accounting reflect total wall time —
        never time-since-requeue."""
        for req in reversed(list(requests)):
            self._buckets.setdefault(self._key(req), deque()).appendleft(req)
            self._depth[req.tier_name] = self._depth.get(req.tier_name, 0) + 1
            self._note_depth(req.tier_name)

    def expire(self, now: float) -> List[ServeRequest]:
        """Remove and return every queued request whose deadline has passed
        (the scheduler cancels them — they hold no KV, so nothing leaks)."""
        out: List[ServeRequest] = []
        for key, q in list(self._buckets.items()):
            if not any(r.deadline_s is not None and now > r.deadline_s
                       for r in q):
                continue
            keep: Deque[ServeRequest] = deque()
            for r in q:
                if r.deadline_s is not None and now > r.deadline_s:
                    out.append(r)
                    self._depth[r.tier_name] -= 1
                    self._note_depth(r.tier_name)
                else:
                    keep.append(r)
            self._buckets[key] = keep
        return out

    def shed_oldest(self, priority_of=None) -> Optional[ServeRequest]:
        """Remove and return the oldest request of the lowest-priority tier
        present (load shedding: oldest-economy-first)."""
        priority_of = priority_of or tier_priority
        victim: Optional[ServeRequest] = None
        vkey: Optional[Tuple] = None
        for key, q in self._buckets.items():
            for r in q:
                if victim is None or \
                        (priority_of(r.tier), r.seq) < \
                        (priority_of(victim.tier), victim.seq):
                    victim, vkey = r, key
        if victim is None:
            return None
        self._buckets[vkey].remove(victim)
        self._depth[victim.tier_name] -= 1
        self._note_depth(victim.tier_name)
        return victim


@dataclass(eq=False)
class _InflightEntry:
    handle: Any
    requests: List[ServeRequest]
    decision: Any
    record: BatchRecord
    start_t: float
    done_t: float


class ContinuousBatchingScheduler:
    """Mixed-tier continuous batching over an execution backend.

    One ``step()`` forms new batches while capacity allows (admission ->
    route_batch -> backend prefill) and advances every in-flight batch by
    one decode token; finished batches retire into ``completed`` keyed by
    request id. ``run_until_idle`` drains everything queued.
    """

    def __init__(self, backend, router,
                 config: SchedulerConfig = SchedulerConfig(),
                 queue: Optional[RequestQueue] = None, trace=None, obs=None,
                 spec_planner=None,
                 noise_for_batch: Optional[
                     Callable[[int, List[ServeRequest]], NoiseSource]] = None):
        self.backend = backend
        self.router = router
        self.config = config
        # optional repro_torch.spec.SpecPlanner: batch formation then sweeps draft
        # depths through the router's spec-priced workload and notes the
        # winning depth on the backend (note_spec) before prefill; a backend
        # without speculative support simply never receives a note
        self.spec_planner = spec_planner
        # optional (batch_id, requests) -> noise source: replaces the
        # scheduler's own per-batch stream (`_batch_noise`)
        self.noise_for_batch = noise_for_batch
        # one obs bundle serves the whole pipeline: the scheduler emits
        # sim-clock lifecycle spans + batch metrics, its queue the admission
        # side, and the backend wall-clock prefill/decode spans (spans meet
        # through tracer.batch_context — see repro_torch.obs.tracer)
        self.obs = obs if obs is not None else NULL_OBS
        self.queue = queue if queue is not None else \
            RequestQueue(router, config.max_queue_depth, obs=self.obs)
        # optional repro_torch.qeil2.telemetry.TraceStore: one "serve" record per
        # formed batch (tier mix, queue delay, operating point, SignalSet
        # snapshots) — serving's side of the calibration measurement loop.
        self.trace = trace
        self._m = None
        if self.obs.metrics.enabled:
            reg = self.obs.metrics
            self._m = {
                "occupancy": reg.histogram(
                    "serving_batch_occupancy",
                    "Requests per formed batch",
                    buckets=(1, 2, 4, 8, 16, 32, 64)),
                "queue_delay": reg.histogram(
                    "serving_queue_delay_s",
                    "Per-request simulated wait before batch service",
                    labelnames=("tier",)),
                "batch_latency": reg.histogram(
                    "serving_batch_latency_s",
                    "Routed batch service makespan (simulated)"),
                "energy": reg.counter(
                    "serving_energy_j_total",
                    "Batch energy attributed per member tier",
                    labelnames=("tier",)),
                "sequences": reg.counter(
                    "serving_sequences_total",
                    "Sequences entering service per tier",
                    labelnames=("tier",)),
                "ipw": reg.gauge(
                    "serving_ipw_seq_per_j",
                    "Cumulative inferences-per-watt-second (sequences/J) "
                    "per tier",
                    labelnames=("tier",)),
                "prefill_saved": reg.counter(
                    "serving_prefill_bytes_saved_total",
                    "KV bytes prefix sharing did not re-prefill"),
                "completed": reg.counter(
                    "serving_requests_completed_total",
                    "Requests retired per tier", labelnames=("tier",)),
                "early_stop": reg.counter(
                    "serving_early_stop_released_total",
                    "KV budget units (blocks/slots) released by CSVET "
                    "early stops"),
                "reanneal": reg.counter(
                    "serving_reanneal_boundaries_total",
                    "Drift re-anneal notifications from the control loop"),
                "inflight": reg.gauge(
                    "serving_inflight_batches",
                    "Batches mid-decode right now"),
                "preempt": reg.counter(
                    "serving_preemptions_total",
                    "In-flight batches cut at a decode boundary, by cause",
                    labelnames=("reason",)),
                "deadline_miss": reg.counter(
                    "serving_deadline_miss_total",
                    "Queued requests cancelled past their tier deadline",
                    labelnames=("tier",)),
                "retries": reg.counter(
                    "serving_retries_total",
                    "Fault-evicted requests re-queued with backoff",
                    labelnames=("tier",)),
                "shed": reg.counter(
                    "serving_load_shed_total",
                    "Queued requests dropped at a shed watermark",
                    labelnames=("tier",)),
                "resume_saved": reg.counter(
                    "serving_resume_prefill_bytes_saved_total",
                    "Resume-prefill KV bytes served from parked "
                    "prefix-pool chains instead of re-prefilled"),
            }
        # per-tier running totals behind the IPW attribution gauge
        self._tier_energy: Dict[str, float] = {}
        self._tier_seqs: Dict[str, int] = {}
        self.clock = 0.0               # simulated now
        self.pipeline_free_t = 0.0     # simulated pipeline horizon
        self.inflight: List[_InflightEntry] = []
        # completed results are the caller's to drain: pop entries after
        # reading them (the RoutedServingEngine shim does) — a long-lived
        # server must not retain every GenerationResult forever
        self.completed: Dict[int, CompletedRequest] = {}
        # requests removed without a result: deadline misses, shed load,
        # retry-budget exhaustion — keyed by id, with the cancel reason
        self.cancelled: Dict[int, Tuple[ServeRequest, str]] = {}
        self.records: Deque[BatchRecord] = deque(maxlen=1024)
        self.reroute_boundaries = 0    # ControlLoop re-anneal notifications
        self._reroute_pending = False
        self._batch_id = 0
        # the lifecycle policies' own ledgers (metrics may be disabled)
        self.preemptions: Dict[str, int] = {}      # reason -> count
        self.deadline_misses = 0
        self.retries_total = 0
        self.shed_total = 0
        self.resume_full_tokens = 0    # re-prefill tokens a pool-less
        self.resume_tail_tokens = 0    # resume would have moved vs moved
        # fault state pushed in over the DriftEvent bus (chaos harness /
        # SafetyMonitor): failed devices, KV squeeze, kernel slowdown
        self._failed_devices: set = set()
        self.kv_reserve = 0            # blocks withheld from admission
        self.latency_inflation = 1.0   # slow-kernel service-time factor
        if config.deadline_factor is not None and \
                self.queue.deadline_factor is None:
            self.queue.deadline_factor = config.deadline_factor

    # ----------------------------------------------------------- admission
    def _capacity_free(self) -> Optional[int]:
        """Backend KV budget remaining (blocks or slots); falls back to the
        legacy ``slots_free`` for duck-typed stub backends."""
        cap = getattr(self.backend, "capacity_free", _MISSING)
        if cap is _MISSING:
            cap = self.backend.slots_free
        if cap is not None and self.kv_reserve:
            cap = max(0, cap - self.kv_reserve)
        return cap

    def _capacity_total(self) -> Optional[int]:
        cap = getattr(self.backend, "capacity_total", _MISSING)
        if cap is _MISSING:
            cap = getattr(self.backend, "max_slots", None)
        return cap

    def _request_cost(self, req: ServeRequest) -> int:
        # marginal (post-dedup) pricing: a backend with a resident prefix
        # pool charges only the tail blocks a request would actually
        # allocate — its trie-cached prefix is free — so cache-hot requests
        # admit cheaply and the block budget reflects real memory. A
        # resumed request prices each sample's own history (divergent after
        # the original prompt); its parked chains make those near-free.
        mrc = getattr(self.backend, "marginal_request_cost", None)
        if mrc is not None:
            if req.resume is not None:
                return sum(mrc(p, req.remaining_new, 1)
                           for p in req.resume.prompts)
            return mrc(req.prompt, req.max_new_tokens, req.n_samples)
        rc = getattr(self.backend, "request_cost", None)
        if rc is None:
            return req.n_samples
        if req.resume is not None:
            return sum(rc(len(p), req.remaining_new, 1)
                       for p in req.resume.prompts)
        return rc(len(req.prompt), req.max_new_tokens, req.n_samples)

    def _kv_bytes_in_use(self) -> Optional[int]:
        """Occupied KV bytes right now, priced at the backend's actual cache
        element format (int8 KV halves this per block)."""
        blocks = getattr(self.backend, "blocks_in_use", None)
        alloc = getattr(self.backend, "allocator", None)
        ktb = getattr(self.backend, "kv_token_bytes", None)
        if blocks is None or alloc is None or ktb is None:
            return None
        return int(blocks * alloc.block_size * ktb)

    def submit(self, prompt: np.ndarray, tier, n_samples: int = 1,
               max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None, rng=None,
               extras: Optional[Dict] = None,
               arrival_s: Optional[float] = None) -> AdmissionResult:
        return self.queue.submit(
            prompt, tier, n_samples=n_samples,
            max_new_tokens=(max_new_tokens if max_new_tokens is not None
                            else self.config.max_new_tokens),
            temperature=(temperature if temperature is not None
                         else self.config.temperature),
            rng=rng, extras=extras,
            arrival_s=self.clock if arrival_s is None else arrival_s,
            budget=self._capacity_total(),
            cost=getattr(self.backend, "request_cost", None))

    # ------------------------------------------------------------- control
    def on_reorchestrate(self, healthy: Optional[Sequence[str]] = None
                         ) -> None:
        """ControlLoop hook: a drift-triggered re-anneal landed. The
        post-drift healthy set is pushed into the router (idempotent when
        the loop already synced a shared router), and the next batch
        *formation* re-pulls the refreshed frontier; the boundary is marked
        so telemetry shows where placement changed."""
        if healthy is not None and hasattr(self.router, "set_healthy"):
            self.router.set_healthy(healthy)
        self.reroute_boundaries += 1
        self._reroute_pending = True
        if self._m is not None:
            self._m["reanneal"].inc()

    def advance_to(self, t_s: float) -> None:
        """Move the simulated clock forward (idle time between arrivals)."""
        self.clock = max(self.clock, t_s)

    def _router_devices(self) -> Optional[List[str]]:
        orch = getattr(self.router, "orchestrator", None)
        devices = getattr(orch, "devices", None)
        if devices is None:
            return None
        return [d.name for d in devices]

    def _push_healthy(self) -> None:
        names = self._router_devices()
        if names is not None and hasattr(self.router, "set_healthy"):
            self.router.set_healthy(
                [n for n in names if n not in self._failed_devices])
            self._reroute_pending = True

    def on_drift(self, event) -> None:
        """`DriftEvent`-bus consumer (``safety.subscribe(sched.on_drift)``).

        ``device_failed`` is the one that matters for in-flight work: every
        batch whose routed assignment includes the failed device is
        preempted at the next decode boundary and its requests re-queued
        with retry backoff — they must not run to completion against a dead
        placement. ``device_recovered`` restores the routing surface. The
        chaos-harness kinds ``kv_squeeze`` (blocks withheld from admission)
        and ``slow_kernel`` (service-time inflation) adjust the admission /
        pricing state the next formations see. Re-anneal decisions stay the
        `ControlLoop`'s job — this hook only keeps the scheduler's own
        state (in-flight batches, admission headroom) consistent with the
        event."""
        kind = getattr(event, "kind", None)
        if kind == "device_failed":
            self._failed_devices.add(event.device)
            for entry in list(self.inflight):
                assignment = getattr(entry.decision, "assignment", None)
                names = getattr(assignment, "device_names", None)
                if names is not None and event.device in names():
                    self.preempt(entry, "fault")
            self._push_healthy()
        elif kind == "device_recovered":
            self._failed_devices.discard(event.device)
            self._push_healthy()
        elif kind == "kv_squeeze":
            self.kv_reserve = max(0, int(event.value))
        elif kind == "slow_kernel":
            self.latency_inflation = max(1.0, float(event.value))

    # ---------------------------------------------------------- preemption
    def _consumed_fraction(self, entry: _InflightEntry) -> float:
        """Share of the batch's routed service time already spent, on the
        decode-progress clock (a batch still chunk-prefilling has step 0)."""
        h = entry.handle
        mx = max(int(getattr(h, "max_new", 1) or 1), 1)
        return min(1.0, int(getattr(h, "step", 0)) / mx)

    def _snapshot(self, entry: _InflightEntry) -> List[Optional[ResumeState]]:
        """Decode-boundary snapshot: per-request sample histories + emitted
        tokens/logprobs, composed over any earlier preemption's state.
        Speculative rows are trimmed to the request's minimum committed
        count so the resumed bucket stays rectangular. ``None`` for a
        request with nothing emitted yet (it resumes as a fresh request)."""
        h = entry.handle
        sp = getattr(h, "spec", None)
        out_toks = getattr(h, "out_toks", None) or []
        if sp is not None:
            toks = [np.asarray(row, np.int64) for row in sp.toks]
            lps = [np.asarray(row, np.float64) for row in sp.lps]
        elif out_toks:
            stacked = np.stack(out_toks, axis=1)       # (B, T[, K])
            lstack = np.stack(h.out_lps, axis=1)       # (B, T)
            toks = [stacked[i] for i in range(stacked.shape[0])]
            lps = [lstack[i].astype(np.float64)
                   for i in range(lstack.shape[0])]
        else:
            n = sum(r.n_samples for r in entry.requests)
            toks = [np.zeros(0, np.int64)] * n
            lps = [np.zeros(0, np.float64)] * n
        states: List[Optional[ResumeState]] = []
        off = 0
        for req in entry.requests:
            k = req.n_samples
            rows_t, rows_l = toks[off:off + k], lps[off:off + k]
            off += k
            keep = min(len(r) for r in rows_t)
            prev = req.resume
            if keep == 0 and prev is None:
                states.append(None)
                continue
            prompts, full_t, full_l = [], [], []
            for i in range(k):
                nt, nl = rows_t[i][:keep], rows_l[i][:keep]
                hist = prev.prompts[i] if prev is not None else \
                    np.asarray(req.prompt)
                prompts.append(np.concatenate([hist, nt.astype(hist.dtype)],
                                              axis=0) if keep else hist)
                if prev is not None:
                    full_t.append(np.concatenate(
                        [prev.toks[i], nt.astype(prev.toks[i].dtype)],
                        axis=0) if keep else prev.toks[i])
                    full_l.append(np.concatenate([prev.lps[i], nl]))
                else:
                    full_t.append(nt)
                    full_l.append(nl)
            states.append(ResumeState(prompts=prompts, toks=full_t,
                                      lps=full_l))
        return states

    def preempt(self, entry: _InflightEntry, reason: str
                ) -> List[ServeRequest]:
        """Cut an in-flight batch at the current decode-step boundary.

        The victim's per-request state becomes `ResumeState` snapshots, the
        backend parks its filled blocks in the resident prefix pool
        (``park_batch`` — resume prefills only the post-preemption tail) or
        releases them, and the requests return to the *head* of the queue
        with their original arrival/seq. The simulated pipeline rolls back
        to the preemption instant, which is where the interactive-tier p95
        win comes from. Fault evictions (+``reason="fault"``) additionally
        arm exponential retry backoff; a request past ``max_retries`` is
        cancelled as failed instead of re-queued."""
        if entry not in self.inflight:
            raise ValueError("preempt of a batch that is not in flight")
        frac = self._consumed_fraction(entry)
        t_p = min(entry.done_t,
                  max(self.clock,
                      entry.start_t + entry.decision.latency_s * frac))
        states = self._snapshot(entry)
        park = getattr(self.backend, "park_batch", None)
        if park is not None:
            # one history per sequence row, aligned with the handle's
            # (prompt x repeat) order — a request with nothing committed
            # contributes its bare prompt (already trie-indexed at prefill)
            histories = []
            for req, st in zip(entry.requests, states):
                if st is not None:
                    histories.extend(st.prompts)
                else:
                    histories.extend([np.asarray(req.prompt)]
                                     * req.n_samples)
            park(entry.handle, histories)
        else:
            release = getattr(self.backend, "release", None)
            if release is not None:
                release(entry.handle)
        self.inflight.remove(entry)
        # the victim held the pipeline tail: service time it will not use
        # returns to the pipeline (preemption of an interior entry cannot
        # shorten later entries' already-fixed start times)
        if entry.done_t >= self.pipeline_free_t - 1e-12:
            self.pipeline_free_t = t_p
        self.clock = max(self.clock, t_p)
        entry.record.preempted = reason
        entry.record.preempted_t_s = t_p
        self.preemptions[reason] = self.preemptions.get(reason, 0) + 1
        tracer = self.obs.tracer
        requeue: List[ServeRequest] = []
        for req, st in zip(entry.requests, states):
            req.resume = st
            req.preemptions += 1
            if reason == "fault":
                req.retries += 1
                self.retries_total += 1
                if self._m is not None:
                    self._m["retries"].inc(tier=req.tier_name)
                if req.retries > self.config.max_retries:
                    self._cancel(req, "retry_exhausted")
                    continue
                req.not_before_s = t_p + self.config.retry_backoff_s * \
                    (2 ** (req.retries - 1))
            requeue.append(req)
            if tracer.enabled:
                tracer.emit("preempt", t_p, request_id=req.id,
                            batch_id=entry.record.batch_id, reason=reason,
                            tier=req.tier_name,
                            emitted=req.emitted_tokens)
        self.queue.push_front(requeue)
        if self._m is not None:
            self._m["preempt"].inc(reason=reason)
            self._m["inflight"].set(len(self.inflight))
        return requeue

    def _cancel(self, req: ServeRequest, reason: str) -> None:
        """Drop a request without a result (deadline / shed / retry budget).
        Only queued (KV-less) requests are cancelled, so nothing can leak;
        a parked resume chain stays an idle, LRU-evictable trie entry."""
        self.cancelled[req.id] = (req, reason)
        if reason == "deadline":
            self.deadline_misses += 1
            if self._m is not None:
                self._m["deadline_miss"].inc(tier=req.tier_name)
        elif reason == "shed":
            self.shed_total += 1
            if self._m is not None:
                self._m["shed"].inc(tier=req.tier_name)
        if self.obs.tracer.enabled:
            self.obs.tracer.emit("cancel", self.clock, request_id=req.id,
                                 reason=reason, tier=req.tier_name,
                                 deadline_s=req.deadline_s)

    def _maybe_preempt_for_tier(self) -> Optional[Tuple]:
        """Tier-priority preemption check: when the best waiting request
        outranks every member of the simulated-pipeline tail batch (and the
        projected wait is worth it), cut the tail. Returns the waiting
        request's bucket key so the caller forms its batch first — the
        victims re-queued at their original seq would otherwise win the
        FIFO pop right back."""
        cfg = self.config
        if not cfg.preempt or not self.inflight:
            return None
        if getattr(self.backend, "release", None) is None:
            return None                     # backend cannot release mid-batch
        head = self.queue.peek_ready(self.clock)
        if head is None:
            return None
        entry = max(self.inflight, key=lambda e: e.done_t)
        if tier_priority(head.tier) <= max(tier_priority(r.tier)
                                           for r in entry.requests):
            return None
        gain = entry.done_t - max(self.clock, head.arrival_s)
        if gain <= cfg.preempt_min_gain_s:
            return None
        if any(r.preemptions >= cfg.preempt_max_per_request
               for r in entry.requests):
            return None                     # no-starvation: victim cap hit
        if cfg.preempt_age_bound_s is not None and \
                any(self.clock - r.arrival_s > cfg.preempt_age_bound_s
                    for r in entry.requests):
            return None                     # no-starvation: victim too old
        self.preempt(entry, "tier")
        return self.queue._key(head)

    # ------------------------------------------------------------ batching
    def _batch_noise(self, requests: List[ServeRequest]) -> NoiseSource:
        if self.noise_for_batch is not None:
            return self.noise_for_batch(self._batch_id, requests)
        carried = [r.rng for r in requests if r.rng is not None]
        if len(requests) == 1 and carried:
            # parity path: a single-request batch follows the caller's own
            # noise, as a blocking generate call would
            return carried[0]
        if carried:
            # caller-seeded stream: vary with the caller's noise (two runs
            # differing only in noise must produce different samples),
            # folded with the batch index to decorrelate batches of one call
            base = _noise_seed(carried[0])
        else:
            base = self.config.seed
        seed = int(np.random.SeedSequence(
            [base, self._batch_id]).generate_state(1, np.uint64)[0])
        dev = torch.device(getattr(self.backend, "device", "cpu"))
        return GumbelNoise(torch.Generator(device=dev).manual_seed(seed))

    def _form_batch(self, bucket: Optional[Tuple] = None
                    ) -> Optional[_InflightEntry]:
        free = self._capacity_free()
        if free is not None and free <= 0:
            return None
        reqs = self.queue.pop_batch(self.config.max_batch_requests, free,
                                    self._request_cost, now=self.clock,
                                    bucket=bucket)
        if not reqs:
            return None
        # extras compatibility: one batch stacks one set of per-request
        # extras rows, so a request with different (or no) extras keys
        # splits the batch there (it heads the next one — FIFO preserved)
        keys0 = frozenset(reqs[0].extras or ())
        cut = next((i for i, r in enumerate(reqs)
                    if frozenset(r.extras or ()) != keys0), None)
        if cut is not None:
            self.queue.push_front(reqs[cut:])
            reqs = reqs[:cut]
        # cap-aware sizing: merged caps tighten to the strictest member, and
        # feasibility depends on batch size (re-costed makespan grows with
        # it) — shed the newest half back to the queue until the routed
        # point meets caps or the batch is a single request. Each candidate
        # is routed/costed at what would actually execute: the members'
        # (possibly admission-raised) mean sampling budget and the bucket's
        # prompt length / decode horizon, not the router's canonical
        # workload — SLA caps must hold for the real batch.
        while True:
            route_kwargs = dict(
                samples=math.ceil(sum(r.n_samples for r in reqs)
                                  / len(reqs)),
                prompt_tokens=len(reqs[0].effective_prompt),
                decode_tokens=reqs[0].remaining_new)
            if self.spec_planner is not None:
                decision = self.spec_planner.route_batch(
                    self.router, [r.tier for r in reqs], **route_kwargs)
            else:
                decision = self.router.route_batch(
                    [r.tier for r in reqs], **route_kwargs)
            if decision.meets_caps or len(reqs) == 1 or \
                    not self.config.respect_caps:
                break
            keep = max(1, len(reqs) // 2)
            self.queue.push_front(reqs[keep:])
            reqs = reqs[:keep]
        # the routed draft depth applies to THIS batch only: the backend
        # consumes the note at its next start_batch
        spec_plan = getattr(decision, "spec", None)
        if spec_plan is not None and hasattr(self.backend, "note_spec"):
            self.backend.note_spec(spec_plan.n)

        start = max(self.clock, self.pipeline_free_t)
        # latency_inflation > 1 models injected slow-kernel faults (chaos
        # harness): the routed estimate stands, service time stretches
        done_t = start + decision.latency_s * self.latency_inflation
        self.pipeline_free_t = done_t
        # a resumed request contributes its n_samples per-sample histories
        # as distinct prompt rows (repeat 1 each): samples may have diverged
        prompts: List[np.ndarray] = []
        nsamps: List[int] = []
        for r in reqs:
            if r.resume is not None:
                prompts.extend(r.resume.prompts)
                nsamps.extend([1] * r.n_samples)
            else:
                prompts.append(r.prompt)
                nsamps.append(r.n_samples)
        extras = None
        if reqs[0].extras:
            extras = {k: np.stack([r.extras[k]
                                   for r in reqs
                                   for _ in range(r.n_samples
                                                  if r.resume is not None
                                                  else 1)])
                      for k in reqs[0].extras}
        tracer = self.obs.tracer
        tracer.batch_context = self._batch_id
        try:
            handle = self.backend.start_batch(
                prompts, nsamps, reqs[0].remaining_new,
                reqs[0].temperature, self._batch_noise(reqs), extras)
        finally:
            tracer.batch_context = None
        self.backend.note_placement(decision.assignment)

        # resume accounting: a parked victim's full-prefix chains come back
        # as trie hits, so only the post-preemption tail prefills — the
        # bytes-saved counter is the robustness claim's receipt
        resume_reqs = resume_full = resume_tail = 0
        layout = getattr(handle, "paged", None)
        hit_counts = layout.hit_counts if layout is not None else []
        bs = layout.block_size if layout is not None else 1
        row = 0
        for r in reqs:
            n_rows = r.n_samples if r.resume is not None else 1
            if r.resume is not None:
                resume_reqs += 1
                for i in range(row, row + n_rows):
                    full = len(prompts[i])
                    hits = hit_counts[i] if i < len(hit_counts) else 0
                    resume_full += full
                    resume_tail += full - hits * bs
                if tracer.enabled:
                    tracer.emit("resume", start, request_id=r.id,
                                batch_id=self._batch_id,
                                tier=r.tier_name,
                                emitted=r.emitted_tokens,
                                preemptions=r.preemptions)
            row += n_rows
        if resume_reqs:
            self.resume_full_tokens += resume_full
            self.resume_tail_tokens += resume_tail
            if self._m is not None:
                ktb = getattr(self.backend, "kv_token_bytes", 0) or 0
                self._m["resume_saved"].inc(
                    (resume_full - resume_tail) * int(ktb))

        tier_mix: Dict[str, int] = {}
        for r in reqs:
            tier_mix[r.tier_name] = tier_mix.get(r.tier_name, 0) + 1
        # the batch's ACTUAL speculation state comes off the handle (the
        # backend may run at its default depth with no planner attached)
        hspec = getattr(handle, "spec", None)
        record = BatchRecord(
            batch_id=self._batch_id, t_s=start,
            bucket=len(reqs[0].effective_prompt), n_requests=len(reqs),
            n_sequences=sum(r.n_samples for r in reqs), tier_mix=tier_mix,
            queue_delay_s=max(start - r.arrival_s for r in reqs),
            point_index=decision.point_index,
            energy_j=decision.energy_j, latency_s=decision.latency_s,
            meets_caps=decision.meets_caps, reroute=self._reroute_pending,
            kv_blocks_in_use=getattr(self.backend, "blocks_in_use", None),
            prefill_bytes_saved=float(getattr(handle, "prefill_bytes_saved",
                                              0.0)),
            pool_hit_blocks=int(getattr(handle, "pool_hit_blocks", 0)),
            pool_evictions=int(getattr(handle, "pool_evictions", 0)),
            quant=getattr(self.backend, "quant_format", "bf16"),
            kv_format=getattr(self.backend, "kv_format", "bf16"),
            weight_bytes=getattr(self.backend, "weight_bytes", None),
            kv_bytes_in_use=self._kv_bytes_in_use(),
            spec_policy=hspec.policy.name if hspec is not None else "off",
            spec_n=hspec.n if hspec is not None else 0,
            spec_accept_rate=(spec_plan.accept_rate
                              if spec_plan is not None and spec_plan.enabled
                              else None),
            resume_requests=resume_reqs,
            resume_full_tokens=resume_full,
            resume_tail_tokens=resume_tail,
            request_entries=[{"id": r.id, "tier": r.tier_name,
                              "n_samples": r.n_samples,
                              "queue_delay_s": start - r.arrival_s,
                              "resumed": r.resume is not None}
                             for r in reqs])
        self._reroute_pending = False
        self._batch_id += 1
        self.records.append(record)
        if self.trace is not None:
            self.trace.ingest_serve(record,
                                    signals=plan_signals(decision))
        if tracer.enabled:
            tracer.emit("schedule", start, batch_id=record.batch_id,
                        point_index=record.point_index,
                        energy_j=record.energy_j,
                        latency_s=record.latency_s,
                        meets_caps=record.meets_caps,
                        n_requests=record.n_requests,
                        tier_mix=dict(tier_mix))
            for r in reqs:
                # per-member wait on the sim clock; batch_id joins the
                # request to its batch-level schedule/prefill/decode spans
                tracer.emit("queue", r.arrival_s, start, request_id=r.id,
                            batch_id=record.batch_id, tier=r.tier_name)
        if self._m is not None:
            self._observe_batch(record, decision, reqs)
        return _InflightEntry(handle, reqs, decision, record, start, done_t)

    def _observe_batch(self, record: BatchRecord, decision,
                       reqs: List[ServeRequest]) -> None:
        m = self._m
        m["occupancy"].observe(record.n_requests)
        m["batch_latency"].observe(record.latency_s)
        m["prefill_saved"].inc(record.prefill_bytes_saved)
        for r in reqs:
            m["queue_delay"].observe(record.t_s - r.arrival_s,
                                     tier=r.tier_name)
            m["sequences"].inc(r.n_samples, tier=r.tier_name)
            self._tier_seqs[r.tier_name] = \
                self._tier_seqs.get(r.tier_name, 0) + r.n_samples
        # per-tier energy attribution when the router prices it (v2-costed
        # batch decisions); stub routers without it attribute nothing
        per_tier = getattr(decision, "per_tier_energy_j", None) or {}
        for tier, e in per_tier.items():
            m["energy"].inc(e, tier=tier)
            self._tier_energy[tier] = self._tier_energy.get(tier, 0.0) + e
        for tier in {r.tier_name for r in reqs}:
            e = self._tier_energy.get(tier, 0.0)
            if e > 0.0:
                m["ipw"].set(self._tier_seqs.get(tier, 0) / e, tier=tier)

    def early_stop(self, request_id: int,
                   sample_indices: Optional[Sequence[int]] = None) -> int:
        """CSVET early-stop hook: a verified pass makes a request's
        remaining samples moot (pass@k is ``any(pass)``), so release their
        KV budget *now* instead of at batch retirement. ``sample_indices``
        selects which of the request's samples to release (default: all).
        Returns the blocks/slots actually returned to the budget (0 when
        the request is not in flight or the backend has no early release)."""
        rel = getattr(self.backend, "release_sequences", None)
        if rel is None:
            return 0
        for entry in self.inflight:
            off = 0
            for r in entry.requests:
                if r.id == request_id:
                    idxs = (range(r.n_samples) if sample_indices is None
                            else list(sample_indices))
                    bad = [i for i in idxs if not 0 <= i < r.n_samples]
                    if bad:
                        # an out-of-range index would map into a *different*
                        # request's rows and release its KV budget under it
                        raise ValueError(
                            f"sample indices {bad} out of range for request "
                            f"{request_id} with {r.n_samples} samples")
                    freed = rel(entry.handle, [off + i for i in idxs])
                    if self.obs.tracer.enabled:
                        self.obs.tracer.emit(
                            "early_stop", self.clock, request_id=request_id,
                            batch_id=entry.record.batch_id, freed=freed,
                            n_released=len(list(idxs)))
                    if self._m is not None and freed:
                        self._m["early_stop"].inc(freed)
                    return freed
                off += r.n_samples
        return 0

    def _merge_resumed(self, req: ServeRequest, tails) -> Any:
        """Splice a resumed request's pre-preemption snapshot onto its
        post-resume tail results: token streams concatenate (then re-truncate
        at the first eos over the WHOLE stream, matching an uninterrupted
        run), per-sample mean logprobs merge as the token-count-weighted
        mean — exactly the uninterrupted mean for deterministic decode."""
        st = req.resume
        eos = getattr(self.backend, "eos_token", None)
        samples, logprobs = [], []
        for i, tail in enumerate(tails):
            pre_t, pre_l = st.toks[i], st.lps[i]
            new = tail.samples[0]
            full = np.concatenate([pre_t.astype(new.dtype), new], axis=0) \
                if len(pre_t) else new
            if eos is not None and full.ndim == 1:
                hits = np.nonzero(full == eos)[0]
                if hits.size:
                    full = full[: hits[0]]
            samples.append(full)
            # tail.logprobs[0] averaged over the tail's full decode horizon
            n_new = req.max_new_tokens - len(pre_l)
            tot = len(pre_l) + n_new
            logprobs.append(float(
                (pre_l.sum() + tail.logprobs[0] * n_new) / max(tot, 1)))
        req.resume = None
        return GenerationResult(
            prompt=req.prompt, samples=samples, logprobs=logprobs,
            prefill_tokens=len(req.prompt),
            decode_tokens=req.max_new_tokens * req.n_samples)

    def _enforce_deadlines(self) -> None:
        for req in self.queue.expire(self.clock):
            self._cancel(req, "deadline")

    def _enforce_shedding(self) -> None:
        """Watermark-driven load shedding, oldest-economy-first. Queue-depth
        and evictable-KV watermarks both shed from the *queue* (cancelled
        requests hold no blocks, so shedding can never leak); when the KV
        watermark trips with an empty queue the pressure is in-flight, and
        the lowest-priority pipeline-tail batch is preempted instead (its
        parked chains are evictable, which is what the watermark wants)."""
        cfg = self.config
        if cfg.shed_queue_depth is not None:
            while self.queue.pending > cfg.shed_queue_depth:
                victim = self.queue.shed_oldest(tier_priority)
                if victim is None:
                    break
                self._cancel(victim, "shed")
        if cfg.shed_kv_free_frac is not None:
            total = self._capacity_total()
            free = self._capacity_free()
            if total and free is not None and \
                    free < cfg.shed_kv_free_frac * total:
                victim = self.queue.shed_oldest(tier_priority)
                if victim is not None:
                    self._cancel(victim, "shed")
                elif self.inflight and cfg.preempt and \
                        getattr(self.backend, "release", None) is not None:
                    entry = min(
                        self.inflight,
                        key=lambda e: (max(tier_priority(r.tier)
                                           for r in e.requests), -e.done_t))
                    if all(r.preemptions < cfg.preempt_max_per_request
                           for r in entry.requests):
                        self.preempt(entry, "shed")

    def _retire(self, entry: _InflightEntry) -> None:
        results = self.backend.finalize(entry.handle)
        self.clock = max(self.clock, entry.done_t)
        tracer = self.obs.tracer
        sp = getattr(entry.handle, "spec", None)
        if sp is not None:
            # measured accept counts land on the record, and a "spec" trace
            # record closes the loop: CalibrationFitter turns these into
            # per-(model, tier, policy) accept rates for SpecPlanner.refresh
            entry.record.spec_proposed = int(sp.proposed)
            entry.record.spec_accepted = int(sp.accepted)
            entry.record.spec_accept_rate = float(sp.accept_rate)
            if self.trace is not None and sp.proposed:
                cfg = getattr(getattr(self.backend, "model", None),
                              "cfg", None)
                merged = getattr(entry.decision, "tier", None)
                rec = {"kind": "spec", "t_s": float(entry.done_t),
                       "policy": str(sp.policy.name), "n": int(sp.n),
                       "proposed": int(sp.proposed),
                       "accepted": int(sp.accepted)}
                if cfg is not None:
                    rec["model"] = str(cfg.name)
                if merged is not None:
                    rec["tier"] = str(merged.name)
                self.trace.ingest(rec)
        off = 0
        for req in entry.requests:
            if req.resume is not None:
                # resumed request: n_samples single-sample results, each the
                # post-preemption tail — splice onto the snapshot so the
                # caller sees one uninterrupted completion
                k = req.n_samples
                res = self._merge_resumed(req, results[off:off + k])
                off += k
            else:
                res = results[off]
                off += 1
            self.completed[req.id] = CompletedRequest(
                request=req, result=res, batch_id=entry.record.batch_id,
                queue_delay_s=entry.start_t - req.arrival_s,
                latency_s=entry.done_t - req.arrival_s,
                decision=entry.decision)
            if tracer.enabled:
                tracer.emit("release", entry.done_t, request_id=req.id,
                            batch_id=entry.record.batch_id,
                            tier=req.tier_name,
                            queue_delay_s=entry.start_t - req.arrival_s,
                            latency_s=entry.done_t - req.arrival_s)
            if self._m is not None:
                self._m["completed"].inc(tier=req.tier_name)

    # ---------------------------------------------------------------- step
    def step(self) -> bool:
        """One scheduler iteration: enforce lifecycle policies (deadlines,
        shedding), check tier preemption, form batches while capacity
        allows, then one decode token per in-flight batch; retire finished
        batches. Returns False when there was nothing to do."""
        progressed = False
        self._enforce_deadlines()
        self._enforce_shedding()
        # tier preemption returns the outranking waiter's bucket so its
        # batch forms FIRST — the re-queued victims hold older seqs and
        # would win the FIFO pop right back otherwise
        bucket_pref = self._maybe_preempt_for_tier()
        while len(self.inflight) < self.config.max_inflight_batches:
            entry = self._form_batch(bucket_pref)
            bucket_pref = None
            if entry is None:
                break
            self.inflight.append(entry)
            progressed = True
        tracer = self.obs.tracer
        for entry in list(self.inflight):
            if not entry.handle.done:
                tracer.batch_context = entry.record.batch_id
                try:
                    self.backend.decode_step(entry.handle)
                finally:
                    tracer.batch_context = None
                progressed = True
            if entry.handle.done:
                self.inflight.remove(entry)
                self._retire(entry)
                progressed = True
        if not progressed and not self.inflight and self.queue.pending:
            # everything queued is backoff-parked: jump the sim clock to the
            # earliest retry instant instead of reporting starvation
            nb = self.queue.earliest_not_before()
            if nb is not None and nb > self.clock:
                self.advance_to(nb)
                progressed = True
        if self._m is not None:
            self._m["inflight"].set(len(self.inflight))
        return progressed

    def run_until_idle(self, max_steps: int = 10 ** 6
                       ) -> Dict[int, CompletedRequest]:
        """Drain the queue and every in-flight batch; returns ``completed``
        (request id -> CompletedRequest)."""
        steps = 0
        while (self.queue.pending or self.inflight) and steps < max_steps:
            if not self.step():
                break                      # starved (e.g. zero slots free)
            steps += 1
        return self.completed

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        done = list(self.completed.values())
        per_tier: Dict[str, List[float]] = {}
        for c in done:
            per_tier.setdefault(c.request.tier_name, []).append(c.latency_s)
        return {
            "completed": len(done),
            "batches": len(self.records),
            "mean_batch_requests": (float(np.mean([r.n_requests
                                                   for r in self.records]))
                                    if self.records else 0.0),
            "caps_met_fraction": (float(np.mean([r.meets_caps
                                                 for r in self.records]))
                                  if self.records else 1.0),
            "energy_j": sum(r.energy_j for r in self.records),
            "sequences": sum(r.n_sequences for r in self.records),
            "makespan_s": self.pipeline_free_t,
            "latency_p95_s": {t: float(np.percentile(v, 95))
                              for t, v in sorted(per_tier.items())},
            "reroute_boundaries": self.reroute_boundaries,
            "spec_proposed": sum(r.spec_proposed for r in self.records),
            "spec_accepted": sum(r.spec_accepted for r in self.records),
            # steady-state prefix-pool accounting, accumulated across
            # batches (per-batch values ride each BatchRecord)
            "pool_hit_blocks": sum(r.pool_hit_blocks for r in self.records),
            "pool_evictions": sum(r.pool_evictions for r in self.records),
            "prefill_bytes_saved": sum(r.prefill_bytes_saved
                                       for r in self.records),
            # robustness ledger: preemption / lifecycle-policy outcomes
            "preemptions": dict(self.preemptions),
            "preemptions_total": sum(self.preemptions.values()),
            "deadline_misses": self.deadline_misses,
            "retries_total": self.retries_total,
            "shed_total": self.shed_total,
            "cancelled": len(self.cancelled),
            "resume_full_tokens": self.resume_full_tokens,
            "resume_tail_tokens": self.resume_tail_tokens,
        }


def _noise_seed(noise: NoiseSource) -> int:
    """A seed that names a caller's noise source without drawing from it
    where it can: a `GumbelNoise` gives its generator's initial seed; any
    other source gives the bits of one draw."""
    gen = getattr(noise, "generator", None)
    if gen is not None:
        return int(gen.initial_seed())
    g = noise((1,), torch.device("cpu")).to(torch.float32).cpu().numpy()
    return int(g.view(np.uint32)[0])


def plan_signals(decision) -> Dict[str, dict]:
    """Per-stage `SignalSet.as_dict()` snapshots of a routed batch — present
    when the orchestrator costs plans with the v2 model (`StageExecutionV2`
    records carry the signal triple). Mirrors the control loop's per-step
    snapshot so serve traces feed the same `CalibrationFitter`."""
    out: Dict[str, dict] = {}
    costs = getattr(decision, "batch_costs", None)
    if costs is None:
        return out
    for e in costs.executions:
        sig = getattr(e, "signals", None)
        if sig is not None:
            out[e.stage.name] = sig.as_dict()
    return out
