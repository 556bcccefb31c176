"""One run of one cell: set-up, the measured window, the check of outputs.

The window drives the server's real entry: `ContinuousBatchingScheduler`'s
``submit`` and ``step`` over a paged `ExecutionBackend`, with the router of
``launch/serve.py --router`` (`build_router`: the PGSAM archive). The
runner times requests on the wall clock itself, around those calls; the
scheduler's own spans run on its simulated clock.

Set-up, in order: the weights from the seed, the kernels built (a no-op
once a checkout has them), the router's anneal, and a warm-up that runs
two batches of every batch size the mix forms through their first decode
steps (a batch's second step captures its CUDA graph, and the two arenas
are what two batches of a size in flight need), then releases them, so
that every batch in the window replays a graph from its first step. A
closed loop then starts one batch, lets it run ``stagger_steps`` steps and
fills the rest of the system, so that batches start half a lifetime apart
as they do in the steady state; an open loop's arrivals start ``warm_s``
before the window. The window opens there.

Tokens count when the scheduler step that sampled them ends inside the
window. A request's latency runs from when it was due to the end of the
step in which it retired; its first token exists at the end of the step in
which its batch formed (the prefill samples it).
"""
from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from harness import traffic as traffic_mod
from harness import work
from harness.noise import NoiseBook
from harness.weights import make_weights


#: scheduler steps in the traced run's profiled slice
PROFILE_STEPS = 64


def process_age_s() -> float:
    """Seconds since this process started (Linux: its start time in clock
    ticks since boot against the boot-time clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Event:
    """A forward a scheduler step ran for one batch."""
    batch: int
    kind: str            # "prefill" | "decode"
    prompts: int
    plen: int
    rows: int
    context: int         # decode: positions each row attends to
    table_blocks: int


@dataclass
class Step:
    index: int
    t0: float
    t1: float
    events: List[Event]
    formed: List[int]    # batch ids formed in this step


@dataclass
class RequestRecord:
    id: int
    tier: str
    due: float
    formed_t0: Optional[float] = None   # start of the step forming its batch
    first_token: Optional[float] = None
    done: Optional[float] = None
    batch: Optional[int] = None


@dataclass
class Run:
    cell: Any
    seed: int
    seconds: float
    device: torch.device
    widths: work.Widths
    setup_s: float = 0.0
    setup_parts: Dict[str, float] = field(default_factory=dict)
    window: tuple = (0.0, 0.0)
    steps: List[Step] = field(default_factory=list)
    requests: Dict[int, RequestRecord] = field(default_factory=dict)
    results: Dict[int, Any] = field(default_factory=dict)
    refused: int = 0
    lateness: List[float] = field(default_factory=list)
    energy_j: Optional[float] = None
    memory_peak_bytes: int = 0
    spans: List[Any] = field(default_factory=list)
    profile: Optional[Dict[str, Any]] = None
    # the profiled slice: its first step and the wall of its profiler
    slice_first: Optional[int] = None
    slice_wall: tuple = (0.0, 0.0)
    book: Optional[NoiseBook] = None
    graph_stats: Dict[str, Any] = field(default_factory=dict)
    # the scheduler's request id -> the request's index, and the prompts
    request_of: Dict[int, int] = field(default_factory=dict)
    prompts: Dict[int, np.ndarray] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def steps_in_window(self) -> List[Step]:
        return [s for s in self.steps if self.window[0] <= s.t1 <= self.window[1]]

    def tokens_in_window(self) -> int:
        """Sampled tokens of the steps that ended inside the window: a row's
        first token at its batch's prefill, then one a decode step."""
        return sum(e.rows for s in self.steps_in_window() for e in s.events)

    def steps_untraced(self) -> List[Step]:
        """The window's steps outside the profiled slice."""
        if self.slice_first is None:
            return self.steps_in_window()
        last = self.slice_first + len(self.profile["steps"])
        return [s for s in self.steps_in_window()
                if not self.slice_first <= s.index < last]

    @property
    def untraced_s(self) -> float:
        """The window's seconds outside the profiler's start to its stop."""
        a, b = self.slice_wall
        return self.window_s - max(0.0, min(b, self.window[1])
                                   - max(a, self.window[0]))

    def completed_in_window(self) -> List[RequestRecord]:
        return [r for r in self.requests.values()
                if r.done is not None and self.window[0] <= r.done <= self.window[1]]


def arch_config(port: Dict[str, Any]):
    """The program's `ArchConfig` of a configuration file's ``port`` group:
    each nested group that a field declares as a dataclass (``mla``,
    ``moe``, ``ssm``) built as one, each JSON list where a field is a tuple
    made one. A key that is no field raises."""
    from repro_torch.models.config import ArchConfig
    return _dataclass_of(ArchConfig, port)


def _dataclass_of(cls, values: Dict[str, Any]):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(values) - fields)
    if unknown:
        raise ValueError(f"{cls.__name__} has no field {unknown}")
    hints = typing.get_type_hints(cls)
    return cls(**{k: _field_value(hints[k], v) for k, v in values.items()})


def _field_value(hint, value):
    if value is None:
        return None
    if typing.get_origin(hint) is typing.Union:        # Optional[X]
        hint = next(a for a in typing.get_args(hint) if a is not type(None))
    if dataclasses.is_dataclass(hint) and isinstance(value, dict):
        return _dataclass_of(hint, value)
    if typing.get_origin(hint) is tuple and isinstance(value, list):
        return tuple(value)
    return value


def request_blocks(plen: int, new: int, samples: int, bs: int) -> int:
    """A request's KV blocks at shared-prefix price: the full prompt blocks
    once, each sample's private blocks."""
    logical = max(-(-(plen + new - 1) // bs), 1)
    return plen // bs + samples * (logical - plen // bs)


class _Tracker:
    """Follows every in-flight batch's handle across scheduler steps and
    turns what moved into `Event`s."""

    def __init__(self):
        self.live: Dict[int, Any] = {}       # batch id -> (handle, steps seen)

    def observe(self, sched) -> List[Event]:
        for e in sched.inflight:
            bid = e.record.batch_id
            if bid not in self.live:
                self.live[bid] = [e.handle, 0]
        events = []
        for bid in list(self.live):
            h, seen = self.live[bid]
            if seen == 0 and h.step > 0:
                events.append(Event(bid, "prefill", len(h.prompts), h.plen,
                                    h.n_sequences, h.plen, 0))
                seen = 1
            nb = 0 if h.block_table is None else int(h.block_table.shape[1])
            for s in range(seen, h.step):
                events.append(Event(bid, "decode", len(h.prompts), h.plen,
                                    h.n_sequences, h.plen + s, nb))
            self.live[bid][1] = h.step
            if h.done:
                del self.live[bid]
        return events


class Runner:
    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", control: Optional[str] = None):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace = trace
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.control = control
        self.port = cell.config["port"]
        self.mix = cell.traffic

    # ------------------------------------------------------------ set-up
    def setup(self) -> Run:
        from repro_torch.core import Workload
        from repro_torch.launch.serve import build_router
        from repro_torch.models import Model
        from repro_torch.obs import make_observability
        from repro_torch.quant import quant_workload, quantize_model
        from repro_torch.serving import ExecutionBackend

        mix = self.mix
        cfg = arch_config(self.port)
        run = Run(self.cell, self.seed, self.seconds, self.device,
                  work.Widths.of(self.port))
        parts = run.setup_parts
        parts["start_s"] = process_age_s()      # interpreter, torch, CUDA
        t = time.perf_counter()
        dtype = torch.bfloat16 if self.on_card else torch.float32
        self.model = Model(cfg, dtype=dtype, device=self.device,
                           use_kernel=self.on_card)
        self.weights = make_weights(self.model.param_shapes(), self.seed,
                                    dtype, self.device)
        params = self.weights
        if self.control is not None:
            params = quantize_model(self.weights, self.control)
        if self.on_card:
            torch.cuda.synchronize()
        parts["weights_s"] = time.perf_counter() - t
        if self.on_card:
            from repro_torch.kernels import build
            t = time.perf_counter()
            build.build()
            parts["build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        plen, new, k = mix["prompt_tokens"], mix["new_tokens"], mix["samples"]
        wl = quant_workload(Workload(batch=mix["max_batch_requests"],
                                     prompt_tokens=plen, decode_tokens=new,
                                     samples=k), self.control or "bf16",
                            kv_format="bf16")
        stdout, sys.stdout = sys.stdout, sys.stderr      # its printed lines
        try:
            self.router, _ = build_router(cfg, wl)
        finally:
            sys.stdout = stdout
        if self.router is None:
            raise RuntimeError("the router placed no operating point")
        parts["router_s"] = time.perf_counter() - t
        bs = mix["kv_block_size"]
        blocks = (mix["kv_batches"] * mix["max_batch_requests"]
                  * request_blocks(plen, new, k, bs))
        self.obs = make_observability() if self.trace else None
        self.backend = ExecutionBackend(self.model, params, kv_blocks=blocks,
                                        kv_block_size=bs, obs=self.obs)
        if self.backend.request_blocks(plen, new, k) != \
                request_blocks(plen, new, k, bs):
            raise RuntimeError("the backend prices a request otherwise than "
                               "the harness sizes its cache")
        if self.trace and self.on_card:
            # the profiler's first start in a process takes seconds: pay it
            # here, not inside the window
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]):
                torch.zeros(1, device=self.device).add_(1)
                torch.cuda.synchronize()
        t = time.perf_counter()
        self._warm()
        if self.on_card:
            torch.cuda.synchronize()
        parts["warm_s"] = time.perf_counter() - t
        run.graph_stats["after_warm"] = dict(vars(self.backend.graph_stats))
        return run

    def _scheduler(self, book: NoiseBook):
        from repro_torch.serving import (ContinuousBatchingScheduler,
                                         SchedulerConfig)
        mix = self.mix
        return ContinuousBatchingScheduler(
            self.backend, self.router,
            SchedulerConfig(max_batch_requests=mix["max_batch_requests"],
                            max_inflight_batches=mix["max_inflight_batches"],
                            max_new_tokens=mix["new_tokens"],
                            temperature=mix["temperature"]),
            obs=self.obs, noise_for_batch=book)

    def _submit(self, sched, req):
        return sched.submit(req.prompt, tier=req.tier,
                            n_samples=self.mix["samples"])

    def _warm(self) -> None:
        """Two batches of each size the mix forms, through their graph
        captures, then released: their arenas and graphs wait idle."""
        vocab = int(self.port["vocab_size"])
        book = NoiseBook(self.seed, 2, self.device)
        idx = 10 ** 6
        for n in self.mix["warm_batch_sizes"]:
            sched = self._scheduler(book)
            for _ in range(2):
                for _ in range(n):
                    req = traffic_mod.closed_loop(self.mix, self.seed, idx,
                                                  vocab)
                    idx += 1
                    if not self._submit(sched, req).admitted:
                        raise RuntimeError("a warm-up request was refused")
                for _ in range(2):
                    sched.step()
            for e in list(sched.inflight):
                self.backend.release(e.handle)

    # ------------------------------------------------------------ window
    def serve(self, run: Run) -> Run:
        mix = self.mix
        vocab = int(self.port["vocab_size"])
        book = NoiseBook(self.seed, 1, self.device)
        run.book = book
        sched = self._scheduler(book)
        self.sched = sched
        tracker = _Tracker()
        closed = mix["loop"] == "closed"
        steps = run.steps
        self._steps = steps
        power = None
        if self.on_card:
            from harness.power import PowerSampler
            power = PowerSampler(list(range(self.cell.chips)))
        arrivals: List[traffic_mod.Request] = []
        next_arrival = 0
        next_index = 0

        def add(req, due) -> None:
            rec = RequestRecord(req.index, req.tier, due)
            run.requests[req.index] = rec
            run.prompts[req.index] = req.prompt
            adm = self._submit(sched, req)
            if adm.admitted:
                run.request_of[adm.request_id] = req.index
            else:
                run.refused += 1
                log(f"request {req.index} refused: {adm.reason}")

        def step() -> None:
            book.step = len(steps)
            t0 = time.perf_counter()
            sched.step()
            t1 = time.perf_counter()
            st = Step(len(steps), t0, t1, tracker.observe(sched), [])
            for bid, src in book.batches.items():
                if src.formed_in_step == st.index:
                    st.formed.append(bid)
                    for sid, _ in src.requests:
                        rec = run.requests[run.request_of[sid]]
                        rec.formed_t0, rec.first_token = t0, t1
                        rec.batch = bid
            steps.append(st)
            for sid in list(sched.completed):
                done = sched.completed.pop(sid)
                i = run.request_of[sid]
                run.requests[i].done = t1
                run.results[i] = done.result

        # everything set-up made stays alive: a collection that scans it
        # would pause the host inside the window
        gc.collect()
        gc.freeze()
        ramp0 = time.perf_counter()
        if closed:
            for _ in range(mix["max_batch_requests"]):
                add(traffic_mod.closed_loop(mix, self.seed, next_index,
                                            vocab), time.perf_counter())
                next_index += 1
            for _ in range(mix["stagger_steps"] - 1):
                step()
            while next_index < mix["outstanding"]:
                add(traffic_mod.closed_loop(mix, self.seed, next_index,
                                            vocab), time.perf_counter())
                next_index += 1
            step()
            start = time.perf_counter()
            run.setup_parts["ramp_s"] = start - ramp0
        else:
            arrivals = traffic_mod.open_loop(mix, self.seed, self.seconds,
                                             vocab)
            origin = time.perf_counter()
            start = origin + float(mix["warm_s"])
            run.setup_parts["ramp_s"] = float(mix["warm_s"])
        run.setup_s = process_age_s() - (time.perf_counter() - start)
        end = start + self.seconds
        run.window = (start, end)
        prof_at = start + 0.25 * self.seconds
        prof = None
        prof_left = PROFILE_STEPS if self.trace and self.on_card else 0
        while True:
            now = time.perf_counter()
            if now >= end:
                break
            if not closed:
                while next_arrival < len(arrivals) and \
                        origin + arrivals[next_arrival].due_s <= now:
                    a = arrivals[next_arrival]
                    due = origin + a.due_s
                    run.lateness.append(now - due)
                    add(a, due)
                    next_arrival += 1
                if not (sched.queue.pending or sched.inflight):
                    nxt = (origin + arrivals[next_arrival].due_s
                           if next_arrival < len(arrivals) else end)
                    time.sleep(max(0.0, min(nxt, end) - now))
                    continue
            if prof_left and prof is None and now >= prof_at:
                run.slice_first = len(steps)
                prof = self._profile_start()
            if prof is not None:
                with torch.profiler.record_function("bench/step"):
                    step()
                prof_left -= 1
                if prof_left == 0:
                    run.profile = self._profile_stop(prof, steps)
                    prof = None
            else:
                step()
            if closed:
                while len(run.requests) - len(run.results) - run.refused \
                        < mix["outstanding"]:
                    add(traffic_mod.closed_loop(mix, self.seed, next_index,
                                                vocab), time.perf_counter())
                    next_index += 1
        if prof is not None:
            run.profile = self._profile_stop(prof, steps)
        if run.slice_first is not None:
            run.slice_wall = self._slice_wall
        if power is not None:
            power.stop()
            run.energy_j = power.energy_j(start, end)
        if self.on_card:
            torch.cuda.synchronize()
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        run.graph_stats["end"] = dict(vars(self.backend.graph_stats))
        if run.profile is not None:
            from harness.trace import read_profile
            run.profile = read_profile(*run.profile)
        if self.obs is not None:
            run.spans = [s for s in self.obs.tracer.spans
                         if s.clock == "wall" and start <= s.t0_s
                         and s.t1_s <= end]
        return run

    # ------------------------------------------------------------ profile
    def _profile_start(self):
        t0 = time.perf_counter()
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        self._slice_wall = (t0, t0)
        self._slice = torch.profiler.record_function("bench/slice")
        self._slice.__enter__()
        self._slice_first = len(self._steps)
        return prof

    def _profile_stop(self, prof, steps):
        """Stop the profiler; its trace is read after the window closes."""
        torch.cuda.synchronize()
        self._slice.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        self._slice_wall = (self._slice_wall[0], time.perf_counter())
        return prof, steps[self._slice_first:]

    # ------------------------------------------------------------ release
    def release_program(self) -> None:
        """Drop the program's state (scheduler, backend, caches, graphs, any
        quantized weights) so that the reference runs beside the weights
        alone."""
        for name in ("sched", "backend", "router", "model"):
            if hasattr(self, name):
                delattr(self, name)
        if self.on_card:
            import gc
            gc.collect()
            torch.cuda.empty_cache()
