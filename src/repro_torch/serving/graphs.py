"""CUDA graphs of the serving backend's decode step.

The port's counterpart of the reference's ``jax.jit`` boundary
(``src/repro/serving/backend.py:527-536``). The reference compiles its
decode step once and passes the step position as a device array, so each
decode step is one XLA program. Here, on the card, each in-flight batch's
decode step is one ``torch.cuda.CUDAGraph``:

* `StaticDecodeStep` is the body: the backend's decode step over static
  buffers (the token ids, the step position, the Gumbel noise, and any
  decode inputs a shared graph must refill). It writes
  its sampled tokens back into the token buffer, so the ids stay on the
  device from one step to the next. It runs eagerly on any device, which
  is how the CPU tests hold it to the plain decode step.
* `StaticVerifyStep` is the body of a speculating batch's verify step
  (`repro_torch.serving.backend`): one forward at S = n + 1 over static
  buffers of the tokens (the last committed token and the n drafts), each
  row's base position and, when it samples, the uniform and Gumbel draws
  of `repro_torch.spec.verify_tokens`; it returns the accept lengths, the
  committed tokens and their logprobs.
* `DecodeGraph.capture` records a body once; `DecodeGraph.replay` fills
  its inputs, replays, and returns the static outputs.

Every graph serves every batch of its shape, as the reference's jit
compiles each step once per static shape (``_decode_step`` and
``_spec_verify``, keyed by the input shapes, ``kv_len`` and ``greedy``).
The step reads static copies of its decode inputs (the block table among
them) and of the batch's last tokens, which `StaticDecodeStep.load` refills
from the batch that replays it, with the step position, the noise and the
temperature: a 0-dim f32 buffer, so that one graph serves every temperature
of a shape (the greedy branch, a plain argmax, is part of the shape). On
the backend's resident prefix pool the graphs address the one cache that
outlives every batch; off it, a retired batch hands its cache and its
graphs on to the next batch of its cache's shape (the backend's cache
arenas). Until a shape has a graph, a batch's first decode step runs
eagerly and pays each kernel's first-use work (planners,
``cudaFuncSetAttribute``, TMA descriptors, workspace growth) outside the
capture. A decode step is not idempotent (it writes a KV slot and advances
the SSM state), so no extra run of the body warms the capture up: the
capture executes nothing, and the replay that follows it is the step. A
verify step is keyed and warmed the same way: a batch's first verify runs
eagerly, and its later ones replay one graph a shape and draft depth.

A graph keeps alive what it addresses: the body (and through it the cache,
weights and buffers), the split kernels' workspaces handed out during the
capture (`repro_torch.kernels.common.holding_workspaces`), and its outputs,
which every replay overwrites.

A capture with ``timed=True`` (the backend asks for one when its tracer is
on) captures the step a second time with a CUDA timing event at each of
the model's segment marks (`repro_torch.obs.segments`), event-record nodes
that each replay of that copy records again; ``replay(..., timed=True)``
replays it, and ``DecodeGraph.timer`` reads its events. The backend replays
the timed copy once in `DEVICE_TIME_EVERY`, because the event nodes are
not free: on an H100, chatglm3-6b's 313 of them added 1.4 ms of device
time and 1.8 ms of host launch time to a 11.4 ms replay. A capture without
``timed`` records no event: the graph of an untraced serve has none.
"""
from __future__ import annotations

import gc
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels.common import holding_workspaces
from repro_torch.obs.segments import SegmentTimer

if TYPE_CHECKING:
    from repro_torch.serving.backend import NoiseSource

#: ``(token ids (B, 1), positions (B, 1) int32, noise, temperature (0-dim
#: f32)) -> (tokens (B,), logprobs (B,))``: one batch's decode step over its
#: cache; with K codebooks the ids are (B, 1, K) and the tokens and
#: logprobs (B, K)
DecodeFn = Callable[[torch.Tensor, torch.Tensor, Callable, torch.Tensor],
                    Tuple[torch.Tensor, torch.Tensor]]
#: ``(token ids (B, n + 1), base positions (B,) int32, u (B, n) or None,
#: g (B, vocab) or None, temperature (0-dim f32)) -> (accept_len (B,),
#: tokens (B, n + 1), logprobs (B, n + 1))``: one speculating batch's verify
#: step over its cache
VerifyFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                     Optional[torch.Tensor], torch.Tensor],
                    Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


@dataclass
class GraphStats:
    """A backend's graph work: decode-step captures and replays, verify-step
    captures and replays (speculating batches), the host seconds all
    captures took (the Python of one step, and the graph's instantiation),
    and the bytes their private memory pools reserved."""
    captures: int = 0
    capture_s: float = 0.0
    replays: int = 0
    pool_bytes: int = 0
    verify_captures: int = 0
    verify_replays: int = 0


class StaticDecodeStep:
    """One batch's decode step over static buffers: the body a graph
    captures.

    ``tok`` (B, 1) holds the token ids the step reads, (B, 1, K) with K
    codebooks (``tok`` given as (B,) or (B, K)); the step writes its
    sampled tokens back into it. ``pos`` (B, 1) int32 holds the step
    position, ``temperature`` (0-dim f32) the batch's temperature, and
    ``noise`` (B, vocab) f32, or (B, K, vocab), the step's Gumbel draws
    (only when ``sampled``, i.e. temperature > 0); `load` fills them.
    ``inputs`` are the decode inputs ``decode`` reads (the block table
    (B, W) int32, extras): `load` copies the replaying batch's into
    them."""

    def __init__(self, decode: DecodeFn, tok: torch.Tensor, vocab: int,
                 sampled: bool,
                 inputs: Optional[Dict[str, torch.Tensor]] = None):
        self.decode = decode
        self.tok = tok[:, None].clone()
        self.inputs = inputs if inputs is not None else {}
        B, dev = self.tok.shape[0], self.tok.device
        self.pos = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self.temperature = torch.ones((), dtype=torch.float32, device=dev)
        self.noise = (torch.zeros((B,) + tuple(tok.shape[1:]) + (vocab,),
                                  dtype=torch.float32, device=dev)
                      if sampled else None)

    @property
    def device(self) -> torch.device:
        return self.tok.device

    def load(self, step_pos: int, noise: NoiseSource,
             tok: Optional[torch.Tensor] = None,
             inputs: Optional[Dict[str, torch.Tensor]] = None,
             temperature: Optional[float] = None) -> None:
        """Fill the inputs of the step at ``step_pos``: the position, and
        the step's draw from the batch's ``noise`` stream, in the shape and
        order of the eager step's draw. With ``tok``, ``inputs`` and
        ``temperature`` (a batch's last tokens (B,) or (B, K), decode
        inputs by name, and temperature), copy those in too."""
        if tok is not None:
            self.tok.copy_(tok[:, None])
        for name, value in (inputs or {}).items():
            self.inputs[name].copy_(value)
        if temperature is not None:
            self.temperature.fill_(temperature)
        self.pos.fill_(step_pos)
        if self.noise is not None:
            self.noise.copy_(noise(tuple(self.noise.shape),
                                   self.noise.device))

    def _static_noise(self, shape: Tuple[int, ...],
                      device: torch.device) -> torch.Tensor:
        held = None if self.noise is None else tuple(self.noise.shape)
        if tuple(shape) != held:
            raise ValueError(f"the decode step drew noise of shape "
                             f"{tuple(shape)}; the static buffer is {held}")
        return self.noise

    def __call__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        tok, lp = self.decode(self.tok, self.pos, self._static_noise,
                              self.temperature)
        self.tok.copy_(tok[:, None])
        return tok, lp

    def run(self, step_pos: int, noise: NoiseSource,
            **batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """`load` (``batch``: its ``tok`` and ``inputs``), then the step,
        eagerly."""
        self.load(step_pos, noise, **batch)
        return self()


class StaticVerifyStep:
    """One speculating batch's verify step over static buffers: the body a
    verify graph captures.

    ``toks`` (B, n + 1) int32 holds the last committed token and the n
    drafts of each row, ``base_pos`` (B,) int32 each row's position of
    ``toks[:, 0]``, ``temperature`` (0-dim f32) the batch's temperature,
    and, when ``sampled``, ``u`` (B, n) and ``g`` (B, vocab) f32 the step's
    uniform and Gumbel draws; `load` fills them, and copies the replaying
    batch's decode inputs into ``inputs``."""

    def __init__(self, verify: VerifyFn, rows: int, n: int, vocab: int,
                 device: torch.device, sampled: bool,
                 inputs: Optional[Dict[str, torch.Tensor]] = None):
        self.verify = verify
        self.inputs = inputs if inputs is not None else {}
        self.toks = torch.zeros((rows, n + 1), dtype=torch.int32,
                                device=device)
        self.base_pos = torch.zeros((rows,), dtype=torch.int32,
                                    device=device)
        self.temperature = torch.ones((), dtype=torch.float32, device=device)
        self.u = self.g = None
        if sampled:
            self.u = torch.zeros((rows, n), dtype=torch.float32,
                                 device=device)
            self.g = torch.zeros((rows, vocab), dtype=torch.float32,
                                 device=device)

    @property
    def device(self) -> torch.device:
        return self.toks.device

    def load(self, toks: torch.Tensor, base_pos: torch.Tensor,
             u: Optional[torch.Tensor] = None,
             g: Optional[torch.Tensor] = None,
             inputs: Optional[Dict[str, torch.Tensor]] = None,
             temperature: Optional[float] = None) -> None:
        """Fill the step's tokens, base positions and (sampled) draws, and
        with ``inputs`` and ``temperature`` a batch's decode inputs, by
        name, and its temperature."""
        self.toks.copy_(toks)
        self.base_pos.copy_(base_pos)
        if (self.u is None) != (u is None) or (self.g is None) != (g is None):
            raise ValueError("the verify step's draws do not match its "
                             "static buffers (sampled and greedy differ)")
        if self.u is not None:
            self.u.copy_(u)
            self.g.copy_(g)
        for name, value in (inputs or {}).items():
            self.inputs[name].copy_(value)
        if temperature is not None:
            self.temperature.fill_(temperature)

    def __call__(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.verify(self.toks, self.base_pos, self.u, self.g,
                           self.temperature)

    def run(self, *args, **batch
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """`load` (the same arguments), then the step, eagerly."""
        self.load(*args, **batch)
        return self()


class DecodeGraph:
    """A captured step (a `StaticDecodeStep` or a `StaticVerifyStep`): the
    graph, its outputs, the kernel launches one replay makes, the
    workspaces it addresses, and for a timed capture the timed copy of the
    graph (``timed``: the graph and its outputs) and its segment timer."""

    def __init__(self, step, graph,
                 outputs: Tuple[torch.Tensor, ...],
                 launches: Dict[str, int], held: List[torch.Tensor],
                 pool_bytes: int = 0, timed: Optional[tuple] = None,
                 timer: Optional[SegmentTimer] = None):
        self.step = step
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.held = held
        self.pool_bytes = pool_bytes
        self.timed = timed
        self.timer = timer

    @classmethod
    def capture(cls, step, timed: bool = False) -> "DecodeGraph":
        """Capture ``step`` on its CUDA device, in PyTorch's default
        (global) capture mode, on a side stream. Nothing runs on the card;
        a capture that fails raises.

        Python's automatic garbage collection is off during the capture: a
        collection there could free another graph held only by a reference
        cycle (a dropped backend), and destroying a graph is refused while
        a stream captures, which invalidates this capture.
        ``torch.cuda.graph`` instead collects garbage and empties the
        allocator's cache before every capture, which costs time once a
        batch; so the capture calls ``capture_begin`` / ``capture_end``.

        ``timed``: capture the step once more, with a timing event at each
        segment mark and one at the step's end (`SegmentTimer`)."""
        dev = step.device
        timer = SegmentTimer() if timed else None
        graphs = [torch.cuda.CUDAGraph() for _ in range(2 if timed else 1)]
        reserved = torch.cuda.memory_reserved(dev)
        before = kernels.launch_counts()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        collecting = gc.isenabled()
        gc.disable()
        try:
            with holding_workspaces() as held, torch.cuda.stream(side):
                outputs = [_record(graph, step, t)
                           for graph, t in zip(graphs, (None, timer))]
        finally:
            if collecting:
                gc.enable()
            # the wrappers counted launches that only a replay makes, once
            # a capture
            after = kernels.launch_counts()
            counted = {k: n - before[k] for k, n in after.items()
                       if n != before[k]}
            kernels.add_launches({k: -n for k, n in counted.items()})
        torch.cuda.current_stream(dev).wait_stream(side)
        launches = {k: n // len(graphs) for k, n in counted.items()}
        return cls(step, graphs[0], outputs[0], launches,
                   list(held.values()),
                   torch.cuda.memory_reserved(dev) - reserved,
                   (graphs[1], outputs[1]) if timed else None, timer)

    def replay(self, *args, timed: bool = False,
               **batch) -> Tuple[torch.Tensor, ...]:
        """Load the step's inputs (``step.load(*args, **batch)``: for a
        decode step its position and noise, and the replaying batch's
        ``tok``, ``inputs`` and ``temperature``), replay (with ``timed``
        the timed copy), and count the captured launches. Returns the
        outputs, which the next replay overwrites."""
        self.step.load(*args, **batch)
        graph, outputs = self.timed if timed else (self.graph, self.outputs)
        graph.replay()
        kernels.add_launches(self.launches)
        return outputs


def _record(graph, step, timer: Optional[SegmentTimer]):
    """Capture ``step`` into ``graph`` (under ``timer``'s recording when
    given); returns the step's outputs."""
    graph.capture_begin()
    try:
        if timer is None:
            return step()
        with timer.recording():
            return step()
    finally:
        graph.capture_end()


__all__ = ["DecodeGraph", "GraphStats", "StaticDecodeStep",
           "StaticVerifyStep"]
