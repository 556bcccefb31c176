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
* `DecodeGraph.capture` records the body once; `DecodeGraph.replay` fills
  the position and the noise, replays, and returns the static outputs.

A batch over its own cache owns its graph
(`repro_torch.serving.backend.InFlightBatch`): captured at the batch's
second decode step and dropped with the batch, whose cache the graph
addresses by pointer. On the backend's resident prefix pool, whose cache
outlives every batch, the backend keeps one graph per decode shape and
every later batch of that shape replays it from its first decode step: the
step then reads static copies of its decode inputs (the block table among
them), which `StaticDecodeStep.load` refills from the batch's, with its
last tokens. Until a batch's shape has a graph, its first decode step runs
eagerly and pays each kernel's first-use work (planners,
``cudaFuncSetAttribute``, TMA descriptors, workspace growth) outside the
capture. A decode step is not idempotent (it writes a KV slot and advances
the SSM state), so no extra run of the body warms the capture up: the
capture executes nothing, and the replay that follows it is the step.

A graph keeps alive what it addresses: the body (and through it the cache,
weights and buffers), the split kernels' workspaces handed out during the
capture (`repro_torch.kernels.common.holding_workspaces`), and its outputs,
which every replay overwrites.
"""
from __future__ import annotations

import gc
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels.common import holding_workspaces

if TYPE_CHECKING:
    from repro_torch.serving.backend import NoiseSource

#: ``(token ids (B, 1), positions (B, 1) int32, noise) -> (tokens (B,),
#: logprobs (B,))``: one batch's decode step over its cache
DecodeFn = Callable[[torch.Tensor, torch.Tensor, Callable],
                    Tuple[torch.Tensor, torch.Tensor]]


@dataclass
class GraphStats:
    """A backend's graph work: captures, the host seconds they took (the
    Python of one decode step, and the graph's instantiation), replays,
    and the bytes the captures' private memory pools reserved."""
    captures: int = 0
    capture_s: float = 0.0
    replays: int = 0
    pool_bytes: int = 0


class StaticDecodeStep:
    """One batch's decode step over static buffers: the body a graph
    captures.

    ``tok`` (B, 1) holds the token ids the step reads; the step writes its
    sampled tokens back into it. ``pos`` (B, 1) int32 holds the step
    position and ``noise`` (B, vocab) f32 the step's Gumbel draws (only
    when ``sampled``, i.e. temperature > 0); `load` fills both. ``inputs``
    are the decode inputs ``decode`` reads (the block table (B, W) int32,
    extras): `load` copies another batch's into them when the step serves
    more than one batch."""

    def __init__(self, decode: DecodeFn, tok: torch.Tensor, vocab: int,
                 sampled: bool,
                 inputs: Optional[Dict[str, torch.Tensor]] = None):
        self.decode = decode
        self.tok = tok.reshape(-1, 1).clone()
        self.inputs = inputs if inputs is not None else {}
        B, dev = self.tok.shape[0], self.tok.device
        self.pos = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self.noise = (torch.zeros((B, vocab), dtype=torch.float32,
                                  device=dev) if sampled else None)

    def load(self, step_pos: int, noise: NoiseSource,
             tok: Optional[torch.Tensor] = None,
             inputs: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Fill the inputs of the step at ``step_pos``: the position, and
        the step's draw from the batch's ``noise`` stream, in the shape and
        order of the eager step's draw. With ``tok`` and ``inputs`` (a
        batch's last tokens (B,) and decode inputs, by name), copy those
        in too."""
        if tok is not None:
            self.tok.copy_(tok.reshape(-1, 1))
        for name, value in (inputs or {}).items():
            self.inputs[name].copy_(value)
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
        tok, lp = self.decode(self.tok, self.pos, self._static_noise)
        self.tok.copy_(tok[:, None])
        return tok, lp

    def run(self, step_pos: int, noise: NoiseSource,
            **batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """`load` (``batch``: its ``tok`` and ``inputs``), then the step,
        eagerly."""
        self.load(step_pos, noise, **batch)
        return self()


class DecodeGraph:
    """A captured `StaticDecodeStep`: the graph, its outputs, the kernel
    launches one replay makes, and the workspaces it addresses."""

    def __init__(self, step: StaticDecodeStep, graph,
                 outputs: Tuple[torch.Tensor, torch.Tensor],
                 launches: Dict[str, int], held: List[torch.Tensor],
                 pool_bytes: int = 0):
        self.step = step
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.held = held
        self.pool_bytes = pool_bytes

    @classmethod
    def capture(cls, step: StaticDecodeStep) -> "DecodeGraph":
        """Capture ``step`` on its CUDA device, in PyTorch's default
        (global) capture mode, on a side stream. Nothing runs on the card;
        a capture that fails raises.

        Python's automatic garbage collection is off during the capture: a
        collection there could free another graph held only by a reference
        cycle (a dropped backend), and destroying a graph is refused while
        a stream captures, which invalidates this capture.
        ``torch.cuda.graph`` instead collects garbage and empties the
        allocator's cache before every capture, which costs time once a
        batch; so the capture calls ``capture_begin`` / ``capture_end``."""
        dev = step.tok.device
        graph = torch.cuda.CUDAGraph()
        reserved = torch.cuda.memory_reserved(dev)
        before = kernels.launch_counts()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        collecting = gc.isenabled()
        gc.disable()
        try:
            with holding_workspaces() as held, torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    outputs = step()
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
            # the wrappers counted launches that only a replay makes
            after = kernels.launch_counts()
            launches = {k: n - before[k] for k, n in after.items()
                        if n != before[k]}
            kernels.add_launches({k: -n for k, n in launches.items()})
        torch.cuda.current_stream(dev).wait_stream(side)
        return cls(step, graph, outputs, launches, list(held.values()),
                   torch.cuda.memory_reserved(dev) - reserved)

    def replay(self, step_pos: int, noise: NoiseSource,
               **batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step at ``step_pos``: load the inputs (``batch``: the
        ``tok`` and ``inputs`` of the batch replaying a shared graph),
        replay, and count the captured launches. Returns the outputs, which
        the next replay overwrites."""
        self.step.load(step_pos, noise, **batch)
        self.graph.replay()
        kernels.add_launches(self.launches)
        return self.outputs


__all__ = ["DecodeGraph", "GraphStats", "StaticDecodeStep"]
