"""The train step's body as CUDA graphs: capture once a batch shape, replay
each step.

The port's counterpart of JAX's jitted step: the eager step issues ~7,800
kernels from Python and keeps the card idle most of the time, where a graph
replays them in one launch. `StepGraphs` keeps one `torch.cuda.CUDAGraph` per
batch-shape signature (one in padded mode, one per (real, fake) bucket pair
otherwise) and runs K steps a call by replaying one step's graph K times:

- static inputs: a signature's device buffers, allocated at its first
  step; every step copies its batch into them (asynchronously, on the
  step's stream, from pinned host tensors), whether it then runs eagerly
  or by replay;
- warm-up: PyTorch wants a few eager iterations on a side stream before a
  capture. They are the signature's first `WARMUP_STEPS` steps: real steps
  of the body on the capture stream, reading the static inputs. The step
  after them is captured and replayed. Every batch is trained on once,
  eagerly or by replay, and both give the same state (bitwise on the card
  under cuDNN's deterministic algorithms), so the batch stream keeps its
  match with JAX's draw for draw, and the kernels launch a step's count on
  every step;
- capture: `before_capture`, when set, is called first (the Trainer's
  stall-watchdog grace); every `.grad` is None, so the backward allocates
  its gradients in the graph's pool; the capture records the body and runs
  nothing;
- replay: a step replays and clones the 16 metrics out of the static
  output, and a call stacks its K columns into a fresh (16, K) tensor, so
  that a block of pending metrics never aliases the newest step's;
- the kernels' launch counters count a capture's launches once and a
  replay not at all: the counts a capture added are taken back and added
  again on every replay, so the counters stay exact;
- memory: all graphs of one `StepGraphs` share one pool. That is safe here:
  a replay reads only the static inputs and the state, which live outside
  the pool, and its one output is copied out before the next replay, so no
  graph's memory must outlive its replay. The pool therefore holds about
  one step's activations, however many bucket pairs are captured.

No fallback: a failed capture raises. `CAPTURE_LOCK` is held for the length
of a capture; a device round trip from another thread (the stall
watchdog's probe) takes it first, since a device-wide synchronisation
during a capture would invalidate it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import torch

from scrabblegan_torch.kernels import attention, fused_block
from scrabblegan_torch.train.state import TrainState

WARMUP_STEPS = 2  # eager steps of a signature on the capture stream before its capture
CAPTURE_LOCK = threading.Lock()
# the kernels' counters (module, attribute), kept exact under replay
COUNTERS = ((attention, "launches"), (attention, "bwd_launches"),
            (attention, "bwd_dout_copies"), (fused_block, "launches"))


def counter_values() -> tuple[int, ...]:
    return tuple(getattr(module, name) for module, name in COUNTERS)


def _add_counts(counts: tuple[int, ...], sign: int = 1) -> None:
    for (module, name), n in zip(COUNTERS, counts):
        setattr(module, name, getattr(module, name) + sign * n)


@dataclasses.dataclass
class _Inputs:
    """A signature's static device inputs and its warm-up steps so far."""
    batch: dict[str, torch.Tensor]
    z: Optional[torch.Tensor]
    warm: int = 0


@dataclasses.dataclass
class CapturedStep:
    graph: torch.cuda.CUDAGraph
    inputs: _Inputs
    metrics: torch.Tensor            # static (16,) output
    counts: tuple[int, ...]          # kernel launches a replay, by COUNTERS
    capture_s: float                 # the capture itself, wall seconds
    pool_bytes: int                  # device memory the capture reserved for its pool


def signature(batches: dict[str, torch.Tensor], z: Optional[torch.Tensor]) -> tuple:
    """The per-step shapes and dtypes of a K-stacked call's leaves."""
    leaves = sorted(batches.items()) + ([("z", z)] if z is not None else [])
    return tuple((key, tuple(v.shape[1:]), v.dtype) for key, v in leaves)


class StepGraphs:
    """`body(state, inputs, z) -> (16,)` (train/step.py `make_step_body`)
    as graphs on `device`."""

    def __init__(self, body: Callable, device: torch.device):
        self.body = body
        self.device = device
        self.captured: dict[tuple, CapturedStep] = {}
        self.warmup_steps = 0  # eager warm-up steps run so far, every signature's
        self.before_capture: Optional[Callable[[], None]] = None
        self._inputs: dict[tuple, _Inputs] = {}
        self._pool = None
        self._state: Optional[TrainState] = None
        self._stream = torch.cuda.Stream(device)

    def __call__(self, state: TrainState, batches: dict[str, torch.Tensor],
                 z: Optional[torch.Tensor]) -> torch.Tensor:
        if self._state is not state:  # graphs read and write one state's tensors
            self.captured.clear()
            self._inputs.clear()
            self._pool, self._state = None, state
        sig = signature(batches, z)
        inputs = self._inputs.get(sig)
        if inputs is None:
            inputs = self._inputs[sig] = _Inputs(
                {key: torch.empty(v.shape[1:], dtype=v.dtype, device=self.device)
                 for key, v in batches.items()},
                None if z is None else torch.empty(z.shape[1:], dtype=z.dtype,
                                                   device=self.device))
        cols = []
        for i in range(next(iter(batches.values())).shape[0]):
            for key, buf in inputs.batch.items():
                buf.copy_(batches[key][i], non_blocking=True)
            if z is not None:
                inputs.z.copy_(z[i], non_blocking=True)
            step = self.captured.get(sig)
            if step is None and inputs.warm < WARMUP_STEPS:
                cols.append(self._eager(state, inputs))
                continue
            if step is None:
                step = self.captured[sig] = self._capture(state, inputs)
            step.graph.replay()
            cols.append(step.metrics.clone())
            _add_counts(step.counts)
        return torch.stack(cols, dim=1)

    def _eager(self, state: TrainState, inputs: _Inputs) -> torch.Tensor:
        """One warm-up step: the body on the capture stream."""
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            metrics = self.body(state, inputs.batch, inputs.z)
        current.wait_stream(self._stream)
        metrics.record_stream(current)
        inputs.warm += 1
        self.warmup_steps += 1
        return metrics

    def _capture(self, state: TrainState, inputs: _Inputs) -> CapturedStep:
        if self.before_capture is not None:
            self.before_capture()
        for module in state.modules().values():
            for p in module.parameters():
                p.grad = None
        graph = torch.cuda.CUDAGraph()
        before = counter_values()
        t0 = time.perf_counter()
        with CAPTURE_LOCK, torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                            capture_error_mode="thread_local"):
            reserved = torch.cuda.memory_reserved(self.device)  # after the cache was emptied
            metrics = self.body(state, inputs.batch, inputs.z)
            pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        capture_s = time.perf_counter() - t0
        counts = tuple(a - b for a, b in zip(counter_values(), before))
        _add_counts(counts, -1)  # a capture launches nothing
        if self._pool is None:
            self._pool = graph.pool()
        return CapturedStep(graph, inputs, metrics, counts, capture_s, pool_bytes)
