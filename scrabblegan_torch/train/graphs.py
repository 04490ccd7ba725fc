"""The train step's body as CUDA graphs: capture once a batch shape, replay
each step.

The port's counterpart of JAX's jitted step: the eager step issues ~7,800
kernels from Python and keeps the card idle most of the time, where a graph
replays them in one launch. `StepGraphs` keeps one `torch.cuda.CUDAGraph` per
batch-shape signature (one in padded mode, one per (real, fake) bucket pair
otherwise) and runs K steps a call by replaying one step's graph K times
(utils/capture.py holds the capture path it shares with G's graphs):

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
  nothing; a failed capture raises (no fallback);
- replay: a step replays and clones the 16 metrics out of the static
  output, and a call stacks its K columns into a fresh (16, K) tensor, so
  that a block of pending metrics never aliases the newest step's;
- tracing (utils/profiling.py): each warm-up step and each capture is a
  `once` span (`graphs.warmup`, `graphs.capture`); the capture keeps the
  step's phase marks as event-record nodes of the graph (`capture_marks`),
  so every replay times its phases on the device; while tracing is on a
  replay is also timed as a whole (`profiling.replay`);
- memory: all graphs of one `StepGraphs` share one pool. That is safe here:
  a replay reads only the static inputs and the state, which live outside
  the pool, and its one output is copied out before the next replay, so no
  graph's memory must outlive its replay. The pool therefore holds about
  one step's activations, however many bucket pairs are captured.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from scrabblegan_torch.train.state import TrainState
from scrabblegan_torch.utils import profiling
from scrabblegan_torch.utils.capture import Captured, aside, capture, replay

WARMUP_STEPS = 2  # eager steps of a signature on the capture stream before its capture


@dataclasses.dataclass
class _Inputs:
    """A signature's static device inputs and its warm-up steps so far."""
    batch: dict[str, torch.Tensor]
    z: Optional[torch.Tensor]
    warm: int = 0


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
        self.captured: dict[tuple, Captured] = {}  # out: the (16,) metrics; entered: the marks
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
        run = functools.partial(self.body, state, inputs.batch, inputs.z)
        cols = []
        for i in range(next(iter(batches.values())).shape[0]):
            for key, buf in inputs.batch.items():
                buf.copy_(batches[key][i], non_blocking=True)
            if z is not None:
                inputs.z.copy_(z[i], non_blocking=True)
            step = self.captured.get(sig)
            if step is None and inputs.warm < WARMUP_STEPS:  # a warm-up step
                cols.append(aside(run, self._stream, self.device, profiling.once("graphs.warmup")))
                inputs.warm += 1
                self.warmup_steps += 1
                continue
            if step is None:
                step = self.captured[sig] = self._capture(state, run)
            cols.append(replay(step, step.entered))
        return torch.stack(cols, dim=1)

    def _capture(self, state: TrainState, run: Callable[[], torch.Tensor]) -> Captured:
        if self.before_capture is not None:
            self.before_capture()
        for module in state.modules().values():
            for p in module.parameters():
                p.grad = None
        step = capture(run, self._pool, self._stream, self.device, "graphs.capture",
                       profiling.capture_marks())
        self._pool = step.pool
        return step
