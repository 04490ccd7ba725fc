"""G's inference forward as CUDA graphs: one graph a call signature, captured
on the signature's second call and replayed on every later one.

Eager, G with its style encoder launches ~1,060 small kernels from Python
for one 16-image request, and the card waits on the host between them. A
graph launches the same kernels, the hand-written attention kernel among
them, in one call. `ForwardGraphs` serves `Generator.forward`:

- when: every call whose Generator is in eval mode, with gradients off, on
  CUDA inputs, while the current stream is not capturing (the train step's
  capture, an outer graph), no compiler or export traces and no parallel
  step is open (parallel/mesh.py `current`). Any other call runs the eager
  forward, counted nowhere;
- the signature (`signature`): each input's shape, dtype and device, or
  None; inference mode or no-grad (a graph's static buffers made under
  `inference_mode` are inference tensors); the autocast state; the float32
  backend flags (cuDNN's switches, TF32 and the matmul precision); each
  attention block's resolved `dataflow` and `use_kernel`;
- the second sighting: a signature's first call runs eagerly and is only
  recorded, so a one-shot call (the `infer` CLI) never pays a capture. The
  second copies its inputs into the signature's static buffers, runs the
  forward on them once on a side stream (the warm-up, whose output it
  returns) and captures it on that stream (utils/capture.py, the train
  step's capture path); so every call launches the forward's kernels
  once. A later call copies its inputs into the buffers (`copy_`, which also
  materialises an expanded style page) and replays on the current stream.
  Every call returns a fresh clone of the static output, so a caller may
  hold one call's images across the next. A failed capture raises;
- weights: a graph reads the parameters and buffers at their addresses.
  Writes in place (`copy_`, the EMA, `load_state_dict`'s copies) keep them,
  so a replay reads the weights as they are now. A graph replays only while
  every parameter and buffer of the Generator is the tensor object, at the
  same `data_ptr`, that the first capture saw (a flat list made then). A
  `functional_call` override, `.to()`, `_apply` or `load_state_dict(
  assign=True)` breaks that: the call runs eagerly, every graph is dropped
  and every signature counts as unseen again. A Generator holding a tensor
  subclass (a DTensor) is never captured;
- memory: one Generator's graphs share one pool. A replay reads only its
  static inputs and the weights, which live outside the pool, and its
  output is cloned on the replay's stream before any later replay, so no
  graph's memory must outlive its replay. Calls from two threads or
  streams must not overlap;
- counters: while tracing (utils/profiling.py), `g.graph.replay` counts calls served
  by a replay, `g.graph.capture` captures and `g.graph.eager` calls that
  could have replayed and ran eagerly (a first sighting, a weights
  mismatch); a capture is a `once` span `g.graph.capture`.

`ForwardGraphs` is a plain attribute of the Generator, not a submodule,
parameter or buffer: `state_dict` does not see it, and `copy.deepcopy` or a
pickle of the Generator gets a new, empty one.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
from torch import nn

from scrabblegan_torch.ops.attention import NonLocalBlock, resolve_dataflow
from scrabblegan_torch.parallel import mesh as pmesh
from scrabblegan_torch.utils import profiling
from scrabblegan_torch.utils.capture import Captured, aside, capture, replay

Inputs = tuple[Optional[torch.Tensor], ...]  # labels, z, lengths, style_imgs


def engages(module: nn.Module, inputs: Inputs) -> bool:
    """Whether a call may be served by a graph (the module's text)."""
    if module.training or torch.is_grad_enabled():
        return False
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return False
    if not all(x is None or x.is_cuda for x in inputs):
        return False
    return not torch.cuda.is_current_stream_capturing() and pmesh.current() is None


def signature(blocks: list[NonLocalBlock], inputs: Inputs) -> tuple:
    """The graph cache's key of a call (the module's text); `blocks` are the
    Generator's attention blocks."""
    return (tuple(None if x is None else (x.shape, x.dtype, x.device) for x in inputs),
            torch.is_inference_mode_enabled(),
            torch.is_autocast_enabled("cuda"), torch.get_autocast_dtype("cuda"),
            torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.get_float32_matmul_precision(),
            tuple((resolve_dataflow(b.dataflow), b.use_kernel) for b in blocks))


def _weights(module: nn.Module) -> list[tuple[dict, str, torch.Tensor, int]]:
    """(owner's store, name, tensor, data_ptr) of every parameter and buffer."""
    return [(store, name, t, t.data_ptr()) for m in module.modules()
            for store in (m._parameters, m._buffers) for name, t in store.items()
            if t is not None]


@dataclasses.dataclass
class Graph(Captured):
    inputs: Inputs                   # static buffers, None where the input is None


class ForwardGraphs:
    """One Generator's inference graphs; `__call__(module, forward, inputs)`
    serves a call of `module`, whose eager forward is `forward(*inputs)`."""

    def __init__(self):
        self.graphs: dict[tuple, Graph] = {}
        self._seen: set[tuple] = set()
        self._weights: Optional[list] = None  # what the graphs read, from the first capture
        self._blocks: Optional[list[NonLocalBlock]] = None
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    def __reduce__(self):  # a pickle or a deep copy holds no graph
        return ForwardGraphs, ()

    def clear(self) -> None:
        """Drops every graph, its pool and every sighting."""
        self.graphs.clear()
        self._seen.clear()
        self._weights = self._pool = self._stream = None

    def __call__(self, module: nn.Module, forward, inputs: Inputs) -> torch.Tensor:
        if not engages(module, inputs):
            return forward(*inputs)
        if self._blocks is None:
            self._blocks = [m for m in module.modules() if isinstance(m, NonLocalBlock)]
        sig = signature(self._blocks, inputs)
        if self._weights is not None and not self._live():
            self.clear()
        graph = self.graphs.get(sig)
        if graph is None and sig not in self._seen:
            self._seen.add(sig)
            profiling.count("g.graph.eager")
            return forward(*inputs)
        if graph is None:
            return self._capture(module, forward, inputs, sig)
        for buf, x in zip(graph.inputs, inputs):
            if buf is not None:
                buf.copy_(x)
        profiling.count("g.graph.replay")
        return replay(graph)

    def _live(self) -> bool:
        return all(store.get(name) is t and t.data_ptr() == ptr
                   for store, name, t, ptr in self._weights)

    def _capture(self, module: nn.Module, forward, inputs: Inputs, sig: tuple) -> torch.Tensor:
        """Captures `sig`'s graph; returns the warm-up's output."""
        weights = self._weights or _weights(module)
        if any(type(t) not in (torch.Tensor, nn.Parameter) for _, _, t, _ in weights):
            return forward(*inputs)  # a tensor subclass (a DTensor) among the weights
        static = tuple(None if x is None else torch.empty(x.shape, dtype=x.dtype,
                                                          device=x.device) for x in inputs)
        for buf, x in zip(static, inputs):
            if buf is not None:
                buf.copy_(x)
        device = inputs[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        warm = aside(lambda: forward(*static), self._stream, device, _uncached_autocast())
        captured = capture(lambda: forward(*static), self._pool, self._stream, device,
                           "g.graph.capture", _uncached_autocast())
        self._pool = captured.pool
        self._weights = weights
        self.graphs[sig] = Graph(**vars(captured), inputs=static)
        profiling.count("g.graph.capture")
        return warm


def _uncached_autocast():
    """Autocast as it is, with its cache of cast weights off: a cast cached
    outside a graph would be freed while the graph still reads it."""
    if not torch.is_autocast_enabled("cuda"):
        return contextlib.nullcontext()
    return torch.autocast("cuda", dtype=torch.get_autocast_dtype("cuda"), cache_enabled=False)
