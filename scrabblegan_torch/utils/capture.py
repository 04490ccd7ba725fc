"""The port's one CUDA graph capture path, shared by the train step
(train/graphs.py) and G's inference graphs (models/forward_graphs.py):
`aside` runs a body on the capture stream (PyTorch wants eager iterations
there first), `capture` records one on it, `replay` replays it.

- `CAPTURE_LOCK` is held for the length of a capture; a device round trip
  from another thread (the stall watchdog's probe) takes it first, since a
  device-wide synchronisation during a capture would invalidate it.
- The hand-written kernels count their launches (`kernels/attention.py`,
  the attention's also by width, `kernels/fused_block.py` and
  `kernels/pool.py`). A capture launches nothing, so the counts it added
  are taken back and added again on every replay.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, ContextManager, Optional

import torch

from scrabblegan_torch.kernels import attention, fused_block, pool
from scrabblegan_torch.utils import profiling

CAPTURE_LOCK = threading.Lock()
# the kernels' counters (module, attribute), kept exact under replay
COUNTERS = ((attention, "launches"), (attention, "bwd_launches"),
            (attention, "bwd_dout_copies"), (fused_block, "launches"),
            (pool, "launches"), (pool, "bwd_launches"), (pool, "nhwc_launches"),
            (pool, "nhwc_bwd_launches"))


def counter_values() -> tuple[int, ...]:
    """COUNTERS' values, then the attention launches by width
    (`attention.WIDTH_COUNTERS`)."""
    return (tuple(getattr(module, name) for module, name in COUNTERS)
            + tuple(attention.width_launches[key] for key in attention.WIDTH_COUNTERS))


def add_counts(counts: tuple[int, ...], sign: int = 1) -> None:
    for (module, name), n in zip(COUNTERS, counts):
        setattr(module, name, getattr(module, name) + sign * n)
    for key, n in zip(attention.WIDTH_COUNTERS, counts[len(COUNTERS):]):
        attention.width_launches[key] += sign * n


@dataclasses.dataclass
class Captured:
    graph: torch.cuda.CUDAGraph
    out: Any                         # the body's static output
    counts: tuple[int, ...]          # kernel launches a replay, by COUNTERS
    capture_s: float                 # the capture itself, wall seconds
    pool_bytes: int                  # device memory the capture reserved for the pool
    pool: tuple                      # the pool, for the next capture to share
    entered: Any                     # what `inside` yielded


def aside(body: Callable[[], torch.Tensor], stream: torch.cuda.Stream, device: torch.device,
          inside: ContextManager) -> torch.Tensor:
    """`body()` inside `inside` on `stream`, ordered after and before the
    current stream's work; its output is marked as used there."""
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream), inside:
        out = body()
    current.wait_stream(stream)
    out.record_stream(current)
    return out


def capture(body: Callable[[], Any], pool: Optional[tuple], stream: torch.cuda.Stream,
            device: torch.device, span: str, inside: ContextManager) -> Captured:
    """`body()` recorded into a new graph in the thread-local error mode, as a
    `once` span `span`, with `inside` entered inside the graph; the graph
    shares `pool` (makes its own when None). A failed capture raises."""
    graph = torch.cuda.CUDAGraph()
    before = counter_values()
    with profiling.once(span) as took, CAPTURE_LOCK, \
            torch.cuda.graph(graph, pool=pool, stream=stream,
                             capture_error_mode="thread_local"), inside as entered:
        reserved = torch.cuda.memory_reserved(device)  # after the cache was emptied
        out = body()
        pool_bytes = torch.cuda.memory_reserved(device) - reserved
    counts = tuple(a - b for a, b in zip(counter_values(), before))
    add_counts(counts, -1)  # a capture launches nothing
    return Captured(graph, out, counts, took.seconds, pool_bytes,
                    graph.pool() if pool is None else pool, entered)


def replay(captured: Captured, marks: Optional[profiling.Marks] = None) -> torch.Tensor:
    """Replays `captured` (timed by `profiling.replay` with `marks`); returns a clone of `out`."""
    if marks is None:
        captured.graph.replay()
    else:
        profiling.replay(captured.graph, marks)
    add_counts(captured.counts)
    return captured.out.clone()
