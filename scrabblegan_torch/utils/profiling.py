"""The port's tracer: spans, counters and device phase marks, and traces.
The port's counterpart of scrabblegan_tpu/utils/profiling.py, with
`torch.profiler` in place of `jax.profiler`.

Tracing is on while any `torch.profiler` session runs, or inside
`tracing()`. When it is off, `span`, `count` and `mark` (outside a capture)
read the two flags and return: no profiler range is opened, no clock is read
and no event is recorded.

- `span(name)`: while on, a `record_function` range (so the profiler's trace,
  and a trace's idle gaps, carry the program's names) and an in-memory
  record: name, start and end in `time.monotonic_ns`, its id, the id of the
  span open around it on its thread (`parent`) and of the outermost one
  (`root`: every span inside one call shares it), and the thread.
- `once(name)`: set-up work done once a process (a graph's warm-up steps and
  its capture): recorded whether on or not, one clock read at each end.
- `count(name, n)`: a counter, while on.
- `mark(phase)`: a phase boundary of the train step. Inside `capture_marks()`
  (a CUDA graph's capture) it records a timing event on the capturing
  stream, `external` so that the graph keeps it as an event-record node and
  every replay records it anew; a phase's device time runs from its mark to
  the next, the gaps between its kernels included, so the phases tile the
  step. Outside a capture, while on, it keeps only the phase's name (the
  eager step's order), on any device.
- `replay(graph, marks)`: `graph.replay()`; while on, with a timing-event
  pair around it, kept for the last `RING` replays, and a span.
- `snapshot()`: the totals so far (see its docstring). It reads only events
  the device has finished and never synchronises. `reset()` clears them.
- `trace(dir)`: a `torch.profiler` session over the block, host and, on a
  card, device activity: writes the Chrome trace (trace.json, viewable in
  Perfetto), the operator table (ops.txt) and `snapshot()` (spans.json).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Iterator, Optional

import torch
import torch.autograd.profiler as _profiler

RING = 256  # timed replays kept, and eager mark names
RECORDS = 4096  # raw span records kept

_NOOP = contextlib.nullcontext()
_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()
_switch = 0  # depth of `tracing()` blocks


def on() -> bool:
    """Whether tracing is on: inside `tracing()` or a profiler session."""
    return _switch > 0 or _profiler._is_profiler_enabled


class Marks:
    """One captured step's phase marks, in the order they were recorded:
    (name, timing event) pairs."""

    def __init__(self):
        self.names: list[str] = []
        self.events: list[torch.cuda.Event] = []

    def add(self, name: str) -> None:
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        self.names.append(name)
        self.events.append(event)

    def phase_ms(self) -> dict[str, float]:
        """Device ms of each phase (a name marked twice sums) in the newest
        replay, if every mark of it has been reached; else {}."""
        if len(self.events) < 2 or not all(e.query() for e in self.events):
            return {}
        out: dict[str, float] = {}
        for name, a, b in zip(self.names, self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


class _Totals:
    """Every record since the last `reset()`."""

    def __init__(self):
        self.spans: dict[str, list[int]] = {}  # name -> [count, total ns, self ns]
        self.counters: dict[str, int] = {}
        self.records: collections.deque = collections.deque(maxlen=RECORDS)
        self.replays: collections.deque = collections.deque(maxlen=RING)
        self.marks: collections.deque = collections.deque(maxlen=RING)
        self.last_replayed: Optional[Marks] = None


_totals = _Totals()
_sink: Optional[Marks] = None  # the capture's marks, inside `capture_marks()`


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """An open span; `seconds` once it is closed."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns", "child_ns", "_range")

    def __init__(self, name: str, ranged: bool):
        self.name = name
        self._range = torch.profiler.record_function(name) if ranged else None
        self.end_ns = None

    def __enter__(self) -> "_Span":
        stack = _stack()
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer else None
        self.root = outer.root if outer else self.id
        self.child_ns = 0
        if self._range is not None:
            self._range.__enter__()
        stack.append(self)
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.monotonic_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = _stack()
        stack.pop()
        took = self.end_ns - self.start_ns
        if stack:
            stack[-1].child_ns += took
        with _lock:
            entry = _totals.spans.setdefault(self.name, [0, 0, 0])
            entry[0] += 1
            entry[1] += took
            entry[2] += took - self.child_ns
            _totals.records.append((self.name, self.start_ns, self.end_ns, self.id,
                                    self.parent, self.root, threading.get_ident()))

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def span(name: str):
    """A named span around the block while tracing is on; else a no-op."""
    if not on():
        return _NOOP
    return _Span(name, ranged=True)


def once(name: str) -> _Span:
    """A span recorded whether tracing is on or not (one-off set-up work);
    its `seconds` are read after the block."""
    return _Span(name, ranged=on())


def count(name: str, n: int = 1) -> None:
    """Add `n` to a counter while tracing is on."""
    if not on():
        return
    with _lock:
        _totals.counters[name] = _totals.counters.get(name, 0) + n


def mark(phase: str) -> None:
    """A phase boundary of the step (see the module's text)."""
    sink = _sink
    if sink is not None:
        sink.add(phase)
    elif on():
        _totals.marks.append(phase)


def marking() -> bool:
    """Whether a `mark` now records anything."""
    return _sink is not None or on()


@contextlib.contextmanager
def capture_marks() -> Iterator[Marks]:
    """Collects the marks made while a CUDA graph is captured."""
    global _sink
    marks = _sink = Marks()
    try:
        yield marks
    finally:
        _sink = None


def replay(graph: torch.cuda.CUDAGraph, marks: Marks) -> None:
    """`graph.replay()`, timed on the device while tracing is on."""
    _totals.last_replayed = marks
    if not on():
        graph.replay()
        return
    with span("graphs.replay"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
    _totals.replays.append((start, end))


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Tracing on for the block, with no profiler session."""
    global _switch
    with _lock:
        _switch += 1
    try:
        yield
    finally:
        with _lock:
            _switch -= 1


def snapshot() -> dict:
    """What was recorded since the last `reset()`:
    - spans: name -> count, seconds and self_seconds (each span's duration
      less the part its child spans cover);
    - counters: name -> count;
    - replay_ms: the device ms of each timed replay the device has finished,
      oldest first;
    - phase_ms: each phase's device ms in the newest replay, in mark order,
      if the device has finished it;
    - marks: the eager steps' phase names, oldest first."""
    with _lock:
        spans = {name: {"count": c, "seconds": t * 1e-9, "self_seconds": s * 1e-9}
                 for name, (c, t, s) in _totals.spans.items()}
        counters = dict(_totals.counters)
        replays = list(_totals.replays)
        marks = list(_totals.marks)
    last = _totals.last_replayed
    return {"spans": spans, "counters": counters,
            "replay_ms": [a.elapsed_time(b) for a, b in replays if b.query()],
            "phase_ms": last.phase_ms() if last is not None else {},
            "marks": marks}


def records() -> list[tuple]:
    """The newest span records: (name, start_ns, end_ns, id, parent, root,
    thread)."""
    with _lock:
        return list(_totals.records)


def reset() -> None:
    global _totals
    with _lock:
        _totals = _Totals()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=40))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(snapshot(), f, indent=1)
