"""Step timing and traces: the port's counterpart of
scrabblegan_tpu/utils/profiling.py, with `torch.profiler` in place of
`jax.profiler`. `trace(dir)` records host and, on a card, device activity
and writes a Chrome trace (trace.json, viewable in Perfetto) and the
operator table (ops.txt) into `dir`; `StepTimer` gives steps/s that wait for
the device before reading the clock."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=40))


def annotate(name: str):
    """A named region inside a trace."""
    return torch.profiler.record_function(name)


def _wait(result) -> None:
    """Block until the device has produced `result` (a tensor or a dict or
    sequence of them)."""
    tensors = (result.values() if isinstance(result, dict)
               else result if isinstance(result, (list, tuple)) else [result])
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class StepTimer:
    """Honest steps/s: waits for the step's result before reading the clock;
    the first `warmup` ticks are not timed."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._count = 0
        self._t0: Optional[float] = None

    def tick(self, result=None) -> None:
        if result is not None:
            _wait(result)
        self._count += 1
        if self._count == self.warmup:
            self._t0 = time.perf_counter()

    @property
    def steps_per_sec(self) -> float:
        if self._t0 is None or self._count <= self.warmup:
            return 0.0
        return (self._count - self.warmup) / (time.perf_counter() - self._t0)
