"""The port's capture path (scrabblegan_torch/utils/capture.py) on the CPU,
with torch.cuda's graph, stream and memory calls replaced by fakes that log
what they are asked: the order of a side-stream run; a capture under the
lock, its `once` span, its pool bytes, its pool and what `inside` yielded;
the launch counters taken back after a capture and added again by every
replay. The real graphs run on the card (tests/test_torch_forward_graphs.py,
tests/test_torch_tracing.py, tests/test_torch_pool.py)."""

import contextlib

import pytest
import torch

from scrabblegan_torch.kernels import attention, pool
from scrabblegan_torch.utils import capture, profiling


class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1

    def pool(self):
        return ("pool", id(self))


class FakeStream:
    def __init__(self, name, log):
        self.name, self.log = name, log

    def wait_stream(self, other):
        self.log.append(f"{self.name} waits for {other.name}")


@pytest.fixture
def log(monkeypatch):
    """The fakes' log; the counters restored after the test."""
    for module, name in capture.COUNTERS:
        monkeypatch.setattr(module, name, getattr(module, name))
    monkeypatch.setattr(attention, "width_launches", dict(attention.width_launches))
    profiling.reset()
    yield []
    profiling.reset()


def _logged(log, what):
    @contextlib.contextmanager
    def enter(*args, **kwargs):
        log.append(f"enter {what}")
        yield what
        log.append(f"exit {what}")
    return enter


def test_aside_orders_the_side_stream_around_the_body(monkeypatch, log):
    current, side = FakeStream("current", log), FakeStream("side", log)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: current)
    monkeypatch.setattr(torch.cuda, "stream", _logged(log, "stream"))

    class Out:
        def record_stream(self, stream):
            log.append(f"recorded on {stream.name}")

    out = Out()
    got = capture.aside(lambda: log.append("body") or out, side, "cpu", _logged(log, "inside")())
    assert got is out
    assert log == ["side waits for current", "enter stream", "enter inside", "body",
                   "exit inside", "exit stream", "current waits for side", "recorded on current"]


def test_capture_takes_back_its_launches_and_each_replay_adds_them(monkeypatch, log):
    reserved = iter([1000, 1064, 2000, 2000])
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: next(reserved))

    @contextlib.contextmanager
    def graph(g, pool, stream, capture_error_mode):
        log.append((capture.CAPTURE_LOCK.locked(), pool, stream, capture_error_mode))
        yield

    monkeypatch.setattr(torch.cuda, "graph", graph)
    width = attention.WIDTH_COUNTERS[0]

    def body():
        pool.launches += 2
        attention.bwd_launches += 1
        attention.width_launches[width] += 3
        return torch.arange(3.0)

    before = capture.counter_values()
    first = capture.capture(body, None, "side", "cpu", "test.capture", profiling.capture_marks())
    assert capture.counter_values() == before and not capture.CAPTURE_LOCK.locked()
    assert log == [(True, None, "side", "thread_local")]
    assert isinstance(first.entered, profiling.Marks) and first.pool == first.graph.pool()
    assert first.pool_bytes == 64 and first.capture_s >= 0
    want = dict.fromkeys(range(len(before)), 0)
    want[capture.COUNTERS.index((pool, "launches"))] = 2
    want[capture.COUNTERS.index((attention, "bwd_launches"))] = 1
    want[len(capture.COUNTERS)] = 3
    assert first.counts == tuple(want.values())

    second = capture.capture(body, first.pool, "side", "cpu", "test.capture",
                             contextlib.nullcontext())
    assert second.pool == first.pool and second.pool_bytes == 0 and log[-1][1] == first.pool
    assert profiling.snapshot()["spans"]["test.capture"]["count"] == 2

    out = capture.replay(first)
    assert torch.equal(out, first.out) and out is not first.out
    capture.replay(first, first.entered)  # through profiling.replay, tracing off
    assert first.graph.replays == 2 and second.graph.replays == 0
    assert capture.counter_values() == tuple(b + 2 * n for b, n in zip(before, first.counts))
