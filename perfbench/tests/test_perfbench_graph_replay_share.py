"""The reader of `graph_replay_share.request` (the program's counters
`g.graph.replay` and `g.graph.eager`) on fake snapshots, and on a program
without the tracer or without the counters, where it gives None."""

import types

import pytest

from perfbench import run
from scrabblegan_torch.utils import profiling

NAME = "graph_replay_share.request"


def _read(monkeypatch, counters):
    snap = {"spans": {}, "counters": counters, "replay_ms": [], "phase_ms": {}, "marks": []}
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    return run.metric_reader(NAME).read(run.Run(None, {}, None,
                                                types.SimpleNamespace(units=50), {}))


@pytest.mark.parametrize("counters, share", [
    ({"g.graph.replay": 50}, 100.0),
    ({"g.graph.replay": 48, "g.graph.eager": 2, "g.graph.capture": 1}, 96.0),
    ({"g.graph.eager": 50}, 0.0),
])
def test_share_of_replays(monkeypatch, counters, share):
    assert _read(monkeypatch, counters) == pytest.approx(share)


def test_none_without_the_counters(monkeypatch):
    assert _read(monkeypatch, {"feed.empty": 3}) is None


def test_none_without_the_tracer(monkeypatch):
    monkeypatch.delattr(profiling, "snapshot")
    assert run.metric_reader(NAME).read(None) is None
