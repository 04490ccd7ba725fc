"""The readers of the program's own tracer (perfbench/program_trace.py and
the metrics that read it) on a fake snapshot, and on a program without the
tracer, where each gives None and raises nothing."""

import types

import pytest

from perfbench import program_trace, run
from scrabblegan_torch.utils import profiling

SNAPSHOT = {
    "spans": {"feed.wait": {"count": 5, "seconds": 0.004, "self_seconds": 0.004},
              "graphs.warmup": {"count": 2, "seconds": 3.5, "self_seconds": 3.5},
              "graphs.capture": {"count": 1, "seconds": 1.25, "self_seconds": 1.25},
              "g.forward": {"count": 50, "seconds": 0.6, "self_seconds": 0.35}},
    "counters": {"feed.empty": 1},
    "replay_ms": [70.0, 69.0, 75.0, 68.0, 71.0],
    "phase_ms": {"step.inputs": 0.1, "g.fwd": 5.0, "d.fwd": 6.0, "w.fwd": 4.0, "r.fwd": 3.0,
                 "ctc": 4.5, "losses": 0.2, "backward.drw": 30.0, "backward.g": 12.0,
                 "stats": 0.3, "update": 3.0, "ema": 0.75},
    "marks": [],
}
EXPECTED = {"replay_ms.train": 70.0, "backward_ms.train": 42.0, "optimizer_ms.train": 3.75,
            "ctc_ms.train": 4.5, "feed_wait_ms.train": 0.8, "graph_setup_s.train": 4.75,
            "launch_ms.request": 12.0}


def _run(units):
    return run.Run(None, {}, None, types.SimpleNamespace(units=units), {})


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_fake_snapshot(monkeypatch, name):
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAPSHOT)
    units = 50 if name.endswith(".request") else 5
    assert run.metric_reader(name).read(_run(units)) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_the_tracer_gives_none(monkeypatch, name):
    monkeypatch.delattr(profiling, "snapshot")
    assert program_trace.snapshot() is None
    assert run.metric_reader(name).read(_run(5)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_an_empty_snapshot_gives_none(monkeypatch, name):
    monkeypatch.setattr(profiling, "snapshot", lambda: {
        "spans": {}, "counters": {}, "replay_ms": [], "phase_ms": {}, "marks": []})
    assert run.metric_reader(name).read(_run(5)) is None


def test_every_program_span_metric_has_a_reader_that_reads_the_tracer():
    from perfbench import common

    names = [m["name"] for m in common.manifest()["per_layer"]
             if m["source"] == "program_span" and m["name"] != "batch_wait_ms.train"]
    assert sorted(names) == sorted(EXPECTED)
