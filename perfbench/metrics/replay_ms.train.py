"""Device ms of a replay of the captured step: the median, over the traced
slice's replays, of the time between the timing events the program records
around each `graph.replay()` (train/graphs.py, `profiling.replay`)."""

import statistics

from perfbench import program_trace

MOVES = "steps_per_s"


def read(run):
    snap = program_trace.snapshot()
    if snap is None or not snap.get("replay_ms"):
        return None
    return statistics.median(snap["replay_ms"])
