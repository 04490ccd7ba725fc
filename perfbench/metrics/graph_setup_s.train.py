"""Seconds of set-up the captured step takes: the program's `once` spans
`graphs.warmup` (each eager warm-up step) and `graphs.capture` (the graph's
capture), train/graphs.py."""

from perfbench import program_trace

MOVES = "setup_s"


def read(run):
    return program_trace.span_seconds(("graphs.warmup", "graphs.capture"))
