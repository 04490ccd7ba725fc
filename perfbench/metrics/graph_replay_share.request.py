"""Share of the traced slice's inference calls of G that a CUDA graph
replay served: the program's counters `g.graph.replay` / (`g.graph.replay`
+ `g.graph.eager`) over the slice, in % (models/forward_graphs.py). None
where the program keeps neither counter."""

from perfbench import program_trace

MOVES = "request_p95_ms"


def read(run):
    snap = program_trace.snapshot()
    if snap is None:
        return None
    counters = snap.get("counters", {})
    if "g.graph.replay" not in counters and "g.graph.eager" not in counters:
        return None
    replay, eager = counters.get("g.graph.replay", 0), counters.get("g.graph.eager", 0)
    return 100.0 * replay / (replay + eager)
