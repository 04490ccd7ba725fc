"""Device ms of the step's one backward in the newest replay: its phases
`backward.drw` (the loss back to G's output, through D, R and W) and
`backward.g` (G's own backward), from the program's phase marks
(train/step.py), which the captured graph records on every replay."""

from perfbench import program_trace

MOVES = "steps_per_s"


def read(run):
    return program_trace.phase_ms(lambda name: name.startswith("backward"))
