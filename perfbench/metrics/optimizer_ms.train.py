"""Device ms of the four optimizer updates and G's EMA in the newest replay:
the phases `update` and `ema` of the program's phase marks (train/step.py,
train/optim.py)."""

from perfbench import program_trace

MOVES = "steps_per_s"


def read(run):
    return program_trace.phase_ms(lambda name: name in ("update", "ema"))
