"""Device ms of the step's two CTC losses in the newest replay: the phases
named `ctc` of the program's phase marks (train/step.py around each
`ops/ctc.py` `ctc_loss` call)."""

from perfbench import program_trace

MOVES = "steps_per_s"


def read(run):
    return program_trace.phase_ms(lambda name: name == "ctc")
