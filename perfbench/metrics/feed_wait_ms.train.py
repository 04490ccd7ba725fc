"""Host ms a step that the Trainer's feed keeps the loop waiting: the
program's span `feed.wait` (train/loop.py `_Prefetcher.get`) over the
traced slice, per step."""

from perfbench import program_trace

MOVES = "steps_per_s"


def read(run):
    return program_trace.per_unit_ms(run, ("feed.wait",))
