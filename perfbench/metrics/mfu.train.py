"""Share of the card's bf16 peak that the train steps/s stands for: the
reference's FLOPs of a step's forwards and backward (perfbench/work.py) times
the window's untraced steps/s."""

from perfbench import peaks

MOVES = "steps_per_s"


def read(run):
    return 100.0 * run.work["flops_per_step"] * run.e2e["steps_per_s"] / peaks.BF16_FLOPS
