"""Share of the traced slice's wall time in which no operation ran on the
device: 1 - (the union of device operations' intervals) / (the slice's
seconds), from torch.profiler."""

MOVES = "steps_per_s"


def read(run):
    if run.slice is None or run.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.window_s)
