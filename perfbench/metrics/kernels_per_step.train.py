"""Device kernels a train step runs (the captured graph's kernel nodes under
replay): kernel launches in the traced slice over its steps."""

MOVES = "steps_per_s"


def read(run):
    if run.slice is None or not run.slice.units or not run.slice.kernels:
        return None
    return run.slice.kernels / run.slice.units
