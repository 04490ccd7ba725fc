"""Device kernels a request launches: kernel launches in the traced slice
over its requests (copies and sets not counted)."""

MOVES = "request_p95_ms"


def read(run):
    if run.slice is None or not run.slice.units or not run.slice.kernels:
        return None
    return run.slice.kernels / run.slice.units
