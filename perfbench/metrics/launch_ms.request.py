"""Host ms a request spends in G's forward, style encoder included: the
program's span `g.forward` (models/generator.py) over the traced slice, per
request. The device runs behind the host's launches in this cell, so this
is the host's launch time of G and its style encoder."""

from perfbench import program_trace

MOVES = "request_p95_ms"


def read(run):
    return program_trace.per_unit_ms(run, ("g.forward",))
