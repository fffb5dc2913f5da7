"""Host ms a profiled request spends in the program's `ar.decode` span (the
whole AR decode, `ops/decode_loop.py`, dispatched step by step): the spans'
summed length over the profiled requests."""

from benchmark.lib import program

LAYER = "AR decode"
UNIT = "ms"
MOVES = "layouts_per_s"
SPAN = "ar.decode"


def read(run):
    ranges = program.spans(run, SPAN)
    if not ranges:
        return None
    return sum(e - s for s, e in ranges) / 1e6 / run.trace.units
