"""Share of the program's `ar.decode` spans (the whole AR decode,
`ops/decode_loop.py`) in the profiled requests that device operations
cover: the union of the device operations' intervals clipped to those
spans, over the spans' summed length (`costs/idle.py`)."""

from benchmark.costs import idle
from benchmark.lib import program

LAYER = "AR decode"
UNIT = "%"
MOVES = "layouts_per_s"
SPAN = "ar.decode"


def read(run):
    ranges = program.spans(run, SPAN)
    total = sum(e - s for s, e in ranges)
    if total <= 0 or not run.trace.ops:
        return None
    ops = [(s, e) for s, e, _ in run.trace.ops]
    return 100.0 * sum(idle.busy(ops, s, e) for s, e in ranges) / total
