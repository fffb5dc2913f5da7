"""MB a profiled request hands from pageable host memory to the card: the
program's `h2d.pageable_bytes` counter (`utils/tracing.py::count_h2d`, at the
request path's host-to-device copies: the canvases, the neighbours, the
constraint and the forced tokens), counted while the profiler ran, over the
profiled requests."""

from benchmark.lib import program

LAYER = "request loop"
UNIT = "MB"
MOVES = "request_ms_p95"
COUNTER = "h2d.pageable_bytes"


def read(run):
    module = program.tracing(run)
    n = None if module is None else module.counters().get(COUNTER)
    if n is None:
        return None
    return n / run.trace.units / 1e6
