"""Median host time, after the request's synchronize, of bringing the tokens
and the layouts to the host and `calculate_violation`."""

LAYER = "request loop"
UNIT = "ms"
MOVES = "request_ms_p95"


def read(run):
    return run.spans.median("violations")
