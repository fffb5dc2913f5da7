"""Median host time of `build_condition` over the window's requests."""

LAYER = "request loop"
UNIT = "ms"
MOVES = "request_ms_p95"


def read(run):
    return run.spans.median("condition")
