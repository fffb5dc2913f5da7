"""Share of the profiled requests' window that no device operation covers:
one less the union of their intervals over the window's length."""

LAYER = "device"
UNIT = "%"
MOVES = "layouts_per_s"


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
