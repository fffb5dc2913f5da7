"""Device operations (kernels, copies, sets) in the profiled window over the
requests run in it."""

LAYER = "host dispatch"
UNIT = "launches"
MOVES = "layouts_per_s"


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return len(run.trace.ops) / run.trace.units
