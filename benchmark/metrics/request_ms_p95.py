"""The 95th percentile over all requests of the window of a request's time,
from its canvases handed to `build_condition` to its layouts and violation
counts in host memory (host clock; numpy's linear interpolation)."""

import numpy as np

LAYER = "service"
UNIT = "ms"
MOVES = None


def read(run):
    return float(np.percentile([r.seconds * 1e3 for r in run.records], 95))
