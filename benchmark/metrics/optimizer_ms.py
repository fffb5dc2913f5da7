"""Median length of torch's own `Optimizer.step#AdamW.step` record over the
profiled steps: the host's time in AdamW's update (the clip before it is
not inside the record)."""

import statistics

LAYER = "train step"
UNIT = "ms"
MOVES = "train_samples_per_s"
RECORD = "Optimizer.step#AdamW.step"


def read(run):
    if run.trace is None:
        return None
    ms = [(e - s) / 1e6 for s, e, name in run.trace.host if name == RECORD]
    return statistics.median(ms) if ms else None
