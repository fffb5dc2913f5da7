"""Median host length of the program's `train.backward` span (`zero_grad`
and `loss.backward()` in `Trainer.train_step`) over the profiled steps."""

import statistics

from benchmark.lib import program

LAYER = "train step"
UNIT = "ms"
MOVES = "train_samples_per_s"
SPAN = "train.backward"


def read(run):
    ranges = program.spans(run, SPAN)
    return statistics.median((e - s) / 1e6 for s, e in ranges) if ranges else None
