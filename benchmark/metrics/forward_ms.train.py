"""Median host length of the program's `train.forward` span (the loss under
autocast in `Trainer.train_step`: ResNet50, the fusion, FIDNet over the
neighbours, the decoder) over the profiled steps."""

import statistics

from benchmark.lib import program

LAYER = "train step"
UNIT = "ms"
MOVES = "train_samples_per_s"
SPAN = "train.forward"


def read(run):
    ranges = program.spans(run, SPAN)
    return statistics.median((e - s) / 1e6 for s, e in ranges) if ranges else None
