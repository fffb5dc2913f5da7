"""Median device time (CUDA events) of `RALFGenerator.decode`, the
KV-cached constrained decode, over the window's requests."""

import statistics

LAYER = "AR decode"
UNIT = "ms"
MOVES = "layouts_per_s"


def read(run):
    ms = run.timers.ms("decode")
    return statistics.median(ms) if ms else None
