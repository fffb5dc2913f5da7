"""Median device time (CUDA events on the stream) of the generator's
`encode_memory` over the window's requests: ResNet50 and the FPN, the
image transformer and what the family fuses into the memory."""

import statistics

LAYER = "encode"
UNIT = "ms"
MOVES = "layouts_per_s"


def read(run):
    ms = run.timers.ms("encode")
    return statistics.median(ms) if ms else None
