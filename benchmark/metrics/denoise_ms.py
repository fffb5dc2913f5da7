"""Median over the window's requests of the device time (CUDA events) of
LayoutDM's `sample` less that of its `encode_memory`: the denoising loop."""

import statistics

LAYER = "zoo sampler"
UNIT = "ms"
MOVES = "layouts_per_s.layoutdm"


def read(run):
    total, enc = run.timers.ms("sample"), run.timers.ms("encode")
    if not total or len(total) != len(enc):
        return None
    return statistics.median(t - e for t, e in zip(total, enc))
