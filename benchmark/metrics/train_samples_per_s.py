"""Samples stepped in the window over the window's time (host clock; the
window closes with a synchronize, so every step's device work is in it)."""

LAYER = "service"
UNIT = "samples/s"
MOVES = None


def read(run):
    return run.samples / run.window_s
