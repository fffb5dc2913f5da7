"""Layouts completed in the window over the window's time (host clock; the
window's last request ends in a synchronize and its tokens on the host)."""

LAYER = "service"
UNIT = "layouts/s"
MOVES = None


def read(run):
    return run.layouts / run.window_s
