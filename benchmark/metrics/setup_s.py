"""Process start (the first line of `run.py`) to the first timed request
or step: imports, the program's build and kernel builds, weights, data,
set-up tables and the warm-up of every shape the window uses."""

LAYER = "service"
UNIT = "s"
MOVES = None


def read(run):
    return run.setup_s
