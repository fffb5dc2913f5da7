"""Model FLOPs of the window's layouts (`costs/flops.py`, from the
configuration's shapes) over the sum of the requests' host-clock times
times the card's peak in the configuration's dtype (bf16: 989 TFLOP/s).
The card's power limit is printed beside it by the run."""

from benchmark.costs.peaks import FLOPS_PER_S

LAYER = "model step"
UNIT = "%"
MOVES = "layouts_per_s"


def read(run):
    per_layout = sum(run.flops_per_layout.values())
    seconds = sum(r.seconds for r in run.records)
    return 100.0 * per_layout * run.layouts / (seconds * FLOPS_PER_S[run.config["dtype"]])
