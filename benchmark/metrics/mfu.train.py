"""Forward and backward FLOPs of the window's samples (`costs/flops.py`,
from the configuration's shapes) over the window's time times the card's
peak in the precision the step runs in: float32 with TF32 off, 67 TFLOP/s
(or TF32's 495 where the configuration turns it on)."""

from benchmark.costs.peaks import FLOPS_PER_S

LAYER = "model step"
UNIT = "%"
MOVES = "train_samples_per_s"


def read(run):
    tc = run.config["train"]
    peak = FLOPS_PER_S["tf32" if tc["dtype"] == "float32" and tc["tf32"] else tc["dtype"]]
    return 100.0 * run.flops_per_sample * run.samples / (run.window_s * peak)
