"""Device ms a profiled request spends in the program's
`zoo.denoise.posterior` spans (CUDA events around each denoising step's
log-space posterior, constraints and sampling through the one-hot,
`models/diffusion.py`), summed over the steps."""

from benchmark.lib import program

LAYER = "zoo sampler"
UNIT = "ms"
MOVES = "layouts_per_s.layoutdm"
SPAN = "zoo.denoise.posterior"


def read(run):
    return program.device_ms_per_unit(run, SPAN)
