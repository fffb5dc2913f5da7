"""Device ms a profiled request spends in the program's
`zoo.denoise.decoder` spans (CUDA events around each denoising step's
decoder and its prediction of x_0, `models/diffusion.py`), summed over the
steps."""

from benchmark.lib import program

LAYER = "zoo sampler"
UNIT = "ms"
MOVES = "layouts_per_s.layoutdm"
SPAN = "zoo.denoise.decoder"


def read(run):
    return program.device_ms_per_unit(run, SPAN)
