"""`k1_roofline` of the LayoutDM cell, under a name of its own so that the cell's
end-to-end metrics keep bounds of their own (its runs spread far less
than RALF's): the same reader, `k1_roofline.py`."""

from benchmark.lib.manifest import metric_reader

LAYER = "kernels"
UNIT = "%"
MOVES = "layouts_per_s.layoutdm"
read = metric_reader("k1_roofline").read
