"""`layouts_per_s` of the LayoutDM cell, under a name of its own so that the cell's
end-to-end metrics keep bounds of their own (its runs spread far less
than RALF's): the same reader, `layouts_per_s.py`."""

from benchmark.lib.manifest import metric_reader

LAYER = "service"
UNIT = "layouts/s"
MOVES = None
read = metric_reader("layouts_per_s").read
