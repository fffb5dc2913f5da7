"""`idle_share.gen` of the LayoutDM cell, under a name of its own so that the cell's
end-to-end metrics keep bounds of their own (its runs spread far less
than RALF's): the same reader, `idle_share.gen.py`."""

from benchmark.lib.manifest import metric_reader

LAYER = "device"
UNIT = "%"
MOVES = "layouts_per_s.layoutdm"
read = metric_reader("idle_share.gen").read
