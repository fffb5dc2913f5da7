"""`launches_per_request` of the LayoutDM cell, under a name of its own so that the cell's
end-to-end metrics keep bounds of their own (its runs spread far less
than RALF's): the same reader, `launches_per_request.py`."""

from benchmark.lib.manifest import metric_reader

LAYER = "host dispatch"
UNIT = "launches"
MOVES = "layouts_per_s.layoutdm"
read = metric_reader("launches_per_request").read
