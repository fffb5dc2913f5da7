"""`request_ms_p95` of the LayoutDM cell, under a name of its own so that the cell's
end-to-end metrics keep bounds of their own (its runs spread far less
than RALF's): the same reader, `request_ms_p95.py`."""

from benchmark.lib.manifest import metric_reader

LAYER = "service"
UNIT = "ms"
MOVES = None
read = metric_reader("request_ms_p95").read
