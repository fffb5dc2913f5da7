"""`violations_ms` of the LayoutDM cell, under a name of its own so that the cell's
end-to-end metrics keep bounds of their own (its runs spread far less
than RALF's): the same reader, `violations_ms.py`."""

from benchmark.lib.manifest import metric_reader

LAYER = "request loop"
UNIT = "ms"
MOVES = "request_ms_p95.layoutdm"
read = metric_reader("violations_ms").read
