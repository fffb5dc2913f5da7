"""One reader a metric, found by the metric's name in `BENCHMARK.json`:
`LAYER` (as `PERF.md`'s list of layers names it), `UNIT`, `MOVES` (the
end-to-end metric it should move; None for an end-to-end metric) and
`read(run)`, which returns the value or None where the run holds nothing
to read it from."""
