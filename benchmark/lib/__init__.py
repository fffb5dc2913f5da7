"""The harness's general code: the manifest, the run's environment, seeded
weights and data, host spans and device timers, and the profiler's trace."""
