"""What the program records of itself (`ralf_tpu_torch/utils/tracing.py`):
its spans as they lie in the profiled trace (each is also a `record_function`
range there) and its own store of records and counters, which holds only
what ran under the profiler, as the harness never turns tracing on itself.
A program without that module gives nothing, and the readers then return
None."""

from __future__ import annotations


def spans(run, name: str) -> list[tuple[int, int]]:
    """(start_ns, end_ns) of each of the program's `name` spans in the
    profiled window (none without a trace)."""
    if run.trace is None:
        return []
    lo, hi = run.trace.window
    return [(s, e) for s, e, n in run.trace.host if n == name and s >= lo and e <= hi]


def tracing(run):
    """The program's tracing module for a traced run, else None (an untraced
    run, or a program that has none)."""
    if run.trace is None:
        return None
    try:
        from ralf_tpu_torch.utils import tracing as module
    except ImportError:
        return None
    return module


def device_ms_per_unit(run, name: str):
    """The summed device ms (CUDA events) of the program's `name` spans over
    the profiled requests or steps, or None where it recorded none."""
    module = tracing(run)
    if module is None:
        return None
    recs = [r for r in module.records() if r.name == name and r.events is not None]
    if not recs:
        return None
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return sum(r.device_ms for r in recs) / run.trace.units
