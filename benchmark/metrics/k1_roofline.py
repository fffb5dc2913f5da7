"""K1 (`ops/csrc/encoder_attention.cu`): the sum of the bounds of its calls
in the profiled requests (`costs/kernels.py`, each call's shape recorded at
its launch) over the device time of its kernels in the trace."""

from benchmark.costs.kernels import k1_bound_s

LAYER = "kernels"
UNIT = "%"
MOVES = "layouts_per_s"


def is_k1(name: str) -> bool:
    return "encoder_attention" in name and "self_attention" not in name


def read(run):
    calls = run.launches.get("K1") if run.trace is not None else None
    seconds = run.trace.kernel_s(is_k1) if calls else 0.0
    if not calls or seconds <= 0:
        return None
    return 100.0 * sum(k1_bound_s(*c) for c in calls) / seconds
