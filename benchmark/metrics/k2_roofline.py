"""K2 (`ops/csrc/decode_attention.cu`, `decode_shared_cluster_kernel`): the
sum of the bounds of its calls in the profiled requests (`costs/kernels.py`)
over the device time of its kernels in the trace."""

from benchmark.costs.kernels import k2_bound_s

LAYER = "kernels"
UNIT = "%"
MOVES = "layouts_per_s"


def is_k2(name: str) -> bool:
    return "decode_shared_cluster_kernel" in name


def read(run):
    calls = run.launches.get("K2") if run.trace is not None else None
    seconds = run.trace.kernel_s(is_k2) if calls else 0.0
    if not calls or seconds <= 0:
        return None
    return 100.0 * sum(k2_bound_s(*c) for c in calls) / seconds
