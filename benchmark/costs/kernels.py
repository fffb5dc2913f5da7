"""Operations and bytes of the port's kernels at a call's shapes, frozen
from `chip_smoke.py::kernel_cases` (K1 by `k1_case`).  Each input byte is
counted once as read and each output byte once as written, whatever the
kernel reads again.

K1 (`ops/csrc/encoder_attention.cu`): multi-head softmax(q k^T) v over q, k,
v [B, S, E] with an optional fp32 key bias [B, S]: reads q, k, v (and the
bias), writes o; 2 B S^2 E multiply-adds for the scores and as many for the
values.

K2 (`ops/csrc/decode_attention.cu`, `decode_shared_cluster_kernel`): one
decode step's weight-folded cross-attention of a query q_tilde [B, H, E]
over the shared memory [B, M, E]: reads the memory and q_tilde, writes
[B, H, E]; 2 B H M E multiply-adds each for scores and values.
"""

from __future__ import annotations

from benchmark.costs.peaks import bound_s

ITEMSIZE = {"bfloat16": 2, "float32": 4, "float16": 2}


def k1_cost(B: int, S: int, E: int, masked: bool, dtype: str) -> tuple[float, float]:
    """(bytes, operations) of one K1 call."""
    isz = ITEMSIZE[dtype]
    return 4 * B * S * E * isz + (4 * B * S if masked else 0), 4 * B * S * S * E


def k2_cost(B: int, M: int, H: int, E: int, dtype: str) -> tuple[float, float]:
    """(bytes, operations) of one K2 call."""
    isz = ITEMSIZE[dtype]
    return B * M * E * isz + 2 * B * H * E * isz, 4 * B * H * M * E


def k1_bound_s(B: int, S: int, E: int, masked: bool, dtype: str) -> float:
    nbytes, ops = k1_cost(B, S, E, masked, dtype)
    return bound_s(nbytes, ops, dtype)[0]


def k2_bound_s(B: int, M: int, H: int, E: int, dtype: str) -> float:
    nbytes, ops = k2_cost(B, M, H, E, dtype)
    return bound_s(nbytes, ops, dtype)[0]
