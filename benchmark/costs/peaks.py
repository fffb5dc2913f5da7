"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {
    "bfloat16": 989e12,  # tensor cores
    "tf32": 495e12,  # tensor cores, fp32 data with TF32 on
    "float32": 67e12,  # CUDA cores, TF32 off
    "int8": 1979e12,
}


def bound_s(nbytes: float, ops: float, op_type: str) -> tuple[float, str]:
    """The least time the card could take for the work: bytes at the HBM
    rate or operations at the peak of `op_type`, whichever is longer, and
    which of the two it was."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FLOPS_PER_S[op_type]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
