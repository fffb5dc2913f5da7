"""K9: the fp32 sum of each batch row, a probe of the device-memory stream rate.

Counterpart of `scripts/probe_dma_rate.py` (`stream_sum`, a Pallas TPU
kernel outside the JAX package).  `stream_sum` launches the CUDA kernel of
`csrc/stream_sum.cu` on a CUDA tensor and runs `stream_sum_plain` on a CPU
tensor.  Both take x [B, ...] of int8, int16, int32, fp32 or bf16 and any
B, and return [B] fp32: the sum of each row over every other dimension.
"""

from __future__ import annotations

import ctypes

import torch

from ralf_tpu_torch.ops import _build

_SIGNATURES = {
    "ralf_stream_sum": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_longlong, ctypes.c_void_p],
}
# dtype codes of csrc/stream_sum.cu
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int16: 3,
               torch.int32: 4}


def stream_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B, ...] -> [B] fp32."""
    return x.float().reshape(x.shape[0], -1).sum(dim=1)


def stream_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums [B] fp32 of x [B, ...], streaming x once."""
    if x.device.type == "cpu":
        return stream_sum_plain(x)
    what = "stream_sum"
    _build.require_cuda(what, x)
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported ({list(DTYPE_CODES)})")
    if x.dim() < 1 or not 1 <= x.shape[0] < 2**31:
        raise ValueError(f"{what}: x must be [B, ...] with 1 <= B < 2^31")
    lib = _build.library("stream_sum", _SIGNATURES)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.ralf_stream_sum(DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), x.shape[0],
                                 x[0].numel(), _build.stream_handle())
    _build.check_launch(rc, what)
    stream_sum.launches += 1
    return out


stream_sum.launches = 0
