"""K11: ResNet's eval-mode BatchNorm with its optional residual add and ReLU,
in one pass over a convolution's output.

It replaces no Pallas kernel: the JAX package leaves BatchNorm to XLA, which
fuses it with the residual add and the ReLU.  `models.resnet.BatchNorm`
sends its eval-mode calls on the card with grad off here when `takes` holds;
`batchnorm_act` launches the CUDA kernel of `csrc/batchnorm_act.cu` on CUDA
tensors and runs `batchnorm_act_plain` on CPU tensors; there is no other
fallback.  It is forward only.

x [N, C, H, W] in channels_last storage, fp32 or bf16, C a multiple of 8 up
to 4096; the optional residual like x; weight, bias, running_mean and
running_var [C], each in fp32 or bf16.  The function is

    s = weight * rsqrt(running_var + eps);  t = bias - running_mean * s
    y = relu?(x * s + t (+ residual))

in fp32, rounded once to x's dtype.  `batchnorm_act_plain` is that formula
with the kernel's one rounding, the reference the kernel is held to within
one rounding of x's dtype.  The module's own plain path
(`models.resnet.eval_plain`, the CPU's and the JAX package's order) rounds
to x's dtype after the multiply, the add and the residual add, so in bf16
it may lie several roundings from the kernel and cannot serve as that
reference; it is the yardstick of what K11 replaced.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ralf_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ralf_batchnorm_act": [_I, _P, _P, _P, ctypes.c_longlong, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                           ctypes.c_float, _I, _P],
}
CHANNEL_MULTIPLE = 8  # a 16-byte vector of bf16 holds 8 channels of one pixel
MAX_CHANNELS = 4096  # s and t of every channel in a block's shared memory


def batchnorm_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                        residual: Optional[torch.Tensor] = None,
                        relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K11: [N, C, H, W] -> [N, C, H, W] in x's dtype."""
    s = weight.float() * torch.rsqrt(running_var.float() + eps)
    t = bias.float() - running_mean.float() * s
    y = x.float() * s[:, None, None] + t[:, None, None]
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _layout_ok(t: torch.Tensor) -> bool:
    return (t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)
            and t.data_ptr() % 16 == 0)


def takes(x: torch.Tensor, residual: Optional[torch.Tensor], params) -> bool:
    """Whether the kernel takes x, the residual (or None) and the four [C]
    vectors `params`: layout, dtypes and shapes; not the device."""
    C = x.shape[1] if x.dim() == 4 else 0
    return (x.dtype in _build.DTYPE_CODES and _layout_ok(x)
            and C % CHANNEL_MULTIPLE == 0 and 0 < C <= MAX_CHANNELS
            and (residual is None or (residual.shape == x.shape and residual.dtype == x.dtype
                                      and residual.device == x.device and _layout_ok(residual)))
            and all(p.shape == (C,) and p.dtype in _build.DTYPE_CODES and p.device == x.device
                    for p in params))


def batchnorm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                  residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """K11: relu?(x * s + t (+ residual)) per channel, s and t from the four
    [C] vectors; x [N, C, H, W] channels_last, fp32 or bf16."""
    if x.device.type == "cpu":
        return batchnorm_act_plain(x, weight, bias, running_mean, running_var, eps, residual,
                                   relu)
    what = "batchnorm_act"
    params = (weight, bias, running_mean, running_var)
    _build.require_cuda(what, *params)
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported (float32 or bfloat16)")
    if not takes(x, residual, params):
        raise ValueError(f"{what}: x (and residual) must be [N, C, H, W] channels_last-contiguous "
                         f"on a 16-byte boundary with C a multiple of {CHANNEL_MULTIPLE} up to "
                         f"{MAX_CHANNELS}, and weight, bias, running_mean, running_var [C] in "
                         "float32 or bfloat16 on x's device")
    if torch.is_grad_enabled() and (x.requires_grad or (residual is not None
                                                        and residual.requires_grad)):
        raise RuntimeError(f"{what}: the CUDA kernel is forward only and an input requires "
                           "grad; call it under torch.no_grad() or torch.inference_mode()")
    lib = _build.library("batchnorm_act", _SIGNATURES)
    out = torch.empty_like(x)  # channels_last, as x
    codes = [_build.dtype_code(p, what) for p in params]
    with torch.cuda.device(x.device):
        rc = lib.ralf_batchnorm_act(
            _build.DTYPE_CODES[x.dtype], x.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(), x.numel(),
            x.shape[1], *(p.data_ptr() for p in params), *codes, eps, int(relu),
            _build.stream_handle(),
        )
    _build.check_launch(rc, what)
    batchnorm_act.launches += 1
    return out


batchnorm_act.launches = 0
