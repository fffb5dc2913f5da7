"""K5: the encoder's fused feed-forward block.

Counterpart of `ralf_tpu/ops/pallas/encoder_ffn.py` (`fused_ffn`).
`fused_ffn` launches the CUDA kernel of `csrc/encoder_ffn.cu` on CUDA
tensors and runs `fused_ffn_plain` on CPU tensors; there is no other
fallback.  It is differentiable as JAX's custom_vjp makes it: the forward
(kernel or plain version) runs inside `_build.RecomputedBackward`, whose
backward recomputes JAX's XLA reference written in torch (`ffn_reference`)
on both devices.  In bf16
both products run on the tensor cores (wgmma, operands copied by TMA),
which needs x, w1 and w2 on a 16-byte boundary; fp32 runs on the CUDA
cores at any alignment.

Both compute relu(x W1^T + b1) W2^T + b2 (inference, relu only) in the TPU
kernel's order, which keeps the hidden [B, S, F] on chip through
relu(h + b1) = max(h, -b1) + b1:

    h = x W1^T             fp32 sums
    g = max(h, T(-b1))     rounded to x's dtype T
    o = T(g W2^T)          fp32 sums
    out = o + T(b1 W2^T + b2)   the tail in fp32, rounded, added in T

so in bf16 they agree with the Pallas kernel, and with a plain
relu(x W1^T + b1) W2^T + b2 only in fp32.  The weights are as nn.Linear
stores them: w1 [F, E], w2 [E, F].
"""

from __future__ import annotations

import ctypes

import torch

from ralf_tpu_torch.ops import _build

_SIGNATURES = {
    "ralf_fused_ffn": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
}
WIDTH = 256  # the E the kernel is built for: d_model of every full-width model
CHUNK = 64  # F must be a multiple of it


def ffn_tail(b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """b1 W2^T + b2 in fp32: the constant the TPU kernel's caller adds."""
    return b1.float() @ w2.float().t() + b2.float()


def ffn_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor) -> torch.Tensor:
    """JAX's `_reference_ffn`, what its custom_vjp differentiates:
    relu(x W1^T + b1), in x's dtype, W2^T + b2."""
    return torch.relu(x @ w1.t() + b1).to(x.dtype) @ w2.t() + b2


def fused_ffn_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, [B, S, E] -> [B, S, E]."""
    h = x.float() @ w1.float().t()
    g = torch.maximum(h, (-b1).to(x.dtype).float()).to(x.dtype)
    o = (g.float() @ w2.float().t()).to(x.dtype)
    return o + ffn_tail(b1, w2, b2).to(x.dtype)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """relu(x W1^T + b1) W2^T + b2 with the hidden tile kept on chip; x
    [B, S, E], w1 [F, E], b1 [F], w2 [E, F], b2 [E]; gradients to all five."""
    forward = fused_ffn_plain if x.device.type == "cpu" else _launch_fused_ffn
    return _build.RecomputedBackward.apply(forward, ffn_reference, x, w1, b1, w2, b2)


def _launch_fused_ffn(x, w1, b1, w2, b2):
    what = "fused_ffn"
    _build.require_cuda(what, x, w1, b1, w2, b2)
    if x.dim() != 3:
        raise ValueError(f"{what}: x must be [B, S, E]")
    B, S, E = x.shape
    F = w1.shape[0]
    if w1.shape != (F, E) or w2.shape != (E, F) or b1.shape != (F,) or b2.shape != (E,):
        raise ValueError(f"{what}: need w1 [F, E], b1 [F], w2 [E, F], b2 [E] for E={E}")
    if E != WIDTH or F % CHUNK or F == 0:
        raise ValueError(f"{what}: E must be {WIDTH} and F a multiple of {CHUNK}, "
                         f"got E={E}, F={F}")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"{what}: x, w1 and w2 must share one dtype")
    M = B * S
    if not 1 <= M < 2**31:
        raise ValueError(f"{what}: need 1 <= B*S < 2^31, got {M}")
    code = _build.dtype_code(x, what)
    if x.dtype == torch.bfloat16:
        _build.require_aligned(what, x, w1, w2)
    lib = _build.library("encoder_ffn", _SIGNATURES)
    nb1 = (-b1).to(x.dtype).contiguous()
    tail = ffn_tail(b1, w2, b2).contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.ralf_fused_ffn(code, x.data_ptr(), w1.data_ptr(), nb1.data_ptr(), w2.data_ptr(),
                                tail.data_ptr(), out.data_ptr(), M, E, F, _build.stream_handle())
    _build.check_launch(rc, what)
    fused_ffn.launches += 1
    return out


fused_ffn.launches = 0
