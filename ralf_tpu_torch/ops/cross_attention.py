"""K10: multi-head cross-attention of S queries over a memory of M tokens.

It replaces no Pallas kernel: the JAX package computes this attention with
XLA's einsums (`ralf_tpu/models/nn.py::MultiHeadAttention`).  The port
sends the eval-mode cross-attentions with S != M through it
(`models.nn.MultiHeadAttention.attend`): above all the denoising decoder's,
over K and V projected once a request (`models.diffusion`).
`cross_attention` launches the CUDA kernel of `csrc/cross_attention.cu` on
CUDA tensors and runs `cross_attention_plain` on CPU tensors; there is no
other fallback.  It is forward only.

q is [B, S, E] and k, v [B, M, E] with head h in columns h*Dh.. (the layout
the projections write), any head width Dh = E / nhead up to 64; key_bias
an optional fp32 [B, M] added to every head's logits (0 kept, -1e9 masked:
`models.nn.keep_to_bias`).  The function is the einsum path's,

    softmax(scale * q k^T + key_bias) v

with the logits in fp32 and the probabilities rounded to v's dtype before
the second product, which sums in fp32; the output takes q's dtype.  The
kernel's softmax is online over key tiles, so it rounds the unnormalised
probabilities and divides after the product: in bf16 it differs from the
plain version by one rounding of p, at most 2^-8 of the largest |v| a row.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ralf_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ralf_cross_attention": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
}
MAX_HEAD_DIM = 64  # heads are padded to 32 or 64 columns in the kernel


def cross_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nhead: int,
                          key_bias: Optional[torch.Tensor] = None,
                          scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of K10: [B, S, E] over [B, M, E] -> [B, S, E]."""
    B, S, E = q.shape
    M, Dh = k.shape[1], E // nhead
    qh = q.float().reshape(B, S, nhead, Dh)
    kh, vh = (t.float().reshape(B, M, nhead, Dh) for t in (k, v))
    logits = torch.einsum("bshd,bmhd->bhsm", qh, kh) * scale
    if key_bias is not None:
        logits = logits + key_bias.float()[:, None, None, :]
    p = torch.softmax(logits, dim=-1).to(v.dtype).float()
    return torch.einsum("bhsm,bmhd->bshd", p, vh).reshape(B, S, E).to(q.dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nhead: int,
                    key_bias: Optional[torch.Tensor] = None, scale: float = 1.0) -> torch.Tensor:
    """K10: softmax(scale * q k^T + key_bias) v per head, q [B, S, E] over
    k, v [B, M, E] -> [B, S, E]; fp32 or bf16, head width up to 64."""
    if q.device.type == "cpu":
        return cross_attention_plain(q, k, v, nhead, key_bias, scale)
    what = "cross_attention"
    tensors = (q, k, v) if key_bias is None else (q, k, v, key_bias)
    _build.require_cuda(what, *tensors)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or k.shape[::2] != q.shape[::2]:
        raise ValueError(f"{what}: q must be [B, S, E] and k, v [B, M, E]")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must share one dtype")
    B, S, E = q.shape
    M = k.shape[1]
    if nhead < 1 or E % nhead or E // nhead > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head width E/nhead must be at most {MAX_HEAD_DIM}, "
                         f"got {E}/{nhead}")
    if not 1 <= B <= 65535 or S < 1 or M < 1:
        raise ValueError(f"{what}: need 1 <= B <= 65535, S >= 1 and M >= 1, got {B}, {S}, {M}")
    if key_bias is not None and (key_bias.dtype != torch.float32 or key_bias.shape != (B, M)):
        raise ValueError(f"{what}: key_bias must be float32 [B, M]")
    code = _build.dtype_code(q, what)
    lib = _build.library("cross_attention", _SIGNATURES)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.ralf_cross_attention(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_bias is None else key_bias.data_ptr(), out.data_ptr(),
            B, S, M, E, nhead, scale, _build.stream_handle(),
        )
    _build.check_launch(rc, what)
    cross_attention.launches += 1
    return out


cross_attention.launches = 0
