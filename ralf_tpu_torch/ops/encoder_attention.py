"""K1: fused bidirectional encoder self-attention (forward only).

Counterpart of `ralf_tpu/ops/pallas/encoder_attention.py`
(`fused_encoder_attention`).  `encoder_attention` launches the CUDA kernel
of `csrc/encoder_attention.cu` on a CUDA tensor and runs
`encoder_attention_plain` on a CPU tensor; there is no other fallback.

Semantics shared by both: q, k, v are [B, S, E] with head h in columns
h*Dh.., the softmax scale folded into q; `key_bias` [B, S] is the
key-padding bias (0 kept, -1e9 masked, `models.nn.keep_to_bias`).  A batch
row with no kept key attends uniformly over all S keys, as the TPU kernel
does, instead of giving NaN.  Softmax and both contractions run in fp32;
the output takes q's dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ralf_tpu_torch.ops import _build

_SIGNATURES = {
    "ralf_encoder_attention": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
}


def encoder_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nhead: int,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, [B, S, E] -> [B, S, E]."""
    B, S, E = q.shape
    Dh = E // nhead
    qh = q.float().reshape(B, S, nhead, Dh)
    kh = k.float().reshape(B, S, nhead, Dh)
    vh = v.float().reshape(B, S, nhead, Dh)
    logits = torch.einsum("bshd,bmhd->bhsm", qh, kh)
    if key_bias is not None:
        kb = key_bias.float()
        dead = ~(torch.exp(kb) > 0).any(dim=-1)  # no key kept in the row
        logits = logits + kb[:, None, None, :]
        logits = torch.where(dead[:, None, None, None], torch.zeros_like(logits), logits)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhsm,bmhd->bshd", p, vh).reshape(B, S, E).to(q.dtype)


def encoder_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nhead: int,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head softmax(q k^T + key_bias) v over [B, S, E] -> [B, S, E]."""
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, nhead, key_bias)
    what = "encoder_attention"
    tensors = (q, k, v) if key_bias is None else (q, k, v, key_bias)
    _build.require_cuda(what, *tensors)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k, v must share one [B, S, E] shape")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must share one dtype")
    B, S, E = q.shape
    if E % nhead or E // nhead not in (32, 64):
        raise ValueError(f"{what}: head width E/nhead must be 32 or 64, got {E}/{nhead}")
    if not 1 <= B <= 65535 or S < 1:
        raise ValueError(f"{what}: need 1 <= B <= 65535 and S >= 1, got B={B}, S={S}")
    if key_bias is not None and (key_bias.dtype != torch.float32 or key_bias.shape != (B, S)):
        raise ValueError(f"{what}: key_bias must be float32 [B, S]")
    code = _build.dtype_code(q, what)
    lib = _build.library("encoder_attention", _SIGNATURES)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.ralf_encoder_attention(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_bias is None else key_bias.data_ptr(), out.data_ptr(),
            B, S, E, nhead, _build.stream_handle(),
        )
    _build.check_launch(rc, what)
    encoder_attention.launches += 1
    return out


encoder_attention.launches = 0
