"""K1 and K6: fused bidirectional encoder self-attention.

Counterpart of `ralf_tpu/ops/pallas/encoder_attention.py`:
`encoder_attention` (K1) of `fused_encoder_attention`, and
`encoder_self_attention` (K6) of `fused_encoder_self_attention`, the same
attention with the q/k/v projections folded into the kernel.  Each
launches its CUDA kernel of `csrc/encoder_attention.cu` on CUDA tensors and
runs its plain version on CPU tensors; there is no other fallback.

Both are differentiable as JAX's custom_vjps make them: the forward (kernel
or plain version) runs inside `_build.RecomputedBackward`, whose backward
recomputes JAX's XLA reference written in torch (`attention_reference`,
`self_attention_reference`; there is no backward kernel), so both devices
take one backward.  The reference
adds key_bias to the logits where the plain version weights the keys, so
on a fully masked row, uniform in both forwards, its softmax of s - 1e9
still passes a gradient to q and k, as JAX's does.  key_bias gets no
gradient (JAX's VJPs return None for it): for K6 that drops the per-key
logit of q_proj's bias, and the terms of x and Wk that reach the loss
through it (ROADMAP.md Queue C).

Semantics shared by both, those of the TPU kernels' `_attend_block`:
q, k, v are [B, S, E] with head h in columns h*Dh.., the softmax scale
folded into q.  A key bias becomes keep weights w = exp(bias) (K1: the
[B, S] key-padding bias, 0 kept and -1e9 masked, `models.nn.keep_to_bias`;
K6: [B, S] or per head [B, H, S], any real value); m is the max over the
scores whose w > 0, p = exp(min(s - m, 0)) * w, normalised, and a row with
no w > 0 attends uniformly over all S keys instead of giving NaN.  Both
contractions accumulate in fp32; the normalised p is rounded to the input
dtype before the second, and the output takes the input dtype.
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
    "ralf_encoder_self_attention": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
    "ralf_encoder_self_attention_smem": [ctypes.c_int, ctypes.c_int, ctypes.c_int],
}
K1_MAX_S = 1024  # a query tile's [32, S] fp32 score row in shared memory
ROWS_MAX_S = 384  # bf16 up to here: a row's scores in registers (K1, K6 on the tensor cores)
SMEM_PER_BLOCK = 232448  # the H100's 227 KB


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nhead: int,
                 keep_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`_attend_block` in plain PyTorch: [B, S, E] -> [B, S, E]; keep_w
    [B, 1 or H, S] fp32 (None: every key kept)."""
    B, S, E = q.shape
    Dh = E // nhead
    qh, kh, vh = (t.float().reshape(B, S, nhead, Dh) for t in (q, k, v))
    s = torch.einsum("bshd,bmhd->bhsm", qh, kh)
    if keep_w is None:
        keep_w = torch.ones((B, 1, S), dtype=torch.float32, device=q.device)
    w = keep_w[:, :, None, :]  # [B, 1 or H, 1, S]
    kept_any = w.amax(dim=-1, keepdim=True) > 0
    s = torch.where(kept_any, s, 0.0)
    m = torch.where(w > 0, s, -torch.inf).amax(dim=-1, keepdim=True)
    m = torch.where(kept_any, m, 0.0)
    p = torch.exp(torch.clamp(s - m, max=0.0)) * torch.where(kept_any, w, 1.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = p.to(v.dtype).float()
    return torch.einsum("bhsm,bmhd->bshd", p, vh).reshape(B, S, E).to(q.dtype)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nhead: int,
                        key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's `_reference_attention`, what its custom_vjps differentiate:
    softmax(q k^T + key_bias) v with fp32 logits, p in q's dtype; key_bias
    [B, S] or per head [B, H, S]."""
    B, S, E = q.shape
    qh, kh, vh = (t.reshape(B, S, nhead, E // nhead) for t in (q, k, v))
    logits = torch.einsum("bshd,bmhd->bhsm", qh.float(), kh.float())
    if key_bias is not None:
        kb = key_bias[:, :, None, :] if key_bias.dim() == 3 else key_bias[:, None, None, :]
        logits = logits + kb.float()
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhsm,bmhd->bshd", p, vh).reshape(B, S, E)


def self_attention_reference(x: torch.Tensor, wqkv: torch.Tensor, nhead: int,
                             key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's `_reference_self_attention` for wqkv [3E, E]."""
    E = x.shape[-1]
    qkv = x @ wqkv.to(x.dtype).t()
    return attention_reference(qkv[..., :E], qkv[..., E:2 * E], qkv[..., 2 * E:], nhead, key_bias)


def encoder_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nhead: int,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1, [B, S, E] -> [B, S, E]."""
    keep_w = None if key_bias is None else torch.exp(key_bias.float())[:, None, :]
    return attend_plain(q, k, v, nhead, keep_w)


def _check_heads(what: str, B: int, S: int, E: int, nhead: int, any_width: bool = False) -> None:
    """K6 takes head widths 32 and 64; K1 (`any_width`) every width up to 64."""
    if nhead < 1 or E % nhead or not (E // nhead <= 64 if any_width else E // nhead in (32, 64)):
        need = "at most 64" if any_width else "32 or 64"
        raise ValueError(f"{what}: head width E/nhead must be {need}, got {E}/{nhead}")
    if not 1 <= B <= 65535 or S < 1:
        raise ValueError(f"{what}: need 1 <= B <= 65535 and S >= 1, got B={B}, S={S}")


def encoder_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nhead: int,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1: multi-head softmax(q k^T, keep weights exp(key_bias)) v over
    [B, S, E] -> [B, S, E], any head width E/nhead up to 64; gradients to
    q, k and v.  Head widths 32 and 64 copy rows by 16-byte cp.async (in
    bf16 q, k, v must start on a 16-byte boundary); the others run padded
    with zero columns to the next of 32 and 64, copied element by element."""
    forward = encoder_attention_plain if q.device.type == "cpu" else _launch_encoder_attention
    kb = None if key_bias is None else key_bias.detach()
    return _build.RecomputedBackward.apply(
        lambda q, k, v: forward(q, k, v, nhead, kb),
        lambda q, k, v: attention_reference(q, k, v, nhead, kb), q, k, v)


def _launch_encoder_attention(q, k, v, nhead, key_bias):
    what = "encoder_attention"
    tensors = (q, k, v) if key_bias is None else (q, k, v, key_bias)
    _build.require_cuda(what, *tensors)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k, v must share one [B, S, E] shape")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must share one dtype")
    B, S, E = q.shape
    _check_heads(what, B, S, E, nhead, any_width=True)
    if S > K1_MAX_S:
        raise ValueError(f"{what}: S={S} above {K1_MAX_S} (the score row lives in shared memory)")
    if key_bias is not None and (key_bias.dtype != torch.float32 or key_bias.shape != (B, S)):
        raise ValueError(f"{what}: key_bias must be float32 [B, S]")
    code = _build.dtype_code(q, what)
    if q.dtype == torch.bfloat16 and E // nhead in (32, 64):  # the routes that copy by cp.async
        _build.require_aligned(what, q, k, v)
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


def encoder_self_attention_plain(
    x: torch.Tensor, wqkv: torch.Tensor, nhead: int, key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K6, [B, S, E] -> [B, S, E]."""
    E = x.shape[-1]
    qkv = (x.float() @ wqkv.float().t()).to(x.dtype)  # fp32 sums, rounded as the kernel does
    keep_w = None
    if key_bias is not None:
        kb = key_bias.float()
        keep_w = torch.exp(kb[:, None, :] if kb.dim() == 2 else kb)
    return attend_plain(qkv[..., :E], qkv[..., E:2 * E], qkv[..., 2 * E:], nhead, keep_w)


def encoder_self_attention(
    x: torch.Tensor, wqkv: torch.Tensor, nhead: int, key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K6: bias-free self-attention with the projections in the kernel,
    softmax((x Wq s)(x Wk)^T, keep weights exp(key_bias)) (x Wv), for x
    [B, S, E] and wqkv [3E, E] = cat(q_proj.weight * s, k_proj.weight,
    v_proj.weight) (nn.Linear's layout); key_bias fp32 [B, S] or per head
    [B, H, S].  The projection biases are the caller's
    (`models.nn.MultiHeadAttention._self_attend_folded`).  bf16 with
    S <= 384 runs on the tensor cores (and needs x and wqkv on a 16-byte
    boundary); fp32, and bf16 past 384, on the CUDA cores.  Gradients to
    x and wqkv."""
    forward = (encoder_self_attention_plain if x.device.type == "cpu"
               else _launch_encoder_self_attention)
    kb = None if key_bias is None else key_bias.detach()
    return _build.RecomputedBackward.apply(
        lambda x, wqkv: forward(x, wqkv, nhead, kb),
        lambda x, wqkv: self_attention_reference(x, wqkv, nhead, kb), x, wqkv)


def _launch_encoder_self_attention(x, wqkv, nhead, key_bias):
    what = "encoder_self_attention"
    tensors = (x, wqkv) if key_bias is None else (x, wqkv, key_bias)
    _build.require_cuda(what, *tensors)
    if x.dim() != 3:
        raise ValueError(f"{what}: x must be [B, S, E]")
    B, S, E = x.shape
    if wqkv.shape != (3 * E, E):
        raise ValueError(f"{what}: wqkv must be [3E, E] = {(3 * E, E)}, got {tuple(wqkv.shape)}")
    if wqkv.dtype != x.dtype:
        raise TypeError(f"{what}: x and wqkv must share one dtype")
    _check_heads(what, B, S, E, nhead)
    head_stride = 0
    if key_bias is not None:
        if key_bias.dtype != torch.float32 or key_bias.shape not in ((B, S), (B, nhead, S)):
            raise ValueError(f"{what}: key_bias must be float32 [B, S] or [B, H, S]")
        head_stride = S if key_bias.dim() == 3 else 0
    code = _build.dtype_code(x, what)
    if x.dtype == torch.bfloat16 and S <= ROWS_MAX_S:  # the route that copies by cp.async
        _build.require_aligned(what, x, wqkv)
    lib = _build.library("encoder_attention", _SIGNATURES)
    # the launcher's own size for the route it takes
    if lib.ralf_encoder_self_attention_smem(code, S, E // nhead) > SMEM_PER_BLOCK:
        raise ValueError(f"{what}: S={S} at head width {E // nhead} needs more than 227 KB "
                         "of shared memory per block")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.ralf_encoder_self_attention(
            code, x.data_ptr(), wqkv.data_ptr(),
            None if key_bias is None else key_bias.data_ptr(), head_stride, out.data_ptr(),
            B, S, E, nhead, _build.stream_handle(),
        )
    _build.check_launch(rc, what)
    encoder_self_attention.launches += 1
    return out


encoder_self_attention.launches = 0
