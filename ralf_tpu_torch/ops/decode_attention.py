"""K2 and K3: the decode step's cross-attention over the SHARED memory.

Counterparts of `ralf_tpu/ops/pallas/decode_attention.py`
(`fused_decode_shared_attention`, `fused_decode_shared_attention_q8` and
`quantize_shared_memory`).  Each wrapper launches its CUDA kernel of
`csrc/decode_attention.cu` on CUDA tensors and runs its plain version on CPU
tensors; there is no other fallback.

The query is pre-folded through Wk (with the 1/sqrt(Dh) scale) and Wv is
applied by the caller (`models.nn.MultiHeadAttention.attend_shared`), so one
copy of the memory serves every decoder layer.

Precision: both kernels and both plain versions keep the probabilities in
fp32 through the p . mem contraction; the TPU kernels round p to the
memory's dtype first.  Against the TPU semantics in bf16 that is a relative
difference of at most 2^-9 per probability, so up to 2^-9 * max|mem| on
each output; in fp32 the two agree to rounding.
"""

from __future__ import annotations

import ctypes

import torch

from ralf_tpu_torch.ops import _build

NUM_HEADS, WIDTH = 8, 256  # the kernels' fixed H and E (the flagship decoder)

_SIGNATURES = {
    "ralf_decode_shared_attention": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
    "ralf_decode_shared_attention_q8": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
}


def quantize_shared_memory(mem: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, M, E] -> (int8 [B, M, E], per-token fp32 scale [B, M]).

    Symmetric absmax over each token's E-vector: memory = scale * mem_i8."""
    memf = mem.float()
    scale = memf.abs().amax(dim=2).clamp_min(1e-8) / 127.0
    mi = torch.clamp(torch.round(memf / scale[:, :, None]), -127, 127)
    return mi.to(torch.int8), scale


def decode_shared_attention_plain(q_tilde: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: softmax(q_tilde . mem^T) . mem, [B, H, E]."""
    memf = mem.float()
    p = torch.softmax(torch.einsum("bhe,bme->bhm", q_tilde.float(), memf), dim=-1)
    return torch.einsum("bhm,bme->bhe", p, memf).to(q_tilde.dtype)


def decode_shared_attention_q8_plain(
    q_tilde: torch.Tensor, mem_i8: torch.Tensor, mem_scale: torch.Tensor
) -> torch.Tensor:
    """Plain version of K3 over int8 memory with per-token scales."""
    memf = mem_i8.float()
    s = mem_scale.float()[:, None, :]  # [B, 1, M]
    p = torch.softmax(torch.einsum("bhe,bme->bhm", q_tilde.float(), memf) * s, dim=-1)
    return torch.einsum("bhm,bme->bhe", p * s, memf).to(q_tilde.dtype)


def _check_shapes(what: str, q_tilde: torch.Tensor, mem: torch.Tensor) -> tuple[int, int]:
    if q_tilde.dim() != 3 or q_tilde.shape[1:] != (NUM_HEADS, WIDTH):
        raise ValueError(f"{what}: q_tilde must be [B, {NUM_HEADS}, {WIDTH}], got "
                         f"{tuple(q_tilde.shape)}")
    B = q_tilde.shape[0]
    if mem.dim() != 3 or mem.shape[0] != B or mem.shape[2] != WIDTH or mem.shape[1] < 1:
        raise ValueError(f"{what}: memory must be [B, M, {WIDTH}] with M >= 1, got "
                         f"{tuple(mem.shape)}")
    if not 1 <= B <= 2**31 - 1:
        raise ValueError(f"{what}: batch must be >= 1")
    return B, mem.shape[1]


def decode_shared_attention(q_tilde: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
    """K2: q_tilde [B, 8, 256], mem [B, M, 256] (same dtype) -> [B, 8, 256]."""
    if q_tilde.device.type == "cpu":
        return decode_shared_attention_plain(q_tilde, mem)
    what = "decode_shared_attention"
    _build.require_cuda(what, q_tilde, mem)
    B, M = _check_shapes(what, q_tilde, mem)
    if mem.dtype != q_tilde.dtype:
        raise TypeError(f"{what}: mem dtype {mem.dtype} != q_tilde dtype {q_tilde.dtype}")
    code = _build.dtype_code(q_tilde, what)
    lib = _build.library("decode_attention", _SIGNATURES)
    out = torch.empty_like(q_tilde)
    with torch.cuda.device(q_tilde.device):
        rc = lib.ralf_decode_shared_attention(
            code, q_tilde.data_ptr(), mem.data_ptr(), out.data_ptr(), B, M,
            _build.stream_handle(),
        )
    _build.check_launch(rc, what)
    decode_shared_attention.launches += 1
    return out


def decode_shared_attention_q8(
    q_tilde: torch.Tensor, mem_i8: torch.Tensor, mem_scale: torch.Tensor
) -> torch.Tensor:
    """K3: q_tilde [B, 8, 256], mem_i8 int8 [B, M, 256], mem_scale fp32
    [B, M] -> [B, 8, 256] in q_tilde's dtype."""
    if q_tilde.device.type == "cpu":
        return decode_shared_attention_q8_plain(q_tilde, mem_i8, mem_scale)
    what = "decode_shared_attention_q8"
    _build.require_cuda(what, q_tilde, mem_i8, mem_scale)
    B, M = _check_shapes(what, q_tilde, mem_i8)
    if mem_i8.dtype != torch.int8:
        raise TypeError(f"{what}: mem_i8 must be int8, got {mem_i8.dtype}")
    if mem_scale.dtype != torch.float32 or mem_scale.shape != (B, M):
        raise ValueError(f"{what}: mem_scale must be float32 [B, M]")
    code = _build.dtype_code(q_tilde, what)
    lib = _build.library("decode_attention", _SIGNATURES)
    out = torch.empty_like(q_tilde)
    with torch.cuda.device(q_tilde.device):
        rc = lib.ralf_decode_shared_attention_q8(
            code, q_tilde.data_ptr(), mem_i8.data_ptr(), mem_scale.data_ptr(),
            out.data_ptr(), B, M, _build.stream_handle(),
        )
    _build.check_launch(rc, what)
    decode_shared_attention_q8.launches += 1
    return out


decode_shared_attention.launches = 0
decode_shared_attention_q8.launches = 0
