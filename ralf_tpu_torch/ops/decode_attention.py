"""The decode step's one-query cross-attention kernels K2, K3, K4, K7 and K8.

Counterparts of `ralf_tpu/ops/pallas/decode_attention.py`.  Each wrapper
launches its CUDA kernel of `csrc/decode_attention.cu` on CUDA tensors and
runs its plain version on CPU tensors; there is no other fallback.

Over the SHARED memory (`cross_kv(shared=True)`), with the query
pre-folded through Wk (with the 1/sqrt(Dh) scale) and Wv applied by the
caller (`models.nn.MultiHeadAttention.attend_shared`), so one copy of the
memory serves every decoder layer:

  * K2 `decode_shared_attention` (`fused_decode_shared_attention`);
  * K3 `decode_shared_attention_q8` over int8 memory with per-token scales
    (`fused_decode_shared_attention_q8`, `quantize_shared_memory`);
  * K4 `decode_shared_attention_q8mxu`: K3 with both contractions int8 x
    int8 -> int32 (`fused_decode_shared_attention_q8mxu`; its plain version
    is the port of `q8mxu_reference`, and `quantize_q_tilde` the quantiser
    that the kernel applies to the query itself).

Over PER-LAYER cross K/V caches in the [B, H, Dh, M] layout
(`cross_kv(shared=False)`):

  * K7 `decode_attention` (`fused_decode_attention`);
  * K8 `decode_attention_q8` over int8 K/V with per-(B, H) scales
    (`fused_decode_attention_q8`, `quantize_kv`).

Precision, as the TPU kernels: K2 rounds the normalised p to the memory's
dtype and K3 rounds p * s to q_tilde's dtype before the p . mem
contraction, which sums in fp32 (in fp32 the rounding is the identity).
K7 and K8 keep p in fp32, scale the scores by the Python float Dh^-1/2 and
return q's dtype; K8's kernel folds k_scale into the query and v_scale onto
the output itself, in `_fold_k_scale`'s order, so one call is one launch.
"""

from __future__ import annotations

import ctypes

import torch

from ralf_tpu_torch.ops import _build

NUM_HEADS, WIDTH = 8, 256  # the shared-memory kernels' fixed H and E (the flagship decoder)
MAX_MEMORY = 4096  # tokens: the scores (K3, K4: and an 8th of the memory) live in shared memory
MAX_HEAD_DIM = 256

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ralf_decode_shared_attention": [_I, _P, _P, _P, _I, _I, _P],
    "ralf_decode_shared_attention_q8": [_I, _P, _P, _P, _P, _I, _I, _P],
    "ralf_decode_shared_attention_q8mxu": [_I, _P, _P, _P, _P, _I, _I, _P],
    "ralf_decode_attention": [_I, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "ralf_decode_attention_q8": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
}


def _lib():
    return _build.library("decode_attention", _SIGNATURES)


# ---- quantisers -------------------------------------------------------------


def _absmax_int8(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 over `dims`: x = scale * xi, scale with the dims kept."""
    xf = x.float()
    amax = xf.abs().amax(dim=dims, keepdim=True).clamp_min(1e-8)
    # a true division, as JAX's and K4's in-kernel quantiser: on CUDA, torch
    # divides by a Python number by multiplying with its reciprocal, which
    # moves scale by an ulp and then qi at exact .5 ties
    scale = amax / amax.new_full((), 127.0)
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def quantize_shared_memory(mem: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, M, E] -> (int8 [B, M, E], per-token fp32 scale [B, M])."""
    mi, scale = _absmax_int8(mem, 2)
    return mi, scale[:, :, 0]


def quantize_q_tilde(q_tilde: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, H, E] folded query -> (int8 [B, H, E], per-head fp32 scale [B, H])."""
    qi, scale = _absmax_int8(q_tilde, 2)
    return qi, scale[:, :, 0]


def quantize_kv(k_t: torch.Tensor, v_t: torch.Tensor):
    """[B, H, Dh, M] caches -> (k_i8, v_i8, k_scale [B, H], v_scale [B, H]):
    absmax over (Dh, M) per (B, H)."""
    ki, ks = _absmax_int8(k_t, (2, 3))
    vi, vs = _absmax_int8(v_t, (2, 3))
    return ki, vi, ks[:, :, 0, 0], vs[:, :, 0, 0]


# ---- plain versions ---------------------------------------------------------


def decode_shared_attention_plain(q_tilde: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: softmax(q_tilde . mem^T), rounded to mem's dtype, . mem."""
    memf = mem.float()
    p = torch.softmax(torch.einsum("bhe,bme->bhm", q_tilde.float(), memf), dim=-1)
    return torch.einsum("bhm,bme->bhe", p.to(mem.dtype).float(), memf).to(q_tilde.dtype)


def decode_shared_attention_q8_plain(
    q_tilde: torch.Tensor, mem_i8: torch.Tensor, mem_scale: torch.Tensor
) -> torch.Tensor:
    """Plain version of K3 over int8 memory with per-token scales; p * s is
    rounded to q_tilde's dtype."""
    memf = mem_i8.float()
    s = mem_scale.float()[:, None, :]  # [B, 1, M]
    p = torch.softmax(torch.einsum("bhe,bme->bhm", q_tilde.float(), memf) * s, dim=-1)
    p = (p * s).to(q_tilde.dtype).float()
    return torch.einsum("bhm,bme->bhe", p, memf).to(q_tilde.dtype)


def q8mxu_probs(q_tilde: torch.Tensor, mem_i8: torch.Tensor, mem_scale: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's quantised probabilities: (pi [B, H, M] integer-valued fp32, the
    per-row scale ps [B, H, 1]); p2 = softmax(scores) * s ~ pi * ps / 127.

    One rounding of p2 * 127 / ps that lands on the other integer moves an
    output by ps * |mem_i8| / 127 <= ps: the bound a kernel is held to."""
    qi, qs = quantize_q_tilde(q_tilde)
    mi = mem_i8.double()  # int8 products summed exactly
    scores = torch.einsum("bhe,bme->bhm", qi.double(), mi).float()
    scores = scores * qs[:, :, None] * mem_scale[:, None, :]
    p2 = torch.softmax(scores, dim=-1) * mem_scale[:, None, :]
    ps = p2.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    # 127 / ps divided, as q8mxu_reference and the kernels do: a Python
    # number over a tensor is a reciprocal times 127 in torch
    return torch.clamp(torch.round(p2 * (ps.new_full((), 127.0) / ps)), -127, 127), ps


def decode_shared_attention_q8mxu_plain(
    q_tilde: torch.Tensor, mem_i8: torch.Tensor, mem_scale: torch.Tensor
) -> torch.Tensor:
    """Plain version of K4, the port of `q8mxu_reference`."""
    pi, ps = q8mxu_probs(q_tilde, mem_i8, mem_scale)
    out = torch.einsum("bhm,bme->bhe", pi.double(), mem_i8.double()).float()
    return (out * ps * (1.0 / 127.0)).to(q_tilde.dtype)


def decode_attention_plain(q: torch.Tensor, k_t: torch.Tensor, v_t: torch.Tensor,
                           scale: float | None = None) -> torch.Tensor:
    """Plain version of K7: softmax(scale * q . k) . v with fp32 scores and p,
    scale = Dh^-1/2 by default; [B, H, Dh] in q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    scores = torch.einsum("bhd,bhdm->bhm", q.float(), k_t.float()) * scale
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhm,bhdm->bhd", p, v_t.float()).to(q.dtype)


def _fold_k_scale(q: torch.Tensor, k_scale: torch.Tensor) -> torch.Tensor:
    return q.float() * (q.shape[-1] ** -0.5) * k_scale[:, :, None]


def decode_attention_q8_plain(q: torch.Tensor, k_i8: torch.Tensor, v_i8: torch.Tensor,
                              k_scale: torch.Tensor, v_scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: k_scale * Dh^-1/2 folded into the fp32 query, K7's
    function on the int8 caches in fp32, v_scale on the output."""
    out = decode_attention_plain(_fold_k_scale(q, k_scale), k_i8, v_i8, scale=1.0)
    return (out * v_scale[:, :, None]).to(q.dtype)


# ---- kernel wrappers --------------------------------------------------------


def _check_shared(what: str, q_tilde: torch.Tensor, mem: torch.Tensor) -> tuple[int, int]:
    if q_tilde.dim() != 3 or q_tilde.shape[1:] != (NUM_HEADS, WIDTH):
        raise ValueError(f"{what}: q_tilde must be [B, {NUM_HEADS}, {WIDTH}], got "
                         f"{tuple(q_tilde.shape)}")
    B = q_tilde.shape[0]
    if mem.dim() != 3 or mem.shape[0] != B or mem.shape[2] != WIDTH \
            or not 1 <= mem.shape[1] <= MAX_MEMORY:
        raise ValueError(f"{what}: memory must be [B, M, {WIDTH}] with 1 <= M <= {MAX_MEMORY}, "
                         f"got {tuple(mem.shape)}")
    if B < 1:
        raise ValueError(f"{what}: batch must be >= 1")
    return B, mem.shape[1]


def _check_int8_memory(what: str, mem_i8: torch.Tensor, mem_scale: torch.Tensor,
                       B: int, M: int) -> None:
    if mem_i8.dtype != torch.int8:
        raise TypeError(f"{what}: mem_i8 must be int8, got {mem_i8.dtype}")
    if mem_scale.dtype != torch.float32 or mem_scale.shape != (B, M):
        raise ValueError(f"{what}: mem_scale must be float32 [B, M]")


def decode_shared_attention(q_tilde: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
    """K2: q_tilde [B, 8, 256], mem [B, M, 256] (same dtype) -> [B, 8, 256]."""
    if q_tilde.device.type == "cpu":
        return decode_shared_attention_plain(q_tilde, mem)
    what = "decode_shared_attention"
    _build.require_cuda(what, q_tilde, mem)
    B, M = _check_shared(what, q_tilde, mem)
    if mem.dtype != q_tilde.dtype:
        raise TypeError(f"{what}: mem dtype {mem.dtype} != q_tilde dtype {q_tilde.dtype}")
    _build.require_aligned(what, q_tilde, mem)
    code = _build.dtype_code(q_tilde, what)
    out = torch.empty_like(q_tilde)
    with torch.cuda.device(q_tilde.device):
        rc = _lib().ralf_decode_shared_attention(
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
    B, M = _check_shared(what, q_tilde, mem_i8)
    _check_int8_memory(what, mem_i8, mem_scale, B, M)
    _build.require_aligned(what, mem_i8)
    code = _build.dtype_code(q_tilde, what)
    out = torch.empty_like(q_tilde)
    with torch.cuda.device(q_tilde.device):
        rc = _lib().ralf_decode_shared_attention_q8(
            code, q_tilde.data_ptr(), mem_i8.data_ptr(), mem_scale.data_ptr(),
            out.data_ptr(), B, M, _build.stream_handle(),
        )
    _build.check_launch(rc, what)
    decode_shared_attention_q8.launches += 1
    return out


def decode_shared_attention_q8mxu(
    q_tilde: torch.Tensor, mem_i8: torch.Tensor, mem_scale: torch.Tensor
) -> torch.Tensor:
    """K4: K3's contract with both contractions int8 x int8 -> int32; the
    kernel absmax-quantises the query per head itself, bit for bit as
    `quantize_q_tilde`, so one call is one launch."""
    if q_tilde.device.type == "cpu":
        return decode_shared_attention_q8mxu_plain(q_tilde, mem_i8, mem_scale)
    what = "decode_shared_attention_q8mxu"
    _build.require_cuda(what, q_tilde, mem_i8, mem_scale)
    B, M = _check_shared(what, q_tilde, mem_i8)
    _check_int8_memory(what, mem_i8, mem_scale, B, M)
    _build.require_aligned(what, mem_i8)
    code = _build.dtype_code(q_tilde, what)
    out = torch.empty_like(q_tilde)
    with torch.cuda.device(q_tilde.device):
        rc = _lib().ralf_decode_shared_attention_q8mxu(
            code, q_tilde.data_ptr(), mem_i8.data_ptr(), mem_scale.data_ptr(),
            out.data_ptr(), B, M, _build.stream_handle(),
        )
    _build.check_launch(rc, what)
    decode_shared_attention_q8mxu.launches += 1
    return out


def _check_kv(what: str, q: torch.Tensor, k_t: torch.Tensor, v_t: torch.Tensor) -> tuple:
    if q.dim() != 3 or not 1 <= q.shape[2] <= MAX_HEAD_DIM or q.shape[0] * q.shape[1] < 1:
        raise ValueError(f"{what}: q must be [B, H, Dh] with Dh <= {MAX_HEAD_DIM}, got "
                         f"{tuple(q.shape)}")
    B, H, Dh = q.shape
    for t in (k_t, v_t):
        if t.dim() != 4 or t.shape[:3] != (B, H, Dh) or not 1 <= t.shape[3] <= MAX_MEMORY:
            raise ValueError(f"{what}: caches must be [B, H, Dh, M] with 1 <= M <= {MAX_MEMORY} "
                             f"and q's B, H, Dh, got {tuple(t.shape)}")
    if v_t.shape != k_t.shape or v_t.dtype != k_t.dtype:
        raise ValueError(f"{what}: k_t and v_t must agree in shape and dtype")
    return B * H, Dh, k_t.shape[3]


def decode_attention(q: torch.Tensor, k_t: torch.Tensor, v_t: torch.Tensor) -> torch.Tensor:
    """K7: q [B, H, Dh], k_t and v_t [B, H, Dh, M] (q's dtype) -> [B, H, Dh]."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_t, v_t)
    what = "decode_attention"
    _build.require_cuda(what, q, k_t, v_t)
    BH, Dh, M = _check_kv(what, q, k_t, v_t)
    if k_t.dtype != q.dtype:
        raise TypeError(f"{what}: cache dtype {k_t.dtype} != q dtype {q.dtype}")
    code = _build.dtype_code(q, what)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _lib().ralf_decode_attention(
            code, q.data_ptr(), k_t.data_ptr(), v_t.data_ptr(), out.data_ptr(), BH, Dh, M,
            Dh**-0.5, _build.stream_handle(),
        )
    _build.check_launch(rc, what)
    decode_attention.launches += 1
    return out


def decode_attention_q8(q: torch.Tensor, k_i8: torch.Tensor, v_i8: torch.Tensor,
                        k_scale: torch.Tensor, v_scale: torch.Tensor) -> torch.Tensor:
    """K8: q [B, H, Dh], int8 caches [B, H, Dh, M], scales fp32 [B, H] ->
    [B, H, Dh] in q's dtype.  The kernel folds both scales itself: one call
    is one launch."""
    if q.device.type == "cpu":
        return decode_attention_q8_plain(q, k_i8, v_i8, k_scale, v_scale)
    what = "decode_attention_q8"
    _build.require_cuda(what, q, k_i8, v_i8, k_scale, v_scale)
    BH, Dh, M = _check_kv(what, q, k_i8, v_i8)
    if k_i8.dtype != torch.int8:
        raise TypeError(f"{what}: caches must be int8, got {k_i8.dtype}")
    for s in (k_scale, v_scale):
        if s.dtype != torch.float32 or s.shape != q.shape[:2]:
            raise ValueError(f"{what}: scales must be float32 [B, H]")
    code = _build.dtype_code(q, what)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _lib().ralf_decode_attention_q8(
            code, q.data_ptr(), k_i8.data_ptr(), v_i8.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), out.data_ptr(), BH, Dh, M, Dh**-0.5, _build.stream_handle(),
        )
    _build.check_launch(rc, what)
    decode_attention_q8.launches += 1
    return out


for _kernel in (decode_shared_attention, decode_shared_attention_q8, decode_shared_attention_q8mxu,
                decode_attention, decode_attention_q8):
    _kernel.launches = 0
