"""The port's CUDA kernels K1-K4, K7 and K8 against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so every test here needs a CUDA card and skips
without one.  On a machine with a card (which need not have JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(`--noconftest` because tests/conftest.py configures JAX, which this file
does not use.)  Tolerances, kernel against plain version on the same inputs:
float32 1e-5 + 1e-4*|ref| (both accumulate in fp32; the order of the sums
differs), bfloat16 1e-3 + 2^-7*|ref| (one rounding of the bf16 output).
K4 adds, per (batch, head) row, the row's probability scale ps: its int32
sums are exact, but one rounding of p2 * 127 / ps that lands on the other
integer moves an output by ps * |mem_i8| / 127 <= ps.
"""

import pytest
import torch

from ralf_tpu_torch.models import nn as tnn
from ralf_tpu_torch.ops import decode_attention as da
from ralf_tpu_torch.ops import encoder_attention as ea

pytestmark = pytest.mark.cuda
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 2**-7)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, dtype, extra=0.0):
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    err = (out.float() - ref.float()).abs()
    assert bool((err <= atol + extra + rtol * ref.float().abs()).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,mask", [
    (2, 330, 8, False),  # image encoder
    (3, 4, 8, True),     # constraint encoder
    (5, 11, 4, True),    # FIDNet, Dh=64
    (1, 1, 8, False),    # a single token
    (2, 97, 4, True),    # ragged key and query tiles
])
def test_encoder_attention_kernel_matches_plain(dev, dtype, B, S, H, mask):
    g = torch.Generator(device=dev).manual_seed(S)
    q, k, v = (torch.randn(B, S, 256, generator=g, device=dev) for _ in range(3))
    q = (q * (256 // H) ** -0.5).to(dtype)
    k, v = k.to(dtype), v.to(dtype)
    bias = None
    if mask:
        keep = torch.rand(B, S, generator=g, device=dev) > 0.3
        keep[0] = False  # a row with no kept key: the mean of V
        bias = torch.where(keep, 0.0, -1e9).float()
    n = ea.encoder_attention.launches
    out = ea.encoder_attention(q, k, v, H, bias)
    assert ea.encoder_attention.launches == n + 1
    _close(out, ea.encoder_attention_plain(q, k, v, H, bias), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 31, 677, 680])
def test_decode_kernels_match_plain(dev, dtype, M):
    g = torch.Generator(device=dev).manual_seed(M)
    qt = (torch.randn(6, 8, 256, generator=g, device=dev) / 16).to(dtype)
    memf = torch.randn(6, M, 256, generator=g, device=dev)
    n2, n3 = da.decode_shared_attention.launches, da.decode_shared_attention_q8.launches
    out = da.decode_shared_attention(qt, memf.to(dtype))
    _close(out, da.decode_shared_attention_plain(qt, memf.to(dtype)), dtype)
    mi, ms = da.quantize_shared_memory(memf)
    out = da.decode_shared_attention_q8(qt, mi, ms)
    _close(out, da.decode_shared_attention_q8_plain(qt, mi, ms), dtype)
    assert (da.decode_shared_attention.launches, da.decode_shared_attention_q8.launches) == \
        (n2 + 1, n3 + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 31, 677, 680, 765])
def test_q8mxu_kernel_matches_plain(dev, dtype, M):
    g = torch.Generator(device=dev).manual_seed(M + 1)
    qt = (torch.randn(6, 8, 256, generator=g, device=dev) / 16).to(dtype)
    mi, ms = da.quantize_shared_memory(torch.randn(6, M, 256, generator=g, device=dev))
    n = da.decode_shared_attention_q8mxu.launches
    out = da.decode_shared_attention_q8mxu(qt, mi, ms)
    assert da.decode_shared_attention_q8mxu.launches == n + 1
    ps = da.q8mxu_probs(qt, mi, ms)[1]  # [B, H, 1]: one flipped probability per output
    _close(out, da.decode_shared_attention_q8mxu_plain(qt, mi, ms), dtype, extra=ps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Dh,M", [(2, 8, 32, 1), (3, 8, 32, 677), (2, 4, 8, 300),
                                      (1, 8, 32, 680)])
def test_per_layer_decode_kernels_match_plain(dev, dtype, B, H, Dh, M):
    g = torch.Generator(device=dev).manual_seed(M + 2)
    q = torch.randn(B, H, Dh, generator=g, device=dev).to(dtype)
    k_t, v_t = (torch.randn(B, H, Dh, M, generator=g, device=dev).to(dtype) for _ in range(2))
    n7, n8 = da.decode_attention.launches, da.decode_attention_q8.launches
    _close(da.decode_attention(q, k_t, v_t), da.decode_attention_plain(q, k_t, v_t), dtype)
    cached = da.quantize_kv(k_t, v_t)
    _close(da.decode_attention_q8(q, *cached), da.decode_attention_q8_plain(q, *cached), dtype)
    assert (da.decode_attention.launches, da.decode_attention_q8.launches) == (n7 + 1, n8 + 1)


def test_q8_mxu_switch_launches_k4(dev):
    """attend_shared_q8 with q8_mxu on CUDA tensors goes through K4 and
    nothing else; without it through K3."""
    mha = tnn.MultiHeadAttention(256, 8).to(dev)
    q_in = torch.randn(4, 1, 256, device=dev)
    mi, ms = da.quantize_shared_memory(torch.randn(4, 50, 256, device=dev))
    n3, n4 = da.decode_shared_attention_q8.launches, da.decode_shared_attention_q8mxu.launches
    with torch.inference_mode():
        mha.attend_shared_q8(q_in, mi, ms, q8_mxu=True)
        assert (da.decode_shared_attention_q8.launches,
                da.decode_shared_attention_q8mxu.launches) == (n3, n4 + 1)
        mha.attend_shared_q8(q_in, mi, ms)
    assert (da.decode_shared_attention_q8.launches,
            da.decode_shared_attention_q8mxu.launches) == (n3 + 1, n4 + 1)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.randn(2, 8, 256, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ea.encoder_attention(q.transpose(0, 1), q.transpose(0, 1), q.transpose(0, 1), 8)
    with pytest.raises(TypeError):
        ea.encoder_attention(q.half(), q.half(), q.half(), 8)
    with pytest.raises(ValueError, match="head width"):
        ea.encoder_attention(q, q, q, 16)
    mem = torch.randn(2, 10, 256, device=dev)
    with pytest.raises(TypeError):
        da.decode_shared_attention(q, mem.bfloat16())
    with pytest.raises(ValueError):
        da.decode_shared_attention(q[:, :4].contiguous(), mem)
    mi, ms = da.quantize_shared_memory(mem)
    with pytest.raises(ValueError):
        da.decode_shared_attention_q8(q, mi, ms[:, :5].contiguous())
    with pytest.raises(ValueError):
        da.decode_shared_attention(q, mem.cpu())
    with pytest.raises(ValueError):
        da.decode_shared_attention_q8mxu(q, mi, ms[:, :5].contiguous())
    qh = torch.randn(2, 8, 32, device=dev)
    k_t = torch.randn(2, 8, 32, 10, device=dev)
    with pytest.raises(TypeError):
        da.decode_attention(qh, k_t.bfloat16(), k_t.bfloat16())
    with pytest.raises(ValueError):
        da.decode_attention(qh, k_t, k_t[..., :5].contiguous())
    with pytest.raises(TypeError):
        da.decode_attention_q8(qh, k_t, k_t, ms[:, :8].contiguous(), ms[:, :8].contiguous())
