"""The port's CUDA kernels K1-K3 against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so every test here needs a CUDA card and skips
without one.  On a machine with a card (which need not have JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(`--noconftest` because tests/conftest.py configures JAX, which this file
does not use.)  Tolerances, kernel against plain version on the same inputs:
float32 1e-5 + 1e-4*|ref| (both accumulate in fp32; the order of the sums
differs), bfloat16 1e-3 + 2^-7*|ref| (one rounding of the bf16 output).
"""

import pytest
import torch

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


def _close(out, ref, dtype):
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    err = (out.float() - ref.float()).abs()
    assert bool((err <= atol + rtol * ref.float().abs()).all()), float(err.max())


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
