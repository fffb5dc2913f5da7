"""The port's CUDA kernels K1-K11 and the exact assignment against their
plain PyTorch versions, on the card.

The kernels have no CPU mode, so every test here needs a CUDA card and skips
without one.  On a machine with a card (which need not have JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(`--noconftest` because tests/conftest.py configures JAX, which this file
does not use.)  Tolerances, kernel against plain version on the same inputs:
float32 1e-5 + 1e-4*|ref| (both accumulate in fp32; the order of the sums
differs), bfloat16 1e-3 + 2^-7*|ref| (one rounding of the bf16 output).
K4 adds, per (batch, head) row, the row's probability scale ps: its int32
sums are exact, but one rounding of p2 * 127 / ps that lands on the other
integer moves an output by ps * |mem_i8| / 127 <= ps.  K9's row sums:
1e-5 * sum|x| (fp32 sums in another order), exact for int8 data.  K5
adds rtol * (|out| + |b1 W2 + b2|): its output rounds o before adding that
tail, and then the sum.  K6 in bf16 adds 2^-8 * max_j |v_j|: its q, k, v
are rounded after fp32 sums in another order than the plain version's.
K8 is held to the fp32 or bf16 tolerance of its output dtype: it keeps p in
fp32, and only the order of its sums differs (an online softmax over 4
warps' slices against the plain version's one softmax).  K10 in bf16 adds
2^-8 * max_j |v_j| of its (batch row, head): its online softmax rounds the
unnormalised p to bf16 where the plain version rounds the normalised p.  The assignment
kernel equals its plain version exactly: the same fp32 operations in the
same order, and the same first-index tie rule.  K11 is held to the plain
tolerances: its plain version is the same fp32 formula rounded once, and
only its fused multiply-add differs (one fp32 rounding fewer), which can
move a bf16 output by one rounding.
"""

import itertools

import pytest
import torch

from ralf_tpu_torch.models import nn as tnn
from ralf_tpu_torch.ops import _build
from ralf_tpu_torch.ops import assignment as asg
from ralf_tpu_torch.ops import batchnorm_act as bna
from ralf_tpu_torch.ops import cross_attention as xa
from ralf_tpu_torch.ops import decode_attention as da
from ralf_tpu_torch.ops import encoder_attention as ea
from ralf_tpu_torch.ops import encoder_ffn as ef
from ralf_tpu_torch.ops import stream_sum as ss

pytestmark = pytest.mark.cuda
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 2**-7)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    # every kernel library loaded before the process's first torch.profiler
    # session: on the card, a library loaded after it showed no kernels to
    # the sessions that followed
    da._lib()
    for mod, name in ((ea, "encoder_attention"), (ef, "encoder_ffn"), (ss, "stream_sum"),
                      (asg, "assignment"), (xa, "cross_attention"), (bna, "batchnorm_act")):
        _build.library(name, mod._SIGNATURES)
    return torch.device("cuda")


def _close(out, ref, dtype, extra=0.0):
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    err = (out.float() - ref.float()).abs()
    assert bool((err <= atol + extra + rtol * ref.float().abs()).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,mask", [
    (2, 330, 8, False),   # image encoder (K and V whole in shared memory)
    (3, 4, 8, True),      # constraint encoder
    (5, 11, 4, True),     # FIDNet, Dh=64
    (1, 1, 8, False),     # a single token
    (2, 97, 4, True),     # ragged key and query tiles
    (2, 16, 8, False),    # one k-step of keys
    (2, 64, 8, True),     # exactly one key tile
    (3, 89, 8, True),     # the constraint encoder's longest, B=3
    (1, 1024, 8, False),  # the largest S at Dh=32 (key tiles streamed)
    (2, 1024, 4, True),   # the largest S at Dh=64
    (2, 330, 4, False),   # Dh=64 past the resident size: streamed
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
@pytest.mark.parametrize("S", [130, 330, 400])  # bf16: scores in registers to 384, then two passes
def test_encoder_attention_first_key_tile_masked(dev, dtype, S):
    """Every key of the first tile of 64 masked: in the two-pass route the
    running max stays at -inf through that tile and must rescale nothing
    (no exp(-inf + inf)); row 1 is fully masked and attends uniformly."""
    g = torch.Generator(device=dev).manual_seed(S + 1)
    B, H = 3, 8
    q, k, v = (torch.randn(B, S, 256, generator=g, device=dev) for _ in range(3))
    q, k, v = (q * 32**-0.5).to(dtype), k.to(dtype), v.to(dtype)
    keep = torch.rand(B, S, generator=g, device=dev) > 0.3
    keep[:, :64] = False
    keep[1] = False
    bias = torch.where(keep, 0.0, -1e9).float()
    out = ea.encoder_attention(q, k, v, H, bias)
    _close(out, ea.encoder_attention_plain(q, k, v, H, bias), dtype)
    _close(out[1], v[1].float().mean(0).expand(S, -1).to(dtype), dtype)


def test_encoder_attention_bf16_rounds_p(dev):
    """K1 on keys in near-equal pairs whose values cancel (+-32 u): within
    the bf16 tolerance of the plain version, which rounds the normalised p;
    the version that keeps p in fp32 is not."""
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, E, H = 2, 64, 256, 8
    q = torch.randn(B, S, E, generator=g, device=dev) * 0.5
    k = torch.randn(B, S, E, generator=g, device=dev)
    k[:, 1::2] = k[:, 0::2] + 0.05 * torch.randn(B, S // 2, E, generator=g, device=dev)
    u = 32.0 * torch.randn(B, S // 2, E, generator=g, device=dev)
    v = torch.stack([u, -u], dim=2).reshape(B, S, E)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    ref = ea.encoder_attention_plain(q, k, v, H)
    _close(ea.encoder_attention(q, k, v, H), ref, torch.bfloat16)
    qh, kh, vh = (t.float().reshape(B, S, H, E // H) for t in (q, k, v))
    p = torch.softmax(torch.einsum("bshd,bmhd->bhsm", qh, kh), -1)
    fp32_p = torch.einsum("bhsm,bmhd->bshd", p, vh).reshape(B, S, E)
    atol, rtol = TOL[torch.bfloat16]
    assert float(((fp32_p - ref.float()).abs() - atol - rtol * ref.float().abs()).max()) > 0.01


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,E,F", [
    (128, 330, 256, 1024),  # the main path's image encoder: 330 tiles of 128 rows, 2.5 waves
    (2, 330, 256, 1024),  # image encoder
    (3, 89, 256, 1024),   # constraint encoder, relation task
    (1, 16, 256, 128),    # the gate's least S, a narrow F
    (2, 37, 256, 192),    # a ragged last row tile
])
def test_fused_ffn_kernel_matches_plain(dev, dtype, B, S, E, F):
    g = torch.Generator(device=dev).manual_seed(S)
    x = torch.randn(B, S, E, generator=g, device=dev).to(dtype)
    w1 = (torch.randn(F, E, generator=g, device=dev) * E**-0.5).to(dtype)
    w2 = (torch.randn(E, F, generator=g, device=dev) * F**-0.5).to(dtype)
    b1, b2 = (torch.randn(n, generator=g, device=dev).to(dtype) for n in (F, E))
    n = ef.fused_ffn.launches
    out = ef.fused_ffn(x, w1, b1, w2, b2)
    assert ef.fused_ffn.launches == n + 1
    # the output rounds twice, T(T(o) + T(tail)), as the TPU kernel and its
    # caller do: a flip of either moves it by rtol * |o| or rtol * |out|,
    # and |o| <= |out| + |tail|
    ref = ef.fused_ffn_plain(x, w1, b1, w2, b2)
    twice = TOL[dtype][1] * (ref.float().abs() + ef.ffn_tail(b1, w2, b2).abs())
    _close(out, ref, dtype, extra=twice)


@pytest.mark.parametrize("B,S,F", [
    (64, 300, 192),  # 150 tiles of 128 rows on the 132 SMs, 3 chunks (odd) a tile
    (100, 330, 64),  # 258 tiles, the last one ragged, one chunk a tile
])
def test_fused_ffn_bf16_random_rows_differ_by_one_rounding_of_g(dev, B, S, F, capsys):
    """Random bf16 inputs made as test_fused_ffn_kernel_matches_plain makes
    them.  The kernel sums h = x W1^T in the tensor cores' order, the plain
    version in cuBLAS's; where h lies that close to the midpoint between
    two bf16 values, g = T(max(h, T(-b1))) can round the other way, which
    moves every output of its row by 2^-8 |g_j| |W2[:, j]|, a term the
    tolerance of test_fused_ffn_kernel_matches_plain does not state.  So
    every row with an output outside that tolerance must come within it
    of the plain version with one g_j (or two) rounded the other way,
    each one whose exact (fp64) h lies within the reorder bound
    E 2^-24 sum|x||w1| of that midpoint.  The rows found, the g_j that
    explain each and their distance over that bound are printed."""
    E = ef.WIDTH
    g = torch.Generator(device=dev).manual_seed(S)
    x = torch.randn(B, S, E, generator=g, device=dev).bfloat16()
    w1 = (torch.randn(F, E, generator=g, device=dev) * E**-0.5).bfloat16()
    w2 = (torch.randn(E, F, generator=g, device=dev) * F**-0.5).bfloat16()
    b1, b2 = (torch.randn(n, generator=g, device=dev).bfloat16() for n in (F, E))
    out = ef.fused_ffn(x, w1, b1, w2, b2).reshape(-1, E).float()
    torch.cuda.synchronize()
    atol, rtol = TOL[torch.bfloat16]
    tail = ef.ffn_tail(b1, w2, b2)

    def plain_rows(gr):  # the plain version from g on: T(T(g W2^T) + T(tail))
        return ((gr.float() @ w2.float().t()).bfloat16() + tail.bfloat16()).float()

    def outside(o, ref):
        return (o - ref).abs() > atol + rtol * ref.abs() + rtol * (ref.abs() + tail.abs())

    xf = x.reshape(-1, E).float()
    nb1 = (-b1).float()
    gp = torch.maximum(xf @ w1.float().t(), nb1).bfloat16()  # the plain version's g
    ref = plain_rows(gp)
    bad_rows = outside(out, ref).any(1).nonzero().flatten().tolist()
    found = []
    for r in bad_rows:
        h64 = xf[r].double() @ w1.double().t()
        bound = E * 2**-24 * (xf[r].double().abs() @ w1.double().abs().t())
        # the two bf16 values around h: its fp32 bits cut to bf16, and one up
        lo = (h64.float().view(torch.int32) & -65536).view(torch.float32)
        hi = (lo.view(torch.int32) + 65536).view(torch.float32)
        dist = (h64 - (lo.double() + hi.double()) / 2).abs()
        g_lo, g_hi = (torch.maximum(v, nb1).bfloat16() for v in (lo, hi))
        other = torch.where(gp[r] == g_lo, g_hi, g_lo)
        near = [j for j in dist.argsort()[:8].tolist()
                if other[j] != gp[r, j] and dist[j] <= bound[j]]

        def held_with(flips):
            gr = gp[r].clone()
            gr[flips] = other[flips]
            return not bool(outside(out[r], plain_rows(gr)).any())

        # the fewest of those roundings, taken the other way, that explain the row
        explains = next((c for n in (1, 2) for c in itertools.combinations(near, n)
                         if held_with(list(c))), None)
        assert explains is not None, (r, near)
        found.append((r, explains, [round(float(dist[j] / bound[j]), 4) for j in explains],
                      float((out[r] - ref[r]).abs().max())))
    with capsys.disabled():
        print(f"\nK5 B={B} S={S} F={F}: {len(bad_rows)} rows outside the tolerance; "
              "(row, js, |h - midpoint| / reorder bound, max err against plain): " + repr(found))


@pytest.mark.parametrize("B,S,F", [
    (64, 300, 192),  # 150 tiles of 128 rows on the 132 SMs, 3 chunks (odd) a tile
    (100, 330, 64),  # 258 tiles, the last one ragged, one chunk a tile
])
def test_fused_ffn_bf16_is_exact_on_a_binary_grid(dev, B, S, F):
    """More tiles than SMs and odd or single chunk counts, on inputs where
    every fp32 sum is exact in any order (x, W1 and W2 on coarse binary
    grids, b1 and b2 multiples of 1/4): the kernel must equal its plain
    version bit for bit, so that a tile, chunk or ring phase taken wrong
    shows as a wrong element.  The same shapes on random inputs are
    test_fused_ffn_bf16_random_rows_differ_by_one_rounding_of_g."""
    g = torch.Generator(device=dev).manual_seed(F)

    def grid(shape, lo, step):
        return (torch.randint(-lo, lo + 1, shape, generator=g, device=dev) * step).bfloat16()

    x, w1, w2 = grid((B, S, 256), 4, 0.25), grid((F, 256), 4, 0.125), grid((256, F), 4, 1 / 64)
    b1, b2 = grid((F,), 8, 0.25), grid((256,), 8, 0.25)
    out = ef.fused_ffn(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert torch.equal(out, ef.fused_ffn_plain(x, w1, b1, w2, b2))


def test_fused_ffn_hands_g_from_accumulator_to_a_registers(dev):
    """One 64-row tile and one chunk of 64 hidden units in bf16, where the
    result is exact: x and W1 on a coarse binary grid (h = x W1^T exact in
    fp32 in any order), b1 = b2 = 0 and W2 the identity on the first 64 of
    the 256 outputs, so out[:, :64] = T(relu(h)) = g exactly and the rest
    0.  A g fragment handed to the second product in the wrong place shows
    as a wrong element, not as a tolerance."""
    g = torch.Generator(device=dev).manual_seed(64)
    x = (torch.randint(-8, 9, (1, 64, 256), generator=g, device=dev) / 4).bfloat16()
    w1 = (torch.randint(-8, 9, (64, 256), generator=g, device=dev) / 8).bfloat16()
    w2 = torch.eye(256, 64, device=dev).bfloat16()
    b1, b2 = torch.zeros(64, device=dev), torch.zeros(256, device=dev)
    out = ef.fused_ffn(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    relu_h = torch.relu(x.float() @ w1.float().t()).bfloat16()
    assert torch.equal(out[..., :64], relu_h)
    assert not bool(out[..., 64:].any())
    assert torch.equal(out, ef.fused_ffn_plain(x, w1, b1, w2, b2))


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "fused_ffn_tc_kernel"),
                                          (torch.float32, "fused_ffn_kernel")])
def test_fused_ffn_call_is_one_k5_kernel(dev, dtype, kernel):
    """One call of K5 is one launch of its kernel (the tensor-core one in
    bf16, the CUDA-core one in fp32), counted by the wrapper and seen by
    torch.profiler; the wrapper's own small kernels (T(-b1), the fp32 tail
    b1 W2^T + b2) are other kernels and not K5's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(4, 330, 256, generator=g, device=dev).to(dtype)
    w1 = (torch.randn(1024, 256, generator=g, device=dev) / 16).to(dtype)
    w2 = (torch.randn(256, 1024, generator=g, device=dev) / 32).to(dtype)
    b1, b2 = torch.randn(1024, generator=g, device=dev), torch.randn(256, generator=g, device=dev)
    ef.fused_ffn(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    n = ef.fused_ffn.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ef.fused_ffn(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
    assert ef.fused_ffn.launches == n + 1
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    k5 = [k for k in kernels if "fused_ffn" in k]
    assert len(k5) == 1 and f"{kernel}(" in k5[0], kernels


def test_fused_ffn_bf16_needs_16_byte_alignment_and_fp32_does_not(dev):
    """The bf16 route copies x and the weights by TMA, which needs their
    starts on a 16-byte boundary: a view 2 bytes off is refused before the
    launch.  The fp32 route reads elements and takes a view 4 bytes off."""
    g = torch.Generator(device=dev).manual_seed(16)
    E, F = 256, 128

    def shifted(t, by):
        buf = torch.empty(t.numel() + by, dtype=t.dtype, device=dev)[by:].view(t.shape)
        buf.copy_(t)
        return buf

    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(2, 20, E, generator=g, device=dev).to(dtype)
        w1 = (torch.randn(F, E, generator=g, device=dev) / 16).to(dtype)
        w2 = (torch.randn(E, F, generator=g, device=dev) / 16).to(dtype)
        b1, b2 = (torch.randn(n, generator=g, device=dev).to(dtype) for n in (F, E))
        if dtype == torch.bfloat16:
            for args in ((shifted(x, 1), w1, w2), (x, shifted(w1, 1), w2), (x, w1, shifted(w2, 1))):
                with pytest.raises(ValueError, match="16-byte"):
                    ef.fused_ffn(args[0], args[1], b1, args[2], b2)
            continue
        out = ef.fused_ffn(shifted(x, 1), shifted(w1, 1), b1, shifted(w2, 1), b2)
        ref = ef.fused_ffn_plain(x, w1, b1, w2, b2)
        _close(out, ref, dtype, extra=TOL[dtype][1] * (ref.abs() + ef.ffn_tail(b1, w2, b2).abs()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,bias", [
    (2, 330, 8, "heads"),       # image encoder: per-head logits of bq
    (3, 89, 8, "heads+keys"),   # constraint encoder with key padding
    (6, 11, 4, "heads+keys"),   # FIDNet, Dh=64, every 3rd row fully masked
    (1, 1, 8, None),            # a single token
    (2, 97, 4, "keys"),         # a shared [B, S] bias, ragged tiles
    (2, 16, 8, "keys"),         # one query tile, a shared bias
    (2, 384, 8, "heads+keys"),  # bf16: the tensor-core route's largest S
    (2, 250, 4, "heads"),       # Dh=64 over two row groups (fp32 takes S <= 254 there)
    (2, 385, 8, "heads+keys"),  # bf16: past it, the CUDA-core kernel
    (1, 385, 8, "keys"),
])
def test_encoder_self_attention_kernel_matches_plain(dev, dtype, B, S, H, bias):
    g = torch.Generator(device=dev).manual_seed(S + H)
    E = 256
    x = torch.randn(B, S, E, generator=g, device=dev).to(dtype)
    wqkv = torch.randn(3 * E, E, generator=g, device=dev) * E**-0.5
    wqkv[:E] *= (E // H) ** -0.5
    wqkv = wqkv.to(dtype)
    kb = None
    if bias is not None:
        keep = torch.rand(B, S, generator=g, device=dev) > 0.3
        keep[::3] = False
        pad = torch.where(keep, 0.0, -1e9) if "keys" in bias else torch.zeros(B, S, device=dev)
        kb = pad[:, None, :] + torch.randn(B, H, S, generator=g, device=dev) if "heads" in bias \
            else pad
    n1, n6 = ea.encoder_attention.launches, ea.encoder_self_attention.launches
    out = ea.encoder_self_attention(x, wqkv, H, kb)
    assert (ea.encoder_attention.launches, ea.encoder_self_attention.launches) == (n1, n6 + 1)
    # bf16: q, k, v are rounded after fp32 sums in another order; one flipped
    # rounding of a p or a v moves an output by <= 2^-8 max_j |v_j|
    v_max = (x.float() @ wqkv[2 * E:].float().t()).abs().amax(dim=1, keepdim=True)
    extra = 2**-8 * v_max if dtype == torch.bfloat16 else 0.0
    _close(out, ea.encoder_self_attention_plain(x, wqkv, H, kb), dtype, extra=extra)


@pytest.mark.parametrize("dtype,S,route", [
    (torch.bfloat16, 1, "encoder_self_attention_rows_kernel"),
    (torch.bfloat16, 330, "encoder_self_attention_rows_kernel"),
    (torch.bfloat16, 385, "encoder_self_attention_kernel"),
    (torch.float32, 330, "encoder_self_attention_kernel"),
])
def test_encoder_self_attention_route(dev, dtype, S, route):
    """bf16 with S <= 384 runs the tensor-core kernel (the projection, then
    K1's rows route); fp32, and bf16 past 384, the CUDA-core one.  Either way
    one call is one kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(2, S, 256, device=dev).to(dtype)
    wqkv = (torch.randn(768, 256, device=dev) / 16).to(dtype)
    ea.encoder_self_attention(x, wqkv, 8)  # builds and loads the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ea.encoder_self_attention(x, wqkv, 8)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and f"{route}<" in kernels[0], kernels


@pytest.mark.parametrize("S", [330, 385])
def test_encoder_self_attention_alignment_follows_the_route(dev, S):
    """Only the tensor-core route (bf16, S <= 384) copies x and wqkv by 16-byte
    cp.async: there a view that starts 2 bytes off a 16-byte boundary is
    refused, and past 384 the CUDA-core kernel takes it."""
    g = torch.Generator(device=dev).manual_seed(S)
    B, E, H = 2, 256, 8
    x = torch.randn(B, S, E, generator=g, device=dev).bfloat16()
    wqkv = (torch.randn(3 * E, E, generator=g, device=dev) / 16).bfloat16()
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    if S <= ea.ROWS_MAX_S:
        with pytest.raises(ValueError, match="16-byte"):
            ea.encoder_self_attention(shifted, wqkv, H)
        return
    v_max = (x.float() @ wqkv[2 * E:].float().t()).abs().amax(dim=1, keepdim=True)
    _close(ea.encoder_self_attention(shifted, wqkv, H), ea.encoder_self_attention_plain(x, wqkv, H),
           torch.bfloat16, extra=2**-8 * v_max)


@pytest.mark.parametrize("dtype,S,Dh,fits", [  # the largest S of each route that fits, and one past
    (torch.bfloat16, 384, 64, True),
    (torch.bfloat16, 688, 32, True), (torch.bfloat16, 689, 32, False),
    (torch.float32, 437, 32, True), (torch.float32, 438, 32, False),
    (torch.float32, 254, 64, True), (torch.float32, 255, 64, False),
])
def test_encoder_self_attention_refuses_what_its_route_cannot_hold(dev, dtype, S, Dh, fits):
    """The wrapper asks the launcher for the shared memory of the route it
    takes, and refuses a shape past the 227 KB of a block before launching."""
    x = torch.zeros(1, S, 256, device=dev, dtype=dtype)
    wqkv = torch.zeros(768, 256, device=dev, dtype=dtype)
    if fits:
        assert bool(torch.isfinite(ea.encoder_self_attention(x, wqkv, 256 // Dh).float()).all())
    else:
        with pytest.raises(ValueError, match="227 KB"):
            ea.encoder_self_attention(x, wqkv, 256 // Dh)


@pytest.mark.parametrize("view", ["int8", "int16", "int32", "float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 680, 256), (1, 16), (5, 7, 3)])
def test_stream_sum_kernel_matches_plain(dev, view, shape):
    g = torch.Generator(device=dev).manual_seed(len(shape))
    slab = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    if view == "bfloat16":
        x = slab.bfloat16()
    elif view == "float32":  # bit 30 cleared: no NaN or Inf pattern
        x = (slab.reshape(shape[0], -1)[:, : slab[0].numel() // 4 * 4].contiguous()
             .view(torch.int32) & ~(1 << 30)).view(torch.float32)
    elif view in ("int16", "int32"):
        width = 2 if view == "int16" else 4
        x = slab.reshape(shape[0], -1)[:, : slab[0].numel() // width * width].contiguous()
        x = x.view(getattr(torch, view))
    else:
        x = slab
    n = ss.stream_sum.launches
    out = ss.stream_sum(x)
    assert ss.stream_sum.launches == n + 1
    torch.cuda.synchronize()
    ref = ss.stream_sum_plain(x)
    if view in ("int8", "bfloat16"):  # integer partial sums below 2^24: exact
        assert torch.equal(out, ref)
    else:
        scale = x.double().abs().reshape(shape[0], -1).sum(1)
        assert bool(((out.double() - ref.double()).abs() <= 1e-5 * scale + 1e-6).all())


def test_fused_encoder_flags_launch_k5_and_k6(dev):
    """use_qkv_folded sends self-attention through K6 (K1 untouched), a key
    bias included; use_pallas sends the FFN through K5 at S >= 16 only."""
    mha = tnn.MultiHeadAttention(256, 8, use_qkv_folded=True).to(dev).eval()
    ffn = tnn.FeedForward(256, 1024, use_pallas=True).to(dev).eval()
    x = torch.randn(4, 20, 256, device=dev)
    keep = torch.ones(4, 20, dtype=torch.bool, device=dev)
    keep[0, 5:] = False
    n1, n5, n6 = (ea.encoder_attention.launches, ef.fused_ffn.launches,
                  ea.encoder_self_attention.launches)
    with torch.inference_mode():
        out = mha(x, x, tnn.keep_to_bias(keep)[:, None, None, :])
        assert (ea.encoder_attention.launches, ea.encoder_self_attention.launches) == (n1, n6 + 1)
        mha.use_qkv_folded = False
        _close(out, mha(x, x, tnn.keep_to_bias(keep)[:, None, None, :]), torch.float32,
               extra=1e-4)  # the folded biases reassociate fp32 sums
        ffn(x)
        ffn(x[:, :8])
    assert ef.fused_ffn.launches == n5 + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# K2: empty, ragged, streamed slices; K3: empty, ragged, 512-token slices
@pytest.mark.parametrize("M", [1, 7, 8, 9, 31, 677, 680, 4096])
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


def test_decode_shared_attention_bf16_rounds_p_as_pallas(dev):
    """Card twin of the CPU test of that name: q_tilde sees only the first
    half of E, and the second half of the memory holds pairs of large tokens
    of opposite sign (+-32 u) with similar p, which cancel in the output.
    K2 stays within the bf16 tolerance of the plain version (held to Pallas
    on the CPU), which rounds the normalised p; the version that keeps p in
    fp32 misses by more than 0.01."""
    g = torch.Generator(device=dev).manual_seed(0)
    B, M, half = 2, 64, 128
    qt = torch.zeros(B, 8, 256, device=dev)
    qt[:, :, :half] = torch.randn(B, 8, half, generator=g, device=dev) * 0.05
    mem = torch.zeros(B, M, 256, device=dev)
    mem[:, :, :half] = torch.randn(B, M, half, generator=g, device=dev)
    u = 32.0 * torch.randn(B, M // 2, half, generator=g, device=dev)
    mem[:, 0::2, half:], mem[:, 1::2, half:] = u, -u
    qt, mem = qt.bfloat16(), mem.bfloat16()
    ref = da.decode_shared_attention_plain(qt, mem)
    _close(da.decode_shared_attention(qt, mem), ref, torch.bfloat16)
    p = torch.softmax(torch.einsum("bhe,bme->bhm", qt.float(), mem.float()), -1)
    fp32_p = torch.einsum("bhm,bme->bhe", p, mem.float()).bfloat16()
    atol, rtol = TOL[torch.bfloat16]
    excess = (fp32_p.float() - ref.float()).abs() - atol - rtol * ref.float().abs()
    assert float(excess.max()) > 0.01


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 5, 31, 677, 680, 765, 4096])  # empty .. 512-token slices
def test_q8mxu_kernel_matches_plain(dev, dtype, M):
    g = torch.Generator(device=dev).manual_seed(M + 1)
    qt = (torch.randn(6, 8, 256, generator=g, device=dev) / 16).to(dtype)
    mi, ms = da.quantize_shared_memory(torch.randn(6, M, 256, generator=g, device=dev))
    n = da.decode_shared_attention_q8mxu.launches
    out = da.decode_shared_attention_q8mxu(qt, mi, ms)
    assert da.decode_shared_attention_q8mxu.launches == n + 1
    ps = da.q8mxu_probs(qt, mi, ms)[1]  # [B, H, 1]: one flipped probability per output
    _close(out, da.decode_shared_attention_q8mxu_plain(qt, mi, ms), dtype, extra=ps)


def test_decode_shared_attention_q8_bf16_rounds_p_as_pallas(dev):
    """Card twin of the CPU test of that name, over the int8 memory: K3
    stays within the bf16 tolerance of the plain version, which rounds p * s
    after the global normalisation as the TPU kernel does; the version that
    keeps p * s in fp32 misses by more than 0.01."""
    g = torch.Generator(device=dev).manual_seed(0)
    B, M, half = 2, 64, 128
    qt = torch.zeros(B, 8, 256, device=dev)
    qt[:, :, :half] = torch.randn(B, 8, half, generator=g, device=dev) * 0.05
    mem = torch.zeros(B, M, 256, device=dev)
    mem[:, :, :half] = torch.randn(B, M, half, generator=g, device=dev)
    u = 32.0 * torch.randn(B, M // 2, half, generator=g, device=dev)
    mem[:, 0::2, half:], mem[:, 1::2, half:] = u, -u
    mi, ms = da.quantize_shared_memory(mem)
    qt = qt.bfloat16()
    ref = da.decode_shared_attention_q8_plain(qt, mi, ms)
    _close(da.decode_shared_attention_q8(qt, mi, ms), ref, torch.bfloat16)
    s = ms[:, None, :]
    p = torch.softmax(torch.einsum("bhe,bme->bhm", qt.float(), mi.float()) * s, -1)
    fp32_p = torch.einsum("bhm,bme->bhe", p * s, mi.float()).bfloat16()
    atol, rtol = TOL[torch.bfloat16]
    excess = (fp32_p.float() - ref.float()).abs() - atol - rtol * ref.float().abs()
    assert float(excess.max()) > 0.01


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q8mxu_call_is_one_kernel(dev, dtype):
    """K4 quantises the query inside the kernel: one wrapper call runs
    exactly one CUDA kernel (and no copy), counted by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(9)
    qt = (torch.randn(4, 8, 256, generator=g, device=dev) / 16).to(dtype)
    mi, ms = da.quantize_shared_memory(torch.randn(4, 680, 256, generator=g, device=dev))
    da.decode_shared_attention_q8mxu(qt, mi, ms)  # builds and loads the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        da.decode_shared_attention_q8mxu(qt, mi, ms)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "decode_shared_q8_cluster_kernel" in kernels[0], kernels


def test_quantisers_on_the_card_match_the_cpu_bit_for_bit(dev):
    """The absmax quantisers divide by 127 truly on the card too (as JAX and
    K4's kernel do): bf16 inputs put elements at amax / 2, where x / qs is an
    exact .5 tie that an ulp of qs would move.  quantize_per_token (the int8
    self caches) and quantize_kv (K8's caches) get such elements planted in
    every group they scale."""
    g = torch.Generator(device=dev).manual_seed(10)
    qt = (torch.randn(64, 8, 256, generator=g, device=dev) / 16).bfloat16()
    mem = torch.randn(64, 300, 256, generator=g, device=dev).bfloat16()
    for fn, x in ((da.quantize_q_tilde, qt), (da.quantize_shared_memory, mem)):
        for card, cpu in zip(fn(x), fn(x.cpu())):
            assert torch.equal(card.cpu(), cpu)

    def halves(x, dims):  # x with its second element along dims at amax / 2 (exact in bf16)
        x = x.clone()
        flat = x.movedim(dims, tuple(range(-len(dims), 0))).flatten(-len(dims))
        flat[..., 1] = flat.float().abs().amax(-1).div(2).to(x.dtype)
        return flat.unflatten(-1, [x.shape[d] for d in dims]).movedim(
            tuple(range(-len(dims), 0)), dims).contiguous()

    tok = halves(torch.randn(64, 8, 32, 1, generator=g, device=dev).bfloat16(), (2,))
    k_t, v_t = (halves(torch.randn(16, 8, 32, 300, generator=g, device=dev).bfloat16(), (2, 3))
                for _ in range(2))
    for card, cpu in ((tnn.quantize_per_token(tok), tnn.quantize_per_token(tok.cpu())),
                      (da.quantize_kv(k_t, v_t), da.quantize_kv(k_t.cpu(), v_t.cpu()))):
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)


def test_int8_cluster_kernels_reject_unaligned_memory(dev):
    qt = torch.randn(2, 8, 256, device=dev)
    mi, ms = da.quantize_shared_memory(torch.randn(2, 10, 256, device=dev))
    shifted = torch.empty(mi.numel() + 1, dtype=torch.int8, device=dev)[1:].view(2, 10, 256)
    shifted.copy_(mi)
    for kernel in (da.decode_shared_attention_q8, da.decode_shared_attention_q8mxu):
        with pytest.raises(ValueError, match="16-byte"):
            kernel(qt, shifted, ms)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# K8 reads 8-byte vectors where M allows (680, 4096), else single bytes (1, 5, 77, 300, 677)
@pytest.mark.parametrize("B,H,Dh,M", [(2, 8, 32, 1), (3, 8, 32, 677), (2, 4, 8, 300),
                                      (1, 8, 32, 680), (2, 4, 8, 5), (2, 8, 32, 4096),
                                      (1, 2, 256, 4096), (2, 3, 40, 77)])
def test_per_layer_decode_kernels_match_plain(dev, dtype, B, H, Dh, M):
    g = torch.Generator(device=dev).manual_seed(M + 2)
    q = torch.randn(B, H, Dh, generator=g, device=dev).to(dtype)
    k_t, v_t = (torch.randn(B, H, Dh, M, generator=g, device=dev).to(dtype) for _ in range(2))
    n7, n8 = da.decode_attention.launches, da.decode_attention_q8.launches
    _close(da.decode_attention(q, k_t, v_t), da.decode_attention_plain(q, k_t, v_t), dtype)
    cached = da.quantize_kv(k_t, v_t)
    _close(da.decode_attention_q8(q, *cached), da.decode_attention_q8_plain(q, *cached), dtype)
    assert (da.decode_attention.launches, da.decode_attention_q8.launches) == (n7 + 1, n8 + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [8, 32, 256])
def test_decode_attention_q8_call_is_one_kernel(dev, dtype, Dh):
    """K8 folds both scales itself: one wrapper call runs exactly one CUDA
    kernel (no cast, multiply or copy), counted by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(Dh)
    q = torch.randn(4, 8, Dh, generator=g, device=dev).to(dtype)
    cached = da.quantize_kv(*(torch.randn(4, 8, Dh, 680, generator=g, device=dev)
                              for _ in range(2)))
    da.decode_attention_q8(q, *cached)  # builds and loads the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = da.decode_attention_q8(q, *cached)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "decode_attention_q8_kernel" in kernels[0], kernels
    _close(out, da.decode_attention_q8_plain(q, *cached), dtype)


@pytest.mark.parametrize("shift", [1, 2, 4, 8])
def test_decode_attention_q8_takes_caches_at_any_alignment(dev, shift):
    """K8 reads 8-byte vectors where M and both caches' starts allow, else
    single bytes: at M=680 (a multiple of 8) caches that start `shift` bytes
    past a 16-byte boundary take 8-byte vectors at a shift of 8, and strided
    single bytes at 1, 2 and 4."""
    g = torch.Generator(device=dev).manual_seed(shift)
    q = torch.randn(3, 8, 32, generator=g, device=dev)
    k_i8, v_i8, ks, vs = da.quantize_kv(*(torch.randn(3, 8, 32, 680, generator=g, device=dev)
                                          for _ in range(2)))
    shifted = []
    for t in (k_i8, v_i8):
        buf = torch.empty(t.numel() + shift, dtype=torch.int8, device=dev)[shift:].view(t.shape)
        buf.copy_(t)
        shifted.append(buf)
    _close(da.decode_attention_q8(q, *shifted, ks, vs), da.decode_attention_q8_plain(q, k_i8, v_i8, ks, vs),
           torch.float32)


def test_kernel_wrappers_refuse_inputs_that_need_a_gradient(dev):
    """K2-K4 and K7-K10 are forward only, as their Pallas calls are (no VJP):
    on CUDA tensors each wrapper raises when grad is enabled and an input
    requires grad, instead of returning a tensor with no grad_fn; under
    no_grad it launches.  K1, K5 and K6 carry gradients instead (below)."""
    qt, mem = torch.randn(2, 8, 256, device=dev) / 16, torch.randn(2, 10, 256, device=dev)
    mi, ms = da.quantize_shared_memory(mem)
    qh, k_t = torch.randn(2, 8, 32, device=dev), torch.randn(2, 8, 32, 10, device=dev)
    calls = (  # the kernel and the argument that will require grad
        (lambda a: da.decode_shared_attention(a, mem), qt),
        (lambda a: da.decode_shared_attention_q8(a, mi, ms), qt),
        (lambda a: da.decode_shared_attention_q8mxu(a, mi, ms), qt),
        (lambda a: da.decode_attention(a, k_t, k_t), qh),
        (lambda a: da.decode_attention_q8(a, *da.quantize_kv(k_t, k_t)), qh),
        (ss.stream_sum, torch.randn(3, 16, device=dev)),
        (lambda a: xa.cross_attention(a, mem, mem, 8), qt),
    )
    for call, arg in calls:
        leaf = arg.clone().requires_grad_()
        with pytest.raises(RuntimeError, match="forward only"):
            call(leaf)
        with torch.no_grad():
            assert bool(torch.isfinite(call(leaf)).all())
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["encoder_attention", "fused_ffn", "encoder_self_attention"])
def test_k1_k5_k6_carry_gradients_through_their_function(dev, dtype, name):
    """K1, K5 and K6 are differentiable as JAX's custom_vjps make them: one
    kernel launch in the forward, and gradients equal to torch.autograd.grad
    of the plain version within the forward's tolerance taken against the
    sums each gradient adds up (chip_smoke.py's `plain_gradients`); K1's and
    K6's key_bias gets none.  Keys are masked but no row is fully masked,
    where the plain version and JAX's reference part ways (the CPU tests
    hold that row against JAX)."""
    import chip_smoke

    g = torch.Generator(device=dev).manual_seed(3)
    B, S, E, H, Fh = 4, 40, 256, 8, 1024

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    keep = torch.ones(B, S, dtype=torch.bool, device=dev)
    keep[0, 25:] = False
    keep[1, 1:] = False
    bias = tnn.keep_to_bias(keep).requires_grad_()
    kb = (rand(B, H, S) + tnn.keep_to_bias(keep)[:, None, :]).requires_grad_()
    if name == "encoder_attention":
        raw = [rand(B, S, E, scale=(E // H) ** -0.5), rand(B, S, E), rand(B, S, E)]
        function = lambda q, k, v: ea.encoder_attention(q, k, v, H, bias)  # noqa: E731
        key_bias = bias.detach()
    elif name == "fused_ffn":
        raw = [rand(B, S, E), rand(Fh, E, scale=E ** -0.5), rand(Fh),
               rand(E, Fh, scale=Fh ** -0.5), rand(E)]
        function, key_bias = ef.fused_ffn, None
    else:
        raw = [rand(B, S, E), rand(3 * E, E, scale=E ** -0.5)]
        function = lambda x, w: ea.encoder_self_attention(x, w, H, kb)  # noqa: E731
        key_bias = kb.detach()
    ins = [t.to(dtype).requires_grad_() for t in raw]
    counter = getattr(ef if name == "fused_ffn" else ea, name)
    n = counter.launches
    out = function(*ins)
    assert counter.launches == n + 1 and out.grad_fn is not None
    gout = rand(*out.shape).to(dtype)
    got = torch.autograd.grad(out, ins + ([bias] if name == "encoder_attention" else
                                          [kb] if name == "encoder_self_attention" else []),
                              gout, allow_unused=True)
    if name != "fused_ffn":
        assert got[-1] is None  # key_bias: no gradient, as JAX's VJP returns None
        got = got[:-1]
    want, allow = chip_smoke.plain_gradients(torch, name, ins, gout, H, key_bias)
    for a, b, tol in zip(got, want, allow):
        assert a.dtype == dtype and bool(torch.isfinite(a.float()).all())
        assert bool(((a.float() - b.float()).abs() <= tol).all())


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
        ea.encoder_attention(q, q, q, 2)  # Dh=128: K1 takes head widths up to 64
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
    with pytest.raises(ValueError, match="above 1024"):
        big = torch.randn(1, 1025, 256, device=dev)
        ea.encoder_attention(big, big, big, 8)


def test_new_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.randn(2, 20, 256, device=dev)
    w1, w2 = torch.randn(1024, 256, device=dev), torch.randn(256, 1024, device=dev)
    b1, b2 = torch.randn(1024, device=dev), torch.randn(256, device=dev)
    with pytest.raises(ValueError, match="E must be"):
        ef.fused_ffn(x[..., :96].contiguous(), w1[:, :96].contiguous(), b1,
                     w2[:96].contiguous(), b2[:96].contiguous())
    with pytest.raises(ValueError, match="E must be"):
        ef.fused_ffn(x, w1[:100].contiguous(), b1[:100].contiguous(), w2[:, :100].contiguous(), b2)
    with pytest.raises(TypeError):
        ef.fused_ffn(x.bfloat16(), w1, b1, w2, b2)
    with pytest.raises(TypeError):
        ef.fused_ffn(x.half(), w1.half(), b1, w2.half(), b2)
    with pytest.raises(ValueError, match="contiguous"):
        ef.fused_ffn(x, w2.t(), b1, w2, b2)
    with pytest.raises(ValueError):
        ef.fused_ffn(x, w1, b1, w2.cpu(), b2)
    wqkv = torch.randn(768, 256, device=dev)
    with pytest.raises(ValueError, match="wqkv"):
        ea.encoder_self_attention(x, wqkv[:512].contiguous(), 8)
    with pytest.raises(TypeError):
        ea.encoder_self_attention(x, wqkv.bfloat16(), 8)
    with pytest.raises(ValueError, match="head width"):
        ea.encoder_self_attention(x, wqkv, 16)
    with pytest.raises(ValueError, match="shared memory"):
        ea.encoder_self_attention(torch.randn(1, 600, 256, device=dev), wqkv, 8)
    with pytest.raises(ValueError, match="key_bias"):
        ea.encoder_self_attention(x, wqkv, 8, torch.zeros(2, 4, 20, device=dev))
    with pytest.raises(ValueError, match="key_bias"):
        ea.encoder_self_attention(x, wqkv, 8, torch.zeros(2, 20, device=dev).half())
    with pytest.raises(TypeError):
        ss.stream_sum(torch.zeros(4, 8, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        ss.stream_sum(torch.zeros(8, 4, device=dev).t())
    mem = torch.randn(2, 33, 256, device=dev)
    with pytest.raises(ValueError, match="head width"):
        xa.cross_attention(x, mem, mem, 2)  # Dh=128: K10 takes head widths up to 64
    with pytest.raises(ValueError, match=r"\[B, M, E\]"):
        xa.cross_attention(x, mem[:1].contiguous(), mem[:1].contiguous(), 8)
    with pytest.raises(TypeError):
        xa.cross_attention(x, mem.bfloat16(), mem.bfloat16(), 8)
    with pytest.raises(ValueError, match="key_bias"):
        xa.cross_attention(x, mem, mem, 8, torch.zeros(2, 20, device=dev))


# ---- K10: cross-attention over a memory of another length ---------------------


def _k10_extra(v, nhead, dtype):
    """K10's bf16 allowance: 2^-8 of the largest |v| of each (batch row, head)."""
    if dtype != torch.bfloat16:
        return 0.0
    B, M, E = v.shape
    vmax = v.float().reshape(B, M, nhead, E // nhead).abs().amax(dim=(1, 3))
    return 2**-8 * vmax[:, None, :, None].expand(B, 1, nhead, E // nhead).reshape(B, 1, E)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,M,E,H,mask", [
    (64, 50, 330, 256, 8, False),   # the denoising decoder's cross-attention: 5 tiles + 10 keys
    (64, 50, 330, 256, 8, True),    # with a key bias, row 0 masking every key
    (3, 50, 1, 256, 8, False),      # one key
    (3, 50, 7, 256, 8, True),       # one partial tile
    (2, 50, 64, 256, 8, False),     # exactly one tile
    (2, 50, 65, 256, 8, True),      # one key past a tile
    (2, 17, 700, 256, 8, True),     # past the ring's 3 stages
    (2, 130, 330, 256, 8, False),   # three query blocks, the last ragged
    (3, 50, 330, 256, 4, True),     # Dh=64
    (2, 10, 330, 200, 8, True),     # Dh=25: padded to 32, copied element by element
    (2, 51, 96, 256, 16, False),    # Dh=16: padded to 32
])
def test_cross_attention_kernel_matches_plain(dev, dtype, B, S, M, E, H, mask):
    g = torch.Generator(device=dev).manual_seed(M + S)
    q = torch.randn(B, S, E, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, M, E, generator=g, device=dev).to(dtype) for _ in range(2))
    bias = None
    if mask:
        keep = torch.rand(B, M, generator=g, device=dev) > 0.3
        keep[:, 0] = True
        keep[0] = False  # a row with no kept key: the mean of V
        bias = torch.where(keep, 0.0, -1e9).float()
    scale = (E // H) ** -0.5
    n = xa.cross_attention.launches
    out = xa.cross_attention(q, k, v, H, bias, scale)
    assert xa.cross_attention.launches == n + 1
    _close(out, xa.cross_attention_plain(q, k, v, H, bias, scale), dtype,
           extra=_k10_extra(v, H, dtype))
    if mask:
        mean = v[0].float().mean(0).expand(S, -1)
        _close(out[0], mean.to(dtype), dtype, extra=_k10_extra(v[:1], H, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_takes_operands_off_a_16_byte_boundary(dev, dtype):
    """q, k and v that start 2 elements into their storage: the bf16 kernel
    copies them element by element instead of by cp.async."""
    g = torch.Generator(device=dev).manual_seed(7)
    B, S, M, E, H = 3, 50, 330, 256, 8
    q, k, v = (torch.randn(B * n * E + 2, generator=g, device=dev).to(dtype)[2:]
               .view(B, n, E) for n in (S, M, M))
    out = xa.cross_attention(q, k, v, H, None, 32**-0.5)
    _close(out, xa.cross_attention_plain(q, k, v, H, None, 32**-0.5), dtype,
           extra=_k10_extra(v, H, dtype))


def test_cross_attention_in_bf16_keeps_the_logits_in_fp32(dev):
    """Logits that bf16 cannot hold apart (1000 + 0.25 j, from bf16 inputs
    that hold them exactly): K10 keeps them in fp32 and is within its
    tolerance of the plain version, whose logits are fp32 too; the einsum
    path, rounding the logits to bf16 (steps of 4 there) first, is not."""
    B, S, M, E, H = 2, 16, 40, 32, 1
    q = torch.zeros(B, S, E, device=dev)
    q[..., :2] = 1.0
    k = torch.zeros(B, M, E, device=dev)
    k[..., 0] = 1000.0
    k[..., 1] = 0.25 * torch.arange(M, device=dev)
    v = torch.randn(B, M, E, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    ref = xa.cross_attention_plain(q, k, v, H)
    _close(xa.cross_attention(q, k, v, H), ref, torch.bfloat16, extra=_k10_extra(v, H,
                                                                                  torch.bfloat16))
    logits = torch.einsum("bsd,bmd->bsm", q, k).float()  # the einsum path: bf16 logits
    einsum = torch.einsum("bsm,bmd->bsd", torch.softmax(logits, -1).bfloat16(), v)
    assert float((einsum.float() - ref.float()).abs().max()) > 0.05


def _layoutdm_bf16(dev):
    from ralf_tpu_torch.config import build_config, build_datasets, build_generator, build_tokenizer
    from ralf_tpu_torch.data.dataset import BatchLoader

    cfg = build_config("layoutdm", ["model.dtype=bfloat16", "synthetic_data=true",
                                    "allow_linear_fallback=true"])  # a test split of 64
    tok = build_tokenizer(cfg)
    _, _, test = build_datasets(cfg)
    loader = BatchLoader(test, 64, shuffle=False, transforms=cfg.transforms, use_native=False)
    return build_generator(cfg, tok, device="cuda"), next(iter(loader))


def test_layoutdm_request_runs_its_cross_attention_through_k10(dev, monkeypatch):
    """A LayoutDM request at the preset's sizes (bf16, 64 canvases): exactly
    300 K10 launches (6 layers x 50 steps), K1's 306 as before, no
    `attn.cross.plain`.  Its greedy chain against the einsum path's: from
    each of K10's states the einsum path's log-probabilities (the card's
    cross-attention sent to the einsum path, `on_card` patched false) put
    K10's next state within 2^-5 of their best, bf16's round-off of
    log-probabilities near 1 (K10's logits, fp32 where the einsum path's are
    bf16, move the sampled chain by such ties only)."""
    import numpy as np

    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.models import diffusion as tdiff
    from ralf_tpu_torch.utils import tracing

    gen, batch = _layoutdm_bf16(dev)
    greedy = SamplingConfig(name="deterministic", temperature=0.0)
    cond, _ = gen.build_condition(batch, np.random.default_rng(0), task="uncond")
    inner = tdiff.sample
    picks, gaps = [], []

    def chosen(lp, sampling, generator=None):  # K10's chain: record each pick
        picks.append(inner(lp, sampling, generator))
        return picks[-1]

    monkeypatch.setattr(tdiff, "sample", chosen)
    ea.encoder_attention.launches = xa.cross_attention.launches = 0
    with tracing.traced():
        toks = gen.sample(cond, greedy, return_tokens=True)[1]
        plain = tracing.counters().get("attn.cross.plain", 0)
    assert (xa.cross_attention.launches, ea.encoder_attention.launches, plain) == (300, 306, 0)

    def followed(lp, sampling, generator=None):  # the einsum path along K10's chain
        pick = picks[len(gaps)]
        gaps.append((lp.amax(-1) - lp.gather(-1, pick[..., None])[..., 0]).float())
        return pick

    monkeypatch.setattr(tdiff, "sample", followed)
    monkeypatch.setattr(tnn, "on_card", lambda t: False)
    n = xa.cross_attention.launches
    assert torch.equal(gen.sample(cond, greedy, return_tokens=True)[1], toks)
    assert xa.cross_attention.launches == n and len(gaps) == 50
    worst = float(torch.stack(gaps).max())
    print(f"K10 against the einsum path: widest gap {worst:.3e}, "
          f"{int((torch.stack(gaps) > 0).sum())} positions off the einsum path's best")
    assert worst <= 2**-5


# ---- K11: eval-mode BatchNorm, residual add and ReLU in one pass ------------------


def _bn_params(C, dtype, dev, seed):
    """weight, bias, running_mean, running_var [C] of a trained-looking
    BatchNorm, in `dtype`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w, b, m = (torch.randn(C, generator=g, device=dev) for _ in range(3))
    v = 0.5 + torch.rand(C, generator=g, device=dev)
    return tuple(t.to(dtype) for t in (1 + 0.2 * w, 0.2 * b, 0.3 * m, v))


def _nhwc(shape, dtype, dev, seed):
    N, C, H, W = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(N, H, W, C, generator=g, device=dev).to(dtype).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual,relu", [(False, False), (False, True), (True, False),
                                           (True, True)])
@pytest.mark.parametrize("shape", [
    (2, 64, 175, 120),   # the stem at 350x240
    (2, 64, 88, 60),     # layer1's bn1, bn2 (ResNet50); ResNet18's layer1
    (2, 256, 88, 60),    # layer1's bn3 and downsample
    (2, 128, 44, 30),    # layer2's bn1, bn2; ResNet18's layer2
    (2, 512, 44, 30),
    (2, 256, 22, 15),    # ResNet18's layer3
    (2, 1024, 22, 15),
    (2, 512, 11, 8),     # ResNet18's layer4
    (2, 2048, 11, 8),
    (3, 72, 5, 7),       # 9 vectors of bf16 a pixel: the channel group wraps unevenly
    (1, 8, 3, 5),        # one vector a pixel; 120 elements, a ragged part of one stride
])
def test_batchnorm_act_kernel_matches_plain(dev, dtype, residual, relu, shape):
    x = _nhwc(shape, dtype, dev, shape[1])
    r = _nhwc(shape, dtype, dev, shape[1] + 1) if residual else None
    params = _bn_params(shape[1], dtype, dev, 3)
    n = bna.batchnorm_act.launches
    out = bna.batchnorm_act(x, *params, 1e-5, r, relu)
    assert bna.batchnorm_act.launches == n + 1
    assert out.is_contiguous(memory_format=torch.channels_last)
    _close(out, bna.batchnorm_act_plain(x, *params, 1e-5, r, relu), dtype)


def test_batchnorm_act_reads_parameters_of_any_stored_dtype(dev):
    """bf16 activations with fp32 weight and bias and bf16 statistics (a
    module whose buffers were cast apart from its parameters)."""
    x, r = (_nhwc((2, 256, 9, 7), torch.bfloat16, dev, s) for s in (1, 2))
    w, b, m, v = _bn_params(256, torch.float32, dev, 4)
    params = (w, b, m.bfloat16(), v.bfloat16())
    _close(bna.batchnorm_act(x, *params, 1e-3, r, True),
           bna.batchnorm_act_plain(x, *params, 1e-3, r, True), torch.bfloat16)


def test_batchnorm_act_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x = _nhwc((2, 16, 5, 3), torch.float32, dev, 1)
    params = _bn_params(16, torch.float32, dev, 2)
    with pytest.raises(ValueError, match="channels_last"):
        bna.batchnorm_act(x.contiguous(), *params, 1e-5)  # NCHW storage
    with pytest.raises(ValueError, match="channels_last"):
        bna.batchnorm_act(x[:, :12], *_bn_params(12, torch.float32, dev, 2), 1e-5)
    with pytest.raises(ValueError, match="channels_last"):
        bna.batchnorm_act(x, *params, 1e-5, x.contiguous())  # an NCHW residual
    with pytest.raises(ValueError, match="channels_last"):
        bna.batchnorm_act(x, *params[:3], params[3][:8].contiguous(), 1e-5)
    with pytest.raises(TypeError):
        bna.batchnorm_act(x.half(), *params, 1e-5)
    off = torch.empty(2 * 16 * 5 * 3 + 2, device=dev)[2:].view(2, 5, 3, 16).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="16-byte"):
        bna.batchnorm_act(off, *params, 1e-5)  # 8 bytes past a 16-byte boundary
    with pytest.raises(RuntimeError, match="forward only"):
        bna.batchnorm_act(x.requires_grad_(), *params, 1e-5)


def _trained_looking_bn(module, seed):
    """BatchNorm statistics and affine parameters such as a trained ResNet's
    (each bottleneck's last BatchNorm small, so that the residual stream
    keeps its scale over 16 blocks in eval mode)."""
    from ralf_tpu_torch.models.resnet import BatchNorm

    g = torch.Generator().manual_seed(seed)
    for name, m in module.named_modules():
        if isinstance(m, BatchNorm):
            C = m.weight.shape[0]
            with torch.no_grad():
                m.weight.copy_((0.25 if name.endswith("bn3") else 1.0)
                               * (1 + 0.05 * torch.randn(C, generator=g)))
                m.bias.copy_(0.02 * torch.randn(C, generator=g))
                m.running_mean.copy_(0.05 * torch.randn(C, generator=g))
                m.running_var.copy_(1 + 0.1 * torch.randn(C, generator=g).abs())
    return module


@pytest.mark.parametrize("backbone,launches", [("resnet50", 53), ("resnet18", 20)])
def test_resnet_encoder_through_k11_against_the_plain_path(dev, monkeypatch, backbone, launches):
    """The ResNet-FPN encoder at 350x240 (batch 2, uint8 canvases) in eval
    mode under inference_mode: one K11 launch a BatchNorm (ResNet50 53,
    ResNet18 20), no `bn.eval.plain`.  Against the plain path (`on_card`
    patched false) on the same card and weights: in fp32 the two differ by
    K11's fused multiply-add alone (one rounding of 2^-24 a BatchNorm fewer),
    which the layers after carry: held to 1e-4 of the map's largest
    magnitude.  In bf16 the plain path rounds three times a BatchNorm where
    K11 rounds once, so K11's map is held to be no further from the fp32
    forward (normwise) than 1.25 times the plain path's."""
    import copy

    from ralf_tpu_torch.models import resnet
    from ralf_tpu_torch.utils import tracing

    enc32 = _trained_looking_bn(resnet.ResNetFPNEncoder(backbone, 256, "cgl"), 5).to(dev).eval()
    g = torch.Generator().manual_seed(6)
    img = torch.randint(0, 256, (2, 350, 240, 4), generator=g, dtype=torch.uint8).to(dev)
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        enc = enc32 if dtype == torch.float32 else copy.deepcopy(enc32).to(dtype)
        for route in ("kernel", "plain"):
            if route == "plain":
                monkeypatch.setattr(resnet, "on_card", lambda t: False)
            n = bna.batchnorm_act.launches
            with torch.inference_mode(), tracing.traced(), \
                    torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                outs[dtype, route] = enc(img).float()
                plain = tracing.counters().get("bn.eval.plain", 0)
            want = (launches, 0) if route == "kernel" else (0, launches)
            assert (bna.batchnorm_act.launches - n, plain) == want
            monkeypatch.undo()
    ref = outs[torch.float32, "plain"]
    err = (outs[torch.float32, "kernel"] - ref).abs().max()
    assert float(err) <= 1e-4 * float(ref.abs().max()), float(err)
    dist = {route: float((outs[torch.bfloat16, route] - ref).norm() / ref.norm())
            for route in ("kernel", "plain")}
    print(f"{backbone} bf16 against fp32, normwise: {dist}")
    assert dist["kernel"] <= 1.25 * dist["plain"]


def test_serving_generators_launch_k11_once_per_batchnorm(dev):
    """A request of RALF (its encode) and of LayoutDM (the whole sample) at
    the presets' sizes in bf16: 53 K11 launches, one a BatchNorm of the
    ResNet50 encoder, and no `bn.eval.plain`."""
    import numpy as np

    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer, TokenizerConfig
    from ralf_tpu_torch.data.dataset import BatchLoader, DatasetConfig, SyntheticPosterDataset
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.ralf import RALFGenerator
    from ralf_tpu_torch.retrieval.retriever import Retriever
    from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader
    from ralf_tpu_torch.utils import tracing

    tok = LayoutSequenceTokenizer(TokenizerConfig(num_labels=3, max_seq_length=10, num_bin=128))
    ralf = RALFGenerator(tok, GeneratorConfig(dtype=torch.bfloat16), "uncond", top_k=16,
                         device="cuda", seed=0)
    gallery = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=32, seed=1,
                                     image_hw=ralf.image_hw)
    retriever = Retriever.build(gallery, device="cuda")
    ds = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=8, seed=0,
                                image_hw=ralf.image_hw)
    batch = next(iter(RetrievalAugmentedLoader(
        BatchLoader(ds, 8, shuffle=False), retriever, top_k=16,
        feats_table=ralf.precompute_retrieved_feats(retriever.layouts))))
    layoutdm, dm_batch = _layoutdm_bf16(dev)
    runs = {
        "ralf": lambda: ralf.encode_memory(ralf.build_condition(batch, np.random.default_rng(0))[0]),
        "layoutdm": lambda: layoutdm.sample(
            layoutdm.build_condition(dm_batch, np.random.default_rng(0), task="uncond")[0],
            SamplingConfig(name="deterministic", temperature=0.0), return_tokens=True),
    }
    for name, run in runs.items():
        n = bna.batchnorm_act.launches
        with tracing.traced():
            run()
            plain = tracing.counters().get("bn.eval.plain", 0)
        assert (bna.batchnorm_act.launches - n, plain) == (53, 0), name


def test_train_step_launches_no_k11(dev, tmp_path):
    """A RALF train step on the card (fp32, ResNet50 with BatchNorm in train
    mode, batch 4) goes nowhere near K11."""
    import numpy as np

    from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer, TokenizerConfig
    from ralf_tpu_torch.data.dataset import BatchLoader, DatasetConfig, SyntheticPosterDataset
    from ralf_tpu_torch.models.base import GeneratorConfig
    from ralf_tpu_torch.models.ralf import RALFGenerator
    from ralf_tpu_torch.retrieval.retriever import Retriever
    from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader
    from ralf_tpu_torch.train.trainer import TrainConfig, Trainer

    tok = LayoutSequenceTokenizer(TokenizerConfig(num_labels=3, max_seq_length=10, num_bin=128))
    ds = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=64, seed=0)
    batch = next(iter(RetrievalAugmentedLoader(BatchLoader(ds, 4, shuffle=False),
                                               Retriever.build(ds, device="cpu"), 16,
                                               is_train_split=True)))
    gen = RALFGenerator(tok, GeneratorConfig(num_encoder_layers=1, num_decoder_layers=1),
                        "uncond", device="cuda", seed=0)
    trainer = Trainer(gen, TrainConfig(job_dir=str(tmp_path)))
    state = trainer.init_state()
    inputs, targets = gen.preprocess(batch, np.random.default_rng(0))
    n = bna.batchnorm_act.launches
    loss = float(trainer.train_step(state, inputs, targets)["loss"])
    assert np.isfinite(loss) and bna.batchnorm_act.launches == n


# ---- the evaluation metrics and the CLIs on the card --------------------------


def _metric_layout(B=64, S=10, seed=0):
    import numpy as np

    from ralf_tpu_torch.core.layout import Layout

    rng = np.random.default_rng(seed)
    n = rng.integers(0, S + 1, size=B)
    mask = np.arange(S)[None] < n[:, None]
    arrays = {"label": np.where(mask, rng.integers(0, 3, (B, S)), 0), "mask": mask}
    for k, lo, hi in (("center_x", -0.1, 1.1), ("center_y", -0.1, 1.1), ("width", 0.0, 0.7),
                      ("height", 0.0, 0.7)):
        arrays[k] = np.where(mask, rng.uniform(lo, hi, (B, S)), 0).astype(np.float32)
    return Layout.fromdict(arrays), rng.random((B, 70, 48, 4)).astype(np.float32)


def test_metrics_on_the_card_equal_the_cpu(dev):
    """Every metric of eval/metrics.py on CUDA tensors against the same call
    on the CPU: 1e-6 absolute (float32 sums in another order), rasters and
    validity masks exact."""
    from ralf_tpu_torch.core.layout import Layout
    from ralf_tpu_torch.eval import metrics as tm

    cpu, img = _metric_layout()
    card = Layout(**{k: getattr(cpu, k).to(dev) for k in ("label", "center_x", "center_y",
                                                          "width", "height", "mask")})
    img_c, img_d = torch.from_numpy(img), torch.from_numpy(img).to(dev)

    def same(a, b, atol=1e-6):
        a, b = a.cpu(), b.cpu()
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.allclose(a.nan_to_num(), b.nan_to_num(), atol=atol, rtol=0), \
            float((a.nan_to_num() - b.nan_to_num()).abs().max())

    for fn in (tm.compute_alignment, tm.compute_overlap):
        same(fn(card), fn(cpu))
    same(tm.compute_overlay(card, 2), tm.compute_overlay(cpu, 2))
    ue_d, ue_c = tm.compute_underlay_effectiveness(card, 2), tm.compute_underlay_effectiveness(cpu, 2)
    for k in ue_c:
        same(ue_d[k], ue_c[k])
    (fd, rd), (fc, rc) = tm.compute_validity(card), tm.compute_validity(cpu)
    assert float(rd) == float(rc)
    for k, a in fc.numpy().items():
        assert (fd.numpy()[k] == a).all(), k
    keep = cpu.mask & (cpu.label == 1)
    assert torch.equal(tm.pixel_box_mask(card, 70, 48, keep.to(dev)).cpu(),
                       tm.pixel_box_mask(cpu, 70, 48, keep))
    same(tm.sobel_gradient_map(img_d[..., :3]), tm.sobel_gradient_map(img_c[..., :3]), 1e-5)
    sd = tm.compute_saliency_aware_metrics(card, img_d, 1, 2)
    sc = tm.compute_saliency_aware_metrics(cpu, img_c, 1, 2)
    for k in sc:
        same(sd[k], sc[k])


def test_cli_inference_and_evaluate_on_the_card_equal_the_cpu(dev, tmp_path):
    """A small RALF job (the kernels' width: d_model 256, 8 heads; 1+1
    layers, resnet18, 96x64 canvases) in fp32 under deterministic sampling:
    the records of --device cuda (K1, K2) equal those of --device cpu (plain
    versions), and the scores agree within 1e-5 relative."""
    import json
    import pickle

    from ralf_tpu_torch.cli import evaluate, inference
    from ralf_tpu_torch.config import build_config, build_generator, build_tokenizer
    from ralf_tpu_torch.utils.weights import export_params, save_params_npz

    job = str(tmp_path / "job")
    cfg = build_config("ralf", [
        "model.d_model=256", "model.nhead=8", "model.num_encoder_layers=1",
        "model.num_decoder_layers=1", "model.dim_feedforward=512", "model.backbone=resnet18",
        "dataset.image_h=96", "dataset.image_w=64", "debug=true", "synthetic_data=true",
        "sampling.name=deterministic", "generator_kwargs.top_k=4",
        f"cache_dir={tmp_path / 'cache'}"])
    cfg.save(job)
    gen = build_generator(cfg, build_tokenizer(cfg), device="cpu")
    save_params_npz(f"{job}/ckpt_final.npz", *export_params(gen.core))
    counts = {}
    for d in ("cpu", "cuda"):
        ea.encoder_attention.launches = da.decode_shared_attention.launches = 0
        for cond in ("c", "uncond"):
            inference.main(["--job-dir", job, "--cond", cond, "--num-seeds", "1",
                            "--batch-size", "16", "--device", d, "--out-dir", f"{job}/{d}_{cond}"])
        counts[d] = (ea.encoder_attention.launches, da.decode_shared_attention.launches)
        evaluate.main(["--input-dir", f"{job}/{d}_c", "--job-dir", job, "--device", d,
                       "--cache-dir", f"{job}/eval_{d}"])
    assert counts["cpu"] == (0, 0) and min(counts["cuda"]) > 0, counts
    for cond in ("c", "uncond"):
        with open(f"{job}/cpu_{cond}/test_0.pkl", "rb") as f:
            want = pickle.load(f)
        with open(f"{job}/cuda_{cond}/test_0.pkl", "rb") as f:
            got = pickle.load(f)
        assert got == want, cond
    with open(f"{job}/cpu_c/scores_all.json") as f:
        want = json.load(f)
    with open(f"{job}/cuda_c/scores_all.json") as f:
        got = json.load(f)
    assert list(got) == list(want)
    for k in want:
        assert got[k]["mean"] == pytest.approx(want[k]["mean"], rel=1e-5, abs=1e-9), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,mask", [
    (128, 50, 8, False),  # the diffusion decoders' self-attention, a request of 128
    (2048, 11, 4, True),  # RA-LayoutDM's FIDNet over B*K = 128 * 16 retrieved layouts
])
def test_encoder_attention_at_the_zoo_shapes(dev, dtype, B, S, H, mask):
    """K1 at the zoo's new shapes against its plain version; in bf16 an element
    outside the tolerance passes only as one p rounded the other way near a
    bf16 midpoint (chip_smoke.py's `k1_one_flip`, ROADMAP.md Queue C 30)."""
    import chip_smoke

    g = torch.Generator(device=dev).manual_seed(B + S)
    q, k, v = (torch.randn(B, S, 256, generator=g, device=dev) for _ in range(3))
    q = (q * (256 // H) ** -0.5).to(dtype)
    k, v = k.to(dtype), v.to(dtype)
    bias = None
    if mask:
        keep = torch.rand(B, S, generator=g, device=dev) > 0.3
        keep[::3] = False
        bias = torch.where(keep, 0.0, -1e9).float()
    n = ea.encoder_attention.launches
    out = ea.encoder_attention(q, k, v, H, bias)
    assert ea.encoder_attention.launches == n + 1
    ref = ea.encoder_attention_plain(q, k, v, H, bias)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    outside = (out.float() - ref.float()).abs() > atol + rtol * ref.float().abs()
    if dtype == torch.bfloat16 and bool(outside.any()):
        explained, _ = chip_smoke.k1_one_flip(torch, q, k, v, H, bias)(out, outside)
        assert bool(explained.all()), int((~explained).sum())
    else:
        _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,E,H,mask", [
    (128, 330, 200, 8, False),  # ICVT's image encoder, a request of 128: Dh=25 padded to 32
    (3, 330, 200, 8, True),     # the same with key padding, a fully masked row
    (2, 400, 200, 8, False),    # bf16 past 384: the two-pass route, padded
    (3, 97, 192, 4, True),      # Dh=48 padded to 64, ragged tiles
    (2, 11, 40, 4, True),       # Dh=10
    (1, 1024, 200, 8, False),   # the largest S, padded
])
def test_encoder_attention_at_padded_head_widths(dev, dtype, B, S, E, H, mask):
    """K1 at head widths other than 32 and 64 (zero columns to the next of
    them): one launch, its plain version's output within the tolerance (in
    bf16, past it only as one flipped rounding of a p, `k1_one_flip`), on
    inputs that start at no 16-byte boundary (the padded route copies
    element by element)."""
    import chip_smoke

    g = torch.Generator(device=dev).manual_seed(B + S + E)
    q, k, v = (torch.randn(B * S * E + 1, generator=g, device=dev)[1:].view(B, S, E)
               for _ in range(3))
    q = (q * (E // H) ** -0.5).to(dtype)
    k, v = k.to(dtype), v.to(dtype)
    if dtype == torch.bfloat16:  # views one element into a buffer: 2 bytes off 16
        q, k, v = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(B, S, E) for t in (q, k, v))
        assert all(t.data_ptr() % 16 for t in (q, k, v))
    bias = None
    if mask:
        keep = torch.rand(B, S, generator=g, device=dev) > 0.3
        keep[::3] = False
        bias = torch.where(keep, 0.0, -1e9).float()
    n = ea.encoder_attention.launches
    out = ea.encoder_attention(q, k, v, H, bias)
    assert ea.encoder_attention.launches == n + 1
    ref = ea.encoder_attention_plain(q, k, v, H, bias)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    outside = (out.float() - ref.float()).abs() > atol + rtol * ref.float().abs()
    if dtype == torch.bfloat16 and bool(outside.any()):
        explained, _ = chip_smoke.k1_one_flip(torch, q, k, v, H, bias)(out, outside)
        assert bool(explained.all()), int((~explained).sum())
    else:
        _close(out, ref, dtype)
    if mask:  # row 0 keeps no key: the mean of V
        _close(out[0], v[0].float().mean(0).expand(S, -1).to(dtype), dtype)


@pytest.mark.parametrize("experiment", ["maskgit", "layoutdm", "vqdiffusion", "layoutdm_ra"])
def test_zoo_generator_on_the_card_equals_the_cpu(dev, experiment):
    """A narrow zoo model at the kernels' width (d_model 256, 8 heads; 1+1
    layers, resnet18, 96x64 canvases) in fp32 on the same weights and batch
    (RA-LayoutDM's top-16 retrieved once, on the CPU): memory within 1e-3
    (RA's with FIDNet over the neighbours, the adapter, cross-attention and
    fusion head), deterministic tokens of task c equal at a share >= 0.99,
    and on the card exactly its K1 launches (the image encoder's layer; for
    the diffusion models the decoder's self-attention at each of its 50
    steps; for RA-LayoutDM FIDNet's 4 layers)."""
    import numpy as np

    from ralf_tpu_torch.config import build_config, build_datasets, build_generator, build_tokenizer
    from ralf_tpu_torch.core.sampling import SamplingConfig
    from ralf_tpu_torch.data.dataset import BatchLoader
    from ralf_tpu_torch.retrieval.retriever import Retriever
    from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader

    cfg = build_config(experiment, [
        "model.d_model=256", "model.nhead=8", "model.num_encoder_layers=1",
        "model.num_decoder_layers=1", "model.backbone=resnet18", "dataset.image_h=96",
        "dataset.image_w=64", "debug=true", "synthetic_data=true", "allow_linear_fallback=true"])
    tok = build_tokenizer(cfg)
    train, _, test = build_datasets(cfg)
    loader = BatchLoader(test, 8, shuffle=False, transforms=cfg.transforms, use_native=False)
    with_retrieval = experiment == "layoutdm_ra"
    if with_retrieval:
        loader = RetrievalAugmentedLoader(loader, Retriever.build(train, device="cpu"), top_k=16)
    batch = next(iter(loader))
    greedy = SamplingConfig(name="deterministic", temperature=0.0)
    mems, toks = {}, {}
    for d in ("cpu", "cuda"):
        gen = build_generator(cfg, tok, device=d)
        cond, _ = gen.build_condition(batch, np.random.default_rng(0), task="c")
        with torch.inference_mode():
            if experiment == "maskgit":
                mems[d] = gen.encode_memory(cond).cpu()
            else:
                prepared = gen.prepare_sample(cond)
                mems[d] = gen.core.encode_memory(prepared["image"],
                                                 prepared.get("retrieved")).cpu()
        ea.encoder_attention.launches = 0
        toks[d] = gen.sample(cond, greedy, return_tokens=True)[1].cpu()
        launches = ea.encoder_attention.launches
    assert float((mems["cuda"] - mems["cpu"]).abs().max()) < 1e-3
    assert float((toks["cuda"] == toks["cpu"]).float().mean()) >= 0.99
    assert launches == 1 + (0 if experiment == "maskgit" else 50) + (4 if with_retrieval else 0)


def _lsa_costs(kind: str, B: int, n: int, g: torch.Generator, dev) -> torch.Tensor:
    if kind == "random":
        return torch.randn(B, n, n, generator=g, device=dev)
    if kind == "ties":  # small integers: ties in every row
        return torch.randint(0, 3, (B, n, n), generator=g, device=dev).float()
    if kind == "equal":
        return torch.full((B, n, n), 0.5, device=dev)
    # the matching's clamp: some costs at 1e5
    c = torch.randn(B, n, n, generator=g, device=dev)
    return torch.where(torch.rand(B, n, n, generator=g, device=dev) < 0.3, 1e5, c)


@pytest.mark.parametrize("kind", ["random", "ties", "equal", "clamped"])
@pytest.mark.parametrize("B,n", [(32, 10), (128, 10), (5, 1), (7, 32), (9, 17)])
def test_batched_lsa_kernel_equals_plain(dev, kind, B, n):
    g = torch.Generator(device=dev).manual_seed(B * n)
    cost = _lsa_costs(kind, B, n, g, dev)
    n0 = asg.batched_lsa.launches
    out = asg.batched_lsa(cost)
    torch.cuda.synchronize()
    assert asg.batched_lsa.launches == n0 + 1 and out.dtype == torch.int32
    assert torch.equal(out.cpu(), asg.batched_lsa_plain(cost.cpu()))
    assert torch.equal(out, asg.batched_lsa_plain(cost))
    assert bool((out.sort(dim=1).values == torch.arange(n, device=dev)).all())


def test_batched_lsa_kernel_refuses_more_than_32_columns(dev):
    with pytest.raises(ValueError, match="n <= 32"):
        asg.batched_lsa(torch.zeros(2, 33, 33, device=dev))
    with pytest.raises(TypeError, match="float32"):
        asg.batched_lsa(torch.zeros(2, 3, 3, device=dev, dtype=torch.float64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [11, 10])  # FIDNet's encoder (CLS + 10 elements), its decoder
def test_encoder_attention_at_fidnet_training_shapes(dev, dtype, S):
    """K1 as every FIDNet train step takes it: B=64, E=256, H=4 (Dh=64),
    the layouts' key mask (column 0 kept: the CLS token, or a layout's first
    element).  One launch; the forward against the plain version (bf16: an
    element outside the tolerance must be one flipped rounding of a p,
    chip_smoke.py's `k1_one_flip`); the gradients of q, k, v through the
    autograd.Function against autograd of the plain version within
    chip_smoke.py's `plain_gradients` allowance."""
    import chip_smoke

    g = torch.Generator(device=dev).manual_seed(S)
    B, E, H = 64, 256, 4
    q, k, v = (torch.randn(B, S, E, generator=g, device=dev) for _ in range(3))
    q, k, v = (q * (E // H) ** -0.5).to(dtype), k.to(dtype), v.to(dtype)
    keep = torch.rand(B, S, generator=g, device=dev) > 0.3
    keep[:, 0] = True
    bias = torch.where(keep, 0.0, -1e9)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    n = ea.encoder_attention.launches
    out = ea.encoder_attention(*ins, H, bias)
    assert ea.encoder_attention.launches == n + 1 and out.grad_fn is not None
    ref = ea.encoder_attention_plain(q, k, v, H, bias)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    outside = (out.detach().float() - ref.float()).abs() > atol + rtol * ref.float().abs()
    if dtype == torch.bfloat16 and bool(outside.any()):
        explained, _ = chip_smoke.k1_one_flip(torch, q, k, v, H, bias)(out.detach(), outside)
        assert bool(explained.all())
    else:
        assert not bool(outside.any())
    gout = torch.randn(out.shape, generator=g, device=dev).to(dtype)
    got = torch.autograd.grad(out, ins, gout)
    want, allow = chip_smoke.plain_gradients(torch, "encoder_attention", ins, gout, H, bias)
    for a, b, tol in zip(got, want, allow):
        assert a.dtype == dtype and bool(((a.float() - b.float()).abs() <= tol).all())


def test_fidnet_train_step_on_the_card_equals_the_cpu(dev):
    """One FIDNetTrainer step at batch 64 (fp32, full width) on the card and
    on the CPU from the same weights and draws: chip_smoke.py's
    `fid_step_check` (the loss and its terms within 1e-4, each subtree's
    update by cosine > 0.99 and norm ratio 0.97-1.03, 8 K1 launches)."""
    import chip_smoke

    from ralf_tpu_torch.data.dataset import BatchLoader, DatasetConfig, SyntheticPosterDataset

    ds = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=64, seed=0)
    batch = next(iter(BatchLoader(ds, 64, with_images=False, use_native=False, prefetch=0)))
    fails = chip_smoke.Failures()
    chip_smoke.fid_step_check(torch, fails, batch, 3, 10)
    assert not fails


def test_bf16_ralf_train_step_on_the_card_equals_the_cpu(dev, tmp_path):
    """One RALF train step at model.dtype=bfloat16 (fp32 parameters,
    autocast on both devices) at the kernels' width (d_model 256, 8 heads;
    1+1 layers, resnet18, batch 4): chip_smoke.py's `train_step_check` at
    bf16's tolerance (the loss within 1e-3, each subtree's update -- a
    subtree of fewer than 64 elements: its gradient -- by cosine >= 0.95 and
    norm ratio 0.9-1.1, BatchNorm's statistics' change), with every Linear's
    and Conv2d's output bf16 on both devices."""
    import chip_smoke

    from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer, TokenizerConfig

    tok = LayoutSequenceTokenizer(TokenizerConfig(num_labels=3, max_seq_length=10, num_bin=128))
    model = dict(d_model=256, nhead=8, num_encoder_layers=1, num_decoder_layers=1,
                 dim_feedforward=1024, backbone="resnet18")
    fails = chip_smoke.Failures()
    chip_smoke.train_step_check(torch, tok, fails, str(tmp_path), model, "bfloat16")
    assert not fails


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S", [
    (128, 676),  # RALF's pre_encoder fusion: the image encoder over [features, CA, ref], 2M+K
    (128, 346),  # post_encoder's modality encoder over [memory, ref], M+K
])
def test_encoder_attention_at_the_fusion_shapes(dev, dtype, B, S):
    """K1 at the fusion ablations' new lengths against its plain version (in
    bf16 S=676 runs the shared-memory route, past the rows route's 384); an
    element outside the tolerance passes only as one flipped rounding of a p
    (`chip_smoke.k1_one_flip`)."""
    import chip_smoke

    g = torch.Generator(device=dev).manual_seed(S)
    q, k, v = (torch.randn(B, S, 256, generator=g, device=dev) for _ in range(3))
    q = (q * 32**-0.5).to(dtype)
    k, v = k.to(dtype), v.to(dtype)
    n = ea.encoder_attention.launches
    out = ea.encoder_attention(q, k, v, 8, None)
    assert ea.encoder_attention.launches == n + 1
    ref = ea.encoder_attention_plain(q, k, v, 8, None)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    outside = (out.float() - ref.float()).abs() > atol + rtol * ref.float().abs()
    if dtype == torch.bfloat16 and bool(outside.any()):
        explained, _ = chip_smoke.k1_one_flip(torch, q, k, v, 8, None)(out, outside)
        assert bool(explained.all()), int((~explained).sum())
    else:
        _close(out, ref, dtype)


@pytest.mark.parametrize("kind", ["vgg", "inception", "clip", "dreamsim", "lpips_alex"])
def test_tower_on_the_card_equals_the_cpu(dev, kind, tmp_path):
    """Each feature tower at full size in fp32 (TF32 off) on the same random
    weights: card against CPU within 1e-4 of the largest magnitude, JAX's
    limit for its towers against torch twins."""
    import numpy as np

    from ralf_tpu_torch.models import towers
    from ralf_tpu_torch.retrieval import lpips

    torch.backends.cudnn.allow_tf32 = False
    canvases = np.random.default_rng(0).random((2, 350, 240, 4), dtype=np.float32)
    out = {}
    for d in ("cuda", "cpu"):
        if kind == "lpips_alex":
            embed, _ = lpips.make_lpips_fns(str(tmp_path), device=d)
            out[d] = [t.float().cpu() for t in embed(canvases)]
        else:
            out[d] = [towers.build_feature_fn(kind, str(tmp_path), d)(canvases).cpu()]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max() / b.abs().max().clamp_min(1e-8)) < 1e-4


@pytest.mark.parametrize("model,size", [("isnet", 512), ("basnet", 256)])
def test_saliency_net_on_the_card_equals_the_cpu(dev, model, size):
    """ISNet and BASNet in fp32 (TF32 off) on the same random weights (flax's
    laws, random BatchNorm statistics): the raw maps and every side output,
    card against CPU within 1e-4, the towers' limit."""
    import chip_smoke
    import numpy as np

    from ralf_tpu_torch.cli import saliency
    from ralf_tpu_torch.preprocess.saliency_models import basnet_preprocess, isnet_preprocess

    torch.backends.cudnn.allow_tf32 = False
    cpu = saliency.build_net(model, device="cpu")
    chip_smoke.randomize_bn(torch, cpu, 0)
    card = saliency.build_net(model, device="cuda")
    card.load_state_dict(cpu.state_dict())
    imgs = np.random.default_rng(0).random((2, size, size, 3), dtype=np.float32)
    want = saliency.raw_maps(cpu, model, imgs)
    got = saliency.raw_maps(card, model, imgs).cpu()
    assert got.shape == (2, size, size) and float(want.max() - want.min()) > 0.05
    assert float((got - want).abs().max()) < 1e-4
    x = (isnet_preprocess if model == "isnet" else basnet_preprocess)(imgs)
    x = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        sides = {"cpu": cpu(x, full=True), "cuda": card(x.cuda(), full=True)}
    flat = {d: [t.cpu() for t in (s[0] if model == "isnet" else s)] for d, s in sides.items()}
    for a, b in zip(flat["cuda"], flat["cpu"]):
        assert float((a - b).abs().max()) < 1e-4


def test_lama_on_the_card_equals_the_cpu(dev):
    """big-lama at full width in fp32 (TF32 off), random weights drawn to
    flax's laws, at 256x256 and at a canvas whose global branch is of odd
    size: card against CPU within 3e-4 (JAX's LaMa test's limit).  With
    random BatchNorm statistics too, the residual stream grows to about 1e5
    and fp32's own error against fp64 reaches 2e-4."""
    import numpy as np

    from ralf_tpu_torch.models.towers import seeded
    from ralf_tpu_torch.preprocess.lama import BIG_LAMA, LamaGenerator

    torch.backends.cudnn.allow_tf32 = False
    cpu = seeded(lambda: LamaGenerator(BIG_LAMA)).eval()
    card = LamaGenerator(BIG_LAMA).cuda().eval()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    for H, W in ((256, 256), (264, 200)):
        img = torch.from_numpy(rng.random((1, 3, H, W), dtype=np.float32))
        mask = torch.from_numpy((rng.random((1, 1, H, W)) > 0.7).astype(np.float32))
        with torch.inference_mode():
            want = cpu(img, mask)
            got = card(img.cuda(), mask.cuda()).cpu()
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) < 3e-4
