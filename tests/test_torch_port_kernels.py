"""The port's kernels K1-K9 against the JAX package's Pallas kernels, K10's
plain version and dispatch against the einsum path it replaces, and K11's
plain version and the eval-mode BatchNorm's dispatch against the unfused
sequence it replaces.

On the CPU each wrapper of `ralf_tpu_torch.ops` runs its plain PyTorch
version; here that version is held against the Pallas kernel run with
interpret=True on the same numpy inputs, in float32, to 1e-5, and K1, K2,
K3, K5 and K6 also in bfloat16 (where the TPU kernels round p, or K5's
hidden g, before the second dot).  K9, a probe outside the package, is held
against numpy's row sums.  The quantisers must agree exactly.  The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_port_cuda.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ralf_tpu.ops.pallas.decode_attention import (
    fused_decode_attention,
    fused_decode_attention_q8,
    fused_decode_shared_attention,
    fused_decode_shared_attention_q8,
    fused_decode_shared_attention_q8mxu,
    q8mxu_reference,
    quantize_kv as jax_quantize_kv,
    quantize_q_tilde as jax_quantize_q,
    quantize_shared_memory as jax_quantize,
)
from ralf_tpu.ops.pallas.encoder_attention import (
    fused_encoder_attention,
    fused_encoder_self_attention,
)
from ralf_tpu.ops.pallas.encoder_ffn import fused_ffn as jax_fused_ffn
from ralf_tpu_torch.models import nn as tnn
from ralf_tpu_torch.models import resnet
from ralf_tpu_torch.ops import batchnorm_act as bna
from ralf_tpu_torch.ops import cross_attention as xa
from ralf_tpu_torch.ops import decode_attention as da
from ralf_tpu_torch.ops import encoder_attention as ea
from ralf_tpu_torch.ops import encoder_ffn as ef
from ralf_tpu_torch.ops import stream_sum as ss
from ralf_tpu_torch.utils import tracing

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)  # fp32 on both sides; only the summation order differs


def _qkv(rng, B, S, E, nhead):
    q = rng.normal(size=(B, S, E)).astype(np.float32) * (E // nhead) ** -0.5
    k = rng.normal(size=(B, S, E)).astype(np.float32)
    v = rng.normal(size=(B, S, E)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,S,nhead,E,mask", [
    (3, 12, 4, 32, "none"),        # image-encoder style, Dh=8
    (2, 33, 8, 256, "none"),       # Dh=32 as on the main path
    (4, 11, 4, 256, "keys"),       # FIDNet style: CLS + 10 elements, Dh=64
    (5, 4, 8, 256, "dead_rows"),   # constraint-encoder style, rows with no kept key
])
def test_encoder_attention_plain_matches_pallas(B, S, nhead, E, mask):
    rng = np.random.default_rng(B * 100 + S)
    q, k, v = _qkv(rng, B, S, E, nhead)
    bias = None
    if mask != "none":
        keep = rng.random((B, S)) > 0.3
        keep[:, 0] = True
        if mask == "dead_rows":
            keep[1] = False
            keep[3] = False
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    ref = fused_encoder_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), nhead,
        None if bias is None else jnp.asarray(bias), interpret=True)
    out = ea.encoder_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), nhead,
        None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_encoder_attention_dead_row_is_mean_of_values():
    # A fully masked row attends uniformly over all S keys (the TPU kernel's
    # rule), even where |score| is large enough that adding -1e9 in fp32
    # would not round every logit to the same value.
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 6, 32, 4)
    q *= 500.0
    bias = np.zeros((2, 6), np.float32)
    bias[0] = -1e9
    out = ea.encoder_attention_plain(*map(torch.from_numpy, (q, k, v)), 4,
                                     torch.from_numpy(bias))
    np.testing.assert_allclose(out[0].numpy(), np.broadcast_to(v[0].mean(0), (6, 32)),
                               atol=1e-5)
    ref = fused_encoder_attention(*map(jnp.asarray, (q, k, v)), 4, jnp.asarray(bias),
                                  interpret=True)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref)[0], atol=1e-5)


@pytest.mark.parametrize("B,M", [(3, 20), (2, 77)])
def test_decode_shared_attention_plain_matches_pallas(B, M):
    rng = np.random.default_rng(M)
    qt = (rng.normal(size=(B, 8, 256)) / 16).astype(np.float32)
    mem = rng.normal(size=(B, M, 256)).astype(np.float32)
    ref = fused_decode_shared_attention(jnp.asarray(qt), jnp.asarray(mem), interpret=True)
    out = da.decode_shared_attention(torch.from_numpy(qt), torch.from_numpy(mem))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("B,M", [(3, 20), (2, 77)])
def test_decode_shared_attention_q8_plain_matches_pallas(B, M):
    rng = np.random.default_rng(M + 1)
    qt = (rng.normal(size=(B, 8, 256)) / 16).astype(np.float32)
    mem = rng.normal(size=(B, M, 256)).astype(np.float32)
    mi, ms = jax_quantize(jnp.asarray(mem))
    ref = fused_decode_shared_attention_q8(jnp.asarray(qt), mi, ms, interpret=True)
    out = da.decode_shared_attention_q8(
        torch.from_numpy(qt), torch.from_numpy(np.asarray(mi)), torch.from_numpy(np.asarray(ms)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _cancelling_pairs(seed, B=2, M=64, A=32.0):
    """q_tilde sees only the first half of E; the second half of the memory
    holds pairs of large tokens of opposite sign (+-A u) with similar p, which
    cancel in the output, so that the rounding of p shows."""
    rng = np.random.default_rng(seed)
    half = 128
    qt = np.zeros((B, 8, 256), np.float32)
    qt[:, :, :half] = rng.normal(size=(B, 8, half)) * 0.05
    mem = np.zeros((B, M, 256), np.float32)
    mem[:, :, :half] = rng.normal(size=(B, M, half))
    u = A * rng.normal(size=(B, M // 2, half))
    mem[:, 0::2, half:], mem[:, 1::2, half:] = u, -u
    return qt, mem


BF16_TOL = dict(atol=1e-3, rtol=2**-7)  # one rounding of the bf16 output


def _assert_bf16_close(out, ref, fp32_p_version):
    """out within BF16_TOL of the Pallas kernel; the version that keeps p in
    fp32 through the second dot is not (the check that the inputs test the
    rounding of p at all)."""
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, **BF16_TOL)
    excess = np.abs(fp32_p_version.float().numpy() - ref) - (
        BF16_TOL["atol"] + BF16_TOL["rtol"] * np.abs(ref))
    assert excess.max() > 0.01


def test_decode_shared_attention_bf16_rounds_p_as_pallas():
    qt, mem = _cancelling_pairs(0)
    tq, tm = torch.from_numpy(qt).bfloat16(), torch.from_numpy(mem).bfloat16()
    ref = fused_decode_shared_attention(jnp.asarray(qt, jnp.bfloat16),
                                        jnp.asarray(mem, jnp.bfloat16), interpret=True)
    memf = tm.float()
    p = torch.softmax(torch.einsum("bhe,bme->bhm", tq.float(), memf), -1)
    fp32_p = torch.einsum("bhm,bme->bhe", p, memf).bfloat16()
    _assert_bf16_close(da.decode_shared_attention(tq, tm), ref, fp32_p)


def test_decode_shared_attention_q8_bf16_rounds_p_as_pallas():
    qt, mem = _cancelling_pairs(0)
    mi, ms = jax_quantize(jnp.asarray(mem))
    tq = torch.from_numpy(qt).bfloat16()
    tmi, tms = torch.from_numpy(np.asarray(mi)), torch.from_numpy(np.array(ms))
    ref = fused_decode_shared_attention_q8(jnp.asarray(qt, jnp.bfloat16), mi, ms, interpret=True)
    s = tms[:, None, :]
    p = torch.softmax(torch.einsum("bhe,bme->bhm", tq.float(), tmi.float()) * s, -1)
    fp32_p = torch.einsum("bhm,bme->bhe", p * s, tmi.float()).bfloat16()
    _assert_bf16_close(da.decode_shared_attention_q8(tq, tmi, tms), ref, fp32_p)


@pytest.mark.parametrize("B,M", [(3, 20), (2, 77)])
def test_decode_shared_attention_q8mxu_plain_matches_pallas(B, M):
    """K4's plain version (the port of q8mxu_reference) against the Pallas
    kernel and the reference.  The int32 dot products are exact on both
    sides; these inputs round no p2 * 127 / ps differently, so 1e-5 holds
    (one such flip could move an output by up to ps)."""
    rng = np.random.default_rng(M + 2)
    qt = (rng.normal(size=(B, 8, 256)) / 16).astype(np.float32)
    mem = rng.normal(size=(B, M, 256)).astype(np.float32)
    mi, ms = jax_quantize(jnp.asarray(mem))
    out = da.decode_shared_attention_q8mxu(
        torch.from_numpy(qt), torch.from_numpy(np.asarray(mi)), torch.from_numpy(np.array(ms)))
    for ref in (fused_decode_shared_attention_q8mxu(jnp.asarray(qt), mi, ms, interpret=True),
                q8mxu_reference(jnp.asarray(qt), mi, ms)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("B,H,Dh,M", [(3, 4, 8, 20), (2, 8, 32, 77)])
def test_decode_attention_plain_matches_pallas(B, H, Dh, M):
    rng = np.random.default_rng(M + 3)
    q = rng.normal(size=(B, H, Dh)).astype(np.float32)
    k_t, v_t = (rng.normal(size=(B, H, Dh, M)).astype(np.float32) for _ in range(2))
    ref = fused_decode_attention(*map(jnp.asarray, (q, k_t, v_t)), interpret=True)
    out = da.decode_attention(*map(torch.from_numpy, (q, k_t, v_t)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("B,H,Dh,M", [(3, 4, 8, 20), (2, 8, 32, 77)])
def test_decode_attention_q8_plain_matches_pallas(B, H, Dh, M):
    rng = np.random.default_rng(M + 4)
    q = rng.normal(size=(B, H, Dh)).astype(np.float32)
    k_t, v_t = (rng.normal(size=(B, H, Dh, M)).astype(np.float32) for _ in range(2))
    cached = jax_quantize_kv(jnp.asarray(k_t), jnp.asarray(v_t))
    ref = fused_decode_attention_q8(jnp.asarray(q), *cached, interpret=True)
    out = da.decode_attention_q8(torch.from_numpy(q), *(torch.from_numpy(np.array(a))
                                                        for a in cached))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_quantize_kv_and_q_tilde_match_exactly():
    rng = np.random.default_rng(6)
    k_t, v_t = ((rng.normal(size=(3, 4, 8, 21)) * rng.uniform(0.01, 5, size=(3, 4, 1, 1)))
                .astype(np.float32) for _ in range(2))
    k_t[0, 0] = 0.0  # an all-zero head takes the 1e-8 floor
    for t, j in zip(da.quantize_kv(torch.from_numpy(k_t), torch.from_numpy(v_t)),
                    jax_quantize_kv(jnp.asarray(k_t), jnp.asarray(v_t))):
        assert t.dtype == (torch.int8 if t.dim() == 4 else torch.float32)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    qt = (rng.normal(size=(3, 8, 256)) * rng.uniform(0.01, 5, size=(3, 8, 1))).astype(np.float32)
    qt[1, 2] = 0.0
    for t, j in zip(da.quantize_q_tilde(torch.from_numpy(qt)), jax_quantize_q(jnp.asarray(qt))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_quantize_shared_memory_matches_exactly():
    rng = np.random.default_rng(3)
    mem = (rng.normal(size=(3, 41, 256)) * rng.uniform(0.01, 5, size=(3, 41, 1))).astype(np.float32)
    mem[0, 0] = 0.0  # an all-zero token takes the 1e-8 floor
    mi_j, s_j = jax_quantize(jnp.asarray(mem))
    mi_t, s_t = da.quantize_shared_memory(torch.from_numpy(mem))
    assert mi_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(mi_t.numpy(), np.asarray(mi_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_encoder_attention_bf16_rounds_p_as_pallas():
    """Keys in near-equal pairs whose values cancel (+-32 u): the rounding
    of the normalised p shows in the output."""
    rng = np.random.default_rng(0)
    B, S, E, H = 2, 64, 256, 8
    q = rng.normal(size=(B, S, E)).astype(np.float32) * 0.5
    k = rng.normal(size=(B, S, E)).astype(np.float32)
    k[:, 1::2] = k[:, 0::2] + 0.05 * rng.normal(size=(B, S // 2, E))
    u = 32.0 * rng.normal(size=(B, S // 2, E))
    v = np.zeros((B, S, E), np.float32)
    v[:, 0::2], v[:, 1::2] = u, -u
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    ref = fused_encoder_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), H,
                                  interpret=True)
    qh, kh, vh = (t.float().reshape(B, S, H, E // H) for t in (tq, tk, tv))
    p = torch.softmax(torch.einsum("bshd,bmhd->bhsm", qh, kh), -1)
    fp32_p = torch.einsum("bhsm,bmhd->bshd", p, vh).reshape(B, S, E).bfloat16()
    _assert_bf16_close(ea.encoder_attention(tq, tk, tv, H), ref, fp32_p)


def _ffn_inputs(dtype_name, B=3, S=20, E=32, F=64):
    """Weights and inputs on a coarse binary grid, so that h = x W1 is
    exact in fp32 whatever the order of the sums.  In bf16 the hidden units
    come in pairs f, f + F/2 with near-equal W1 rows, equal b1 and opposite
    W2 columns (+-32): the outputs are differences of near-equal g, where
    the rounding of g shows."""
    rng = np.random.default_rng(7)
    x = rng.integers(-8, 9, size=(B, S, E)) / 4.0
    w1 = rng.integers(-8, 9, size=(F, E)) / 8.0
    b1 = rng.integers(-16, 17, size=F) / 4.0
    w2 = rng.integers(-8, 9, size=(E, F)) / 64.0
    b2 = rng.integers(-8, 9, size=E) / 8.0
    if dtype_name == "bfloat16":
        half = F // 2
        w1[half:] = w1[:half] + (rng.random((half, E)) < 0.1) * rng.integers(-2, 3, (half, E)) / 8
        b1[half:] = b1[:half]
        w2[:, :half] = rng.integers(-8, 9, size=(E, half)) * 4.0
        w2[:, half:] = -w2[:, :half]
    return [a.astype(np.float32) for a in (x, w1, b1, w2, b2)]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_fused_ffn_plain_matches_pallas(dtype_name):
    x, w1, b1, w2, b2 = _ffn_inputs(dtype_name)
    jd, td = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    ref = jax_fused_ffn(jnp.asarray(x, jd), jnp.asarray(w1.T, jd), jnp.asarray(b1),
                        jnp.asarray(w2.T, jd), jnp.asarray(b2), interpret=True)
    tx, tw1, tb1, tw2, tb2 = (torch.from_numpy(a).to(td) for a in (x, w1, b1, w2, b2))
    out = ef.fused_ffn(tx, tw1, tb1, tw2, tb2)
    assert out.dtype == td
    if dtype_name == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        return
    # relu(x W1 + b1) W2 + b2 with g kept in fp32 agrees only in fp32
    g = torch.relu(tx.float() @ tw1.float().t() + tb1.float())
    unrounded_g = (g @ tw2.float().t() + tb2.float()).bfloat16()
    _assert_bf16_close(out, ref, unrounded_g)


def test_fused_ffn_bf16_with_fp32_biases_off_the_grid():
    """bf16 x and weights with fp32 biases between two bf16 values, as the
    JAX module passes its parameters: the kernel compares h with T(-b1)
    (harmless, rounding is monotone: T(max(h, a)) = max(T(h), T(a))) and
    the tail b1 W2 + b2 takes b1 as given, in fp32."""
    x, w1, b1, w2, b2 = _ffn_inputs("float32")
    b1 = b1 + 1.0 / 1024  # off the bf16 grid
    ref = jax_fused_ffn(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w1.T)), jnp.asarray(b1),
                        jnp.asarray(w2.T, jnp.bfloat16), jnp.asarray(b2), interpret=True)
    out = ef.fused_ffn_plain(*(torch.from_numpy(a).bfloat16() for a in (x, w1)),
                             torch.from_numpy(b1), torch.from_numpy(w2).bfloat16(),
                             torch.from_numpy(b2))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               **BF16_TOL)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Dh,S", [(4, 8, 12), (8, 32, 33), (4, 64, 11)])
def test_encoder_self_attention_plain_matches_pallas(dtype_name, H, Dh, S):
    """Per-head real-valued logits plus key padding, with one batch row
    fully masked (uniform attention), at Dh 8, 32 and 64."""
    rng = np.random.default_rng(S + Dh)
    B, E = 4, H * Dh
    x = rng.normal(size=(B, S, E)).astype(np.float32)
    wqkv = (rng.normal(size=(3 * E, E)) * E**-0.5).astype(np.float32)
    wqkv[:E] *= Dh**-0.5  # the softmax scale folded into Wq
    keep = rng.random((B, S)) > 0.3
    keep[:, 0] = True
    keep[2] = False
    bias = (rng.normal(size=(B, H, S)) + np.where(keep, 0.0, -1e9)[:, None, :]).astype(np.float32)
    jd, td = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    for kb in (None, bias, bias[:, 0]):
        ref = fused_encoder_self_attention(jnp.asarray(x, jd), jnp.asarray(wqkv.T, jd), H,
                                           None if kb is None else jnp.asarray(kb),
                                           interpret=True)
        out = ea.encoder_self_attention(torch.from_numpy(x).to(td), torch.from_numpy(wqkv).to(td),
                                        H, None if kb is None else torch.from_numpy(kb))
        assert out.dtype == td
        tol = TOL if dtype_name == "float32" else BF16_TOL
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), **tol)


def test_stream_sum_plain_matches_numpy_on_every_view():
    """The probe's views of one int8 slab: int16, int32, the f32 view with
    bit 30 cleared (no NaN or Inf pattern), and the bf16 copy."""
    rng = np.random.default_rng(8)
    slab = rng.integers(-127, 128, size=(5, 6, 16)).astype(np.int8)
    words = slab.view(np.int32) & np.int32(~(1 << 30))
    views = [slab, slab.view(np.int16), slab.view(np.int32), words.view(np.float32)]
    for a in views:
        ref = a.astype(np.float64).reshape(5, -1).sum(1)
        out = ss.stream_sum(torch.from_numpy(a))
        assert out.dtype == torch.float32 and out.shape == (5,)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    bf = torch.from_numpy(slab).bfloat16()  # int8 values are exact in bf16
    np.testing.assert_array_equal(ss.stream_sum(bf).numpy(), slab.reshape(5, -1).sum(1))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(4)
    q, k, v = map(torch.from_numpy, _qkv(rng, 2, 5, 64, 2))
    qt = torch.from_numpy((rng.normal(size=(2, 8, 256)) / 16).astype(np.float32))
    mem = torch.from_numpy(rng.normal(size=(2, 9, 256)).astype(np.float32))
    mi, ms = da.quantize_shared_memory(mem)
    qh = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    k_t, v_t = (torch.from_numpy(rng.normal(size=(2, 4, 8, 9)).astype(np.float32))
                for _ in range(2))
    cached = da.quantize_kv(k_t, v_t)
    x = q[..., :32].contiguous()
    wqkv = torch.from_numpy(rng.normal(size=(96, 32)).astype(np.float32))
    w1, w2 = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((64, 32), (32, 64)))
    b1, b2 = torch.zeros(64), torch.ones(32)
    counters = (ea.encoder_attention, ea.encoder_self_attention, ef.fused_ffn,
                da.decode_shared_attention, da.decode_shared_attention_q8,
                da.decode_shared_attention_q8mxu, da.decode_attention, da.decode_attention_q8,
                ss.stream_sum)
    before = [c.launches for c in counters]
    for kernel, plain, args in (
        (ea.encoder_attention, ea.encoder_attention_plain, (q, k, v, 2)),
        (ea.encoder_self_attention, ea.encoder_self_attention_plain, (x, wqkv, 4)),
        (ef.fused_ffn, ef.fused_ffn_plain, (x, w1, b1, w2, b2)),
        (ss.stream_sum, ss.stream_sum_plain, (mi,)),
        (da.decode_shared_attention, da.decode_shared_attention_plain, (qt, mem)),
        (da.decode_shared_attention_q8, da.decode_shared_attention_q8_plain, (qt, mi, ms)),
        (da.decode_shared_attention_q8mxu, da.decode_shared_attention_q8mxu_plain, (qt, mi, ms)),
        (da.decode_attention, da.decode_attention_plain, (qh, k_t, v_t)),
        (da.decode_attention_q8, da.decode_attention_q8_plain, (qh, *cached)),
    ):
        torch.testing.assert_close(kernel(*args), plain(*args), rtol=0, atol=0)
    assert before == [c.launches for c in counters] == [0] * len(counters)


def test_plain_versions_keep_the_input_dtype():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(rng, 2, 7, 64, 2))
    assert ea.encoder_attention(q, k, v, 2).dtype == torch.bfloat16
    wqkv = torch.from_numpy(rng.normal(size=(192, 64)).astype(np.float32)).bfloat16()
    assert ea.encoder_self_attention(q, wqkv, 2).dtype == torch.bfloat16
    w1 = torch.from_numpy(rng.normal(size=(128, 64)).astype(np.float32)).bfloat16()
    w2 = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32)).bfloat16()
    assert ef.fused_ffn(q, w1, w1[:, 0], w2, w2[:, 0]).dtype == torch.bfloat16
    qt = torch.from_numpy((rng.normal(size=(2, 8, 256)) / 16).astype(np.float32)).bfloat16()
    mem = torch.from_numpy(rng.normal(size=(2, 9, 256)).astype(np.float32))
    assert da.decode_shared_attention(qt, mem.bfloat16()).dtype == torch.bfloat16
    mi, ms = da.quantize_shared_memory(mem)
    assert da.decode_shared_attention_q8(qt, mi, ms).dtype == torch.bfloat16
    assert da.decode_shared_attention_q8mxu(qt, mi, ms).dtype == torch.bfloat16
    qh = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32)).bfloat16()
    k_t = torch.from_numpy(rng.normal(size=(2, 4, 8, 9)).astype(np.float32)).bfloat16()
    assert da.decode_attention(qh, k_t, k_t).dtype == torch.bfloat16
    assert da.decode_attention_q8(qh, *da.quantize_kv(k_t, k_t)).dtype == torch.bfloat16


def test_q8mxu_probs_equal_the_reference_on_rounding_ties():
    """K4's quantised probabilities pi = round(p2 * (127 / ps)) equal
    q8mxu_reference's bit for bit where p2 * 127 / ps lands on k + 0.5: a
    zero query makes every score 0, so p = 1/M exactly (M a power of two)
    on both sides, and per-token scales s = top * (k + 0.5) / 127 with the
    row's largest s = top (3, 5, 6, 7 or 11) make ps = top / M, whose
    reciprocal is inexact.  127 / ps must be divided, as the reference does:
    a reciprocal times 127 flips thousands of these roundings."""
    rng = np.random.default_rng(14)
    B, M = 4, 1024
    qt = np.zeros((B, 8, 256), np.float32)
    mem_i8 = rng.integers(-127, 128, size=(B, M, 256)).astype(np.int8)
    top = rng.choice([3.0, 5.0, 6.0, 7.0, 11.0], size=(B, 1)).astype(np.float32)
    ms = (top * (rng.integers(0, 127, size=(B, M)) + 0.5) / np.float32(127)).astype(np.float32)
    ms[:, 0] = top[:, 0]

    @jax.jit
    def reference_pi(q, mem, s):  # q8mxu_reference's lines up to its quantised p
        qi, qs = jax_quantize_q(q)
        scores = jnp.einsum("bhe,bme->bhm", qi.astype(jnp.int32),
                            mem.astype(jnp.int32)).astype(jnp.float32)
        p2 = jax.nn.softmax(scores * qs[:, :, None] * s[:, None, :], axis=-1) * s[:, None, :]
        ps = jnp.maximum(jnp.max(jnp.abs(p2), axis=-1, keepdims=True), 1e-30)
        return jnp.clip(jnp.round(p2 * (127.0 / ps)), -127, 127), ps, p2

    ref_pi, ref_ps, p2 = (np.asarray(a) for a in reference_pi(qt, mem_i8, ms))
    assert (np.abs(p2 * (np.float32(127) / ref_ps)) % 1 == 0.5).sum() > 10000  # the ties
    pi, ps = da.q8mxu_probs(*(torch.from_numpy(a) for a in (qt, mem_i8, ms)))
    np.testing.assert_array_equal(ps.numpy(), ref_ps)
    np.testing.assert_array_equal(pi.numpy(), ref_pi)
    by_reciprocal = np.clip(np.round(p2 * (np.float32(1) / ref_ps * np.float32(127))), -127, 127)
    assert (by_reciprocal != ref_pi).sum() > 1000  # the ties do decide


def test_plain_versions_carry_the_gradients_of_the_jax_kernels():
    """On CPU tensors the wrappers run their plain versions: K1's, K5's and
    K6's gradients, through the backward they take on the card too, equal
    those of the JAX kernels' custom_vjps, which recompute through their
    XLA references, in fp32; K2, K3, K7 and K8, forward only on the card,
    give finite, nonzero gradients to their float inputs on the CPU."""
    rng = np.random.default_rng(15)
    B, S, E, H = 2, 9, 64, 2
    x, q, k, v, cot = (rng.normal(size=(B, S, E)).astype(np.float32) for _ in range(5))
    wqkv = (rng.normal(size=(3 * E, E)) * E**-0.5).astype(np.float32)
    w1, w2 = ((rng.normal(size=s) * 0.2).astype(np.float32) for s in ((128, E), (E, 128)))
    b1, b2 = rng.normal(size=128).astype(np.float32), rng.normal(size=E).astype(np.float32)

    def grads(torch_fn, jax_fn, arrays):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
        (torch_fn(*ts) * torch.from_numpy(cot)).sum().backward()
        ref = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * cot), argnums=tuple(range(len(arrays))))(
            *map(jnp.asarray, arrays))
        for t, r in zip(ts, ref):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)

    grads(lambda q, k, v: ea.encoder_attention(q, k, v, H),
          lambda q, k, v: fused_encoder_attention(q, k, v, H, interpret=True), (q, k, v))
    grads(lambda x, w: ea.encoder_self_attention(x, w, H),
          lambda x, w: fused_encoder_self_attention(x, w.T, H, interpret=True), (x, wqkv))
    grads(ef.fused_ffn,
          lambda x, w1, b1, w2, b2: jax_fused_ffn(x, w1.T, b1, w2.T, b2, interpret=True),
          (x, w1, b1, w2, b2))

    qt = torch.from_numpy((rng.normal(size=(2, 8, 256)) / 16).astype(np.float32))
    mem = torch.from_numpy(rng.normal(size=(2, 9, 256)).astype(np.float32))
    mi, ms = da.quantize_shared_memory(mem)
    qh = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    k_t, v_t = (torch.from_numpy(rng.normal(size=(2, 4, 8, 9)).astype(np.float32))
                for _ in range(2))
    for fn, args in ((da.decode_shared_attention, (qt, mem)),
                     (da.decode_shared_attention_q8, (qt, mi, ms)),
                     (da.decode_attention, (qh, k_t, v_t)),
                     (da.decode_attention_q8, (qh, *da.quantize_kv(k_t, v_t)))):
        leaves = [a.clone().requires_grad_() if a.is_floating_point() else a for a in args]
        fn(*leaves).square().sum().backward()
        for a in leaves:
            if a.requires_grad:
                assert bool(torch.isfinite(a.grad).all()) and float(a.grad.abs().max()) > 0


# ---- K10: cross-attention over a memory of another length (no Pallas kernel) ----


def _cross_inputs(seed, B, S, M, E=256, nhead=8, bias=False):
    """A module in eval mode, q_in [B, S, E], its k, v [B, M, H, Dh] and a
    key-padding bias [B, 1, 1, M] (every row keeps a key; row 1 none)."""
    torch.manual_seed(seed)
    mha = tnn.MultiHeadAttention(E, nhead).eval()
    g = torch.Generator().manual_seed(seed)
    q_in = torch.randn(B, S, E, generator=g)
    k, v = mha.project_kv(torch.randn(B, M, E, generator=g))
    key_bias = None
    if bias:
        keep = torch.rand(B, M, generator=g) > 0.3
        keep[:, 0] = True
        keep[1] = False
        key_bias = tnn.keep_to_bias(keep)[:, None, None, :]
    return mha, q_in, k, v, key_bias


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("M", [1, 7, 330, 700])
def test_cross_attention_plain_matches_einsum_path(M, bias):
    """K10's plain version is the einsum path's function in fp32: the module's
    projections around it against `attend` on the CPU (the einsum path),
    with and without a key bias, a row of which masks every key."""
    B, S = 3, 50
    mha, q_in, k, v, kb = _cross_inputs(M, B, S, M, bias=bias)
    with torch.no_grad():
        want = mha.attend(q_in, k, v, kb)
        out = xa.cross_attention(mha.q_proj(q_in), k.reshape(B, M, -1), v.reshape(B, M, -1), 8,
                                 None if kb is None else kb[:, 0, 0, :].contiguous(),
                                 mha.head_dim**-0.5)
        got = mha.out_proj(out)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("case", ["kernel", "key_bias", "grad", "head_width", "structured_bias",
                                  "train"])
def test_cross_attention_dispatch(monkeypatch, case):
    """`attend` sends an S != M call to K10 only in eval mode on the card with
    grad off, no bias or a key-only one and a head width up to 64; an
    eval-mode call it does not send counts `attn.cross.plain`, a train-mode
    call nothing.  The card is stood in for: `on_card` patched true and the
    kernel recorded, running its plain version."""
    calls = []

    def recorded(*args):
        calls.append(args)
        return xa.cross_attention_plain(*args)

    monkeypatch.setattr(tnn, "on_card", lambda t: True)
    monkeypatch.setattr(tnn, "cross_attention", recorded)
    E, nhead = (256, 2) if case == "head_width" else (256, 8)  # Dh=128 past the kernel's 64
    mha, q_in, k, v, kb = _cross_inputs(5, 2, 10, 33, E, nhead, bias=case == "key_bias")
    if case == "structured_bias":
        kb = torch.zeros(2, 1, 10, 33)
    if case == "train":
        mha.train()
        mha.attn_drop.p = 0.0
    want = None
    with torch.no_grad():
        want = mha.out_proj(xa.cross_attention_plain(
            mha.q_proj(q_in), k.reshape(2, 33, E), v.reshape(2, 33, E), nhead,
            None if kb is None or kb.shape[2] != 1 else kb[:, 0, 0, :], mha.head_dim**-0.5))
    with tracing.traced(), torch.set_grad_enabled(case == "grad"):
        got = mha.attend(q_in, k, v, kb)
        plain = tracing.counters().get("attn.cross.plain", 0)
    takes = case in ("kernel", "key_bias")
    assert len(calls) == int(takes)
    assert plain == (0 if takes or case == "train" else 1)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **TOL)


# ---- K11: eval-mode BatchNorm, residual add and ReLU in one pass ---------------------


def _randomize_bn(module, seed):
    """Random BatchNorm statistics and affine parameters, so that no
    BatchNorm is the identity."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, resnet.BatchNorm):
            C = m.weight.shape[0]
            with torch.no_grad():
                m.weight.copy_(1 + 0.2 * torch.randn(C, generator=g))
                m.bias.copy_(0.2 * torch.randn(C, generator=g))
                m.running_mean.copy_(0.3 * torch.randn(C, generator=g))
                m.running_var.copy_(0.5 + torch.rand(C, generator=g))
    return module


def _channels_last(N, C, H, W, seed, dtype=torch.float32):
    """[N, C, H, W] viewing NHWC storage, as the trunk's activations are."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(N, H, W, C, generator=g).to(dtype).permute(0, 3, 1, 2)


def _old_bn(bn, x):
    """The eval-mode BatchNorm's expression before K11 (train mode: its own)."""
    if bn.training:
        return bn._train_forward(x)
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    shift = bn.bias.float() - bn.running_mean.float() * scale
    return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def _old_block(m, x):
    """Bottleneck's and BasicBlock's forward before K11: separate residual add
    and ReLUs."""
    relu = torch.nn.functional.relu
    y = relu(_old_bn(m.bn1, m.conv1(x)))
    if isinstance(m, resnet.Bottleneck):
        y = relu(_old_bn(m.bn2, m.conv2(y)))
        y = _old_bn(m.bn3, m.conv3(y))
    else:
        y = _old_bn(m.bn2, m.conv2(y))
    residual = _old_bn(m.down_bn, m.down_conv(x)) if m.has_down else x
    return relu(y + residual)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("block,cin,features,stride", [
    ("Bottleneck", 16, 4, 1),   # residual = x
    ("Bottleneck", 8, 4, 2),    # the downsample's BatchNorm on the residual
    ("BasicBlock", 8, 8, 1),
    ("BasicBlock", 8, 16, 2),
])
def test_blocks_plain_path_is_the_unfused_sequence_bit_for_bit(dtype, mode, block, cin,
                                                               features, stride):
    """On the plain path (the CPU) a block that hands its residual and ReLUs to
    its BatchNorms computes what it did before, bit for bit, in eval and in
    train mode (the running statistics too), in fp32 and bf16."""
    import copy

    new = _randomize_bn(getattr(resnet, block)(cin, features, stride), cin + stride).to(dtype)
    old = copy.deepcopy(new)
    for m in (new, old):
        m.train(mode == "train")
    x = _channels_last(2, cin, 9, 7, 3, dtype)
    with torch.set_grad_enabled(mode == "train"):
        got, want = new(x), _old_block(old, x)
    assert got.dtype == dtype and torch.equal(got, want)
    for a, b in zip(new.buffers(), old.buffers()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual,relu", [(False, False), (False, True), (True, False),
                                           (True, True)])
def test_batchnorm_plain_path_is_the_unfused_sequence_bit_for_bit(dtype, residual, relu):
    """`BatchNorm(x, residual, relu)` on the plain path: today's expression,
    then `+ residual`, then relu, in x's dtype."""
    bn = _randomize_bn(resnet.BatchNorm(16), 1).eval()
    x = _channels_last(2, 16, 5, 3, 4, dtype)
    r = _channels_last(2, 16, 5, 3, 5, dtype) if residual else None
    with torch.no_grad():
        want = _old_bn(bn, x)
        want = want + r if residual else want
        want = torch.relu(want) if relu else want
        got = bn(x, r, relu)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("case", ["kernel", "kernel_residual", "train", "grad", "cpu", "nchw",
                                  "residual_nchw", "channels", "float16"])
def test_batchnorm_dispatch(monkeypatch, case):
    """An eval-mode BatchNorm goes to K11 only with grad off, on the card, in
    fp32 or bf16, x (and the residual) channels_last with C a multiple of 8;
    any other eval-mode call counts `bn.eval.plain`, a train-mode call
    nothing.  The card is stood in for: `on_card` patched true (but in
    "cpu") and the kernel recorded, running its plain version."""
    calls = []

    def recorded(*args):
        calls.append(args)
        return bna.batchnorm_act_plain(*args)

    if case != "cpu":
        monkeypatch.setattr(resnet, "on_card", lambda t: True)
    monkeypatch.setattr(resnet, "batchnorm_act", recorded)
    C = 12 if case == "channels" else 16
    dtype = torch.float16 if case == "float16" else torch.float32
    bn = _randomize_bn(resnet.BatchNorm(C), 2).train(case == "train")
    x = _channels_last(2, C, 5, 3, 6, dtype)
    if case == "nchw":
        x = x.contiguous()
    r = None
    if case in ("kernel_residual", "residual_nchw"):
        r = _channels_last(2, C, 5, 3, 7, dtype)
        r = r.contiguous() if case == "residual_nchw" else r
    with tracing.traced(), torch.set_grad_enabled(case == "grad"):
        got = bn(x, r, relu=True)
        plain = tracing.counters().get("bn.eval.plain", 0)
    takes = case.startswith("kernel")
    assert len(calls) == int(takes)
    assert plain == (0 if takes or case == "train" else 1)
    with torch.no_grad():
        want = _old_bn(bn.eval(), x) if case != "train" else got
        want = torch.relu(want + r if r is not None else want)
    np.testing.assert_allclose(got.detach().float().numpy(), want.float().numpy(),
                               **({} if dtype == torch.float32 else dict(rtol=1e-3)))


@pytest.mark.parametrize("backbone,launches", [("resnet50", 53), ("resnet18", 20)])
def test_trunk_calls_k11_once_per_batchnorm(monkeypatch, backbone, launches):
    """With the card stood in for, the eval-mode trunk with grad off calls K11
    once per BatchNorm (ResNet50: the stem, 16 x 3 and 4 downsamples;
    ResNet18: 1 + 8 x 2 + 3), counts no `bn.eval.plain`, and in fp32 gives the
    plain path's maps bit for bit (both compute in fp32 with the same
    roundings there)."""
    calls = []

    def recorded(*args):
        calls.append(args)
        return bna.batchnorm_act_plain(*args)

    trunk = _randomize_bn(resnet.ResNetTrunk(backbone), 3).eval()
    x = _channels_last(1, 4, 48, 40, 8)
    with torch.no_grad():
        want = trunk(x)
        monkeypatch.setattr(resnet, "on_card", lambda t: True)
        monkeypatch.setattr(resnet, "batchnorm_act", recorded)
        with tracing.traced():
            got = trunk(x)
            plain = tracing.counters().get("bn.eval.plain", 0)
    assert (len(calls), plain) == (launches, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual,relu", [(False, False), (True, True), (True, False),
                                           (False, True)])
def test_batchnorm_act_plain_is_the_formula_in_fp32(dtype, residual, relu):
    """K11's plain version is the formula worked in fp32 and rounded once to
    x's dtype, the parameters read in whatever dtype they are stored."""
    rng = np.random.default_rng(9)
    C = 24
    x = _channels_last(3, C, 4, 5, 10, dtype)
    r = _channels_last(3, C, 4, 5, 11, dtype) if residual else None
    w, b, m = (torch.from_numpy(rng.normal(size=C).astype(np.float32)) for _ in range(3))
    v = torch.from_numpy(rng.uniform(0.5, 2.0, size=C).astype(np.float32))
    params = (w.bfloat16(), b, m.bfloat16(), v)  # mixed storage dtypes
    eps = 1e-3
    launches = bna.batchnorm_act.launches
    got = bna.batchnorm_act_plain(x, *params, eps, r, relu)
    pf = [p.float().numpy() for p in params]
    s = pf[0] * (np.float32(1) / np.sqrt(pf[3] + np.float32(eps)))
    t = pf[1] - pf[2] * s
    y = x.float().numpy() * s[:, None, None] + t[:, None, None]
    if residual:
        y = y + r.float().numpy()
    if relu:
        y = np.maximum(y, np.float32(0))
    want = torch.from_numpy(y.astype(np.float32)).to(dtype)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=1e-6, atol=1e-6)
    assert bna.batchnorm_act(x, *params, eps, r, relu).equal(got)  # the CPU wrapper: plain
    assert bna.batchnorm_act.launches == launches
