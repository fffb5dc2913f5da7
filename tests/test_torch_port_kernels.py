"""The port's kernels K1-K4, K7 and K8 against the JAX package's Pallas kernels.

On the CPU each wrapper of `ralf_tpu_torch.ops` runs its plain PyTorch
version; here that version is held against the Pallas kernel run with
interpret=True on the same numpy inputs, in float32, to 1e-5, and K2 and K3
also in bfloat16 (where the TPU kernels round p before the second dot).
The quantisers must agree exactly.  The CUDA kernels themselves are held
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
from ralf_tpu.ops.pallas.encoder_attention import fused_encoder_attention
from ralf_tpu_torch.ops import decode_attention as da
from ralf_tpu_torch.ops import encoder_attention as ea

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
    counters = (ea.encoder_attention, da.decode_shared_attention, da.decode_shared_attention_q8,
                da.decode_shared_attention_q8mxu, da.decode_attention, da.decode_attention_q8)
    before = [c.launches for c in counters]
    for kernel, plain, args in (
        (ea.encoder_attention, ea.encoder_attention_plain, (q, k, v, 2)),
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
