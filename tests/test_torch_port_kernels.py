"""The port's kernels K1-K3 against the JAX package's Pallas kernels.

On the CPU each wrapper of `ralf_tpu_torch.ops` runs its plain PyTorch
version; here that version is held against the Pallas kernel run with
interpret=True on the same numpy inputs, in float32, to 1e-5.  The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ralf_tpu.ops.pallas.decode_attention import (
    fused_decode_shared_attention,
    fused_decode_shared_attention_q8,
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
    before = (ea.encoder_attention.launches, da.decode_shared_attention.launches,
              da.decode_shared_attention_q8.launches)
    torch.testing.assert_close(ea.encoder_attention(q, k, v, 2),
                               ea.encoder_attention_plain(q, k, v, 2), rtol=0, atol=0)
    torch.testing.assert_close(da.decode_shared_attention(qt, mem),
                               da.decode_shared_attention_plain(qt, mem), rtol=0, atol=0)
    torch.testing.assert_close(da.decode_shared_attention_q8(qt, mi, ms),
                               da.decode_shared_attention_q8_plain(qt, mi, ms), rtol=0, atol=0)
    after = (ea.encoder_attention.launches, da.decode_shared_attention.launches,
             da.decode_shared_attention_q8.launches)
    assert before == after == (0, 0, 0)


def test_plain_versions_keep_the_input_dtype():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(rng, 2, 7, 64, 2))
    assert ea.encoder_attention(q, k, v, 2).dtype == torch.bfloat16
    qt = torch.from_numpy((rng.normal(size=(2, 8, 256)) / 16).astype(np.float32)).bfloat16()
    mem = torch.from_numpy(rng.normal(size=(2, 9, 256)).astype(np.float32))
    assert da.decode_shared_attention(qt, mem.bfloat16()).dtype == torch.bfloat16
    mi, ms = da.quantize_shared_memory(mem)
    assert da.decode_shared_attention_q8(qt, mi, ms).dtype == torch.bfloat16
