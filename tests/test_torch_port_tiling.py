"""The decompositions that the CUDA kernels of K1-K6 and K8 follow, in plain torch.

`csrc/encoder_attention.cu`, `csrc/decode_attention.cu` and
`csrc/encoder_ffn.cu` cannot run on the CPU, but the algebra of their
tilings can.  Each function below writes one kernel's split of the work in
plain torch, and each test holds it against the port's plain version
(`encoder_attention_plain`, `decode_shared_attention_plain`, ...) and
against the JAX package's Pallas kernel in interpret mode, on the same
numpy inputs, in float32 (to 1e-5: only the order of the sums differs) and
bfloat16 (1e-3 + 2^-7*|ref|: one rounding of the output).

K1 has two routes:
  resident   (S <= 384) the keys split across 4 warps in chunks of 16, each
             warp's partial max, then partial sum, combined in warp order;
  recompute  (S > 384) key tiles of 64: pass A keeps a running max over kept
             keys and the rescaled sum (a tile with no kept key rescales
             nothing), pass B recomputes the scores and forms p.
Both form p = T(exp(min(s - m, 0)) * w * (1 / l)), T the input dtype, and a
row with no kept key attends uniformly (s = m = 0, w = 1, l = S).
K2 splits the memory into C = 8 contiguous slices of ceil(M / 8) tokens (a
slice may be empty), combines the slices' maxima and sums into the global m
and l, and adds the slices' partial p . mem in slice order.  K3 and K4 split
the int8 memory the same way: K3 forms p = T((exp(sc - m) / l) * s) from the
merged m and l; K4 also merges the slices' max |p2| into ps before it
quantises p2, and sums the slices' int32 partials exactly.  K4's quantised
probabilities add a tolerance of the row's ps: its int32 sums are exact, but
one rounding of p2 * 127 / ps that lands on the other integer (the slices
sum l in another order) moves an output by ps * |mem_i8| / 127 <= ps.  The
quantiser that K4 runs inside the kernel is held bit for bit against
`quantize_q_tilde` on exact .5 ties.
K6 (bf16 with S <= 384) projects x through the head's rows of wqkv in depth
tiles of 16 along E with fp32 sums, rounds q, k, v once, and then runs K1's
resident tiling with the head's keep weights.  K8 folds Dh^-1/2 and k_scale
into the fp32 query, splits M into 4 warps' slices of a multiple of the 8
tokens a lane owns in a step (8 consecutive where M % 8 == 0; else lane l
owns tokens l, l + 32, ... of the step), and within a slice takes steps of
32 lanes: an online softmax (running max, rescaled per-lane sums and partial
outputs, p never rounded), then the warps' (m, l, o) merged in warp order
and v_scale applied to the output.
K5 in bf16 takes row tiles of 128 (two warpgroups of 64; a ragged last
tile is zero-padded and its extra rows dropped) and walks F in chunks of
64: h_c = x W1_c^T with fp32 sums, g_c = T(max(h_c, T(-b1_c))) rounded per
chunk, the fp32 partials g_c W2_c^T added to o in chunk order, and out =
T(T(o) + T(b1 W2^T + b2)).  Its inputs lie on a coarse binary grid, so that
every fp32 sum is exact in any order and the split's roundings alone decide
the result: the hidden units come in pairs f, f + F/2 (in different chunks
at F = 192) with near-equal W1 rows, equal b1 and opposite W2 columns,
whose outputs are differences of near-equal g, where the rounding of g shows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ralf_tpu.ops.pallas.decode_attention import (
    fused_decode_attention_q8,
    fused_decode_shared_attention,
    fused_decode_shared_attention_q8,
    fused_decode_shared_attention_q8mxu,
    quantize_kv as jax_quantize_kv,
    quantize_q_tilde as jax_quantize_q,
    quantize_shared_memory as jax_quantize,
)
from ralf_tpu.ops.pallas.encoder_attention import (
    fused_encoder_attention,
    fused_encoder_self_attention,
)
from ralf_tpu.ops.pallas.encoder_ffn import fused_ffn as jax_fused_ffn
from ralf_tpu_torch.ops import decode_attention as da
from ralf_tpu_torch.ops import encoder_attention as ea
from ralf_tpu_torch.ops import encoder_ffn as ef

torch.set_num_threads(2)
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-3, rtol=2**-7)}
K1_TILE = 64      # encoder_attention_rec_kernel: keys a tile
K1_CHUNK = 16     # encoder_attention_rows_kernel: keys a chunk (one k-step of mma)
K1_SPLIT = 4      # ... and warps that share a row group, chunk i to warp i % 4
K2_CLUSTER = 8    # decode_shared_cluster_kernel: CTAs a batch row
K6_DEPTH = 16     # encoder_self_attention_rows_kernel: depth of a projection tile along E
K8_WARPS = 4      # decode_attention_q8_kernel: warps a (b, h) row, each a slice of M
K8_TOK = 8        # ... and tokens a lane owns in a step (consecutive where M % 8 == 0)
K5_ROWS = 128     # fused_ffn_tc_kernel: rows a block (two consumer warpgroups of 64)
K5_CHUNK = 64     # ... and hidden units a step (Fc)


def _heads(t, nhead):
    """[B, S, E] -> [B, H, S, Dh] in fp32."""
    B, S, E = t.shape
    return t.float().reshape(B, S, nhead, E // nhead).transpose(1, 2)


def _keep_weights(key_bias, B, S, n):
    """The kernels' w [B, n]: exp(bias) for j < S, 0 past S; a row with no
    kept key takes w = 1 for j < S.  Also returns the dead rows [B]."""
    w = torch.zeros(B, n)
    w[:, :S] = 1.0 if key_bias is None else torch.exp(key_bias.float())
    dead = ~(w > 0).any(-1)
    live_cols = (torch.arange(n) < S).float().expand(B, n)
    return torch.where(dead[:, None], live_cols, w), dead


def _pad_keys(t, n):
    """[B, H, S, Dh] -> [B, H, n, Dh], zero rows past S."""
    return torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[2]))


def k1_recompute(q, k, v, nhead, key_bias=None, tile=K1_TILE):
    """K1 over key tiles of `tile`, two passes over K."""
    B, S, E = q.shape
    n = -(-S // tile) * tile
    qh = _heads(q, nhead)
    kh, vh = (_pad_keys(_heads(t, nhead), n) for t in (k, v))
    w, dead = _keep_weights(key_bias, B, S, n)
    deadr = dead[:, None, None]
    m = torch.full(qh.shape[:3], -torch.inf)
    l = torch.zeros(qh.shape[:3])
    for j0 in range(0, n, tile):  # pass A
        s = qh @ kh[:, :, j0:j0 + tile].transpose(-1, -2)
        wt = w[:, None, None, j0:j0 + tile]
        m_new = torch.maximum(m, torch.where(wt > 0, s, -torch.inf).amax(-1))
        live = m_new > -torch.inf  # no kept key yet: l stays 0, no exp(-inf + inf)
        e = torch.exp(torch.clamp(s - m_new[..., None], max=0.0)) * wt
        l = torch.where(live, l * torch.exp(m - m_new) + e.sum(-1), l)
        m = m_new
    m = torch.where(deadr, 0.0, m)
    inv = 1.0 / torch.where(deadr, float(S), l.clamp_min(1e-30))
    o = torch.zeros_like(qh)
    for j0 in range(0, n, tile):  # pass B
        s = torch.where(deadr[..., None], 0.0, qh @ kh[:, :, j0:j0 + tile].transpose(-1, -2))
        p = torch.exp(torch.clamp(s - m[..., None], max=0.0)) * w[:, None, None, j0:j0 + tile]
        p = (p * inv[..., None]).to(v.dtype).float()
        o = o + p @ vh[:, :, j0:j0 + tile]
    return o.transpose(1, 2).reshape(B, S, E).to(q.dtype)


def k1_resident(q, k, v, nhead, key_bias=None, chunk=K1_CHUNK, split=K1_SPLIT):
    """K1 with every score of a row held at once, the keys split `split`
    ways in interleaved chunks of `chunk`: partial maxima, then partial sums,
    then partial outputs, each combined in split order."""
    B, S, E = q.shape
    n = -(-S // chunk) * chunk
    qh = _heads(q, nhead)
    kh, vh = (_pad_keys(_heads(t, nhead), n) for t in (k, v))
    w, dead = _keep_weights(key_bias, B, S, n)
    deadr = dead[:, None, None]
    s = torch.where(deadr[..., None], 0.0, qh @ kh.transpose(-1, -2))  # [B, H, S, n]
    wb = w[:, None, None, :]
    owner = (torch.arange(n) // chunk) % split  # the warp that holds key j
    parts = [owner == r for r in range(split)]
    m = torch.stack([torch.where((wb > 0) & pr, s, -torch.inf).amax(-1) for pr in parts]).amax(0)
    m = torch.where(deadr, 0.0, m)
    e = torch.exp(torch.clamp(s - m[..., None], max=0.0)) * wb
    l = sum(torch.where(pr, e, 0.0).sum(-1) for pr in parts)
    p = (e * (1.0 / l.clamp_min(1e-30))[..., None]).to(v.dtype).float()
    o = sum(torch.where(pr, p, 0.0) @ vh for pr in parts)
    return o.transpose(1, 2).reshape(B, S, E).to(q.dtype)


def k2_cluster(q_tilde, mem, clusters=K2_CLUSTER):
    """K2 over `clusters` contiguous slices of ceil(M / clusters) tokens."""
    B, M, E = mem.shape
    per = -(-M // clusters)
    qf = q_tilde.float()
    slices, stats = [], []
    for r in range(clusters):
        b0, b1 = min(M, r * per), min(M, (r + 1) * per)
        x = mem[:, b0:b1].float()
        s = torch.einsum("bhe,bme->bhm", qf, x)
        if b1 > b0:
            m_r = s.amax(-1)
            l_r = torch.exp(s - m_r[..., None]).sum(-1)
        else:  # an empty slice: m = -inf, l = 0, o = 0
            m_r = torch.full(qf.shape[:2], -torch.inf)
            l_r = torch.zeros(qf.shape[:2])
        slices.append((s, x))
        stats.append((m_r, l_r))
    m = torch.stack([m_r for m_r, _ in stats]).amax(0)
    l = sum(torch.where(m_r == -torch.inf, 0.0, l_r * torch.exp(m_r - m)) for m_r, l_r in stats)
    o = torch.zeros_like(qf)
    for s, x in slices:
        p = (torch.exp(s - m[..., None]) / l[..., None]).to(mem.dtype).float()
        o = o + torch.einsum("bhm,bme->bhe", p, x)
    return o.to(q_tilde.dtype)


def _assert_close(out, ref, dtype_name):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **TOL[dtype_name])


K1_CASES = {
    # (B, S, nhead, mask)
    "first_tile_masked": (3, 100, 8, "first_tile"),  # plus a fully masked row
    "unmasked": (2, 33, 8, "none"),
    "fidnet": (4, 11, 4, "keys"),                    # Dh=64, with a dead row
}


def _k1_inputs(case):
    B, S, nhead, mask = K1_CASES[case]
    rng = np.random.default_rng(S + B)
    q = (rng.normal(size=(B, S, 256)) * (256 // nhead) ** -0.5).astype(np.float32)
    k, v = (rng.normal(size=(B, S, 256)).astype(np.float32) for _ in range(2))
    bias = None
    if mask != "none":
        keep = rng.random((B, S)) > 0.3
        keep[:, -1] = True
        if mask == "first_tile":
            keep[:, :K1_TILE] = False
        keep[1] = False
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    return q, k, v, nhead, bias


@pytest.mark.parametrize("case", list(K1_CASES))
@pytest.mark.parametrize("route", ["recompute", "resident"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_k1_tiling_matches_plain_and_pallas(case, route, dtype_name):
    q, k, v, nhead, bias = _k1_inputs(case)
    jd, td = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    tiled = (k1_recompute if route == "recompute" else k1_resident)(tq, tk, tv, nhead, tb)
    assert tiled.dtype == td and bool(torch.isfinite(tiled.float()).all())
    _assert_close(tiled, ea.encoder_attention_plain(tq, tk, tv, nhead, tb).float(), dtype_name)
    ref = fused_encoder_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), nhead,
                                  None if bias is None else jnp.asarray(bias), interpret=True)
    _assert_close(tiled, ref.astype(jnp.float32), dtype_name)
    if bias is not None:  # the fully masked row is the mean of V
        mean_v = tv[1].float().mean(0).expand_as(tiled[1]).to(td).float()
        _assert_close(tiled[1], mean_v, dtype_name)


@pytest.mark.parametrize("M", [1, 5, 77, 200])  # empty slices (M < 8), ragged (8 does not divide M)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_k2_tiling_matches_plain_and_pallas(M, dtype_name):
    rng = np.random.default_rng(M)
    qt = (rng.normal(size=(2, 8, 256)) / 16).astype(np.float32)
    mem = rng.normal(size=(2, M, 256)).astype(np.float32)
    jd, td = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    tq, tm = torch.from_numpy(qt).to(td), torch.from_numpy(mem).to(td)
    tiled = k2_cluster(tq, tm)
    assert tiled.dtype == td and bool(torch.isfinite(tiled.float()).all())
    _assert_close(tiled, da.decode_shared_attention_plain(tq, tm).float(), dtype_name)
    ref = fused_decode_shared_attention(jnp.asarray(qt, jd), jnp.asarray(mem, jd), interpret=True)
    _assert_close(tiled, ref.astype(jnp.float32), dtype_name)



def _slices(M, clusters):
    """The contiguous slices [b0, b1) of ceil(M / clusters) tokens; some may be empty."""
    per = -(-M // clusters)
    return [(min(M, r * per), min(M, (r + 1) * per)) for r in range(clusters)]


def _merge_softmax_stats(slice_scores, shape):
    """Each slice's max and sum of exp(sc - max), merged into the global m and
    l; an empty slice gives m = -inf, l = 0."""
    stats = []
    for sc in slice_scores:
        if sc.shape[-1]:
            m_r = sc.amax(-1)
            stats.append((m_r, torch.exp(sc - m_r[..., None]).sum(-1)))
        else:
            stats.append((torch.full(shape, -torch.inf), torch.zeros(shape)))
    m = torch.stack([m_r for m_r, _ in stats]).amax(0)
    l = sum(torch.where(m_r == -torch.inf, 0.0, l_r * torch.exp(m_r - m)) for m_r, l_r in stats)
    return m, l


def k3_cluster(q_tilde, mem_i8, mem_scale, clusters=K2_CLUSTER):
    """K3 over `clusters` contiguous slices: sc = (q . mem_i8) * s per slice,
    p = T((exp(sc - m) / l) * s) with the merged m and l, partials in slice order."""
    M = mem_i8.shape[1]
    qf = q_tilde.float()
    parts = []
    for b0, b1 in _slices(M, clusters):
        x, s = mem_i8[:, b0:b1].float(), mem_scale[:, None, b0:b1].float()
        parts.append((torch.einsum("bhe,bme->bhm", qf, x) * s, x, s))
    m, l = _merge_softmax_stats([sc for sc, _, _ in parts], qf.shape[:2])
    o = torch.zeros_like(qf)
    for sc, x, s in parts:
        p = (torch.exp(sc - m[..., None]) / l[..., None] * s).to(q_tilde.dtype).float()
        o = o + torch.einsum("bhm,bme->bhe", p, x)
    return o.to(q_tilde.dtype)


def k4_cluster(q_tilde, mem_i8, mem_scale, clusters=K2_CLUSTER):
    """K4 over `clusters` contiguous slices: the quantised query, int32
    scores times qs then s, the merged m and l, each slice's max |p2| merged
    into ps, pi = clip(round(p2 * (127 / ps))), the int32 partials summed
    exactly, then times ps / 127."""
    M = mem_i8.shape[1]
    qi, qs = da.quantize_q_tilde(q_tilde)
    parts = []
    for b0, b1 in _slices(M, clusters):
        x, s = mem_i8[:, b0:b1].long(), mem_scale[:, None, b0:b1].float()
        dot = torch.einsum("bhe,bme->bhm", qi.long(), x)  # exact
        parts.append((dot.float() * qs[:, :, None] * s, x, s))
    m, l = _merge_softmax_stats([sc for sc, _, _ in parts], qi.shape[:2])
    p2 = [torch.exp(sc - m[..., None]) / l[..., None] * s for sc, _, s in parts]
    maxima = [p.abs().amax(-1) if p.shape[-1] else torch.zeros(qi.shape[:2]) for p in p2]
    ps = torch.stack(maxima).amax(0).clamp_min(1e-30)[..., None]  # [B, H, 1]
    acc = torch.zeros(qi.shape, dtype=torch.long)
    for p, (_, x, _) in zip(p2, parts):
        pi = torch.clamp(torch.round(p * (127.0 / ps)), -127, 127).long()
        acc = acc + torch.einsum("bhm,bme->bhe", pi, x)
    return (acc.float() * (ps * (1.0 / 127.0))).to(q_tilde.dtype), ps


def _q8_inputs(M, dtype_name):
    rng = np.random.default_rng(M + 11)
    B = 2
    qt = (rng.normal(size=(B, 8, 256)) / 16).astype(np.float32)
    mi, ms = jax_quantize(jnp.asarray(rng.normal(size=(B, M, 256)).astype(np.float32)))
    tq = torch.from_numpy(qt).to(getattr(torch, dtype_name))
    return qt, mi, ms, tq, torch.from_numpy(np.array(mi)), torch.from_numpy(np.array(ms))


Q8_MEMORIES = [5, 677, 680, 4096]  # CTAs with no token, ragged slices, the main M, 512-token slices


@pytest.mark.parametrize("M", Q8_MEMORIES)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_k3_tiling_matches_plain_and_pallas(M, dtype_name):
    qt, mi, ms, tq, tmi, tms = _q8_inputs(M, dtype_name)
    tiled = k3_cluster(tq, tmi, tms)
    assert tiled.dtype == tq.dtype and bool(torch.isfinite(tiled.float()).all())
    _assert_close(tiled, da.decode_shared_attention_q8_plain(tq, tmi, tms).float(), dtype_name)
    ref = fused_decode_shared_attention_q8(jnp.asarray(qt, getattr(jnp, dtype_name)), mi, ms,
                                           interpret=True)
    _assert_close(tiled, ref.astype(jnp.float32), dtype_name)


@pytest.mark.parametrize("M", Q8_MEMORIES)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_k4_tiling_matches_plain_and_pallas(M, dtype_name):
    qt, mi, ms, tq, tmi, tms = _q8_inputs(M, dtype_name)
    tiled, ps = k4_cluster(tq, tmi, tms)
    assert tiled.dtype == tq.dtype and bool(torch.isfinite(tiled.float()).all())
    plain_ps = da.q8mxu_probs(tq, tmi, tms)[1]
    torch.testing.assert_close(ps, plain_ps, rtol=1e-6, atol=0)  # the merged ps is the row's
    tol = dict(TOL[dtype_name])
    extra = ps.numpy()  # one flipped quantised probability per output
    for ref in (da.decode_shared_attention_q8mxu_plain(tq, tmi, tms).float().numpy(),
                np.asarray(fused_decode_shared_attention_q8mxu(
                    jnp.asarray(qt, getattr(jnp, dtype_name)), mi, ms, interpret=True)
                    .astype(jnp.float32))):
        err = np.abs(tiled.float().numpy() - ref)
        assert (err <= tol["atol"] + extra + tol["rtol"] * np.abs(ref)).all(), float(err.max())


def kernel_quantise(x):
    """The quantiser K4's kernel runs on each head, written in numpy float32:
    amax over E, qs = max(amax, 1e-8) / 127 with an IEEE division, qi =
    clip(rint(x / qs), -127, 127), rint rounding half to even."""
    amax = np.abs(x).max(-1, keepdims=True)
    qs = np.maximum(amax, np.float32(1e-8)) / np.float32(127.0)
    return np.clip(np.rint(x / qs), -127, 127).astype(np.int8), qs[..., 0]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_in_kernel_quantiser_matches_quantize_q_tilde_bit_for_bit(dtype_name):
    rng = np.random.default_rng(12)
    x = (rng.normal(size=(3, 8, 256)) * rng.uniform(0.01, 5, size=(3, 8, 1))).astype(np.float32)
    ties = rng.integers(-126, 126, size=(2, 8, 255)) + 0.5  # x / qs lands on k + 0.5
    x[0, :, 0] = 127.0  # qs = 1 exactly
    x[0, :, 1:] = ties[0]
    x[1, :4, 0] = 63.5  # qs = 0.5 exactly
    x[1, :4, 1:] = ties[1, :4] / 2
    x[2, 3] = 0.0  # an all-zero head takes the 1e-8 floor
    x = torch.from_numpy(x).to(getattr(torch, dtype_name)).float().numpy()  # the kernel's input
    qi, qs = kernel_quantise(x)
    assert qs.dtype == np.float32 and (np.abs(x / qs[..., None]) % 1 == 0.5).sum() > 3000
    for ref_qi, ref_qs in (da.quantize_q_tilde(torch.from_numpy(x)), jax_quantize_q(jnp.asarray(x))):
        np.testing.assert_array_equal(qi, np.asarray(ref_qi))
        assert np.asarray(ref_qs).tobytes() == qs.tobytes()


def k6_split(x, wqkv, nhead, key_bias=None, depth=K6_DEPTH):
    """K6's tensor-core route: qkv = T(sum over depth tiles of x . W^T) with
    fp32 sums, then K1's resident tiling head by head with the head's keep
    weights (key_bias [B, S] shared or [B, H, S] per head)."""
    B, S, E = x.shape
    Dh = E // nhead
    acc = torch.zeros(B, S, 3 * E)
    for e0 in range(0, E, depth):
        acc = acc + x[..., e0:e0 + depth].float() @ wqkv[:, e0:e0 + depth].float().t()
    qkv = acc.to(x.dtype)
    heads = []
    for h in range(nhead):
        cols = slice(h * Dh, (h + 1) * Dh)
        q, k, v = (qkv[..., i * E:(i + 1) * E][..., cols] for i in range(3))
        bias = None if key_bias is None else (key_bias[:, h] if key_bias.dim() == 3 else key_bias)
        heads.append(k1_resident(q, k, v, 1, bias))
    return torch.cat(heads, dim=-1)


K6_CASES = {
    # (B, S, nhead, bias)
    "single_token": (2, 1, 8, None),
    "fidnet": (3, 11, 4, "heads+keys"),        # Dh=64, one tile of 16 rows, a dead row
    "constraint": (3, 89, 8, "keys"),          # a shared [B, S] bias, a dead row
}


@pytest.mark.parametrize("case", list(K6_CASES))
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_k6_tiling_matches_plain_and_pallas(case, dtype_name):
    B, S, nhead, bias = K6_CASES[case]
    rng = np.random.default_rng(S + nhead)
    E, Dh = 256, 256 // nhead
    x = rng.normal(size=(B, S, E)).astype(np.float32)
    wqkv = (rng.normal(size=(3 * E, E)) * E**-0.5).astype(np.float32)
    wqkv[:E] *= Dh**-0.5  # the softmax scale folded into Wq
    kb = None
    if bias is not None:
        keep = rng.random((B, S)) > 0.3
        keep[:, 0] = True
        keep[1] = False  # a dead row: uniform over its keys
        kb = np.where(keep, 0.0, -1e9).astype(np.float32)
        if "heads" in bias:
            kb = (kb[:, None, :] + rng.normal(size=(B, nhead, S))).astype(np.float32)
    jd, td = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    tx, tw = torch.from_numpy(x).to(td), torch.from_numpy(wqkv).to(td)
    tkb = None if kb is None else torch.from_numpy(kb)
    tiled = k6_split(tx, tw, nhead, tkb)
    assert tiled.dtype == td and bool(torch.isfinite(tiled.float()).all())
    _assert_close(tiled, ea.encoder_self_attention_plain(tx, tw, nhead, tkb).float(), dtype_name)
    ref = fused_encoder_self_attention(jnp.asarray(x, jd), jnp.asarray(wqkv.T, jd), nhead,
                                       None if kb is None else jnp.asarray(kb), interpret=True)
    _assert_close(tiled, ref.astype(jnp.float32), dtype_name)


def k8_split(q, k_i8, v_i8, k_scale, v_scale, warps=K8_WARPS, tok=K8_TOK):
    """K8: the fp32 query with Dh^-1/2 and k_scale folded in (in that order),
    M in `warps` slices of a multiple of `tok` tokens, steps of 32 lanes of
    `tok` tokens with an online softmax (per-lane sums and partial outputs
    rescaled by exp(m - m_new)), the warps merged in order, v_scale last."""
    B, H, Dh, M = k_i8.shape
    strided = M % 8 != 0  # lane l owns tokens l, l + 32, ... (the kernel's byte loads)

    def lanes(x):  # [..., step] -> [..., 32 lanes, tok]
        return x.unflatten(-1, (tok, 32)).transpose(-1, -2) if strided else x.unflatten(-1, (32, tok))

    qf = q.float() * Dh**-0.5 * k_scale[:, :, None]
    per = -(-M // (warps * tok)) * tok
    step = 32 * tok
    parts = []
    for w in range(warps):
        b0 = min(M, w * per)
        b1 = min(M, b0 + per)
        m = torch.full((B, H), -torch.inf)
        lanes_l = torch.zeros(B, H, 32)      # each lane's share of the sum
        o = torch.zeros(B, H, Dh)
        for t0 in range(b0, b1, step):
            n = min(b1, t0 + step) - t0
            pad = (0, step - n)
            k = torch.nn.functional.pad(k_i8[..., t0:t0 + n].float(), pad)
            v = torch.nn.functional.pad(v_i8[..., t0:t0 + n].float(), pad)
            s = torch.einsum("bhd,bhdm->bhm", qf, k)
            live = torch.arange(step) < n
            m_new = torch.maximum(m, torch.where(live, s, -torch.inf).amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(live, torch.exp(s - m_new[..., None]), 0.0)  # fp32, never rounded
            lanes_l = lanes_l * alpha[..., None] + lanes(p).sum(-1)
            lane_o = torch.einsum("bhlt,bhdlt->bhdl", lanes(p), lanes(v))
            o = o * alpha[..., None] + lane_o.sum(-1)
            m = m_new
        parts.append((m, lanes_l.sum(-1), o))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    f = [torch.where(m == -torch.inf, 0.0, torch.exp(m - m_all)) for m, _, _ in parts]
    l_all = sum(l * fw for (_, l, _), fw in zip(parts, f))
    o_all = sum(o * fw[..., None] for (_, _, o), fw in zip(parts, f))
    return (o_all / l_all[..., None] * v_scale[:, :, None]).to(q.dtype)


# strided lanes: one token, empty warps, ragged, two steps a warp (1100); 8 consecutive
# tokens a lane, one step a warp (600) and three (2064)
@pytest.mark.parametrize("M", [1, 5, 77, 600, 1100, 2064])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_k8_tiling_matches_plain_and_pallas(M, dtype_name):
    rng = np.random.default_rng(M + 13)
    B, H, Dh = 2, 4, 32
    q = rng.normal(size=(B, H, Dh)).astype(np.float32)
    k_t, v_t = (rng.normal(size=(B, H, Dh, M)).astype(np.float32) for _ in range(2))
    cached = jax_quantize_kv(jnp.asarray(k_t), jnp.asarray(v_t))
    jd, td = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    tq = torch.from_numpy(q).to(td)
    tc = [torch.from_numpy(np.array(a)) for a in cached]
    tiled = k8_split(tq, *tc)
    assert tiled.dtype == td and bool(torch.isfinite(tiled.float()).all())
    _assert_close(tiled, da.decode_attention_q8_plain(tq, *tc).float(), dtype_name)
    ref = fused_decode_attention_q8(jnp.asarray(q, jd), *cached, interpret=True)
    _assert_close(tiled, ref.astype(jnp.float32), dtype_name)


def k5_tiles(x, w1, b1, w2, b2, rows=K5_ROWS, chunk=K5_CHUNK):
    """K5's split: row tiles of `rows` (the last zero-padded, as TMA fills
    it, and its extra rows dropped, as TMA clips the store), F in chunks of
    `chunk`: g rounded per chunk, o's fp32 partials added in chunk order,
    then the epilogue's two roundings T(T(o) + T(tail))."""
    B, S, E = x.shape
    F = w1.shape[0]
    xm = x.reshape(-1, E)
    M = xm.shape[0]
    xm = torch.cat([xm, xm.new_zeros(-M % rows, E)])
    nb1 = (-b1).to(x.dtype).float()
    tail = ef.ffn_tail(b1, w2, b2).to(x.dtype)
    tiles = []
    for r0 in range(0, xm.shape[0], rows):
        xt = xm[r0:r0 + rows].float()
        o = torch.zeros(rows, E)
        for f0 in range(0, F, chunk):
            h = xt @ w1[f0:f0 + chunk].float().t()
            g = torch.maximum(h, nb1[f0:f0 + chunk]).to(x.dtype)
            o = o + g.float() @ w2[:, f0:f0 + chunk].float().t()
        tiles.append(o.to(x.dtype) + tail)
    return torch.cat(tiles)[:M].reshape(B, S, E)


def _k5_inputs(B, S, F, E=256):
    rng = np.random.default_rng(B * S + F)
    x = rng.integers(-8, 9, size=(B, S, E)) / 4.0
    w1 = rng.integers(-8, 9, size=(F, E)) / 8.0
    b1 = rng.integers(-16, 17, size=F) / 4.0
    w2 = rng.integers(-8, 9, size=(E, F)) / 64.0
    b2 = rng.integers(-8, 9, size=E) / 8.0
    half = F // 2
    w1[half:] = w1[:half] + (rng.random((half, E)) < 0.1) * rng.integers(-2, 3, (half, E)) / 8
    b1[half:] = b1[:half]
    w2[:, :half] = rng.integers(-8, 9, size=(E, half)) * 4.0
    w2[:, half:] = -w2[:, :half]
    return [a.astype(np.float32) for a in (x, w1, b1, w2, b2)]


# a ragged last row tile (M = 74 of 128) or two tiles (M = 160); one chunk or three
@pytest.mark.parametrize("B,S", [(2, 37), (4, 40)])
@pytest.mark.parametrize("F", [64, 192])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_k5_tiling_matches_plain_and_pallas(B, S, F, dtype_name):
    x, w1, b1, w2, b2 = _k5_inputs(B, S, F)
    jd, td = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    tx, tw1, tw2 = (torch.from_numpy(a).to(td) for a in (x, w1, w2))
    tb1, tb2 = torch.from_numpy(b1), torch.from_numpy(b2)
    tiled = k5_tiles(tx, tw1, tb1, tw2, tb2)
    assert tiled.dtype == td and bool(torch.isfinite(tiled.float()).all())
    _assert_close(tiled, ef.fused_ffn_plain(tx, tw1, tb1, tw2, tb2).float(), dtype_name)
    ref = jax_fused_ffn(jnp.asarray(x, jd), jnp.asarray(w1.T, jd), jnp.asarray(b1),
                        jnp.asarray(w2.T, jd), jnp.asarray(b2), interpret=True)
    _assert_close(tiled, ref.astype(jnp.float32), dtype_name)
