"""The port's modules against the JAX package, module by module.

Both packages get the same weights (the JAX variables, loaded into the port
by `ralf_tpu_torch.utils.weights.load_jax_params`) and the same numpy
inputs; everything runs in float32 on the CPU, where the port's kernel
wrappers run their plain versions and the JAX package its XLA paths.  Each
assert states its tolerance: 1e-5 where only the summation order differs,
looser where a deeper stack compounds it.

The traps found while porting each have a test named `test_trap_*`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ralf_tpu.core import conditioning as jcond
from ralf_tpu.core import sampling as jsamp
from ralf_tpu.core.layout import Layout as JLayout
from ralf_tpu.core.tokenizer import LayoutSequenceTokenizer as JTokenizer
from ralf_tpu.core.tokenizer import TokenizerConfig as JTokCfg
from ralf_tpu.data import dataset as jdata
from ralf_tpu.models import fidnet as jfid
from ralf_tpu.models import nn as jnn
from ralf_tpu.models import positional as jpos
from ralf_tpu.models import ralf as jralf
from ralf_tpu.models import resnet as jres
from ralf_tpu.ops.pallas.decode_attention import quantize_shared_memory as jquantize
from ralf_tpu.retrieval import retriever as jret
from ralf_tpu.retrieval import wrapper as jwrap
from ralf_tpu_torch.core import conditioning as tcond
from ralf_tpu_torch.core import sampling as tsamp
from ralf_tpu_torch.core.layout import Layout as TLayout
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer as TTokenizer
from ralf_tpu_torch.core.tokenizer import TokenizerConfig as TTokCfg
from ralf_tpu_torch.data import dataset as tdata
from ralf_tpu_torch.models import fidnet as tfid
from ralf_tpu_torch.models import nn as tnn
from ralf_tpu_torch.models import positional as tpos
from ralf_tpu_torch.models import ralf as tralf
from ralf_tpu_torch.models import resnet as tres
from ralf_tpu_torch.ops.decode_attention import quantize_shared_memory as tquantize
from ralf_tpu_torch.retrieval import retriever as tret
from ralf_tpu_torch.retrieval import wrapper as twrap
from ralf_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(2)
D, H = 32, 4  # tiny width: d_model 32, 4 heads


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bridge(port_module, variables):
    """Load the JAX variables into the port module and return it in eval mode."""
    load_jax_params(port_module, _np(variables["params"]),
                    _np(variables["batch_stats"]) if "batch_stats" in variables else None)
    return port_module.eval()


def _randomize_batch_stats(variables, seed=0):
    """Non-trivial BatchNorm statistics, so that the bridge's mean/var mapping is tested."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if str(path[-1].key) == "var":
            return jnp.asarray(rng.uniform(0.5, 2.0, a.shape).astype(np.float32))
        return jnp.asarray(rng.normal(0, 0.1, a.shape).astype(np.float32))

    return {**variables,
            "batch_stats": jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])}


def _random_layout(rng, B, S, num_labels=3):
    n = rng.integers(0, S + 1, size=B)
    n[0] = S  # one full layout (no EOS slot)
    mask = np.arange(S)[None, :] < n[:, None]
    d = {
        "label": np.where(mask, rng.integers(0, num_labels, (B, S)), 0),
        "center_x": np.where(mask, rng.random((B, S)), 0).astype(np.float32),
        "center_y": np.where(mask, rng.random((B, S)), 0).astype(np.float32),
        "width": np.where(mask, rng.random((B, S)), 0).astype(np.float32),
        "height": np.where(mask, rng.random((B, S)), 0).astype(np.float32),
        "mask": mask,
    }
    return d


def _jlayout(d):
    return JLayout.fromdict({k: jnp.asarray(v) for k, v in d.items()})


# ---- positional encodings ------------------------------------------------


def test_positional_encodings_match_jax():
    np.testing.assert_array_equal(tpos.sincos_1d(64, D), jpos.sincos_1d(64, D))
    np.testing.assert_array_equal(tpos.sine_2d_table(5, 3, D), jpos.sine_2d_table(5, 3, D))
    x = np.random.default_rng(0).normal(size=(2, 7, D)).astype(np.float32)
    pe = jpos.PositionalEncoding1D(D)
    ref = pe.apply(pe.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x))
    np.testing.assert_allclose(tpos.PositionalEncoding1D(D)(_t(x)).numpy(), ref, atol=1e-6)
    fmap = np.random.default_rng(1).normal(size=(2, 5, 3, D)).astype(np.float32)
    p2 = jpos.PositionEmbeddingSine2D(D)
    ref2 = p2.apply({}, jnp.asarray(fmap))
    np.testing.assert_allclose(tpos.PositionEmbeddingSine2D(D)(_t(fmap)).numpy(), ref2, atol=1e-6)


# ---- multi-head attention, every method on the path ----------------------


def _mha_pair(seed=0, B=3, M=20):
    rng = np.random.default_rng(seed)
    q_in = rng.normal(size=(B, 1, D)).astype(np.float32)
    mem = rng.normal(size=(B, M, D)).astype(np.float32)
    jm = jnn.MultiHeadAttention(D, H, dropout=0.0)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(q_in), jnp.asarray(mem))
    tm = _bridge(tnn.MultiHeadAttention(D, H), v)
    return rng, jm, v, tm, q_in, mem


@pytest.mark.parametrize("case", ["attend", "attend_key_bias", "attend_dead_row",
                                  "attend_causal", "attend_shared", "attend_shared_bias",
                                  "attend_shared_q8", "attend_t", "attend_t_q8tok"])
def test_mha_matches_jax(case):
    rng, jm, v, tm, q_in, mem = _mha_pair()
    B, M = mem.shape[:2]
    JM = jnn.MultiHeadAttention
    keep = rng.random((B, M)) > 0.3
    keep[:, 0] = True
    if case == "attend_dead_row":
        keep[1] = False  # no key kept: uniform attention on both sides
    if case in ("attend", "attend_key_bias", "attend_dead_row", "attend_causal"):
        x = mem  # same-length self-attention: K1's call site
        jb = tb = None
        if case in ("attend_key_bias", "attend_dead_row"):
            jb = jnn.keep_to_bias(jnp.asarray(keep))[:, None, None, :]
            tb = tnn.keep_to_bias(_t(keep))[:, None, None, :]
        elif case == "attend_causal":
            jb = jnn.causal_bias(M)[None, None]
            tb = tnn.causal_bias(M)[None, None]
        ref = jm.apply(v, jnp.asarray(x), jnp.asarray(x), jb)
        out = tm(_t(x), _t(x), tb)
    elif case in ("attend_shared", "attend_shared_bias"):
        jb = tb = None
        if case == "attend_shared_bias":
            jb = jnn.keep_to_bias(jnp.asarray(keep))[:, None, :]
            tb = tnn.keep_to_bias(_t(keep))[:, None, :]
        ref = jm.apply(v, jnp.asarray(q_in), jnp.asarray(mem), jb, method=JM.attend_shared)
        out = tm.attend_shared(_t(q_in), _t(mem), tb)
    elif case == "attend_shared_q8":
        mi, sc = jquantize(jnp.asarray(mem))
        ref = jm.apply(v, jnp.asarray(q_in), (mi, sc), method=JM.attend_t_any)
        out = tm.attend_t_any(_t(q_in), tquantize(_t(mem)))
    elif case == "attend_t":
        T = 9
        k_t = rng.normal(size=(B, H, D // H, T)).astype(np.float32)
        v_t = rng.normal(size=(B, H, D // H, T)).astype(np.float32)
        kp = keep[:, :T]
        ref = jm.apply(v, jnp.asarray(q_in), jnp.asarray(k_t), jnp.asarray(v_t),
                       jnn.keep_to_bias(jnp.asarray(kp))[:, None, :], method=JM.attend_t)
        out = tm.attend_t(_t(q_in), _t(k_t), _t(v_t), tnn.keep_to_bias(_t(kp))[:, None, :])
    else:  # attend_t_q8tok: int8 per-token self caches
        T = 9
        k_i8 = rng.integers(-127, 128, size=(B, H, D // H, T)).astype(np.int8)
        v_i8 = rng.integers(-127, 128, size=(B, H, D // H, T)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, size=(B, H, T)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, size=(B, H, T)).astype(np.float32)
        kp = keep[:, :T]
        ref = jm.apply(v, jnp.asarray(q_in), *map(jnp.asarray, (k_i8, v_i8, ks, vs)),
                       jnn.keep_to_bias(jnp.asarray(kp))[:, None, :], method=JM.attend_t_q8tok)
        out = tm.attend_t_q8tok(_t(q_in), *map(_t, (k_i8, v_i8, ks, vs)),
                                tnn.keep_to_bias(_t(kp))[:, None, :])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


# ---- encoder and decoder stacks -------------------------------------------


@pytest.mark.parametrize("norm_first", [True, False])  # pre-LN (image/constraint), post-LN (FIDNet)
def test_encoder_stack_matches_jax(norm_first):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 9, D)).astype(np.float32)
    keep = rng.random((3, 9)) > 0.3
    keep[0] = False  # a row with no kept key
    je = jnn.TransformerEncoder(D, H, 2, 64, dropout=0.0, norm_first=norm_first)
    v = je.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(keep))
    te = _bridge(tnn.TransformerEncoder(D, H, 2, 64, norm_first=norm_first), v)
    for kp in (None, keep):
        ref = je.apply(v, jnp.asarray(x), None if kp is None else jnp.asarray(kp))
        out = te(_t(x), None if kp is None else _t(kp))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def _decoder_pair(V=20, T=6, B=3, M=5):
    rng = np.random.default_rng(4)
    seq = rng.integers(0, V, (B, T))
    memory = rng.normal(size=(B, M, D)).astype(np.float32)
    jd = jnn.TokenDecoder(V, D, H, 2, 64, dropout=0.0)
    v = jd.init(jax.random.PRNGKey(5), jnp.asarray(seq), jnp.asarray(memory))
    td = _bridge(tnn.TokenDecoder(V, D, H, 2, 64), v)
    return rng, jd, v, td, seq, memory


def test_token_decoder_forward_matches_jax():
    rng, jd, v, td, seq, memory = _decoder_pair()
    tgt_keep = rng.random(seq.shape) > 0.2
    mem_keep = np.ones(memory.shape[:2], bool)
    mem_keep[0, 3:] = False
    ref = jd.apply(v, jnp.asarray(seq), jnp.asarray(memory), jnp.asarray(tgt_keep),
                   jnp.asarray(mem_keep))
    out = td(_t(seq), _t(memory), _t(tgt_keep), _t(mem_keep))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kv_quant,self_quant", [(False, False), (True, False), (True, True)])
def test_cached_step_matches_jax(kv_quant, self_quant):
    """The cached decode step (step / step_q8 over init_cache and
    cross_kv(shared=True)) against the JAX step on the same tokens; without
    quantisation it must also reproduce the full causal forward."""
    rng, jd, v, td, seq, memory = _decoder_pair()
    B, T = seq.shape
    JD = jnn.TokenDecoder
    jcache = jd.apply(v, B, T, self_quant, method=JD.init_cache)
    jcross = jd.apply(v, jnp.asarray(memory), kv_quant, method=JD.cross_kv)
    tcache = td.stack.init_cache(B, T, self_quant)
    tcross = td.stack.cross_kv(_t(memory), kv_quant)
    if kv_quant:
        np.testing.assert_array_equal(tcross[0].numpy(), np.asarray(jcross[0]))
    j_logits, t_logits = [], []
    for t in range(T):
        self_keep = np.broadcast_to(np.arange(T) <= t, (B, T))
        jx = jd.apply(v, jnp.asarray(seq[:, t]), jnp.int32(t), method=JD.embed_step)
        jx, jcache = jd.apply(v, jx, jnp.int32(t), jcache, jcross, jnp.asarray(self_keep), None,
                              method=JD.step)
        j_logits.append(np.asarray(jd.apply(v, jx, method=JD.head))[:, 0])
        tx = td.embed_step(_t(seq[:, t]), t)
        tx = td.stack.step(tx, t, tcache, tcross, _t(self_keep), None)
        t_logits.append(td.head(tx)[:, 0].detach().numpy())
    np.testing.assert_allclose(np.stack(t_logits, 1), np.stack(j_logits, 1), atol=2e-4, rtol=1e-4)
    if not kv_quant:
        full = td(_t(seq), _t(memory)).detach().numpy()
        np.testing.assert_allclose(np.stack(t_logits, 1), full, atol=2e-4)


# ---- image encoder, FIDNet, RALF heads -------------------------------------


@pytest.mark.parametrize("uint8", [False, True])
def test_image_encoder_matches_jax(uint8):
    rng = np.random.default_rng(6)
    img = rng.random((2, 64, 48, 4)).astype(np.float32)
    if uint8:  # the uint8 ingress, normalised inside the encoder
        img = (img * 255).astype(np.uint8)
    ji = jres.ImageEncoder("resnet18", D, H, 1, 64, dropout=0.0)
    v = _randomize_batch_stats(ji.init(jax.random.PRNGKey(7), jnp.asarray(img)))
    ti = _bridge(tres.ImageEncoder("resnet18", D, H, 1, 64), v)
    ref = ji.apply(v, jnp.asarray(img))
    out = ti(_t(img))
    assert out.shape == (2, 4 * 3, D)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-3, rtol=1e-3)


def test_trap_nearest_upsample_is_nearest_exact():
    """At a 350x240 canvas the mini-FPN upsamples 11x8 -> 22x15: a factor
    that is not an integer in width.  jax.image.resize(nearest) samples at
    half-pixel centres, which is torch's nearest-exact; legacy nearest
    picks other columns."""
    f5 = np.random.default_rng(8).normal(size=(1, 11, 8, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(f5), (1, 22, 15, 3), method="nearest"))
    x = _t(f5).permute(0, 3, 1, 2)
    exact = F.interpolate(x, size=(22, 15), mode="nearest-exact").permute(0, 2, 3, 1).numpy()
    legacy = F.interpolate(x, size=(22, 15), mode="nearest").permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(exact, ref)
    assert np.abs(legacy - ref).max() > 0.5


def test_fidnet_features_match_jax():
    rng = np.random.default_rng(9)
    lay = _random_layout(rng, 5, 10)
    lay["mask"][1] = False  # an empty layout: only the CLS token is kept
    jf = jfid.FIDNetV3(3, 64, 4, 2, max_bbox=10)  # RALF's is 256 wide, 4 layers
    v = jf.init(jax.random.PRNGKey(10), _jlayout(lay), method=jfid.FIDNetV3.extract_features)
    tf = _bridge(tfid.FIDNetV3(3, 64, 4, 2, max_bbox=10), v)
    ref = jf.apply(v, _jlayout(lay), method=jfid.FIDNetV3.extract_features)
    out = tf.extract_features(TLayout.fromdict(lay))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_trap_layernorm_epsilon_and_tanh_gelu():
    """flax LayerNorm uses eps 1e-6 (torch 1e-5) and flax nn.gelu is the
    tanh approximation: ViTFeedForward matches only with both."""
    assert tnn.layer_norm(8).eps == 1e-6
    x = (np.random.default_rng(11).normal(size=(2, 5, D)) * 1e-3).astype(np.float32)
    jf = jralf.ViTFeedForward(4 * D, D)
    v = jf.init(jax.random.PRNGKey(12), jnp.asarray(x))
    tf = _bridge(tralf.ViTFeedForward(D, 4 * D, D), v)
    np.testing.assert_allclose(tf(_t(x)).detach().numpy(), np.asarray(jf.apply(v, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)
    ctx = np.random.default_rng(13).normal(size=(2, 4, D)).astype(np.float32)
    ja = jralf.ViTCrossAttention(heads=4, dim_head=8)
    va = ja.init(jax.random.PRNGKey(14), jnp.asarray(x), jnp.asarray(ctx))
    ta = _bridge(tralf.ViTCrossAttention(D, 4, 8), va)
    np.testing.assert_allclose(ta(_t(x), _t(ctx)).detach().numpy(),
                               np.asarray(ja.apply(va, jnp.asarray(x), jnp.asarray(ctx))),
                               atol=1e-5, rtol=1e-5)


def test_trap_two_neg_inf_constants():
    """Attention masks add the finite -1e9; the sampler masks logits with
    float32's lowest value.  Neither is -inf."""
    assert tnn.NEG_INF == jnn.NEG_INF == -1e9
    assert tsamp.NEG_INF == float(jsamp.NEG_INF) == torch.finfo(torch.float32).min
    assert float(tnn.keep_to_bias(torch.tensor([False]))[0]) == -1e9


# ---- tokenizer, conditioning, sampling -------------------------------------


def _tokenizers(S=10, num_bin=16):
    return JTokenizer(JTokCfg(num_labels=3, max_seq_length=S, num_bin=num_bin)), \
        TTokenizer(TTokCfg(num_labels=3, max_seq_length=S, num_bin=num_bin))


def test_tokenizer_matches_jax():
    jt, tt = _tokenizers()
    assert (jt.N_total, jt.bos_id, jt.eos_id, jt.pad_id, jt.max_token_length) == \
        (tt.N_total, tt.bos_id, tt.eos_id, tt.pad_id, tt.max_token_length)
    np.testing.assert_array_equal(tt.token_mask, jt.token_mask)
    rng = np.random.default_rng(15)
    lay = _random_layout(rng, 16, 10)
    je, te = jt.encode(_jlayout(lay)), tt.encode(TLayout.fromdict(lay))
    np.testing.assert_array_equal(te["seq"].numpy(), np.asarray(je["seq"]))
    np.testing.assert_array_equal(te["mask"].numpy(), np.asarray(je["mask"]))
    # decode: the encoded sequences, and random ones with stray specials and EOS
    seqs = np.concatenate([np.asarray(je["seq"])[:, 1:],
                           rng.integers(0, jt.N_total, (16, jt.max_token_length))])
    jd, td = jt.decode(jnp.asarray(seqs)), tt.decode(_t(seqs))
    for k, a in td.numpy().items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jd, k)), err_msg=k)


def test_uncond_conditioning_matches_jax():
    jt, tt = _tokenizers()
    jv, tv = jcond.ConstraintVocabulary(jt), tcond.ConstraintVocabulary(tt)
    assert jv.N_total == tv.N_total and jv.const_len("uncond") == tv.const_len("uncond")
    lay = _random_layout(np.random.default_rng(16), 4, 10)
    img = np.zeros((4, 8, 8, 4), np.float32)
    jc, _ = jcond.get_condition(_jlayout(lay), img, "uncond", jt, np.random.default_rng(0))
    tc, _ = tcond.get_condition(TLayout.fromdict(lay), img, "uncond")
    js, jm = jcond.build_constraint_sequence(jc, jv, np.random.default_rng(0))
    ts, tm = tcond.build_constraint_sequence(tc, tv)
    np.testing.assert_array_equal(ts, np.asarray(js))
    np.testing.assert_array_equal(tm, np.asarray(jm))
    np.testing.assert_array_equal(tcond.build_forced_tokens(tc, tt),
                                  np.asarray(jcond.build_forced_tokens(jc, jt)))
    with pytest.raises(NotImplementedError):
        tcond.get_condition(TLayout.fromdict(lay), img, "c")


@pytest.mark.parametrize("p", [0.5, 0.9, 0.99, 1.0])
def test_top_p_kept_set_matches_jax(p):
    """jax.random cannot be reproduced, so top-p is held by its kept set on
    shared logits (with exact ties, which the bisection keeps together)."""
    rng = np.random.default_rng(17)
    logits = rng.normal(size=(64, 40)).astype(np.float32) * 2
    logits[:8, 5] = logits[:8, 9] = logits[:8].max(axis=1) + 0.5  # tied maxima
    logits[8:16, :] = logits[8:16, :1]  # all tied
    ref = np.asarray(jsamp.top_p_filter_bisect(jnp.asarray(logits), p)) > jsamp.NEG_INF
    out = tsamp.top_p_filter_bisect(_t(logits), p).numpy() > tsamp.NEG_INF
    np.testing.assert_array_equal(out, ref)
    det = tsamp.sample(_t(logits), tsamp.SamplingConfig(name="deterministic"))
    np.testing.assert_array_equal(det.numpy(), np.asarray(jsamp.sample(
        None, jnp.asarray(logits), jsamp.SamplingConfig(name="deterministic"))))


def test_sampled_draws_follow_the_filtered_softmax():
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0, -30.0]]).repeat(40000, 1)
    g = torch.Generator().manual_seed(0)
    draws = tsamp.sample(logits, tsamp.SamplingConfig(name="top_p", top_p=0.9), g)
    kept = tsamp.top_p_filter_bisect(logits[:1], 0.9)[0] > tsamp.NEG_INF
    assert kept.tolist() == [True, True, False, False, False]
    freq = torch.bincount(draws, minlength=5).float() / draws.numel()
    want = torch.softmax(torch.where(kept, logits[0], tsamp.NEG_INF), -1)
    assert (freq - want).abs().max() < 0.01  # ~4 standard errors at n=40000


# ---- data and retrieval ----------------------------------------------------


def _datasets(size=24, hw=(40, 32), seed=3):
    cfg = dict(name="synthetic")
    return (jdata.SyntheticPosterDataset(jdata.DatasetConfig(**cfg), size, seed, hw),
            tdata.SyntheticPosterDataset(tdata.DatasetConfig(**cfg), size, seed, hw))


def test_dataset_and_loader_match_jax():
    jd, td = _datasets()
    idx = np.arange(len(jd))
    for k, a in td.get_layouts(idx).items():
        np.testing.assert_array_equal(a, jd.get_layouts(idx)[k], err_msg=k)
    for dt in (np.float32, np.uint8):
        np.testing.assert_array_equal(td.get_images(idx[:5], dt), jd.get_images(idx[:5], dt))
    jl = jdata.BatchLoader(jd, 8, seed=4, use_native=False, prefetch=0, image_dtype=np.uint8)
    tl = tdata.BatchLoader(td, 8, seed=4, image_dtype=np.uint8)
    for jb, tb in zip(jl, tl, strict=True):
        np.testing.assert_array_equal(tb["indices"], jb["indices"])
        np.testing.assert_array_equal(tb["image"], jb["image"])
        for k, a in tb["layout"].numpy().items():
            np.testing.assert_array_equal(a, np.asarray(getattr(jb["layout"], k)), err_msg=k)


def test_trap_retrieval_thumbnail_antialias():
    """jax.image.resize(linear) antialiases when it shrinks; torch's
    bilinear does so only with antialias=True."""
    jd, td = _datasets(size=6, hw=(350, 240))
    img = td.get_images(np.arange(6))
    ref = np.asarray(jret.coarse_saliency_features(jnp.asarray(img)))
    out = tret.coarse_saliency_features(_t(img)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    sal = _t(img)[..., 3][:, None]
    plain = F.interpolate(sal, size=(16, 16), mode="bilinear", align_corners=False)
    plain = plain.reshape(6, -1)
    plain = plain / plain.norm(dim=-1, keepdim=True)
    assert np.abs(plain.numpy() - ref).max() > 0.05
    img8 = td.get_images(np.arange(6), np.uint8)
    np.testing.assert_allclose(tret.coarse_saliency_features(_t(img8)).numpy(),
                               np.asarray(jret.coarse_saliency_features(jnp.asarray(img8))),
                               atol=1e-5)


def test_retrieval_topk_and_loader_match_jax():
    jg, tg = _datasets(size=40, hw=(48, 32), seed=5)
    jq, tq = _datasets(size=16, hw=(48, 32), seed=6)
    jr = jret.Retriever.build(jg)
    tr = tret.Retriever.build(tg, device="cpu")
    np.testing.assert_allclose(tr.features.numpy(), np.asarray(jr.features), atol=1e-6)
    for train_split, (jds, tds) in ((False, (jq, tq)), (True, (jg, tg))):
        jt = jr.precompute_table(jds, 4, is_train_split=train_split)
        tt = tr.precompute_table(tds, 4, is_train_split=train_split)
        np.testing.assert_array_equal(tt, jt)
    feats = np.random.default_rng(7).normal(size=(40, 256)).astype(np.float32)
    jl = jwrap.RetrievalAugmentedLoader(
        jdata.BatchLoader(jq, 8, shuffle=False, use_native=False, prefetch=0), jr, top_k=4,
        feats_table=feats)
    tl = twrap.RetrievalAugmentedLoader(tdata.BatchLoader(tq, 8, shuffle=False), tr, top_k=4,
                                        feats_table=feats)
    for jb, tb in zip(jl, tl, strict=True):
        np.testing.assert_array_equal(tb["retrieved_indices"], jb["retrieved_indices"])
        for k, a in tb["retrieved"].items():
            np.testing.assert_array_equal(a, np.asarray(jb["retrieved"][k]), err_msg=k)
