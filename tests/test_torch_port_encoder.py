"""The port's fused encoder configuration against the JAX package.

`MultiHeadAttention.use_qkv_folded` (self-attention through K6) and
`FeedForward.use_pallas` (the FFN through K5) are the JAX modules' fields.
On the CPU the port's wrappers run their plain versions; the JAX modules
are held to the same fields with their Pallas kernels forced into
interpret mode by monkeypatching inside the test, as tests/test_nn.py
does, and the JAX package is left as it is.  The tiny RALF with both flags
on every module is held against the JAX package's RALF (which on the CPU
takes its XLA paths, the same function), and FIDNet's full forward against
`FIDNetV3.__call__`.  Everything runs in float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ralf_tpu.core.layout import Layout as JLayout
from ralf_tpu.core.sampling import SamplingConfig as JSampling
from ralf_tpu.core.tokenizer import LayoutSequenceTokenizer as JTokenizer
from ralf_tpu.core.tokenizer import TokenizerConfig as JTokCfg
from ralf_tpu.data import dataset as jdata
from ralf_tpu.models import fidnet as jfid
from ralf_tpu.models import nn as jnn
from ralf_tpu.models.base import GeneratorConfig as JCfg
from ralf_tpu.models.ralf import RALFGenerator as JRALF
from ralf_tpu.ops.pallas import decode_attention as jda
from ralf_tpu.ops.pallas import encoder_attention as jea
from ralf_tpu.ops.pallas import encoder_ffn as jef
from ralf_tpu.retrieval import retriever as jret
from ralf_tpu.retrieval import wrapper as jwrap
from ralf_tpu_torch.core.conditioning import build_forced_tokens
from ralf_tpu_torch.core.layout import Layout as TLayout
from ralf_tpu_torch.core.sampling import SamplingConfig as TSampling
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer as TTokenizer
from ralf_tpu_torch.core.tokenizer import TokenizerConfig as TTokCfg
from ralf_tpu_torch.data import dataset as tdata
from ralf_tpu_torch.models import fidnet as tfid
from ralf_tpu_torch.models import nn as tnn
from ralf_tpu_torch.models.base import GeneratorConfig as TCfg
from ralf_tpu_torch.models.ralf import RALFGenerator as TRALF
from ralf_tpu_torch.retrieval import retriever as tret
from ralf_tpu_torch.retrieval import wrapper as twrap
from ralf_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(2)
D, H = 32, 4
TINY = dict(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=1,
            dim_feedforward=64, backbone="resnet18")
TOP_K = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_biases(params, seed=0, scale=0.3):
    """Every `bias` leaf drawn at random: flax initialises them to zero,
    which would leave the folded path's bias recovery untested."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (jnp.asarray(rng.normal(0, scale, a.shape).astype(np.float32))
                      if p[-1].key == "bias" else a), params)


def set_fused_encoder(module: torch.nn.Module) -> None:
    """Both flags on every module, as the JAX modules' fields."""
    for m in module.modules():
        if isinstance(m, tnn.MultiHeadAttention):
            m.use_qkv_folded = True
        elif isinstance(m, tnn.FeedForward):
            m.use_pallas = True


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX modules' Pallas paths, run in interpret mode on the CPU."""
    monkeypatch.setattr(jda, "pallas_decode_available", lambda: True)
    folded, unfolded = jea._fused_qkv_forward, jea._fused_forward
    monkeypatch.setattr(jea, "_fused_qkv_forward",
                        lambda x, w, h, kb, interp, bb, qc: folded(x, w, h, kb, True, bb, qc))
    monkeypatch.setattr(jea, "_fused_forward", lambda q, k, v, h, kb, interp, bb, qc:
                        unfolded(q, k, v, h, kb, True, bb, qc))
    monkeypatch.setattr(jef, "fused_ffn", functools.partial(jef.fused_ffn, interpret=True))


@pytest.fixture
def spies(monkeypatch):
    """Counts the port modules' calls of the K5 and K6 wrappers."""
    calls = {"K5": 0, "K6": 0}

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tnn, "fused_ffn", spy("K5", tnn.fused_ffn))
    monkeypatch.setattr(tnn, "encoder_self_attention", spy("K6", tnn.encoder_self_attention))
    return calls


@pytest.mark.parametrize("case", ["none", "key_bias", "dead_row", "causal"])
def test_mha_qkv_folded_matches_jax(case, jax_interpret, spies):
    rng = np.random.default_rng(0)
    B, S = 3, 10
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    jm = jnn.MultiHeadAttention(D, H, dropout=0.0, use_qkv_folded=True)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(x))
    v = {"params": _random_biases(v["params"])}
    tm = tnn.MultiHeadAttention(D, H, use_qkv_folded=True).eval()  # K6 is an eval-mode path
    load_jax_params(tm, _np(v["params"]))
    keep = rng.random((B, S)) > 0.3
    keep[:, 0] = True
    if case == "dead_row":
        keep[1] = False
    jb = tb = None
    if case in ("key_bias", "dead_row"):
        jb = jnn.keep_to_bias(jnp.asarray(keep))[:, None, None, :]
        tb = tnn.keep_to_bias(_t(keep))[:, None, None, :]
    elif case == "causal":  # a structured bias: both take the unfolded path
        jb, tb = jnn.causal_bias(S)[None, None], tnn.causal_bias(S)[None, None]
    ref = jm.apply(v, jnp.asarray(x), jnp.asarray(x), jb)
    tx = _t(x)
    out = tm(tx, tx, tb)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert spies["K6"] == (0 if case == "causal" else 1)
    tm.use_qkv_folded = False  # the unfolded path computes the same function
    np.testing.assert_allclose(tm(tx, tx, tb).detach().numpy(), out.detach().numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [10, 20])  # below and above the S >= 16 gate
def test_feedforward_use_pallas_matches_jax(S, jax_interpret, spies):
    x = np.random.default_rng(1).normal(size=(3, S, D)).astype(np.float32)
    jf = jnn.FeedForward(D, 64, dropout=0.0, use_pallas=True)
    v = jf.init(jax.random.PRNGKey(2), jnp.asarray(x))
    v = {"params": _random_biases(v["params"], seed=1)}
    tf = tnn.FeedForward(D, 64, use_pallas=True).eval()  # K5 is an eval-mode path
    load_jax_params(tf, _np(v["params"]))
    ref = jf.apply(v, jnp.asarray(x))
    out = tf(_t(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert spies["K5"] == (1 if S >= 16 else 0)


@pytest.fixture(scope="module")
def ralf_pair():
    """The tiny RALF in both packages on the same weights (random biases),
    the port with both flags on every module, and a batch of both."""
    jt = JTokenizer(JTokCfg(num_labels=3, max_seq_length=10, num_bin=16))
    tt = TTokenizer(TTokCfg(num_labels=3, max_seq_length=10, num_bin=16))
    jg = JRALF(jt, JCfg(**TINY), "c", image_hw=(64, 48), top_k=TOP_K)
    v = jg.init(jax.random.PRNGKey(0))
    v = {"params": _random_biases(v["params"], scale=0.1), "batch_stats": v["batch_stats"]}
    tg = TRALF(tt, TCfg(**TINY), "c", image_hw=(64, 48), top_k=TOP_K, device="cpu")
    load_jax_params(tg.core, _np(v["params"]), _np(v["batch_stats"]))
    set_fused_encoder(tg.core)
    batches = {}
    for name, data, ret, wrap in (("jax", jdata, jret, jwrap), ("port", tdata, tret, twrap)):
        cfg = data.DatasetConfig(name="synthetic")
        gallery = data.SyntheticPosterDataset(cfg, 24, 1, (64, 48))
        queries = data.SyntheticPosterDataset(cfg, 3, 2, (64, 48))
        if name == "jax":
            retriever = ret.Retriever.build(gallery)
            loader = data.BatchLoader(queries, 3, shuffle=False, use_native=False, prefetch=0)
            feats = jg.precompute_retrieved_feats(v, retriever.layouts)
        else:
            retriever = ret.Retriever.build(gallery, device="cpu")
            loader = data.BatchLoader(queries, 3, shuffle=False)
            feats = tg.precompute_retrieved_feats(retriever.layouts)
        batches[name] = (feats, next(iter(wrap.RetrievalAugmentedLoader(
            loader, retriever, TOP_K, feats_table=feats))))
    return jt, tt, jg, v, tg, batches


def test_ralf_with_the_fused_encoder_matches_jax(ralf_pair, spies):
    """encode_memory to 1e-4 and equal greedy tokens, task `c` (constraint
    length 23, so the constraint encoder's FFN passes the S >= 16 gate)."""
    jt, tt, jg, v, tg, batches = ralf_pair
    np.testing.assert_allclose(batches["port"][0], batches["jax"][0], atol=1e-4, rtol=1e-4)
    jc, _ = jg.build_condition(batches["jax"][1], np.random.default_rng(0))
    tc, _ = tg.build_condition(batches["port"][1], np.random.default_rng(0))
    assert tc.const_seq.shape[1] >= 16
    jmem = np.asarray(jg.encode_memory(v, jc))
    tmem = tg.encode_memory(tc)
    np.testing.assert_allclose(tmem.numpy(), jmem, atol=1e-4, rtol=1e-4)
    # one layer each of the image and constraint encoders: 2 self-attentions,
    # and the constraint encoder's FFN (the image memory is 12 tokens)
    assert spies == {"K5": 1, "K6": 2}
    forced = build_forced_tokens(tc, tt)
    jtok = np.asarray(jg.decode(v, jnp.asarray(jmem), forced, JSampling(name="deterministic"),
                                jax.random.PRNGKey(0)))
    ttok = tg.decode(tmem, forced, TSampling(name="deterministic"))
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    assert spies == {"K5": 1, "K6": 2}  # the decode steps take neither


def _layout(seed, B=5, S=10):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, S + 1, size=B)
    n[0], n[1] = S, 0  # one full layout, one empty (fully masked decoder rows)
    mask = np.arange(S)[None, :] < n[:, None]
    d = {k: np.where(mask, rng.random((B, S)), 0).astype(np.float32)
         for k in ("center_x", "center_y", "width", "height")}
    d["label"] = np.where(mask, rng.integers(0, 3, (B, S)), 0)
    d["mask"] = mask
    return d


@pytest.mark.parametrize("fused", [False, True])
def test_fidnet_full_forward_matches_jax(fused, spies):
    lay = _layout(3)
    jl = JLayout.fromdict({k: jnp.asarray(a) for k, a in lay.items()})
    jf = jfid.FIDNetV3(3, 64, 4, 2, max_bbox=10)
    v = jf.init(jax.random.PRNGKey(4), jl)
    v = {"params": _random_biases(v["params"], seed=2, scale=0.1)}
    tf = tfid.FIDNetV3(3, 64, 4, 2, max_bbox=10).eval()
    load_jax_params(tf, _np(v["params"]))  # every head of the full forward is filled
    if fused:
        set_fused_encoder(tf)
    refs = jf.apply(v, jl)
    outs = tf(TLayout.fromdict(lay))
    assert [tuple(o.shape) for o in outs] == [(5,), (5, 10, 3), (5, 10, 4)]
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    assert spies["K6"] == (4 if fused else 0)  # 2 encoder + 2 decoder layers
