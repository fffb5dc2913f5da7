"""RALF's seven fusion modes in the port against the JAX package, on the CPU.

Each mode is initialised in JAX (tiny: d_model 32, 4 heads, 1+1 layers,
resnet18, 64x48 canvases, top-4 retrieval, as tests/test_ralf_fusion.py)
and loaded into the port through the weights bridge; both packages build
the same retrieval-augmented batch from the same numpy seeds.

Tolerances: encode_memory and the teacher-forced logits within 1e-5
(atol and rtol; one fp32 forward of a small model), the loss rtol 1e-5,
greedy tokens equal.  The loss is compared in eval mode (JAX's
train=False) and in train mode at dropout 0, where BatchNorm uses the
batch's statistics; post_encoder's modality encoder keeps dropout 0.1
whatever cfg.dropout is (JAX's `ralf.py:172-177`), so its train-mode pass
is random in both packages and is held by its rate instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ralf_tpu.core.sampling import SamplingConfig as JSampling
from ralf_tpu.core.tokenizer import LayoutSequenceTokenizer as JTokenizer
from ralf_tpu.core.tokenizer import TokenizerConfig as JTokCfg
from ralf_tpu.data import dataset as jdata
from ralf_tpu.models.base import GeneratorConfig as JCfg
from ralf_tpu.models.ralf import RALFGenerator as JRALF
from ralf_tpu.retrieval import retriever as jret
from ralf_tpu.retrieval import wrapper as jwrap
from ralf_tpu_torch.core.conditioning import build_forced_tokens
from ralf_tpu_torch.core.sampling import SamplingConfig as TSampling
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer as TTokenizer
from ralf_tpu_torch.core.tokenizer import TokenizerConfig as TTokCfg
from ralf_tpu_torch.data import dataset as tdata
from ralf_tpu_torch.models.base import GeneratorConfig as TCfg
from ralf_tpu_torch.models.dropout import Dropout, set_dropout_generator
from ralf_tpu_torch.models.ralf import RALFCore
from ralf_tpu_torch.models.ralf import RALFGenerator as TRALF
from ralf_tpu_torch.retrieval import retriever as tret
from ralf_tpu_torch.retrieval import wrapper as twrap
from ralf_tpu_torch.utils.weights import export_params, load_jax_params

torch.set_num_threads(2)
TINY = dict(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=1,
            dim_feedforward=64, backbone="resnet18", dropout=0.0)
K, HW, M = 4, (64, 48), 12  # M: the 4x3 feature map of a 64x48 canvas
TOL = 1e-5
# mode: the fused memory's length before the constraint (tests/test_ralf_fusion.py)
MODES = {"concat_crossattn": 2 * M + K, "crossattn": 2 * M, "concat": M + K,
         "adapter": M + K, "flag_concat_crossattn": 2 * M + K, "pre_encoder": 2 * M + K,
         "post_encoder": M + K}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def batches():
    """One batch of 3 canvases with their top-4, built by each package."""
    out = {}
    for name, data, ret, wrap in (("jax", jdata, jret, jwrap), ("port", tdata, tret, twrap)):
        cfg = data.DatasetConfig(name="synthetic")
        gallery = data.SyntheticPosterDataset(cfg, 16, 1, HW)
        queries = data.SyntheticPosterDataset(cfg, 3, 2, HW)
        if name == "jax":
            retriever = ret.Retriever.build(gallery)
            loader = data.BatchLoader(queries, 3, shuffle=False, use_native=False, prefetch=0)
        else:
            retriever = ret.Retriever.build(gallery, device="cpu")
            loader = data.BatchLoader(queries, 3, shuffle=False)
        out[name] = next(iter(wrap.RetrievalAugmentedLoader(loader, retriever, K)))
    return out


def _variables(jg, rng):
    """Variables of `jg`'s mode without compiling its init: the tree's
    structure from jax.eval_shape (tracing only), every leaf drawn from
    `rng` (fresh for each mode; BatchNorm statistics non-trivial)."""
    shapes = jax.eval_shape(jg.init, jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, leaf.shape).astype(np.float32)
        if name == "embedding" or leaf.ndim < 2:
            return rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))  # flax's kernels end in their outputs
        return rng.normal(0, fan_in**-0.5, leaf.shape).astype(np.float32)

    return {c: jax.tree_util.tree_map_with_path(draw, dict(shapes[c]))
            for c in ("params", "batch_stats")}


@pytest.fixture(scope="module", params=list(MODES))
def pair(request, batches):
    """(mode, JAX generator, its variables, port generator, both conditions
    and memories, both preprocessed batches) for one mode."""
    mode = request.param
    jt = JTokenizer(JTokCfg(num_labels=3, max_seq_length=10, num_bin=16))
    tt = TTokenizer(TTokCfg(num_labels=3, max_seq_length=10, num_bin=16))
    jg = JRALF(jt, JCfg(**TINY), "c", image_hw=HW, top_k=K, fusion=mode)
    v = _variables(jg, np.random.default_rng(list(MODES).index(mode)))
    tg = TRALF(tt, TCfg(**TINY), "c", image_hw=HW, top_k=K, fusion=mode, device="cpu")
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    v = jax.tree.map(jnp.asarray, v)
    jc, _ = jg.build_condition(batches["jax"], np.random.default_rng(1))
    tc, _ = tg.build_condition(batches["port"], np.random.default_rng(1))
    pre = {"jax": jg.preprocess(batches["jax"], np.random.default_rng(2)),
           "port": tg.preprocess(batches["port"], np.random.default_rng(2))}
    return dict(mode=mode, jt=jt, tt=tt, jg=jg, v=v, tg=tg, jc=jc, tc=tc, pre=pre,
                jmem=np.asarray(jg.encode_memory(v, jc)), tmem=tg.encode_memory(tc))


def test_encode_memory_matches_jax(pair):
    Lc = pair["tg"].vocab.const_len("c")
    assert pair["tmem"].shape == pair["jmem"].shape == (3, MODES[pair["mode"]] + Lc, 32)
    np.testing.assert_allclose(pair["tmem"].numpy(), pair["jmem"], atol=TOL, rtol=TOL)


def _jax_inputs(inputs):
    return jax.tree.map(jnp.asarray, inputs)


def test_teacher_forced_logits_match_jax(pair):
    (ji, _), (ti, _) = pair["pre"]["jax"], pair["pre"]["port"]
    ji = _jax_inputs(ji)
    want = np.asarray(pair["jg"].core.apply(pair["v"], ji["seq"], ji["image"], ji["retrieved"],
                                            ji["const_seq"], ji["const_keep"], ji["tgt_keep"],
                                            False))
    with torch.no_grad():
        got = pair["tg"].logits(ti).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_greedy_tokens_match_jax(pair):
    forced = build_forced_tokens(pair["tc"], pair["tt"])
    jtok = np.asarray(pair["jg"].decode(pair["v"], jnp.asarray(pair["jmem"]), forced,
                                        JSampling(name="deterministic"), jax.random.PRNGKey(0)))
    ttok = pair["tg"].decode(pair["tmem"], forced, TSampling(name="deterministic"))
    np.testing.assert_array_equal(ttok.numpy(), jtok)


def _losses(pair, train: bool):
    (ji, jtg), (ti, ttg) = pair["pre"]["jax"], pair["pre"]["port"]
    want, _ = pair["jg"].loss(pair["v"], _jax_inputs(ji), _jax_inputs(jtg), train=train,
                              rngs={"dropout": jax.random.PRNGKey(3)})
    core = pair["tg"].core
    set_dropout_generator(core, torch.Generator().manual_seed(3))
    core.train(train)
    try:
        with torch.no_grad():
            got, _ = pair["tg"].loss(ti, ttg)
    finally:
        core.eval()
        set_dropout_generator(core, None)
    return float(got), float(want)


def test_loss_matches_jax(pair):
    got, want = _losses(pair, train=False)
    np.testing.assert_allclose(got, want, rtol=TOL)
    if pair["mode"] == "post_encoder":  # the modality encoder's fixed dropout: by its rate
        drops = [m for m in pair["tg"].core.modality_encoder.modules() if isinstance(m, Dropout)]
        assert drops and {m.p for m in drops} == {RALFCore.MODALITY_DROPOUT}
        assert all(m.p == 0.0 for m in pair["tg"].core.encoder.modules()
                   if isinstance(m, Dropout))
        set_dropout_generator(drops[0], torch.Generator().manual_seed(0))
        drops[0].train()
        kept = (drops[0](torch.ones(200_000)) != 0).float().mean().item()
        drops[0].eval()
        assert abs(kept - 0.9) < 4 * (0.9 * 0.1 / 200_000) ** 0.5
        train_loss, _ = _losses(pair, train=True)
        assert np.isfinite(train_loss) and train_loss != got
    else:
        got, want = _losses(pair, train=True)
        np.testing.assert_allclose(got, want, rtol=TOL)


def test_weights_bridge_round_trips_each_mode(pair):
    """export_params gives JAX's tree back: the mode's own subtrees
    (modality_emb, modality_encoder) and no submodule the mode does not call."""
    params, stats = export_params(pair["tg"].core)
    want = _np(pair["v"]["params"])
    assert sorted(params) == sorted(want)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(params),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_unknown_fusion_raises_value_error():
    tt = TTokenizer(TTokCfg(num_labels=3, max_seq_length=10, num_bin=16))
    with pytest.raises(ValueError, match="nope"):
        TRALF(tt, TCfg(**TINY), "c", image_hw=HW, top_k=K, fusion="nope", device="cpu")
    jt = JTokenizer(JTokCfg(num_labels=3, max_seq_length=10, num_bin=16))
    with pytest.raises(ValueError, match="nope"):
        jax.eval_shape(JRALF(jt, JCfg(**TINY), "c", image_hw=HW, top_k=K, fusion="nope").init,
                       jax.random.PRNGKey(0))
