"""CGL-GAN and DS-GAN (and their retrieval-augmented variants) in the port
against the JAX package: the packed layout, the random initial layout, the
IoU-grouping order, the task conditioning of the initial layout under every
task, the weights bridge's Conv1d and LSTM rules, the cores' forward, and
samples drawn from the same numpy seed.

Models are tiny (d_model 32, 4 heads in the image encoder, 1+1 layers,
resnet18, 64x48 canvases, top-4 neighbours), initialised in JAX and loaded
into the port through the weights bridge; both run on the CPU in float32.
Host-side numpy (initial layouts, permutations, the reorder) is exact; the
cores' outputs agree within 1e-4 absolute + 1e-4 relative; labels exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from ralf_tpu import config as jconfig
from ralf_tpu.core.layout import Layout as JLayout
from ralf_tpu.data import dataset as jdata
from ralf_tpu.models import dsgan as jds
from ralf_tpu.models import gan_common as jgc
from ralf_tpu_torch import config as tconfig
from ralf_tpu_torch.core.layout import Layout as TLayout
from ralf_tpu_torch.data import dataset as tdata
from ralf_tpu_torch.models import dsgan as tds
from ralf_tpu_torch.models import gan_common as tgc
from ralf_tpu_torch.utils.weights import export_params, flax_names, load_jax_params

torch.set_num_threads(2)
ATOL, RTOL = 1e-4, 1e-4
HW = (64, 48)
TINY = ["model.d_model=32", "model.nhead=4", "model.num_encoder_layers=1",
        "model.num_decoder_layers=1", "model.dim_feedforward=64", "model.backbone=resnet18",
        f"dataset.image_h={HW[0]}", f"dataset.image_w={HW[1]}", "debug=true",
        "synthetic_data=true", "generator_kwargs.top_k=4"]
PRESETS = ("cglgan", "cglgan_ra", "dsgan", "dsgan_ra")
TASKS = ("uncond", "c", "cwh", "partial", "refinement")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=rtol)


def _random_layouts(seed, B=6, S=10, L=3):
    """The same random layouts as a JAX Layout and a port Layout; rows 0 and
    1 empty and full."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, S + 1, size=B)
    n[0], n[1] = 0, S
    mask = np.arange(S)[None] < n[:, None]
    d = {"label": np.where(mask, rng.integers(0, L, (B, S)), 0).astype(np.int32), "mask": mask}
    for k in ("center_x", "center_y", "width", "height"):
        d[k] = np.where(mask, rng.uniform(0.05, 0.95, (B, S)), 0.0).astype(np.float32)
    return JLayout(**{k: v for k, v in d.items()}), TLayout.fromdict(d)


@pytest.fixture(scope="module")
def models():
    """{preset: (JAX generator, port generator, JAX variables, (JAX batch, port batch))}"""
    out = {}
    for exp in PRESETS:
        jcfg, tcfg = jconfig.build_config(exp, TINY), tconfig.build_config(exp, TINY)
        jg = jconfig.build_generator(jcfg, None)
        tg = tconfig.build_generator(tcfg, None, device="cpu")
        v = _np(jg.init(jax.random.PRNGKey(0)))
        load_jax_params(tg.core, v["params"], v["batch_stats"])
        jd, _, jtest = jconfig.build_datasets(jcfg)
        td, _, ttest = tconfig.build_datasets(tcfg)
        kw = dict(shuffle=False, transforms=(), use_native=False)
        jb = next(iter(jdata.BatchLoader(jtest, 4, prefetch=0, **kw)))
        tb = next(iter(tdata.BatchLoader(ttest, 4, **kw)))
        if tg.with_retrieval:  # neighbours from the train split, the same rows for both
            idx = np.random.default_rng(1).integers(0, len(td), size=(4, tg.top_k))
            jl, tl = jd.get_layouts(idx.reshape(-1)), td.get_layouts(idx.reshape(-1))
            jb["retrieved"] = {k: a.reshape(4, tg.top_k, -1) for k, a in jl.items()}
            tb["retrieved"] = {k: a.reshape(4, tg.top_k, -1) for k, a in tl.items()}
        out[exp] = (jg, tg, v, (jb, tb))
    return out


# ---- the host side ----------------------------------------------------------------


@pytest.mark.parametrize("K", [4, 5])
def test_pack_unpack_and_random_init_match_jax(K):
    jl, tl = _random_layouts(K, L=K - 1)
    np.testing.assert_array_equal(tgc.pack_layout(tl, K), np.asarray(jgc.pack_layout(jl, K)))
    rng = np.random.default_rng(K)
    logits = rng.normal(size=(6, 10, K)).astype(np.float32)
    boxes = rng.uniform(size=(6, 10, 4)).astype(np.float32)
    got = tgc.unpack_outputs(torch.from_numpy(logits), torch.from_numpy(boxes), K).numpy()
    want = jgc.unpack_outputs(jnp.asarray(logits), jnp.asarray(boxes), K)
    for k, a in got.items():
        np.testing.assert_array_equal(a, np.asarray(getattr(want, k)), err_msg=k)
    for coef, n in ((None, None), (tgc.DS_COEF[K], None), (None, np.array([1, 10, 3, 7]))):
        a = tgc.random_init_layout(np.random.default_rng(3), 4, 10, K, coef, n)
        b = jgc.random_init_layout(np.random.default_rng(3), 4, 10, K, coef, n)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.float32


def test_reorder_matches_jax():
    """The IoU-grouping order on random layouts with every class mix, boxes
    that overlap often (max_elem below and at S)."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 11))
        cls = rng.integers(0, 4, size=n)
        box = np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.05, 0.6, (n, 2))], -1)
        box = box.astype(np.float32)
        for max_elem in (None, int(rng.integers(1, n + 1))):
            assert tgc.reorder(cls, box, max_elem) == jgc.reorder(cls, box, max_elem)


@pytest.mark.parametrize("exp", ["cglgan", "dsgan"])
@pytest.mark.parametrize("task", TASKS)
def test_preprocess_matches_jax(models, exp, task):
    """The initial layout (coef prior, the task's part of the ground truth,
    refinement's noise, the per-row permutations; DS-GAN's reorder) and the
    targets, from the same numpy seed, exactly; the element-count EMA too."""
    jg, tg, _, (jb, tb) = models[exp]
    jg.task = tg.task = task
    try:
        ji, jt = jg.preprocess(jb, np.random.default_rng(5))
        ti, tt = tg.preprocess(tb, np.random.default_rng(5))
    finally:
        jg.task = tg.task = "uncond"
    np.testing.assert_array_equal(ti["layout"], ji["layout"])
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    np.testing.assert_allclose(tg.seq_dist.n_elements_prob, jg.seq_dist.n_elements_prob,
                               rtol=1e-12)


def test_seq_dist_init_matches_jax(models):
    """use_seq_dist: uncond inits past a drawn element count start as the
    no-object class, the counts drawn from the same rng stream."""
    jg, tg, _, (jb, tb) = models["cglgan"]
    jg.use_seq_dist = tg.use_seq_dist = True
    try:
        ji, _ = jg.preprocess(jb, np.random.default_rng(9))
        ti, _ = tg.preprocess(tb, np.random.default_rng(9))
    finally:
        jg.use_seq_dist = tg.use_seq_dist = False
    np.testing.assert_array_equal(ti["layout"], ji["layout"])


# ---- the weights bridge -----------------------------------------------------------


def test_lstm_and_conv1d_rules_of_the_weights_bridge():
    """flax's BiLSTM cells (input Dense without bias, hidden Dense with one,
    carry (c, h) with h0 = 0) and nn.Conv over [B, S, C]: the port's CNNLSTM
    on the loaded weights gives flax's outputs; export is the exact inverse."""
    rng = np.random.default_rng(0)
    B, S, K, D, L = 3, 10, 4, 16, 2
    packed = rng.normal(size=(B, S, 2, K)).astype(np.float32)
    c0 = rng.normal(size=(B, 2 * L, D)).astype(np.float32)
    jm = jds.CNNLSTM(32, D, L)
    params = _np(jm.init(jax.random.PRNGKey(1), jnp.asarray(packed), jnp.asarray(c0))["params"])
    tm = tds.CNNLSTM(2 * K, 32, D, L)
    load_jax_params(tm, params)
    assert float(tm.BiLSTM_0.bias_ih_l1_reverse.detach().abs().max()) == 0.0
    with torch.no_grad():
        got = tm(torch.from_numpy(packed), torch.from_numpy(c0))
    want = jm.apply({"params": params}, jnp.asarray(packed), jnp.asarray(c0))
    assert got.shape == (B, S, 2 * D)
    _close(got.numpy(), np.asarray(want), atol=1e-5)
    exported, _ = export_params(tm)
    a, b = flatten_dict(params), flatten_dict(exported)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg="/".join(k))
    # a non-zero input bias folds into the hidden bias on export
    with torch.no_grad():
        tm.BiLSTM_0.bias_ih_l0.fill_(0.5)
    moved = flatten_dict(export_params(tm)[0])
    key = ("BiLSTM_0", "l0_d0", "hf", "bias")
    np.testing.assert_allclose(moved[key], a[key] + 0.5, rtol=1e-6)
    names = flax_names(tm)
    assert names["BiLSTM_0.weight_hh_l1_reverse"] == ("BiLSTM_0", "l1_d1", "h", "kernel")
    assert names["Conv_0.weight"] == ("Conv_0", "kernel")
    # a leaf the LSTM does not have raises
    bad = {"BiLSTM_0": {"l0_d0": {"ix": {"kernel": np.zeros((32, D), np.float32)}}}}
    with pytest.raises(KeyError, match="LSTM"):
        load_jax_params(tm, bad)


@pytest.mark.parametrize("exp", PRESETS)
def test_every_preset_round_trips_through_the_bridge(models, exp):
    _, tg, v, _ = models[exp]
    params, stats = export_params(tg.core)
    for want, got in ((v["params"], params), (v["batch_stats"], stats)):
        a, b = flatten_dict(want), flatten_dict(got)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg="/".join(k))


# ---- the cores and the samples ----------------------------------------------------


@pytest.mark.parametrize("exp", PRESETS)
def test_cores_match_jax(models, exp):
    """Each core's forward on the same weights and the same initial layout:
    class logits (DS-GAN: probabilities) and boxes, and the labels they give."""
    jg, tg, v, (jb, tb) = models[exp]
    inputs, _ = jg.preprocess(jb, np.random.default_rng(2))
    (want_l, want_b), _ = jg._forward(v, jax.tree.map(jnp.asarray, inputs), False)
    t_inputs = {"image": tb["image"], "layout": inputs["layout"]}
    if tg.with_retrieval:
        t_inputs["retrieved"] = tb["retrieved"]
    got_l, got_b = tg._forward(t_inputs)
    assert got_l.shape == (4, 10, tg.K) and got_b.shape == (4, 10, 4)
    _close(got_l.numpy(), np.asarray(want_l))
    _close(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_l.argmax(-1).numpy(), np.asarray(want_l).argmax(-1))


@pytest.mark.parametrize("exp", PRESETS)
def test_samples_equal_jax(models, exp):
    """gen.sample(batch, rng) from the same numpy seed, twice in a row (the
    rng's stream and the element-count EMA carry over): the same elements
    and labels, boxes within the tolerance."""
    jg, tg, v, (jb, tb) = models[exp]
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):
        want = jg.sample(v, jb, jr)
        got = tg.sample(tb, tr).numpy()
        for k in ("label", "mask"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)), err_msg=k)
        for k in ("center_x", "center_y", "width", "height"):
            _close(got[k], np.asarray(getattr(want, k)))
    assert jr.integers(1 << 30) == tr.integers(1 << 30)


def test_dsgan_lstm_stays_fp32_in_a_bf16_model():
    """model.dtype=bfloat16 casts the DS-GAN core but its LSTM, which flax
    runs in fp32; the bf16 forward (with retrieval) gives finite outputs of
    the heads' dtype."""
    cfg = tconfig.build_config("dsgan_ra", TINY + ["model.dtype=bfloat16"])
    tg = tconfig.build_generator(cfg, None, device="cpu")
    assert tg.core.cnnlstm.BiLSTM_0.weight_ih_l0.dtype == torch.float32
    assert tg.core.cnnlstm.Conv_0.weight.dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    _, tl = _random_layouts(0, B=2)
    nbrs = {k: np.repeat(np.asarray(getattr(tl, k))[:, None], 4, 1) for k in
            ("label", "center_x", "center_y", "width", "height", "mask")}
    batch = {"layout": tl, "image": rng.uniform(size=(2, *HW, 4)).astype(np.float32),
             "retrieved": nbrs}
    logits, boxes = tg._forward(tg.preprocess(batch, rng)[0])
    assert logits.dtype == boxes.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all() and torch.isfinite(boxes.float()).all())
