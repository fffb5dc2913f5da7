"""Training CGL-GAN and DS-GAN (and their retrieval-augmented variants) in
the port against the JAX package's `GANTrainer`, on the CPU: the exact
assignment, the straight-through argmax, the matching losses, both
discriminators, one GAN step of each preset, a three-step `fit_gan`, and
`cli.train` whose checkpoint both packages' `cli.inference` serve.

Models are tiny (d_model 32, 4 heads in the generator's image encoder, 1+1
generator layers, resnet18, 64x48 canvases, top-4 neighbours; the
discriminators keep their fixed depths), initialised in JAX and loaded into
the port through the weights bridge; both run in float32 with dropout 0.
JAX's steps are its own `_build_gan_steps` bodies, jitted once per preset
with the adversarial weight as an argument (JAX's jitted steps read
`adv_weight` when they are traced: see
`test_trap_jax_steps_keep_the_adversarial_weight_of_their_trace`).

Tolerances: the assignment exactly; the straight-through argmax and its
VJP exactly; gIoU, the matching's losses and the hinge within 1e-6; the
discriminators' critics within 1e-5; losses rtol 1e-5; updated parameters
within 1e-4 absolute for the generator (base LR 1e-4) and 1e-3 for the
discriminator (base LR 1e-3), but for an element whose gradient is at the
cross-framework noise floor: AdamW's first step moves an element by about
lr * sign(g), and such an element may step the other way, 2 lr from JAX's
(at most one element in a thousand of a leaf, or two; measured: at most 15
of 65,536 in a discriminator's FFN kernel and 2 of 1,024 in a projection,
none in a generator); each subtree's update is also held by cosine > 0.99
and norm ratio 0.97-1.03 (`_same_change`, the rule of
`tests/test_torch_port_train.py`); BatchNorm statistics after one step
rtol 1e-4 + 1e-5 (a batch mean near zero over some 1,500 activations of
order one, summed in another order: measured 2e-6 off in DS-GAN's
discriminator), after three by `_same_change`;
pickles: labels exactly, coordinates within 1e-5.
"""

import json
import os
import pickle
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from scipy.optimize import linear_sum_assignment

from ralf_tpu import config as jconfig
from ralf_tpu.cli import inference as jinf
from ralf_tpu.data import dataset as jdata
from ralf_tpu.models import gan_common as jgc
from ralf_tpu.ops.assignment import batched_lsa as jax_lsa
from ralf_tpu.parallel.mesh import replicate
from ralf_tpu.train import optim as joptim
from ralf_tpu.train.gan_trainer import GANTrainer as JGANTrainer
from ralf_tpu.train.trainer import TrainConfig as JTrainConfig
from ralf_tpu.train.trainer import Trainer as JTrainer
from ralf_tpu.train.trainer import TrainState as JTrainState
from ralf_tpu_torch import config as tconfig
from ralf_tpu_torch.cli import inference as tinf
from ralf_tpu_torch.cli import train as tcli_train
from ralf_tpu_torch.data import dataset as tdata
from ralf_tpu_torch.models import cgl_gan as tcgl
from ralf_tpu_torch.models import dsgan as tds
from ralf_tpu_torch.models import gan_common as tgc
from ralf_tpu_torch.ops import _build
from ralf_tpu_torch.ops import assignment as tasg
from ralf_tpu_torch.train import optim as toptim
from ralf_tpu_torch.train.gan_trainer import GANTrainer as TGANTrainer
from ralf_tpu_torch.train.trainer import TrainConfig as TTrainConfig
from ralf_tpu_torch.utils.weights import export_params, load_jax_params, load_params_npz

torch.set_num_threads(2)
HW, BATCH = (64, 48), 8  # 8: one canvas per device of JAX's CPU mesh
TINY = ["model.d_model=32", "model.nhead=4", "model.num_encoder_layers=1",
        "model.num_decoder_layers=1", "model.dim_feedforward=64", "model.backbone=resnet18",
        "model.dropout=0.0", f"dataset.image_h={HW[0]}", f"dataset.image_w={HW[1]}",
        "debug=true", "synthetic_data=true"]
PRESETS = ("cglgan", "cglgan_ra", "dsgan", "dsgan_ra")
LOSS_RTOL, SMALL = 1e-5, 1e-6
PARAM_ATOL = {"gen": 1e-4, "disc": 1e-3}  # the base LRs
STATS_RTOL, STATS_ATOL = 1e-4, 1e-5
GEO = ("center_x", "center_y", "width", "height")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _over(exp):
    return TINY + (["generator_kwargs.top_k=4"] if exp.endswith("_ra") else [])


@pytest.fixture
def job_root(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


# ---- the exact assignment ---------------------------------------------------------


def _costs(case: int, rng):
    """[5, n, n] fp32 costs of one kind: gaussian, small integers (ties
    everywhere), all equal, one decimal, and values at the matching's 1e5 clamp."""
    n = 1 + case % 12
    kind = case % 5
    if kind == 0:
        c = rng.normal(size=(5, n, n))
    elif kind == 1:
        c = rng.integers(0, 3, size=(5, n, n))
    elif kind == 2:
        c = np.full((5, n, n), float(rng.integers(-2, 3)))
    elif kind == 3:
        c = np.round(rng.normal(size=(5, n, n)), 1)
    else:
        c = np.where(rng.uniform(size=(5, n, n)) < 0.3, 1e5, rng.normal(size=(5, n, n)))
    return np.asarray(c, np.float32)


@pytest.mark.parametrize("case", range(30))
def test_plain_lsa_equals_jax_exactly_and_scipy_in_cost(case):
    """n from 1 to 12 over tie-heavy and all-equal costs: the same assignment
    as JAX's jitted batched_lsa, row by row, and scipy's least total cost."""
    c = _costs(case, np.random.default_rng(case))
    want = np.asarray(jax.jit(jax_lsa)(jnp.asarray(c)))
    got = tasg.batched_lsa(torch.from_numpy(c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    n = c.shape[1]
    for b in range(c.shape[0]):
        assert sorted(got[b].tolist()) == list(range(n))
        r, col = linear_sum_assignment(c[b].astype(np.float64))
        total = c[b][np.arange(n), got[b].numpy()].astype(np.float64).sum()
        assert abs(total - c[b][r, col].astype(np.float64).sum()) <= 1e-5 * max(1.0, abs(total))


def test_plain_lsa_counts_its_steps():
    """A row's search takes one Dijkstra step per row added on diagonal
    costs (each row finds its own column free at once)."""
    eye = torch.ones(3, 6, 6) - torch.eye(6)
    col, steps = tasg.batched_lsa_plain(eye, return_steps=True)
    assert steps == 3 * 6 and (col == torch.arange(6, dtype=torch.int32)).all()


def test_lsa_kernel_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """On a non-CPU tensor the wrapper launches the kernel or raises: more
    than 32 columns, a non-square or non-fp32 cost, all before any build."""
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda *a: pytest.fail("built for a refused call"))
    with pytest.raises(ValueError, match="n <= 32"):
        tasg.batched_lsa(torch.empty(2, 33, 33, device="meta"))
    with pytest.raises(ValueError, match=r"\[B, n, n\]"):
        tasg.batched_lsa(torch.empty(2, 3, 4, device="meta"))
    with pytest.raises(TypeError, match="float32"):
        tasg.batched_lsa(torch.empty(2, 3, 3, device="meta", dtype=torch.float64))


# ---- the straight-through argmax and the matching losses ---------------------------


def test_straight_through_argmax_and_its_vjp_match_jax():
    rng = np.random.default_rng(0)
    packed = rng.normal(size=(3, 10, 2, 5)).astype(np.float32)
    packed[0, 0, 0] = 1.0  # a tie: the first index wins in both
    g = rng.normal(size=packed.shape).astype(np.float32)
    want, vjp = jax.vjp(jgc.straight_through_argmax, jnp.asarray(packed))
    x = torch.from_numpy(packed).requires_grad_()
    got = tgc.straight_through_argmax(x)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    assert got[0, 0, 0].tolist() == [1.0, 0.0, 0.0, 0.0, 0.0]


def _boxes(rng, shape):
    """cxcywh boxes, some degenerate (zero width) and some the zero padding."""
    b = np.concatenate([rng.uniform(0.1, 0.9, shape + (2,)),
                        rng.uniform(0.0, 0.5, shape + (2,))], -1).astype(np.float32)
    b[..., 0, 2] = 0.0
    b[..., -1, :] = 0.0
    return b


def test_generalized_box_iou_matches_jax():
    rng = np.random.default_rng(1)
    a, b = _boxes(rng, (7,)), _boxes(rng, (5,))
    xa, xb = jgc._box_cxcywh_to_xyxy(jnp.asarray(a)), jgc._box_cxcywh_to_xyxy(jnp.asarray(b))
    want = jgc.generalized_box_iou(xa, xb)
    ta, tb = tgc._box_cxcywh_to_xyxy(torch.from_numpy(a)), tgc._box_cxcywh_to_xyxy(
        torch.from_numpy(b))
    np.testing.assert_allclose(ta.numpy(), np.asarray(xa), atol=SMALL)
    np.testing.assert_allclose(tgc.generalized_box_iou(ta, tb).numpy(), np.asarray(want),
                               atol=SMALL)


def _prediction(seed, K=5, B=4, S=10):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, S, K)).astype(np.float32)
    boxes = rng.uniform(0.05, 0.95, (B, S, 4)).astype(np.float32)
    labels = rng.integers(0, K, (B, S)).astype(np.int32)
    labels[:, 6:] = K - 1  # the padded no-object slots: equal targets, tied columns
    tboxes = np.concatenate([_boxes(rng, (B, S)), np.zeros((B, S, K - 4), np.float32)], -1)
    tboxes[:, 6:] = 0.0
    return logits, boxes, labels, tboxes


@pytest.mark.parametrize("seed", [0, 1])
def test_matching_and_set_criterion_match_jax(seed):
    """The assignment exactly (the padded slots tie), each loss within 1e-6,
    and the gradients of the weighted sum through both within 1e-6."""
    logits, boxes, labels, tboxes = _prediction(seed)
    w = np.asarray([1.0, 0.8, 1.0, 1.0, 0.1], np.float32)
    j = [jnp.asarray(x) for x in (logits, boxes, labels, tboxes)]
    want_match = jgc.hungarian_match(*j)
    got_match = tgc.hungarian_match(*(torch.from_numpy(x) for x in (logits, boxes, labels,
                                                                     tboxes)))
    np.testing.assert_array_equal(got_match.numpy(), np.asarray(want_match))

    def jloss(lg, bx):
        t = jgc.set_criterion(lg, bx, j[2], j[3], jnp.asarray(w), 5)
        return 2 * t["loss_ce"] + 5 * t["loss_bbox"] + 2 * t["loss_giou"], t

    (want, jterms), (g_lg, g_bx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        j[0], j[1])
    lg, bx = (torch.from_numpy(x).requires_grad_() for x in (logits, boxes))
    terms = tgc.set_criterion(lg, bx, torch.from_numpy(labels).long(), torch.from_numpy(tboxes),
                              torch.from_numpy(w), 5)
    got = 2 * terms["loss_ce"] + 5 * terms["loss_bbox"] + 2 * terms["loss_giou"]
    got.backward()
    for k in ("loss_ce", "loss_bbox", "loss_giou"):
        np.testing.assert_allclose(float(terms[k].detach()), float(jterms[k]), atol=SMALL,
                                   err_msg=k)
    np.testing.assert_array_equal(terms["match"].numpy(), np.asarray(want_match))
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(g_lg), atol=SMALL)
    np.testing.assert_allclose(bx.grad.numpy(), np.asarray(g_bx), atol=SMALL)


def test_hungarian_match_clamps_non_finite_costs_like_jax():
    logits, boxes, labels, tboxes = _prediction(3)
    logits[0, 2] = np.nan
    boxes[1, 4, 0] = np.inf
    want = jgc.hungarian_match(*(jnp.asarray(x) for x in (logits, boxes, labels, tboxes)))
    got = tgc.hungarian_match(*(torch.from_numpy(x) for x in (logits, boxes, labels, tboxes)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hinge_embedding_loss_and_its_gradient_match_jax():
    """At the kink (a critic saturated at exactly 1.0 against -1) both halve
    the max's gradient."""
    x = np.asarray([1.0, -1.0, 0.3, 2.0, 1.0], np.float32)
    for target in (1.0, -1.0):
        t = np.full_like(x, target)
        want, grad = jax.value_and_grad(lambda v: jgc.hinge_embedding_loss(v, jnp.asarray(t)))(
            jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_()
        got = tgc.hinge_embedding_loss(tx, torch.from_numpy(t))
        got.backward()
        np.testing.assert_allclose(float(got), float(want), atol=SMALL)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(grad), atol=SMALL)


# ---- the generators, the discriminators and one GAN step ----------------------------


@pytest.fixture(scope="module")
def gans():
    """{preset: (JAX generator, its variables, its discriminator's, port generator,
    (JAX batch, port batch))}: 8 train canvases (the _ra presets' top-4 from
    the train split, the same rows for both)."""
    out = {}
    for exp in PRESETS:
        jcfg, tcfg = jconfig.build_config(exp, _over(exp)), tconfig.build_config(exp, _over(exp))
        jg = jconfig.build_generator(jcfg, None)
        tg = tconfig.build_generator(tcfg, None, device="cpu")
        v = _np(jg.init(jax.random.PRNGKey(0)))
        base = exp.removesuffix("_ra")  # the same discriminator as its RA variant's
        dv = out[base][2] if base in out else _np(jg.init_disc(jax.random.PRNGKey(1)))
        tg.init_disc()
        jtrain, _, _ = jconfig.build_datasets(jcfg)
        ttrain, _, _ = tconfig.build_datasets(tcfg)
        kw = dict(shuffle=False, transforms=(), use_native=False)
        jb = next(iter(jdata.BatchLoader(jtrain, BATCH, prefetch=0, **kw)))
        tb = next(iter(tdata.BatchLoader(ttrain, BATCH, **kw)))
        if tg.with_retrieval:
            idx = np.random.default_rng(1).integers(0, len(ttrain), size=(BATCH, tg.top_k))
            jl, tl = jtrain.get_layouts(idx.reshape(-1)), ttrain.get_layouts(idx.reshape(-1))
            jb["retrieved"] = {k: a.reshape(BATCH, tg.top_k, -1) for k, a in jl.items()}
            tb["retrieved"] = {k: a.reshape(BATCH, tg.top_k, -1) for k, a in tl.items()}
        out[exp] = (jg, v, dv, tg, (jb, tb))
    return out


def _load(entry):
    """The port's generator and discriminator at JAX's initial weights."""
    _, v, dv, tg, _ = entry
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    load_jax_params(tg.disc, dv["params"], dv.get("batch_stats"))
    tg.core.eval()
    tg.disc.eval()


@pytest.mark.parametrize("exp", ["cglgan", "dsgan"])
def test_discriminators_match_jax_and_round_trip(gans, exp):
    """Each critic on the same weights, canvases and packed ground truth
    (in eval mode), and the discriminator's tree through export exactly:
    the resnet18 encoder, the LSTM cells, head_norm (flax's eps 1e-6),
    head without bias and fc_tf with one."""
    jg, _, dv, tg, (jb, tb) = gans[exp]
    _load(gans[exp])
    _, targets = jg.preprocess(jb, np.random.default_rng(4))
    want = jax.jit(jg.disc.apply)(dv, jnp.asarray(jb["image"]), jnp.asarray(targets["packed"]))
    with torch.no_grad():
        got = tg.disc(torch.from_numpy(np.asarray(tb["image"])),
                      torch.from_numpy(targets["packed"]))
    assert got.shape == (BATCH,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    params, stats = export_params(tg.disc)
    for a, b in ((dv["params"], params), (dv.get("batch_stats", {}), stats)):
        fa, fb = flatten_dict(a), flatten_dict(b)
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fb[k], fa[k], err_msg="/".join(k))
    names = toptim.lr_group_labels(tg.disc)
    if exp == "cglgan":
        assert tg.disc.head.bias is None and tg.disc.head_norm.eps == 1e-6
        assert names["layout_encoder.Conv_0.weight"] == "frozen"
    else:
        assert tg.disc.fc_tf.bias is not None
        assert names["cnnlstm.BiLSTM_0.weight_hh_l1_reverse"] == "rest"


def test_dsgan_discriminator_keeps_its_lstm_in_train_mode(gans):
    """cuDNN's RNN backward needs train mode: the LSTM stays in it when the
    discriminator is put in eval mode; its BatchNorms follow."""
    tg = gans["dsgan"][3]
    tg.disc.eval()
    assert tg.disc.cnnlstm.BiLSTM_0.training
    assert not tg.disc.encoder.ResNetFPNEncoder_0.trunk.training


_STEPS: dict = {}  # per preset: JAX's two step bodies, jitted with the adversarial weight


def jax_steps(exp, entry, job_dir, mesh=None):
    """(trainer, gen_step(w, state, dis_state, inputs, targets, key),
    dis_step(w, dis_state, state, inputs, targets, key)) of JAX's
    GANTrainer on `mesh` (default: every device), compiled once per `exp`."""
    jg, v, dv, _, _ = entry
    tr = JGANTrainer(jg, JTrainConfig(job_dir=str(job_dir), batch_size=BATCH), mesh)
    if exp not in _STEPS:
        tr.tx = joptim.build_optimizer(v["params"], base_lr=tr.cfg.lr,
                                       weight_decay=tr.cfg.weight_decay,
                                       clip_max_norm=tr.cfg.clip_max_norm)
        tr.tx_dis = joptim.build_optimizer(dv["params"], base_lr=tr.cfg.lr * jg.LR_MULT_DIS,
                                           weight_decay=tr.cfg.weight_decay,
                                           clip_max_norm=tr.cfg.clip_max_norm)
        tr._build_gan_steps()

        def weighted(step):
            def run(w, *args):
                saved, jg.adv_weight = jg.adv_weight, w
                try:
                    return step(*args)
                finally:
                    jg.adv_weight = saved
            return jax.jit(run)

        _STEPS[exp] = (tr.tx, tr.tx_dis, weighted(tr._train_step.__wrapped__),
                       weighted(tr._dis_step.__wrapped__))
    tr.tx, tr.tx_dis, gen_step, dis_step = _STEPS[exp]
    return tr, gen_step, dis_step


def _jax_states(tr, v, dv):
    def state(tx, tree):
        params = jax.tree.map(jnp.asarray, tree["params"])
        return replicate(tr.mesh, JTrainState(
            params=params, batch_stats=jax.tree.map(jnp.asarray, tree.get("batch_stats", {})),
            opt_state=tx.init(params), step=jnp.zeros((), jnp.int32)))
    return state(tr.tx, v), state(tr.tx_dis, dv)


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])


def _same_change(key, before, after_j, after_t):
    """Cosine > 0.99 and norm ratio 0.97-1.03 of the two changes."""
    d_j, d_t = _flat(after_j) - _flat(before), _flat(after_t) - _flat(before)
    mag = float(np.linalg.norm(d_j))
    assert mag > 0, f"{key} did not move; the test has no teeth"
    cos = float(d_j @ d_t / (mag * np.linalg.norm(d_t)))
    ratio = float(np.linalg.norm(d_t)) / mag
    assert cos > 0.99 and 0.97 < ratio < 1.03, (key, cos, ratio)


def assert_same_update(net, init, after_j, after_t):
    """Every leaf within the net's LR of JAX's, each subtree's change alike,
    the frozen `layout_encoder` leaves (CGL-GAN's Conv1d, RA's FIDNet)
    unmoved on both sides."""
    fa, fj, ft = (flatten_dict(t, sep="/") for t in (init, after_j, after_t))
    assert set(fa) == set(fj) == set(ft)
    lr = PARAM_ATOL[net]
    for k in fa:
        err = np.abs(ft[k] - fj[k])
        off = err > lr  # a flipped first step: at most 2 lr away, and rare
        assert int(off.sum()) <= max(2, off.size // 1000) and float(err.max()) <= 2.5 * lr, (
            k, int(off.sum()), off.size, float(err.max()))
        if "/layout_encoder/" in f"/{k}/":
            np.testing.assert_array_equal(fj[k], fa[k], err_msg=k)
            np.testing.assert_array_equal(ft[k], fa[k], err_msg=k)
    for key in init:
        if key != "layout_encoder":
            _same_change(f"{net}/{key}", init[key], after_j[key], after_t[key])


def assert_same_stats(got, want):
    fg, fw = flatten_dict(got, sep="/"), flatten_dict(want, sep="/")
    assert set(fg) == set(fw)
    for k in fw:
        np.testing.assert_allclose(fg[k], fw[k], rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=k)


@pytest.mark.parametrize("adv", [1.0, 0.3])
@pytest.mark.parametrize("exp", PRESETS)
def test_one_gan_step_matches_jax(gans, exp, adv, job_root):
    """A generator step, then a discriminator step, from the same weights
    and batch: both losses, both nets' updated parameters (the frozen
    layout_encoder leaves unmoved), the generator's BatchNorm statistics
    of its train pass, the discriminator's of its real pass alone, and the
    discriminator's LR groups (10x, trunk 0.1x)."""
    entry = gans[exp]
    jg, v, dv, tg, (jb, tb) = entry
    tr, gen_step, dis_step = jax_steps(exp, entry, job_root / "jax")
    state, dis_state = _jax_states(tr, v, dv)
    ji, jt = tr._device_batch(*jg.preprocess(jb, np.random.default_rng(3)))
    state, gm = gen_step(adv, state, dis_state, ji, jt, jax.random.PRNGKey(1))
    dis_state, dm = dis_step(adv, dis_state, state, ji, jt, jax.random.PRNGKey(2))

    _load(entry)
    tg.adv_weight = adv
    trainer = TGANTrainer(tg, TTrainConfig(job_dir=str(job_root / "port"), batch_size=BATCH))
    tstate, tdis = trainer.init_states()
    inputs, targets = tg.device_batch(*tg.preprocess(tb, np.random.default_rng(3)))
    got_g = trainer.gen_step(tstate, tdis, inputs, targets)
    got_d = trainer.dis_step(tdis, tstate, inputs, targets)
    tg.adv_weight = 1.0

    np.testing.assert_allclose(float(got_g["loss"]), float(gm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got_d["loss_d"]), float(dm["loss_d"]), rtol=LOSS_RTOL)
    # the step's assignment is a permutation of each row (its equality with JAX's
    # on the same costs: test_matching_and_set_criterion_match_jax)
    assert (np.sort(got_g["match"].numpy(), axis=1) == np.arange(10)).all()
    for net, module, init, after in (("gen", tg.core, v, state), ("disc", tg.disc, dv, dis_state)):
        params, stats = export_params(module)
        assert_same_update(net, init["params"], _np(after.params), params)
        assert_same_stats(stats, _np(after.batch_stats))
    groups = {g["label"]: g["lr"] for g in tdis.optimizer.opt.param_groups}
    assert groups == {"rest": 1e-3, "trunk": 1e-3 * 0.1}
    labels = toptim.lr_group_labels(tg.disc)
    names = {"/".join(p): n for n, p in toptim._param_paths(tg.disc).items()}
    want_labels = flatten_dict(joptim.lr_group_labels(dv["params"]), sep="/")
    # an LSTM gate's leaf (i{g}, h{g}) lives in the rows of the port's packed tensor
    assert {k: labels[names[re.sub(r"/([ih])[ifgo]/", r"/\1/", k)]]
            for k in want_labels} == want_labels


def test_generator_step_takes_no_gradient_of_the_discriminator(gans, job_root):
    """JAX differentiates the generator's parameters only: the
    discriminator keeps no gradient and requires grad again after the step."""
    entry = gans["cglgan"]
    _, _, _, tg, (_, tb) = entry
    _load(entry)
    trainer = TGANTrainer(tg, TTrainConfig(job_dir=str(job_root), batch_size=BATCH))
    state, dis = trainer.init_states()
    dis.optimizer.zero_grad()
    inputs, targets = tg.device_batch(*tg.preprocess(tb, np.random.default_rng(0)))
    trainer.gen_step(state, dis, inputs, targets)
    assert all(p.grad is None and p.requires_grad for p in tg.disc.parameters())
    assert any(p.grad is not None for p in tg.core.parameters())


# ---- fit_gan ----------------------------------------------------------------------


def test_three_step_fit_gan_of_dsgan_matches_jax(gans, job_root):
    """Three GAN steps of one epoch from the same weights and loader: the
    schedulers' scale(0) (DS-GAN's intended stair starts both nets at 0.8
    of their LR), the first epoch's adversarial weight (0), both nets'
    parameters and statistics, metrics.jsonl and the checkpoints."""
    entry = gans["dsgan"]
    jg, v, dv, tg, _ = entry
    jcfg, tcfg = (m.build_config("dsgan", _over("dsgan")) for m in (jconfig, tconfig))
    # the preset's stair is flat (the reference's, see train.schedulers); the
    # intended one starts both nets at gamma 0.8 of their LR from scale(0) on
    kw = dict(epochs=1, scheduler="dsgan", scheduler_kwargs={"intended_stair": True},
              batch_size=BATCH)
    tr, gen_step, dis_step = jax_steps("dsgan", entry, job_root / "jax")
    tr.cfg = JTrainConfig(job_dir=str(job_root / "jax"), **kw)
    tr.scheduler = JGANTrainer(jg, tr.cfg).scheduler
    tr.scheduler_dis = JGANTrainer(jg, tr.cfg).scheduler_dis

    def build():  # the steps compiled above, at the epoch's adversarial weight
        tr._train_step = lambda *a: gen_step(jg.adv_weight, *a)
        tr._dis_step = lambda *a: dis_step(jg.adv_weight, *a)

    tr._build_gan_steps = build
    state, dis_state = _jax_states(tr, v, dv)
    j_train, _, _ = jconfig.build_datasets(jcfg)
    jl = jdata.BatchLoader(j_train, BATCH, transforms=jcfg.transforms, use_native=False,
                           prefetch=0, seed=0)
    state, dis_state = tr.fit_gan(jl, state=state, dis_state=dis_state, num_steps_cap=3)
    assert jg.adv_weight == 0.0

    _load(entry)
    trainer = TGANTrainer(tg, TTrainConfig(job_dir=str(job_root / "port"), **kw))
    t_train, _, _ = tconfig.build_datasets(tcfg)
    tl = tdata.BatchLoader(t_train, BATCH, transforms=tcfg.transforms, use_native=False, seed=0)
    tstate, tdis = trainer.fit_gan(tl, num_steps_cap=3)
    assert tg.adv_weight == 0.0 and tstate.step == tdis.step == 3
    for net, module, init, after in (("gen", tg.core, v, state), ("disc", tg.disc, dv, dis_state)):
        params, stats = export_params(module)
        for k, a in flatten_dict(_np(after.params), sep="/").items():
            np.testing.assert_allclose(flatten_dict(params, sep="/")[k], a, atol=1e-3, err_msg=k)
        # after three steps the running means near zero carry the parameters' noise
        _same_change(f"{net}/batch_stats", init["batch_stats"], _np(after.batch_stats), stats)
    _same_change("gen", v["params"], _np(state.params), export_params(tg.core)[0])
    assert {g["label"]: g["lr"] for g in tstate.optimizer.opt.param_groups} == {
        "rest": 1e-4 * 0.8, "trunk": 1e-4 * 0.8 * 0.1}
    assert {g["label"]: g["lr"] for g in tdis.optimizer.opt.param_groups} == {
        "rest": 1e-3 * 0.8, "trunk": 1e-3 * 0.8 * 0.1}
    (jrec,), (trec,) = (_records(job_root / d) for d in ("jax", "port"))
    assert sorted(trec) == sorted(jrec) == ["d_loss", "epoch", "g_loss", "sec"]
    np.testing.assert_allclose([trec["g_loss"], trec["d_loss"]], [jrec["g_loss"],
                                                                jrec["d_loss"]], rtol=1e-4)
    for f in ("ckpt_final.npz", "ckpt_final_opt.pt", "ckpt_final_dis.npz",
              "ckpt_final_dis_opt.pt"):
        assert os.path.exists(job_root / "port" / f), f
    params, _ = load_params_npz(str(job_root / "port" / "ckpt_final_dis.npz"))
    assert set(flatten_dict(params)) == set(flatten_dict(dv["params"]))


def _records(job_dir):
    with open(os.path.join(job_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("exp", ["cglgan", "dsgan"])
def test_adversarial_ramps_match_jax(gans, exp):
    """update_per_epoch at warmup 10 over 30 epochs: CGL-GAN's 0 before the
    warmup then linear to 1, DS-GAN's (epoch - 1) / warmup then 1; both
    start at 0."""
    jg, _, _, tg, _ = gans[exp]
    got, want = [], []
    for epoch in range(1, 31):
        jg.update_per_epoch(epoch, 10, 30)
        tg.update_per_epoch(epoch, 10, 30)
        want.append(jg.adv_weight)
        got.append(tg.adv_weight)
    jg.adv_weight = tg.adv_weight = 1.0
    assert got == want and got[0] == 0.0 and got[-1] == 1.0


def test_trap_jax_steps_keep_the_adversarial_weight_of_their_trace():
    """JAX's `_build_gan_steps` jits closures that read `gen.adv_weight`
    while they are traced: a later `update_per_epoch` changes nothing in a
    step already compiled for the same shapes.  The port reads the weight
    at every step."""
    class Toy:
        adv_weight = 0.0

        def loss(self, variables, inputs, targets, **_):
            w = variables["params"]["w"]
            return self.adv_weight * jnp.sum(w * inputs["x"]), {"state": {}}

        def disc_loss(self, dv, variables, inputs, targets, **_):
            return self.adv_weight * jnp.sum(dv["params"]["d"]), {"state": {}}

    toy = Toy()
    tr = JGANTrainer.__new__(JGANTrainer)
    tr.gen = toy
    params, d_params = {"w": jnp.ones(2)}, {"d": jnp.ones(2)}
    tr.tx = joptim.build_optimizer(params, clip_max_norm=0.0)
    tr.tx_dis = joptim.build_optimizer(d_params, clip_max_norm=0.0)
    tr._build_gan_steps()
    st = JTrainState(params=params, batch_stats={}, opt_state=tr.tx.init(params),
                     step=jnp.zeros((), jnp.int32))
    dst = st.replace(params=d_params, opt_state=tr.tx_dis.init(d_params))
    inputs = {"x": jnp.ones(2)}
    losses = []
    for w in (0.0, 1.0):
        toy.adv_weight = w
        _, m = tr._train_step(jax.tree.map(jnp.copy, st), dst, inputs, {}, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    assert losses == [0.0, 0.0]


# ---- cli.train -> cli.inference ---------------------------------------------------


def _run_jax(main, argv):
    old = sys.argv
    sys.argv = ["cli", *argv]
    try:
        main()
    finally:
        sys.argv = old


def _pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def write_jax_checkpoint(job: str) -> None:
    """JAX's orbax checkpoint `ckpt_final/` of the port's `ckpt_final.npz`."""
    cfg = jconfig.FrameworkConfig.load(job)
    params, stats = load_params_npz(os.path.join(job, "ckpt_final.npz"))
    trainer = JTrainer(jconfig.build_generator(cfg, None), cfg.train)
    state = trainer.init_state(jax.random.PRNGKey(0))
    assert sorted(flatten_dict(jax.device_get(state.params), sep="/")) == sorted(
        flatten_dict(params, sep="/"))
    trainer.save(state.replace(params=jax.tree.map(jnp.asarray, params),
                               batch_stats=jax.tree.map(jnp.asarray, stats)), "final")


@pytest.mark.parametrize("exp", ["cglgan", "dsgan_ra"])
def test_cli_train_writes_the_gan_job_and_both_cli_inferences_serve_it(exp, job_root):
    """cli.train --debug on the CPU: the job dir's files (no best, no step
    checkpoint, as JAX's GAN branch), --resume changing nothing (JAX's GAN
    branch takes none), and the checkpoint served by both packages'
    cli.inference with equal pickles."""
    files = {}
    for name, extra in (("job", []), ("resumed", ["--resume"])):
        job = str(job_root / name)
        tcli_train.main(["--experiment", exp, "--synthetic", "--debug", "--device", "cpu",
                         "--batch-size", "8", "--job-dir", job, *extra, *_over(exp)])
        files[name] = tuple(sorted(os.listdir(job)))
        (rec,) = _records(job)
        assert rec["epoch"] == 1 and np.isfinite(rec["g_loss"]) and rec["d_loss"] == 0.0
    assert set(files.values()) == {(
        "ckpt_final.npz", "ckpt_final_dis.npz", "ckpt_final_dis_opt.pt", "ckpt_final_opt.pt",
        "config.json", "metrics.jsonl")}
    for tag in ("final", "final_dis"):
        a, b = (load_params_npz(str(job_root / d / f"ckpt_{tag}.npz")) for d in ("job", "resumed"))
        for x, y in zip(a, b):
            fx, fy = flatten_dict(x), flatten_dict(y)
            assert set(fx) == set(fy) and all(np.array_equal(fx[k], fy[k]) for k in fx)
    job = str(job_root / "job")
    write_jax_checkpoint(job)
    args = ["--job-dir", job, "--cond", "c", "--num-seeds", "1", "--batch-size", "8"]
    _run_jax(jinf.main, args + ["--out-dir", f"{job}/jax"])
    tinf.main(args + ["--device", "cpu", "--out-dir", f"{job}/port"])
    want, got = _pickle(f"{job}/jax/test_0.pkl"), _pickle(f"{job}/port/test_0.pkl")
    assert len(got["results"]) == 16
    assert sum(len(r["label"]) for r in got["results"]) > 0
    for g, w in zip(got["results"], want["results"], strict=True):
        assert g["id"] == w["id"] and g["label"] == w["label"]
        for k in GEO:
            np.testing.assert_allclose(g[k], w[k], atol=1e-5, rtol=0)


def test_inference_builds_no_discriminator(gans):
    """Serving builds the generator alone: the discriminator comes with init_disc."""
    cfg = tconfig.build_config("cglgan", _over("cglgan"))
    assert tconfig.build_generator(cfg, None, device="cpu").disc is None
    assert isinstance(gans["cglgan"][3].disc, tcgl.CGLDiscriminatorCore)
    assert isinstance(gans["dsgan"][3].disc, tds.DSDiscriminatorCore)
