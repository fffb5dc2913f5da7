"""FIDNet's training in the port against the JAX package, on the CPU.

FIDNetTrainer fixes the width (d_model 256, 4 heads, 4 + 4 layers, FFN
128), as JAX's does; the tests run it at batch 8 on the synthetic split
(3 labels, S = 10), both packages from JAX's initial parameters through
the weights bridge, and the same loader stream and numpy seeds.

FIDNet trains deterministic in both packages (JAX's `loss_fn` applies the
model with `train=False`): in the port the model is in eval mode, so every
encoder layer takes K1, here its plain version inside
`ops._build.RecomputedBackward`, whose backward recomputes JAX's reference.

Tolerances: the fake/real draws bit for bit; the loss and its three terms
rtol 1e-5 (one forward, another framework's sums); a 3-step `fit`: losses
rtol 2e-4, each top-level subtree's update by cosine > 0.99 and norm ratio
0.97-1.03 (tests/test_torch_port_train.py's rule: AdamW's first steps are
about lr * sign(g)); a zero-gradient AdamW step equal to optax's within
rtol 1e-6; K1's gradients against the einsum path's rtol 1e-4 plus 1e-6 of
the largest of any parameter's; the checkpoint's features in JAX's FIDNetV3 within 1e-5.
"""

import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train import _same_change

from ralf_tpu.core.layout import Layout as JLayout
from ralf_tpu.data import dataset as jdata
from ralf_tpu.models.fidnet import FIDNetV3 as JFIDNet
from ralf_tpu.train import fid_trainer as jfid
from ralf_tpu_torch.cli import evaluate as teval
from ralf_tpu_torch.cli import fid_train as tcli_fid
from ralf_tpu_torch.cli import inference as tinf
from ralf_tpu_torch.cli import train as tcli_train
from ralf_tpu_torch.core.layout import FIELDS
from ralf_tpu_torch.data import dataset as tdata
from ralf_tpu_torch.models import nn as tnn
from ralf_tpu_torch.models.dropout import Dropout
from ralf_tpu_torch.ops import encoder_attention as tea
from ralf_tpu_torch.train import fid_trainer as tfid
from ralf_tpu_torch.utils.weights import export_params, load_jax_params, load_params_npz

torch.set_num_threads(2)
NUM_LABELS, S, BATCH = 3, 10, 8
LOSS_RTOL = 2e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture
def job_root(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_init():
    """JAX's initial FIDNet parameters, those of its `fit(seed=0)`."""
    return _np(jfid.FIDNetTrainer(NUM_LABELS, S).init(jax.random.PRNGKey(0))[0])


def _loader(pkg: str):
    data = jdata if pkg == "jax" else tdata
    ds = data.SyntheticPosterDataset(data.DatasetConfig(name="synthetic"), 64, 0, (64, 48))
    return data.BatchLoader(ds, BATCH, with_images=False, use_native=False, prefetch=0, seed=0)


def _jax_layout(lay) -> JLayout:
    return JLayout(**{k: jnp.asarray(np.asarray(getattr(lay, k))) for k in FIELDS})


def _port_model(params):
    trainer = tfid.FIDNetTrainer(NUM_LABELS, S, device="cpu")
    model, opt = trainer.init(0)
    load_jax_params(model, params)
    return trainer, model.eval(), opt


@pytest.mark.parametrize("seed", [0, 1])
def test_generate_fake_and_real_is_bit_for_bit(seed):
    """The same batch and numpy seed: the perturbed layouts, is_real and the
    rng's next draw equal JAX's exactly; fake rows' padded slots are 0."""
    jb, tb = next(iter(_loader("jax"))), next(iter(_loader("port")))
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    (jl, jreal), (tl, treal) = (jfid.generate_fake_and_real(jb["layout"], jr),
                                tfid.generate_fake_and_real(tb["layout"], tr))
    np.testing.assert_array_equal(treal, jreal)
    assert treal.dtype == np.float32 and 0 < treal.sum() < BATCH
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tl, k).numpy(), np.asarray(getattr(jl, k)), k)
    assert jr.integers(2**31) == tr.integers(2**31)
    mask = tl.mask.numpy()
    fake = treal == 0
    assert (~mask[fake]).any() and (tl.width.numpy()[fake][~mask[fake]] == 0).all()
    np.testing.assert_array_equal(tl.width.numpy()[~fake], tb["layout"].width.numpy()[~fake])


def test_loss_fn_and_its_terms_match_jax(jax_init):
    jb = next(iter(_loader("jax")))
    lay, real = jfid.generate_fake_and_real(jb["layout"], np.random.default_rng(2))
    want, jaux = jfid.FIDNetTrainer(NUM_LABELS, S).loss_fn(jax_init, _jax_layout(lay),
                                                           jnp.asarray(real))
    trainer, model, _ = _port_model(jax_init)
    tl, treal = tfid.generate_fake_and_real(next(iter(_loader("port")))["layout"],
                                            np.random.default_rng(2))
    with torch.no_grad():
        got, taux = trainer.loss_fn(model, tl, torch.from_numpy(treal))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert sorted(taux) == sorted(jaux) == ["bbox", "bce", "label"]
    for k in taux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)


def test_three_step_fit_matches_jax(jax_init, job_root, monkeypatch):
    """`fit(epochs=1, num_steps_cap=3)` in both packages: per-step losses,
    each subtree's update, and the saved checkpoint equal to the result."""
    jtr = jfid.FIDNetTrainer(NUM_LABELS, S, job_dir=str(job_root / "jax"))
    jl, build = [], jtr._build_step

    def build_recording():
        build()
        step = jtr._step

        def recorded(*args):
            out = step(*args)
            jl.append(float(out[2]))
            return out
        jtr._step = recorded

    jtr._build_step = build_recording
    jparams = _np(jtr.fit(_loader("jax"), epochs=1, seed=0, num_steps_cap=3))

    ttr = tfid.FIDNetTrainer(NUM_LABELS, S, job_dir=str(job_root / "port"), device="cpu")
    tl, init, step = [], ttr.init, ttr.step

    def init_from_jax(seed=0):
        model, opt = init(seed)
        load_jax_params(model, jax_init)
        return model, opt

    def recorded(*args):
        out = step(*args)
        tl.append(float(out[0]))
        return out

    monkeypatch.setattr(ttr, "init", init_from_jax)
    monkeypatch.setattr(ttr, "step", recorded)
    model = ttr.fit(_loader("port"), epochs=1, seed=0, num_steps_cap=3)
    assert not model.training and all(p.requires_grad for p in model.parameters())
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    tparams = export_params(model)[0]
    assert sorted(tparams) == sorted(jparams)
    for key in jparams:
        _same_change(key, jax_init[key], jparams[key], tparams[key])
    saved = load_params_npz(str(job_root / "port" / "fidnet_ckpt.npz"))[0]
    for a, b in zip(jax.tree.leaves(saved), jax.tree.leaves(tparams), strict=True):
        np.testing.assert_array_equal(a, b)


def test_weight_decay_reaches_every_leaf_as_optax_adamw(jax_init):
    """A step on zero gradients moves each leaf by -lr wd p alone: optax's
    unmasked adamw decays biases, LayerNorm scales, embeddings and both
    tokens, and the port's AdamW does the same (the generators' optimizer
    decays `kernel` leaves only)."""
    jtr = jfid.FIDNetTrainer(NUM_LABELS, S)
    rng = np.random.default_rng(5)  # nonzero biases: flax initialises them at 0
    init = jax.tree.map(lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
                        jax_init)
    params = jax.tree.map(jnp.asarray, init)
    zeros = jax.tree.map(jnp.zeros_like, params)
    updates, _ = jtr.tx.update(zeros, jtr.tx.init(params), params)
    want = _np(jax.tree.map(lambda p, u: p + u, params, updates))
    _, model, opt = _port_model(init)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    got = export_params(model)[0]
    bias = got["enc_transformer"]["layer_0"]["self_attn"]["q_proj"]["bias"]
    before = init["enc_transformer"]["layer_0"]["self_attn"]["q_proj"]["bias"]
    assert np.abs(bias - before).max() > 0  # the bias moved with no gradient
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_fidnet_step_takes_k1_forward_and_backward(jax_init, monkeypatch):
    """In a step the K1 gate is open: 8 K1 calls (4 encoder layers at
    S = 11, 4 decoder layers at S = 10), each one's backward the
    reference recomputed; the gradients equal those of the einsum path
    (train mode at dropout 0)."""
    calls = {"forward": [], "backward": 0}
    wrapper, reference = tnn.encoder_attention, tea.attention_reference

    def counted(q, k, v, nhead, key_bias=None):
        calls["forward"].append(q.shape[1])
        return wrapper(q, k, v, nhead, key_bias)

    def recomputed(*args, **kw):
        calls["backward"] += 1
        return reference(*args, **kw)

    monkeypatch.setattr(tnn, "encoder_attention", counted)
    monkeypatch.setattr(tea, "attention_reference", recomputed)
    trainer, model, opt = _port_model(jax_init)
    lay, real = tfid.generate_fake_and_real(next(iter(_loader("port")))["layout"],
                                            np.random.default_rng(0))

    def grads(train: bool):
        model.train(train)
        model.zero_grad(set_to_none=True)
        loss, _ = trainer.loss_fn(model, lay, torch.from_numpy(real))
        loss.backward()
        return [p.grad.clone() for p in model.parameters()]

    k1 = grads(False)
    assert sorted(calls["forward"]) == [10] * 4 + [11] * 4 and calls["backward"] == 8
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    einsum = grads(True)
    assert len(calls["forward"]) == 8 and calls["backward"] == 8  # train mode: no K1
    scale = max(float(g.abs().max()) for g in einsum)  # k_proj's bias has none but noise
    for a, b in zip(k1, einsum):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * scale)


def test_cli_fid_train_checkpoint_reads_in_jax_and_in_cli_evaluate(job_root):
    """`cli.fid_train --synthetic --debug --device cpu` writes
    fidnet_ckpt.npz; its features in JAX's FIDNetV3 equal the port's, and
    the port's cli.evaluate reads it under the `trained` tag."""
    d = str(job_root / "fidnet")
    assert tcli_fid.main(["--synthetic", "--debug", "--device", "cpu", "--job-dir", d]) == d
    params, stats = load_params_npz(os.path.join(d, "fidnet_ckpt.npz"))
    assert not stats and all(a.dtype == np.float32 for a in jax.tree.leaves(params))
    model = tfid.FIDNetTrainer(NUM_LABELS, S, job_dir=d, device="cpu").load()
    lay = next(iter(_loader("port")))["layout"]
    with torch.no_grad():
        got = model.extract_features(lay).numpy()
    want = JFIDNet(num_labels=NUM_LABELS, max_bbox=S).apply(
        {"params": params}, _jax_layout(lay), method=JFIDNet.extract_features)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)

    job = str(job_root / "retriever")
    tcli_train.main(["--experiment", "retriever", "--device", "cpu", "--job-dir", job,
                     "--synthetic", "--debug", "dataset.image_h=64", "dataset.image_w=48"])
    tinf.main(["--job-dir", job, "--cond", "uncond", "--num-seeds", "1", "--batch-size", "16",
               "--device", "cpu", "--out-dir", f"{job}/out"])
    cache = str(job_root / "cache")
    scores = teval.main(["--input-dir", f"{job}/out", "--job-dir", job, "--fidnet-dir", d,
                         "--cache-dir", cache, "--device", "cpu"])
    assert [os.path.basename(p) for p in glob.glob(f"{cache}/*")] == [
        "eval_gt_features_pku10_test_trained.npz"]
    for k in ("fid", "precision", "recall", "density", "coverage"):
        assert np.isfinite(scores[k]["mean"]), k
