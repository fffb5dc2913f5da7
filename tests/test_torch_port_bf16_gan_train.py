"""bf16 training of the GAN baselines in the port against the JAX package's,
on the CPU: one GAN step (a generator step, then a discriminator step) of
CGL-GAN at model.dtype=bfloat16 against JAX's jitted step bodies
(tests/test_torch_port_gan_train.py's `jax_steps`, adversarial weight 1),
and `cli.train` at bf16 into both packages' `cli.inference`, with
`cli.train` at bf16 of the token models and ICVT.  DS-GAN and
DS-GAN-RA train in fp32 only: JAX's cannot be built at bf16 (its LSTM
scan refuses the bf16 initial carry), and the port's GANTrainer refuses
them too.

Both nets keep fp32 parameters (flax's param_dtype; the port's GANTrainer
casts both to fp32, and JAX's weights load after it) and compute in bf16,
but for the assignment's costs, fp32 as `_lsa_one` casts them.

JAX's step runs jitted on one device, where its sums run in one order:
on its 8-device mesh a bf16 GAN loss moves by up to 1% (16.328 on one
device, 16.491 on the mesh, on this batch), because bf16 costs put
near-ties in the matching that another order of sums resolves otherwise
(ROADMAP.md Queue C 62, 66).  Tolerances, each beside the spread of its
readings over the preprocessing seeds 0, 1, 3 (the test's) and 7: the
generator's loss rtol 5e-3 (3.2e-4 to 1.8e-3; 1.8e-3 on seed 3), the
discriminator's rtol 1e-2 (4.3e-3 to 1.25e-2; 4.3e-3 on seed 3: its hinge
scores the updated generator's layouts, where the bf16 rounding of the
first step shows); each top-level subtree's update by norm ratio 0.9-1.1
(0.994-1.0007) and by cosine >= 0.9 for the generator (least 0.913-0.925)
and >= 0.85 for the discriminator (least 0.864-0.901): JAX's own bf16
update is at cosine 0.928-1.000 (generator) and 0.886-0.972
(discriminator) to its fp32 one, the image encoders lowest, so these
limits sit at bf16's noise; the dtype hooks show the step ran in bf16;
the assignments are not compared.  Served in fp32 from the bf16-trained
checkpoint, the two CLIs' pickles agree as fp32 ones do (labels exactly,
coordinates within 1e-5); served in bf16, both give the same number of
elements of each canvas.
"""

import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch
from test_torch_port_bf16_train import assert_fp32_state, output_dtypes, overrides, same_change
from test_torch_port_gan_train import _jax_states, jax_steps, write_jax_checkpoint
from test_torch_port_zoo_train import _records, cache_dir, job_root  # noqa: F401  (fixtures)

from ralf_tpu import config as jconfig
from ralf_tpu.cli import inference as jinf
from ralf_tpu.data import dataset as jdata
from ralf_tpu.parallel.mesh import make_mesh
from ralf_tpu_torch import config as tconfig
from ralf_tpu_torch.cli import inference as tinf
from ralf_tpu_torch.cli import train as tcli_train
from ralf_tpu_torch.data import dataset as tdata
from ralf_tpu_torch.models import gan_common as tgc
from ralf_tpu_torch.train.gan_trainer import GANTrainer as TGANTrainer
from ralf_tpu_torch.train.trainer import TrainConfig as TTrainConfig
from ralf_tpu_torch.utils.weights import export_params, load_jax_params, load_params_npz

torch.set_num_threads(2)
BATCH = 8  # one canvas per device of JAX's CPU mesh
TINY = ["model.d_model=32", "model.nhead=4", "model.num_encoder_layers=1",
        "model.num_decoder_layers=1", "model.dim_feedforward=64", "model.backbone=resnet18",
        "model.dropout=0.0", "dataset.image_h=64", "dataset.image_w=48", "debug=true",
        "synthetic_data=true", "model.dtype=bfloat16"]
LOSS_RTOL = {"gen": 5e-3, "disc": 1e-2}  # the module docstring gives the readings
COS = {"gen": 0.9, "disc": 0.85}  # JAX's own bf16 updates: 0.93 and 0.89 of its fp32 ones
GEO = ("center_x", "center_y", "width", "height")


def _over(exp):
    return TINY + (["generator_kwargs.top_k=4"] if exp.endswith("_ra") else [])


def bf16_gan(exp):
    """(JAX generator, its variables, its discriminator's, the port's
    generator with its discriminator, (JAX batch, port batch)) at
    model.dtype=bfloat16."""
    jcfg, tcfg = jconfig.build_config(exp, _over(exp)), tconfig.build_config(exp, _over(exp))
    jg = jconfig.build_generator(jcfg, None)
    tg = tconfig.build_generator(tcfg, None, device="cpu")
    v = jax.tree.map(np.asarray, jg.init(jax.random.PRNGKey(0)))
    dv = jax.tree.map(np.asarray, jg.init_disc(jax.random.PRNGKey(1)))
    tg.init_disc()
    kw = dict(shuffle=False, transforms=(), use_native=False)
    jb = next(iter(jdata.BatchLoader(jconfig.build_datasets(jcfg)[0], BATCH, prefetch=0, **kw)))
    tb = next(iter(tdata.BatchLoader(tconfig.build_datasets(tcfg)[0], BATCH, **kw)))
    return jg, v, dv, tg, (jb, tb)


def test_one_bf16_gan_step_matches_jax(job_root, monkeypatch):
    exp = "cglgan"
    entry = bf16_gan(exp)
    jg, v, dv, tg, (jb, tb) = entry
    tr, gen_step, dis_step = jax_steps(f"bf16-{exp}-1dev", entry, job_root / "jax",
                                       make_mesh(devices=jax.devices()[:1]))
    state, dis_state = _jax_states(tr, v, dv)
    ji, jt = tr._device_batch(*jg.preprocess(jb, np.random.default_rng(3)))
    state, gm = gen_step(1.0, state, dis_state, ji, jt, jax.random.PRNGKey(1))
    dis_state, dm = dis_step(1.0, dis_state, state, ji, jt, jax.random.PRNGKey(2))

    costs = []
    lsa = tgc.batched_lsa
    monkeypatch.setattr(tgc, "batched_lsa", lambda c: costs.append(c.dtype) or lsa(c))
    trainer = TGANTrainer(tg, TTrainConfig(job_dir=str(job_root / "port"), batch_size=BATCH))
    tstate, tdis = trainer.init_states()  # both nets fp32, then JAX's weights unrounded
    load_jax_params(tg.core, v["params"], v["batch_stats"])
    load_jax_params(tg.disc, dv["params"], dv.get("batch_stats"))
    inputs, targets = tg.device_batch(*tg.preprocess(tb, np.random.default_rng(3)))
    seen, hooks = output_dtypes(tg.core)
    seen_d, hooks_d = output_dtypes(tg.disc)
    try:
        got_g = trainer.gen_step(tstate, tdis, inputs, targets)
        got_d = trainer.dis_step(tdis, tstate, inputs, targets)
    finally:
        for h in hooks + hooks_d:
            h.remove()

    assert seen == seen_d == {"Linear": {torch.bfloat16}, "Conv2d": {torch.bfloat16}}
    assert costs == [torch.float32]  # one assignment, on fp32 costs
    for module, st in ((tg.core, tstate), (tg.disc, tdis)):
        assert_fp32_state(module, st.optimizer.opt)
    np.testing.assert_allclose(float(got_g["loss"]), float(gm["loss"]), rtol=LOSS_RTOL["gen"])
    np.testing.assert_allclose(float(got_d["loss_d"]), float(dm["loss_d"]),
                               rtol=LOSS_RTOL["disc"])
    for net, module, init, after in (("gen", tg.core, v, state), ("disc", tg.disc, dv, dis_state)):
        params = export_params(module)[0]
        jp = jax.tree.map(np.asarray, after.params)
        for key in init["params"]:
            if key != "layout_encoder":  # frozen by its name on both sides
                same_change(f"{net}/{key}", init["params"][key], jp[key], params[key],
                            COS[net])


@pytest.mark.parametrize("preset", ["autoreg", "maskgit", "vqdiffusion", "layoutdm_ra", "icvt"])
def test_cli_train_bf16_trains_the_preset(cache_dir, job_root, preset):
    """`cli.train --debug model.dtype=bfloat16` on the CPU trains the preset
    with fp32 checkpoints; the port's cli.inference serves the job in bf16
    (`ralf`: test_torch_port_bf16_train.py; the GAN presets: below)."""
    job = str(job_root / "job")
    tcli_train.main(["--experiment", preset, "--synthetic", "--debug", "--device", "cpu",
                     "--batch-size", "8", "--job-dir", job, "--cache-dir", cache_dir,
                     *overrides(preset, cache_dir)])
    (rec,) = _records(job_root / "job")
    assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])
    for tag in ("final", "best"):
        params, stats = load_params_npz(os.path.join(job, f"ckpt_{tag}.npz"))
        assert all(a.dtype == np.float32 for a in jax.tree.leaves((params, stats)))
    if preset == "autoreg":
        summary = tinf.main(["--job-dir", job, "--cond", "c", "--num-seeds", "1",
                             "--batch-size", "8", "--device", "cpu", "--out-dir", f"{job}/out"])
        assert summary["ms_per_sample"] and os.path.exists(f"{job}/out/test_0.pkl")


@pytest.mark.parametrize("exp", ["dsgan", "dsgan_ra"])
def test_dsgan_trains_in_fp32_only_as_in_jax(exp, job_root):
    """JAX's DS-GAN and its discriminator fail to build at bf16; the port's
    GANTrainer and its cli.train refuse the dtype."""
    jg = jconfig.build_generator(jconfig.build_config(exp, _over(exp)), None)
    for build in (lambda: jg.init(jax.random.PRNGKey(0)),
                  lambda: jg.init_disc(jax.random.PRNGKey(1))):
        with pytest.raises(TypeError, match="carry"):
            build()
    tg = tconfig.build_generator(tconfig.build_config(exp, _over(exp)), None, device="cpu")
    with pytest.raises(ValueError, match="float32 only"):
        TGANTrainer(tg, TTrainConfig(job_dir=str(job_root / "t")))
    with pytest.raises(ValueError, match="float32 only"):
        tcli_train.main(["--experiment", exp, "--synthetic", "--debug", "--device", "cpu",
                         "--job-dir", str(job_root / "job"), *_over(exp)])


def test_cli_train_bf16_trains_cglgan_ra(job_root):
    exp = "cglgan_ra"
    job = str(job_root / "job")
    tcli_train.main(["--experiment", exp, "--synthetic", "--debug", "--device", "cpu",
                     "--batch-size", "8", "--job-dir", job, *_over(exp)])
    with open(os.path.join(job, "metrics.jsonl")) as f:
        (rec,) = [json.loads(line) for line in f]
    assert np.isfinite(rec["g_loss"])
    for tag in ("final", "final_dis"):
        trees = load_params_npz(os.path.join(job, f"ckpt_{tag}.npz"))
        assert all(a.dtype == np.float32 for a in jax.tree.leaves(trees))


def _run_jax(main, argv):
    old = sys.argv
    sys.argv = ["cli", *argv]
    try:
        main()
    finally:
        sys.argv = old


def _results(path):
    with open(path, "rb") as f:
        return pickle.load(f)["results"]


def test_cli_train_bf16_checkpoint_serves_both_cli_inferences(job_root):
    """cglgan trained at bf16 through cli.train: its fp32 checkpoints serve
    both packages' cli.inference in bf16 (the job's config) and in fp32."""
    job = str(job_root / "job")
    tcli_train.main(["--experiment", "cglgan", "--synthetic", "--debug", "--device", "cpu",
                     "--batch-size", "8", "--job-dir", job, *_over("cglgan")])
    for tag in ("final", "final_dis"):
        trees = load_params_npz(os.path.join(job, f"ckpt_{tag}.npz"))
        assert all(a.dtype == np.float32 for a in jax.tree.leaves(trees))
    write_jax_checkpoint(job)
    args = ["--job-dir", job, "--cond", "c", "--num-seeds", "1", "--batch-size", "8"]
    for dtype in ("bfloat16", "float32"):
        with open(os.path.join(job, "config.json")) as f:
            cfg = json.load(f)
        cfg["model"]["dtype"] = None if dtype == "float32" else dtype
        with open(os.path.join(job, "config.json"), "w") as f:
            json.dump(cfg, f)
        _run_jax(jinf.main, args + ["--out-dir", f"{job}/jax_{dtype}"])
        tinf.main(args + ["--device", "cpu", "--out-dir", f"{job}/port_{dtype}"])
        want, got = (_results(f"{job}/{pkg}_{dtype}/test_0.pkl") for pkg in ("jax", "port"))
        assert len(got) == len(want) == 16
        assert [r["id"] for r in got] == [r["id"] for r in want]
        if dtype == "bfloat16":
            assert [len(r["label"]) for r in got] == [len(r["label"]) for r in want]
            continue
        for g, w in zip(got, want, strict=True):
            assert g["label"] == w["label"]
            for k in GEO:
                np.testing.assert_allclose(g[k], w[k], atol=1e-5, rtol=0)
