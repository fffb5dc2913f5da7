"""`cli.inference` on the GAN, ICVT and retriever presets: JAX's CLI (at
its default --mesh auto, in process) and the port's on one tiny job dir per
preset, and the relation clause table's gate in both CLIs.

The job dirs hold JAX's orbax checkpoint and the `.npz` of the same tree
(random weights); the retriever's is written by the port's `cli.train`,
which stops after the config, as JAX's does.  Pickles: the GANs' labels
exactly and coordinates within 1e-5 (the same numpy initial layouts through
two fp32 forwards), the retriever's exactly; ICVT's latent comes from
`jax.random` in JAX and from a torch generator in the port, so its pickle is
held by its form: every record's elements legal.
"""

import os
import pickle
import sys

import jax
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

from ralf_tpu import config as jconfig
from ralf_tpu.cli import inference as jinf
from ralf_tpu.train.trainer import Trainer
from ralf_tpu_torch import config as tconfig
from ralf_tpu_torch.cli import inference as tinf
from ralf_tpu_torch.cli import train as ttrain

HW = (64, 48)
TINY = ["model.d_model=40", "model.nhead=4", "model.num_encoder_layers=1",
        "model.num_decoder_layers=1", "model.dim_feedforward=64", "model.backbone=resnet18",
        f"dataset.image_h={HW[0]}", f"dataset.image_w={HW[1]}", "debug=true",
        "synthetic_data=true"]
ARGS = ["--num-seeds", "1", "--batch-size", "8"]  # the 16 test canvases in 2 batches
GEO = ("center_x", "center_y", "width", "height")


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


def _make_job(root, experiment, extra=()):
    """A job dir of `experiment`: config.json, JAX's orbax checkpoint of a
    fresh init and the .npz of the same tree."""
    job = str(root / experiment)
    cfg = jconfig.build_config(experiment, TINY + [f"train.job_dir={job}",
                                                   f"cache_dir={root}/cache", *extra])
    cfg.save(job)
    trainer = Trainer(jconfig.build_generator(cfg, jconfig.build_tokenizer(cfg)), cfg.train)
    state = trainer.init_state(jax.random.PRNGKey(0))
    trainer.save(state, "final")
    flat = {f"{name}/{k}": np.asarray(a) for name, tree in
            (("params", state.params), ("batch_stats", state.batch_stats))
            for k, a in flatten_dict(jax.device_get(tree), sep="/").items()}
    np.savez(os.path.join(job, "ckpt_final.npz"), **flat)
    return job


@pytest.mark.parametrize("experiment,task", [("cglgan", "c"), ("cglgan_ra", "uncond"),
                                             ("dsgan", "c"), ("dsgan_ra", "uncond")])
def test_gan_pickles_equal_jax(tmp_path, experiment, task):
    """The job's auxiliary_task conditions the initial layouts (`--cond`
    only names the directory); DS-GAN reorders its ground truth; the _ra
    presets retrieve their top-k from the train split."""
    extra = [f"auxiliary_task={task}"] + (["generator_kwargs.top_k=4"] if "_ra" in experiment
                                          else [])
    job = _make_job(tmp_path, experiment, extra)
    args = ["--job-dir", job, "--cond", task, *ARGS]
    _run_jax(jinf.main, args + ["--out-dir", f"{job}/jax"])
    summary = tinf.main(args + ["--device", "cpu", "--out-dir", f"{job}/port"])
    want, got = _pickle(f"{job}/jax/test_0.pkl"), _pickle(f"{job}/port/test_0.pkl")
    assert len(got["results"]) == 16 and summary["ms_per_sample"][0] > 0
    assert {k: got[k] for k in ("cond", "split", "seed")} == {k: want[k] for k in
                                                             ("cond", "split", "seed")}
    assert sum(len(r["label"]) for r in got["results"]) > 0
    for g, w in zip(got["results"], want["results"], strict=True):
        assert g["id"] == w["id"] and g["label"] == w["label"]
        for k in GEO:
            np.testing.assert_allclose(g[k], w[k], atol=1e-5, rtol=0)
    with open(f"{job}/port/test_0_violation.csv") as f:
        assert f.read().splitlines()[1] == "0,0,0.0"  # no tokens: no violation counted


def test_retriever_job_from_port_train_and_pickles_equal_jax(tmp_path):
    """The port's cli.train --experiment retriever writes the config and
    stops (no checkpoint); both CLIs answer from the train split's gallery."""
    job = str(tmp_path / "retriever")
    assert ttrain.main(["--experiment", "retriever", "--device", "cpu", "--job-dir", job,
                        "--synthetic", "--debug", f"dataset.image_h={HW[0]}",
                        f"dataset.image_w={HW[1]}"]) == job
    assert sorted(os.listdir(job)) == ["config.json"]
    args = ["--job-dir", job, *ARGS]
    _run_jax(jinf.main, args + ["--out-dir", f"{job}/jax"])
    tinf.main(args + ["--device", "cpu", "--out-dir", f"{job}/port"])
    got, want = _pickle(f"{job}/port/test_0.pkl"), _pickle(f"{job}/jax/test_0.pkl")
    assert len(got["results"]) == 16 and got == want


def test_icvt_pickle_holds_legal_layouts(tmp_path):
    job = _make_job(tmp_path, "icvt")
    out = f"{job}/port"
    tinf.main(["--job-dir", job, *ARGS, "--device", "cpu", "--out-dir", out])
    records = _pickle(f"{out}/test_0.pkl")["results"]
    assert len(records) == 16
    for r in records:
        assert all(0 <= lab < 3 for lab in r["label"]) and len(r["label"]) <= 10
        for k in GEO:
            assert len(r[k]) == len(r["label"]) and all(0.0 < x < 1.0 for x in r[k])


def test_relation_table_reaches_only_the_ar_family(tmp_path, monkeypatch):
    """A maskgit job with transforms=[] (the relation table's gate open) and
    a planted clause cache: under --cond relation both CLIs describe the
    batch's own layouts, as JAX's gate keeps the table from every generator
    without a `relationships_table` (the AR family's), and give the same
    conditions."""
    job = _make_job(tmp_path, "maskgit", ["transforms=[]", "sampling.name=deterministic",
                                          "sampling.temperature=0.0"])
    from ralf_tpu_torch import cache as tcache

    from ralf_tpu_torch.core.layout import Layout
    from ralf_tpu_torch.core.relationships import describe_relationships

    test_ds = tconfig.build_datasets(tconfig.FrameworkConfig.load(job))[2]
    ids = test_ds.get_ids(np.arange(16))
    # each canvas planted with the clauses of the next canvas's layout
    clauses = describe_relationships(Layout.fromdict(test_ds.get_layouts(np.arange(16))))
    planted = {str(i): clauses[(n + 1) % 16] for n, i in enumerate(ids)}
    path = tcache.relationships_path(f"{tmp_path}/cache", "pku10")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(planted, f)
    seen = {"jax": [], "port": []}

    def recording(module, side):
        build = module.build_generator

        def wrapped(*a, **kw):
            gen = build(*a, **kw)
            inner = gen.build_condition

            def build_condition(batch, rng, task=None):
                cond, target = inner(batch, rng, task=task)
                seen[side].append(cond)
                return cond, target

            gen.build_condition = build_condition
            return gen
        monkeypatch.setattr(module, "build_generator", wrapped)

    recording(jconfig, "jax")
    recording(tconfig, "port")
    args = ["--job-dir", job, "--cond", "relation", *ARGS]
    _run_jax(jinf.main, args + ["--out-dir", f"{job}/jax"])
    tinf.main(args + ["--device", "cpu", "--out-dir", f"{job}/port"])
    assert len(seen["jax"]) == len(seen["port"]) == 2
    for j, t in zip(seen["jax"], seen["port"]):
        assert t.relations == j.relations
        assert t.relations != [planted[str(i)] for i in t.ids]
        np.testing.assert_array_equal(np.asarray(t.seq), np.asarray(j.seq))
        np.testing.assert_array_equal(np.asarray(t.seq_mask), np.asarray(j.seq_mask))
    assert _pickle(f"{job}/port/test_0.pkl") == _pickle(f"{job}/jax/test_0.pkl")
