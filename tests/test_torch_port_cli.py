"""The port's inference and evaluation CLIs end to end against the JAX
package's, in process on the CPU.

For `ralf` and `autoreg` one tiny job dir (d_model 32, 1+1 layers,
resnet18, 64x48 canvases, debug-size synthetic splits, deterministic
sampling) is made from one set of variables: JAX's `Trainer.save` writes
the orbax checkpoint and the test writes the same tree as
`ckpt_final.npz`.  Then JAX's `cli.inference` (`--mesh off`) and the
port's (`--device cpu`) decode `--cond c` and `uncond`: the pickles must be
equal (labels and coordinates exactly, both decoded from equal tokens) and
so must the violation csvs.  Both `cli.evaluate` then run with the same
FIDNet parameters (orbax for JAX, `.npz` for the port): every score agrees
within 1e-5 relative.  Also `--single-image` and `--topk`, and the guards.
"""

import csv
import dataclasses
import json
import logging
import os
import pickle
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from ralf_tpu import config as jconfig
from ralf_tpu.cli import evaluate as jeval
from ralf_tpu.cli import inference as jinf
from ralf_tpu.train.fid_trainer import FIDNetTrainer
from ralf_tpu.train.trainer import Trainer
from ralf_tpu_torch.cli import evaluate as teval
from ralf_tpu_torch.cli import inference as tinf
from ralf_tpu_torch.data import dataset as tdata

torch.set_num_threads(2)
REL = 1e-5  # scores_all.json, port against JAX
TINY = ["model.d_model=32", "model.nhead=4", "model.num_encoder_layers=1",
        "model.num_decoder_layers=1", "model.dim_feedforward=64", "model.backbone=resnet18",
        "dataset.image_h=64", "dataset.image_w=48", "debug=true", "synthetic_data=true",
        "sampling.name=deterministic"]


def _run_jax(main, argv):
    old = sys.argv
    sys.argv = ["cli", *argv]
    try:
        main()
    finally:
        sys.argv = old


def _flat_npz(path, **trees):
    flat = {f"{name}/{k}": np.asarray(v) for name, tree in trees.items()
            for k, v in flatten_dict(jax.device_get(tree), sep="/").items()}
    np.savez(path, **flat)


def _make_job(root, experiment):
    job = str(root / f"job_{experiment}")
    over = TINY + [f"cache_dir={root}/cache_{experiment}", f"train.job_dir={job}"]
    if experiment == "ralf":
        over.append("generator_kwargs.top_k=4")
    cfg = jconfig.build_config(experiment, over)
    cfg.save(job)
    trainer = Trainer(jconfig.build_generator(cfg, jconfig.build_tokenizer(cfg)), cfg.train)
    state = trainer.init_state(jax.random.PRNGKey(0))
    trainer.save(state, "final")
    _flat_npz(os.path.join(job, "ckpt_final.npz"), params=state.params,
              batch_stats=state.batch_stats)
    for cond in ("c", "uncond"):
        args = ["--job-dir", job, "--cond", cond, "--num-seeds", "1", "--batch-size", "16"]
        _run_jax(jinf.main, args + ["--mesh", "off", "--out-dir", f"{job}/jax_{cond}"])
        tinf.main(args + ["--device", "cpu", "--out-dir", f"{job}/port_{cond}"])
    return job


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    return {exp: _make_job(root, exp) for exp in ("ralf", "autoreg")}


@pytest.fixture(scope="module")
def fidnet_dir(tmp_path_factory):
    """One FIDNet (3 labels, S = 10) as JAX's orbax checkpoint and as the .npz."""
    d = str(tmp_path_factory.mktemp("fidnet"))
    trainer = FIDNetTrainer(3, 10, job_dir=d)
    params, _ = trainer.init(jax.random.PRNGKey(3))
    trainer.save(params)
    _flat_npz(os.path.join(d, "fidnet_ckpt.npz"), params=params)
    return d


def _pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("experiment", ["ralf", "autoreg"])
@pytest.mark.parametrize("cond", ["c", "uncond"])
def test_inference_writes_jax_pickles_and_violations(jobs, experiment, cond):
    job = jobs[experiment]
    want = _pickle(f"{job}/jax_{cond}/test_0.pkl")
    got = _pickle(f"{job}/port_{cond}/test_0.pkl")
    assert len(got["results"]) == 16 and set(got["results"][0]) == {
        "id", "label", "center_x", "center_y", "width", "height"}
    assert got == want
    assert _csv(f"{job}/port_{cond}/test_0_violation.csv") == \
        _csv(f"{job}/jax_{cond}/test_0_violation.csv")
    if cond == "c":
        assert _csv(f"{job}/port_c/test_0_violation.csv")[1][2] == "0.0"


@pytest.mark.parametrize("experiment", ["ralf", "autoreg"])
def test_evaluate_writes_jax_scores(jobs, fidnet_dir, experiment):
    job = jobs[experiment]
    common = ["--job-dir", job, "--fidnet-dir", fidnet_dir, "--split", "test"]
    _run_jax(jeval.main, ["--input-dir", f"{job}/jax_c", "--cache-dir", f"{job}/jax_eval"]
             + common)
    teval.main(["--input-dir", f"{job}/port_c", "--cache-dir", f"{job}/port_eval",
                "--device", "cpu", "--eval-batch-size", "5"] + common)
    with open(f"{job}/jax_c/scores_all.json") as f:
        want = json.load(f)
    with open(f"{job}/port_c/scores_all.json") as f:
        got = json.load(f)
    assert list(got) == list(want)
    for k in want:
        for stat in ("mean", "std"):
            assert got[k][stat] == pytest.approx(want[k][stat], rel=REL, abs=1e-12), (k, stat)
    with open(f"{job}/port_c/scores_all.txt") as f:
        assert f.readline().rstrip("\n").split("\t") == list(want)
    assert os.path.exists(f"{job}/port_eval/eval_gt_features_pku10_test_trained.npz")


def test_single_image_and_dynamic_topk_match_jax(jobs, tmp_path):
    from PIL import Image

    job = jobs["ralf"]
    img = str(tmp_path / "canvas.png")
    rng = np.random.default_rng(0)
    Image.fromarray((rng.random((70, 40, 3)) * 255).astype("uint8")).save(img)
    runs = {"single": ["--cond", "c", "--single-image", img],
            "topk": ["--cond", "uncond", "--topk", "2", "--batch-size", "16"]}
    for name, extra in runs.items():
        args = ["--job-dir", job, "--num-seeds", "1", *extra]
        _run_jax(jinf.main, args + ["--mesh", "off", "--out-dir", f"{tmp_path}/jax_{name}"])
        tinf.main(args + ["--device", "cpu", "--out-dir", f"{tmp_path}/port_{name}"])
        want = _pickle(f"{tmp_path}/jax_{name}/test_0.pkl")
        got = _pickle(f"{tmp_path}/port_{name}/test_0.pkl")
        assert got == want
        assert len(got["results"]) == (1 if name == "single" else 16)
    assert got != _pickle(f"{job}/port_uncond/test_0.pkl")  # top-2, not top-4, neighbours


def test_existing_pickle_is_skipped_and_default_out_dir(jobs, caplog):
    job = jobs["autoreg"]
    args = ["--job-dir", job, "--cond", "c", "--num-seeds", "2", "--device", "cpu",
            "--batch-size", "16", "--ckpt", "final"]
    with caplog.at_level(logging.INFO):
        first = tinf.main(args)
        assert first["out_dir"] == f"{job}/generated_samples_c"
        assert set(first["ms_per_sample"]) == {0, 1}
        again = tinf.main(args)
    assert again["ms_per_sample"] == {}
    assert "skip existing" in caplog.text
    assert _pickle(f"{job}/generated_samples_c/test_0.pkl") == _pickle(f"{job}/port_c/test_0.pkl")


def test_unannotated_falls_back_only_when_the_split_is_absent(jobs, tmp_path):
    job = jobs["autoreg"]
    args = ["--job-dir", job, "--cond", "uncond", "--num-seeds", "1", "--device", "cpu",
            "--unannotated"]
    tinf.main(args + ["--out-dir", str(tmp_path / "un")])
    assert _pickle(tmp_path / "un" / "test_0.pkl") == _pickle(f"{job}/port_uncond/test_0.pkl")
    scores = teval.main(["--input-dir", str(tmp_path / "un"), "--job-dir", job, "--device",
                         "cpu", "--unannotated", "--cache-dir", str(tmp_path / "c")])
    assert "fid" not in scores and "overlay" in scores
    # a split directory that exists but cannot be read is an error, not a fallback
    from ralf_tpu_torch.config import FrameworkConfig

    cfg = FrameworkConfig.load(job)
    cfg.dataset = dataclasses.replace(cfg.dataset, data_dir=str(tmp_path))
    (tmp_path / "with_no_annotation").mkdir()
    with pytest.raises(Exception) as e:
        tdata.unannotated_dataset(cfg.dataset, None, "test")
    assert not isinstance(e.value, ImportError)


def test_evaluate_split_both_writes_one_file_per_split(jobs, tmp_path):
    job = jobs["autoreg"]
    out = tmp_path / "both"
    for split in ("val", "test"):
        tinf.main(["--job-dir", job, "--cond", "uncond", "--split", split, "--num-seeds", "1",
                   "--device", "cpu", "--out-dir", str(out)])
    common = ["--input-dir", str(out), "--job-dir", job, "--device", "cpu", "--cache-dir",
              str(tmp_path / "cache")]
    both = teval.main(common + ["--split", "both"])
    assert set(both) == {"val", "test"} and both["val"] != both["test"]
    assert (out / "scores_all_val.json").exists() and (out / "scores_all_test.txt").exists()
    test_only = teval.main(common + ["--split", "test"])
    assert json.dumps(test_only) == json.dumps(both["test"])  # NaN-aware


def test_untrained_fidnet_features_never_share_jax_cache_tag(jobs, tmp_path):
    job = jobs["ralf"]
    teval.main(["--input-dir", f"{job}/port_uncond", "--job-dir", job, "--device", "cpu",
                "--cache-dir", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["eval_gt_features_pku10_test_untrained_torch.npz"]


def test_clis_guard_the_device_and_what_is_not_ported(jobs, tmp_path, monkeypatch):
    job = jobs["ralf"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tinf.main(["--job-dir", job])
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.main(["--input-dir", f"{job}/port_c", "--job-dir", job])
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        tinf.main(["--job-dir", job, "--device", "cpu", "--mesh", "on"])
    # --image-metrics runs on the CPU and writes R_shm (the towers cut to a
    # cheap feature function here; tests/test_torch_port_towers.py holds them)
    from ralf_tpu_torch.eval import image_metrics

    monkeypatch.setattr(image_metrics, "tower_feature_fn", lambda kind, *a, **kw: (
        lambda images: np.asarray(images, np.float32)[..., :3].mean((1, 2))))
    pickles = shutil.copytree(f"{job}/port_c", tmp_path / "image_metrics")
    scores = teval.main(["--input-dir", str(pickles), "--job-dir", job, "--device", "cpu",
                         "--image-metrics", "--cache-dir", str(tmp_path / "image_cache")])
    assert np.isfinite(scores["R_shm"]["mean"]) and "image_fid" in scores
    with open(pickles / "scores_all.json") as f:
        assert "R_shm" in json.load(f)
    with pytest.raises(FileNotFoundError, match="no parameters"):
        tinf.main(["--job-dir", job, "--device", "cpu", "--ckpt", "missing", "--out-dir",
                   str(tmp_path / "x")])
    # only the orbax checkpoint: the port says it reads an .npz
    os.rename(f"{job}/ckpt_final.npz", f"{job}/ckpt_final.npz.bak")
    try:
        with pytest.raises(FileNotFoundError, match="orbax checkpoint"):
            tinf.main(["--job-dir", job, "--device", "cpu", "--out-dir", str(tmp_path / "y")])
    finally:
        os.rename(f"{job}/ckpt_final.npz.bak", f"{job}/ckpt_final.npz")
    fid_orbax_only = tmp_path / "fid"
    (fid_orbax_only / "fidnet_ckpt").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="orbax checkpoint"):
        teval.main(["--input-dir", f"{job}/port_c", "--job-dir", job, "--device", "cpu",
                    "--fidnet-dir", str(fid_orbax_only)])
