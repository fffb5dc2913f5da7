"""The port's offline builders and image metrics against the JAX package's,
on the CPU: `cli.build_caches` (every `--what`, every rerank, the tower
backbones) and `cli.evaluate --image-metrics`, both packages' CLIs run in
process (JAX's reads `sys.argv`).

Both packages use the synthetic splits of 64/16/16 canvases: both
packages' `build_datasets` are wrapped to set `debug` and 64x48 canvases,
as JAX's CLI has no flag for either.  The tower backbones run
the same weights in both: `dreamsim` and `clip` cut to small ViTs (dim 96,
depth 2, 64x64 inputs) whose timm-named checkpoint both packages load from
the same cache dir, LPIPS-Alex from one `lpips_alex.pth`, and `vgg` (138 M
parameters) as one shared deterministic feature function patched into both
packages' `build_feature_fn`.

Tables and pickles must be equal.  The synthetic canvases are noise, so
random towers give them features whose cosines all lie within 2e-5 of 1:
neighbours a tower ranks then differ by less than the two frameworks'
float32 sums, and those tables are held by JAX's scores of each position's
neighbour (within 1e-6 of the largest score: a few float32 ulps), not by
the indices.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import tower_twins
from test_torch_port_towers import _alexnet_lpips_state_dict, shared_features
from ralf_tpu import cache as jcache
from ralf_tpu import config as jconfig
from ralf_tpu.cli import build_caches as jbuild
from ralf_tpu.core import relationships as jrel
from ralf_tpu.models import towers as jtow
from ralf_tpu.retrieval import retriever as jret
from ralf_tpu_torch import cache as tcache
from ralf_tpu_torch import config as tconfig
from ralf_tpu_torch.cli import build_caches as tbuild
from ralf_tpu_torch.core import relationships as trel
from ralf_tpu_torch.models import towers as ttow
from ralf_tpu_torch.retrieval import retriever as tret

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = ("train", "val", "test")


@pytest.fixture
def debug_splits(monkeypatch):
    """Both packages' build_datasets with `debug` set and 64x48 canvases."""
    for mod in (jconfig, tconfig):
        def small(cfg, build=mod.build_datasets):
            data = dataclasses.replace(cfg.dataset, image_h=64, image_w=48)
            return build(dataclasses.replace(cfg, debug=True, dataset=data))

        monkeypatch.setattr(mod, "build_datasets", small)


@pytest.fixture
def small_towers(monkeypatch, tmp_path):
    """dreamsim and clip as small ViTs in both packages, one checkpoint each
    in `tmp_path`, and LPIPS-Alex's; vgg as one shared feature function."""
    for kind, ckpt, pre_norms in (("dreamsim", "dreamsim_ensemble.pt", ttow.DREAMSIM_TOWERS),
                                  ("clip", "clip_vit_b16.pt", ((None, True),))):
        sd = {}
        for i, (name, pre_norm) in enumerate(pre_norms):
            twin = tower_twins.randomize_(tower_twins.ViTTwin(
                dim=96, depth=2, num_heads=4, img_size=64, pre_norm=pre_norm), seed=20 + i)
            sd.update({(f"{name}." if name else "") + k: v for k, v in twin.state_dict().items()})
        torch.save(sd, str(tmp_path / ckpt))
    torch.save(_alexnet_lpips_state_dict(22, as_slices=True)[0], str(tmp_path / "lpips_alex.pth"))
    jspec, tspec = dict(jtow.TOWER_SPECS), dict(ttow.TOWER_SPECS)
    monkeypatch.setitem(jtow.TOWER_SPECS, "dreamsim", (
        lambda dt: jtow.DreamSimEnsemble(dim=96, depth=2, num_heads=4, dtype=dt), 64,
        *jspec["dreamsim"][2:]))
    monkeypatch.setitem(jtow.TOWER_SPECS, "clip", (
        lambda dt: jtow.ViTB16(dim=96, depth=2, num_heads=4, pre_norm=True, dtype=dt), 64,
        *jspec["clip"][2:]))
    monkeypatch.setitem(ttow.TOWER_SPECS, "dreamsim", (
        lambda: ttow.DreamSimEnsemble(96, 2, 4, img_size=64), 64, *tspec["dreamsim"][2:]))
    monkeypatch.setitem(ttow.TOWER_SPECS, "clip", (
        lambda: ttow.ViTB16(96, 2, 4, pre_norm=True, img_size=64), 64, *tspec["clip"][2:]))
    fn = shared_features(16)
    build_j, build_t = jtow.build_feature_fn, ttow.build_feature_fn
    monkeypatch.setattr(jtow, "build_feature_fn", lambda kind, cache_dir="cache", dtype=None: (
        fn if kind == "vgg" else build_j(kind, cache_dir)))
    monkeypatch.setattr(ttow, "build_feature_fn", lambda kind, cache_dir="cache", device="cuda": (
        (lambda x: torch.from_numpy(fn(x))) if kind == "vgg" else build_t(kind, cache_dir, device)))
    jret.get_backbone.cache_clear()
    yield str(tmp_path)
    jret.get_backbone.cache_clear()


def _run_jax(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["build_caches", *argv])
    jbuild.main()


def _query_features(backbone, cache_dir, split):
    """JAX's features of a split's canvases by the backbone (the CLI's)."""
    ds = jconfig.build_datasets(jconfig.FrameworkConfig(
        dataset=jconfig.DatasetConfig(name="pku10"), synthetic_data=True))[SPLITS.index(split)]
    return np.asarray(jret.get_backbone(backbone, cache_dir)(ds.get_images(np.arange(len(ds)))))


@pytest.mark.parametrize("backbone,rerank", [
    ("saliency", "none"), ("saliency", "mmr"), ("saliency", "random"), ("saliency", "lpips"),
    ("dreamsim", "none"), ("clip", "none"), ("vgg", "mmr")])
def test_build_caches_retrieval_matches_jax(backbone, rerank, small_towers, debug_splits,
                                            monkeypatch, tmp_path):
    common = ["--what", "retrieval", "--synthetic", "--top-k", "6", "--backbone", backbone,
              "--rerank", rerank, "--lpips-size", "32"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for d in (jdir, tdir):  # the checkpoints, where each package's cache dir is
        os.makedirs(d)
        for f in os.listdir(small_towers):
            if f.endswith((".pt", ".pth")):
                os.link(os.path.join(small_towers, f), os.path.join(d, f))
    _run_jax(monkeypatch, [*common, "--cache-dir", jdir])
    tbuild.main([*common, "--cache-dir", tdir, "--device", "cpu"])
    key = "lpips" if rerank == "lpips" else backbone
    k = 3 if rerank == "mmr" else 6
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for split, n in zip(SPLITS, (64, 16, 16)):
        want = jcache.load_retrieval_table(jdir, "pku10", split, key, k)
        got = tcache.load_retrieval_table(tdir, "pku10", split, key, k)
        assert got.shape == (n, k) and got.dtype == want.dtype
        if backbone in ("dreamsim", "clip"):  # each position's neighbour by JAX's score
            gallery = np.load(os.path.join(jdir, f"pku10_{backbone}_gallery_features.npz"))
            g = gallery["features"] / np.linalg.norm(gallery["features"], axis=-1,
                                                     keepdims=True)
            scores = _query_features(backbone, jdir, split) @ g.T
            assert scores.max() > scores.min()
            np.testing.assert_allclose(np.take_along_axis(scores, got, 1),
                                       np.take_along_axis(scores, want, 1), rtol=0,
                                       atol=1e-6 * np.abs(scores).max(), err_msg=split)
        else:
            np.testing.assert_array_equal(got, want, err_msg=split)
        if split == "train":
            assert not (got == np.arange(n)[:, None]).any()  # never a canvas itself
        assert ((got >= 0) & (got < 64)).all()
    feats = {p: np.load(os.path.join(d, f"pku10_{backbone}_gallery_features.npz"))["features"]
             for p, d in (("jax", jdir), ("port", tdir))}
    assert feats["port"].shape == feats["jax"].shape and feats["port"].shape[0] == 64
    np.testing.assert_allclose(feats["port"], feats["jax"], rtol=1e-4,
                               atol=1e-4 * np.abs(feats["jax"]).max())


def test_build_caches_clusters_and_relationships_match_jax(debug_splits, monkeypatch, tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for what in ("clusters", "relationships"):
        _run_jax(monkeypatch, ["--what", what, "--synthetic", "--cache-dir", jdir])
        tbuild.main(["--what", what, "--synthetic", "--cache-dir", tdir, "--device", "cpu"])
    with open(tcache.kmeans_clusters_path(tdir, "pku10"), "rb") as f:
        got = pickle.load(f)
    with open(jcache.kmeans_clusters_path(jdir, "pku10"), "rb") as f:
        want = pickle.load(f)
    assert list(got) == list(want) and len(got) == 4 * 8
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the relation tables: each package reads the other's with its own enums
    port_by_jax = jcache.load_relationships(tdir, "pku10")
    jax_by_jax = jcache.load_relationships(jdir, "pku10")
    jax_by_port = tcache.load_relationships(jdir, "pku10")
    port_by_port = tcache.load_relationships(tdir, "pku10")
    assert len(jax_by_jax) == 64  # the synthetic splits' ids are 0.. in each
    assert port_by_jax == jax_by_jax == jax_by_port == port_by_port
    for table, pkg in ((port_by_jax, jrel), (jax_by_port, trel), (port_by_port, trel)):
        rels = [c[2] for clauses in table.values() for c in clauses]
        assert rels and all(isinstance(r, (pkg.RelLoc, pkg.RelSize)) for r in rels)
        assert any(isinstance(r, pkg.RelSize) for r in rels)


def test_relation_table_loads_without_the_jax_package(debug_splits, monkeypatch, tmp_path):
    """Queue C 70: a JAX-written table read by the port imports no module of
    the JAX package (its enums are mapped onto the port's)."""
    _run_jax(monkeypatch, ["--what", "relationships", "--synthetic", "--cache-dir",
                           str(tmp_path)])
    code = ("import sys; from ralf_tpu_torch import cache; "
            f"t = cache.load_relationships({str(tmp_path)!r}, 'pku10'); "
            "from ralf_tpu_torch.core.relationships import RelLoc, RelSize; "
            "rels = [c[2] for v in t.values() for c in v]; "
            "assert rels and all(isinstance(r, (RelLoc, RelSize)) for r in rels); "
            "assert not [m for m in sys.modules if m.split('.')[0] in ('ralf_tpu', 'jax')]; "
            "print(len(t))")
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "64"
