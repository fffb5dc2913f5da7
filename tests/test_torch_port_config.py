"""The port's job configuration, caches, kmeans vocabulary and checkpoint
file against the JAX package: each package loads what the other wrote.

Config fields, presets, overrides and factories are compared as JSON (the
job dir's `config.json`); cache files cross in both directions; the kmeans
bucketizer and tokenizer are exact; the weights' `.npz` round-trips.
"""

import dataclasses
import json
import pickle

import jax
import numpy as np
import pytest
import torch

from ralf_tpu import cache as jcache
from ralf_tpu import config as jconfig
from ralf_tpu.core import bucketizer as jbuck
from ralf_tpu.core.layout import Layout as JLayout
from ralf_tpu.core.tokenizer import LayoutSequenceTokenizer as JTokenizer
from ralf_tpu.core.tokenizer import TokenizerConfig as JTokCfg
from ralf_tpu.data.dataset import DatasetConfig as JDataCfg
from ralf_tpu.models.base import GeneratorConfig as JGenCfg
from ralf_tpu.models.ralf import RALFGenerator as JRALF
from ralf_tpu.train.trainer import TrainConfig as JTrainCfg
from ralf_tpu_torch import cache as tcache
from ralf_tpu_torch import config as tconfig
from ralf_tpu_torch.core import bucketizer as tbuck
from ralf_tpu_torch.core.layout import Layout as TLayout
from ralf_tpu_torch.core.tokenizer import LayoutSequenceTokenizer as TTokenizer
from ralf_tpu_torch.core.tokenizer import TokenizerConfig as TTokCfg
from ralf_tpu_torch.data.dataset import DatasetConfig as TDataCfg
from ralf_tpu_torch.models.base import GeneratorConfig as TGenCfg
from ralf_tpu_torch.models.ralf import RALFGenerator as TRALF
from ralf_tpu_torch.train.trainer import TrainConfig as TTrainCfg
from ralf_tpu_torch.utils.weights import (
    export_params,
    load_jax_params,
    load_params_npz,
    save_params_npz,
)

torch.set_num_threads(2)
TINY = dict(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=1,
            dim_feedforward=64, backbone="resnet18")
OVERRIDES = ["model.d_model=32", "++generator_kwargs.top_k=4", "train.lr=0.001",
             "sampling.name=deterministic", "dataset.image_h=64", "dataset.name=cgl",
             "auxiliary_task=c", "debug=true", "model.dtype=bfloat16"]


def _defaults(cls) -> dict:
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
    return out


# ---- step 0: the config dataclasses hold JAX's fields ------------------------


@pytest.mark.parametrize("jcls,tcls", [(JDataCfg, TDataCfg), (JTokCfg, TTokCfg),
                                       (JGenCfg, TGenCfg), (JTrainCfg, TTrainCfg)],
                         ids=["dataset", "tokenizer", "generator", "train"])
def test_config_dataclasses_have_every_jax_field_and_default(jcls, tcls):
    """Every field of the JAX twin, in its order and with its default (a
    job dir's config.json written by JAX names them all)."""
    assert [f.name for f in dataclasses.fields(tcls)] == [f.name for f in dataclasses.fields(jcls)]
    assert _defaults(tcls) == _defaults(jcls)


@pytest.mark.parametrize("written,dtype", [
    (None, None), ("float32", torch.float32), ("bfloat16", torch.bfloat16),
    (json.loads(json.dumps(jax.numpy.float32, default=str)), torch.float32),
    (json.loads(json.dumps(jax.numpy.bfloat16, default=str)), torch.bfloat16),
])
def test_generator_dtype_reads_what_jax_writes(written, dtype):
    assert TGenCfg(dtype=written).dtype == dtype
    with pytest.raises(ValueError, match="dtype"):
        TGenCfg(dtype="int7")


@pytest.mark.parametrize("name", ["pku10", "cgl", "pku_cgl", "cgl_pku", "synthetic"])
def test_label_names_follow_jax(name):
    """JAX tests 'pku' first, then 'cgl', then falls back to PKU."""
    assert tuple(TDataCfg(name=name).label_names) == tuple(JDataCfg(name=name).label_names)
    assert TDataCfg(name=name).num_labels == JDataCfg(name=name).num_labels


# ---- presets, save / load, overrides -----------------------------------------


def _as_json(cfg) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg), default=str))


@pytest.mark.parametrize("experiment", sorted(jconfig.EXPERIMENTS))
def test_every_preset_crosses_between_the_packages(tmp_path, experiment):
    """JAX's saved config loads in the port and the port's in JAX, and the
    same overrides give the same config on both sides."""
    assert tconfig.EXPERIMENTS[experiment] == jconfig.EXPERIMENTS[experiment]
    jc = jconfig.build_config(experiment, OVERRIDES)
    tc = tconfig.build_config(experiment, OVERRIDES)
    assert _as_json(tc) == _as_json(jc)
    jc.save(str(tmp_path / "jax"))
    tc.save(str(tmp_path / "port"))
    assert (tmp_path / "jax" / "config.json").read_text() == \
        (tmp_path / "port" / "config.json").read_text()
    t_from_j = tconfig.FrameworkConfig.load(str(tmp_path / "jax"))
    j_from_t = jconfig.FrameworkConfig.load(str(tmp_path / "port"))
    assert _as_json(t_from_j) == _as_json(j_from_t) == _as_json(jconfig.FrameworkConfig.load(
        str(tmp_path / "jax")))
    assert t_from_j.dataset.name == "cgl" and t_from_j.dataset.num_labels == 4
    assert isinstance(t_from_j.sampling, tconfig.SamplingConfig)
    assert t_from_j.train.lr == 0.001
    assert TGenCfg(**t_from_j.model).dtype == torch.bfloat16


def test_overrides_rebuild_frozen_dataclasses():
    for mod in (jconfig, tconfig):
        cfg = mod.build_config("ralf", ["dataset.max_seq_length=7", "sampling.top_k=3",
                                        "dataset.data_dir=null"])
        assert cfg.dataset.max_seq_length == 7 and cfg.sampling.top_k == 3
        assert cfg.dataset.data_dir is None


def test_tokenizer_override_leaves_the_preset_alone():
    """JAX's build_config hands out the preset's own tokenizer dict, so a
    `tokenizer.*` override there edits EXPERIMENTS for the whole process
    (not exercised on the JAX side here: it would leak into other tests).
    The port copies it."""
    before = dict(tconfig.EXPERIMENTS["ralf"]["tokenizer"])
    cfg = tconfig.build_config("ralf", ["tokenizer.num_bin=16"])
    assert cfg.tokenizer["num_bin"] == 16
    assert tconfig.EXPERIMENTS["ralf"]["tokenizer"] == before
    assert tconfig.build_tokenizer(tconfig.build_config("ralf")).config.num_bin == 128


def test_build_datasets_sizes_and_seeds_match():
    for debug, sizes in ((True, (64, 16, 16)), (False, (512, 64, 64))):
        jc = jconfig.build_config("ralf", [f"debug={str(debug).lower()}", "dataset.image_h=16",
                                           "dataset.image_w=12"])
        tc = tconfig.build_config("ralf", [f"debug={str(debug).lower()}", "dataset.image_h=16",
                                           "dataset.image_w=12"])
        for jd, td, n in zip(jconfig.build_datasets(jc), tconfig.build_datasets(tc), sizes,
                             strict=True):
            assert len(td) == len(jd) == n
            idx = np.arange(0, n, 7)
            for k, a in td.get_layouts(idx).items():
                np.testing.assert_array_equal(a, jd.get_layouts(idx)[k], err_msg=k)
            np.testing.assert_array_equal(td.get_images(idx[:2]), jd.get_images(idx[:2]))


def test_build_generator_ports_autoreg_and_ralf_only():
    for exp, cls in (("ralf", TRALF), ("autoreg", None)):
        cfg = tconfig.build_config(exp, [f"model.{k}={json.dumps(v)}" for k, v in TINY.items()]
                                   + ["dataset.image_h=64", "dataset.image_w=48"])
        gen = tconfig.build_generator(cfg, tconfig.build_tokenizer(cfg), device="cpu")
        assert gen.device == torch.device("cpu") and gen.image_hw == (64, 48)
        assert gen.cfg == TGenCfg(**TINY)
        if cls is not None:
            assert isinstance(gen, cls) and gen.top_k == 16
    # the zoo's token models build too (tests/test_torch_port_maskgit.py and
    # test_torch_port_diffusion.py), and so do the GANs, ICVT and the retriever
    # (tests/test_torch_port_gan.py, test_torch_port_icvt.py), at the presets'
    # other fields
    from ralf_tpu_torch.models.cgl_gan import CGLGANGenerator
    from ralf_tpu_torch.models.dsgan import DSGANGenerator
    from ralf_tpu_torch.models.icvt import ICVTGenerator
    from ralf_tpu_torch.models.retriever_baseline import RetrieverGenerator

    zoo = {"maskgit", "layoutdm", "layoutdm_ra", "vqdiffusion"}
    baselines = {"cglgan": CGLGANGenerator, "cglgan_ra": CGLGANGenerator,
                 "dsgan": DSGANGenerator, "dsgan_ra": DSGANGenerator, "icvt": ICVTGenerator,
                 "retriever": RetrieverGenerator}
    assert set(tconfig.EXPERIMENTS) - {"ralf", "autoreg"} - zoo == set(baselines)
    tiny = ["model.d_model=40", "model.nhead=4", "model.num_encoder_layers=1",
            "model.num_decoder_layers=1", "model.backbone=resnet18", "dataset.image_h=64",
            "dataset.image_w=48", "synthetic_data=true", "debug=true"]
    for exp, cls in sorted(baselines.items()):
        cfg = tconfig.build_config(exp, tiny)
        gen = tconfig.build_generator(cfg, tconfig.build_tokenizer(cfg), device="cpu")
        assert type(gen) is cls and gen.device == torch.device("cpu") and gen.tokenizer is None
        if exp != "retriever":
            assert gen.image_hw == (64, 48) and gen.cfg.d_model == 40
            assert getattr(gen, "with_retrieval", False) == exp.endswith("_ra")
            assert not hasattr(gen, "relationships_table")  # the AR family's only


# ---- caches: written by one package, read by the other ------------------------


def _kmeans_weights(seed=3, bins=(16, 128)):
    rng = np.random.default_rng(seed)
    return {f"{k}-{n}": jbuck.fit_kmeans_1d(rng.uniform(0, 1, 400), n, n_iters=5)
            for k in jcache.GEO_KEYS for n in bins}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_every_cache_kind_crosses_between_the_packages(tmp_path, writer):
    w, r = (jcache, tcache) if writer == "jax" else (tcache, jcache)
    d = str(tmp_path)
    rng = np.random.default_rng(0)
    # retrieval tables: the narrowest K' >= k, sliced to k; row-count checks
    table = rng.integers(0, 50, size=(6, 8))
    w.save_retrieval_table(d, "pku10", "test", "saliency", table)
    w.save_retrieval_table(d, "pku10", "test", "saliency", table[:, :5])
    for k, rows, want in ((4, 6, table[:, :4]), (6, 6, table[:, :6]), (9, 6, None),
                          (4, 7, None)):
        got = r.load_retrieval_table(d, "pku10", "test", "saliency", k, expect_rows=rows)
        ref = w.load_retrieval_table(d, "pku10", "test", "saliency", k, expect_rows=rows)
        if want is None:
            assert got is None and ref is None
        else:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(ref, want)
    assert r.retrieval_table_path(d, "a", "b", "c", 3) == w.retrieval_table_path(d, "a", "b", "c", 3)
    # gallery features
    feats = rng.normal(size=(6, 256))
    w.save_gallery_features(d, "pku10", "saliency", feats)
    np.testing.assert_array_equal(r.load_gallery_features(d, "pku10", "saliency", 6),
                                  feats.astype(np.float32))
    assert r.load_gallery_features(d, "pku10", "saliency", 5) is None
    # GT features, per extractor tag
    w.save_gt_features(d, "pku10", "test", "trained", feats)
    np.testing.assert_array_equal(r.load_gt_features(d, "pku10", "test", "trained", 6),
                                  feats.astype(np.float32))
    assert r.load_gt_features(d, "pku10", "test", "untrained", 6) is None
    # kmeans centers and relationships: pickles at the shared paths
    weights = _kmeans_weights()
    with open(w.kmeans_clusters_path(d, "pku10"), "wb") as f:
        pickle.dump(weights, f)
    got = r.load_kmeans_centers(d, "pku10", 16)
    for k in r.GEO_KEYS:
        np.testing.assert_array_equal(got[k], weights[f"{k}-16"].astype(np.float32))
    assert r.load_kmeans_centers(d, "pku10", 64) is None
    rel = {"3": [("a", "b", "left")]}
    with open(w.relationships_path(d, "pku10"), "wb") as f:
        pickle.dump(rel, f)
    assert r.load_relationships(d, "pku10") == rel
    assert r.load_relationships(d, "cgl") is None


# ---- kmeans vocabulary -------------------------------------------------------


def test_kmeans_fit_and_bucketizer_are_exact():
    rng = np.random.default_rng(1)
    data = np.concatenate([rng.beta(2, 8, 3000), rng.beta(8, 2, 3000)])
    for n in (4, 32):
        centers = tbuck.fit_kmeans_1d(data, n, seed=2)
        np.testing.assert_array_equal(centers, jbuck.fit_kmeans_1d(data, n, seed=2))
        tb, jb = tbuck.kmeans_bucketizer(rng.permutation(centers)), jbuck.kmeans_bucketizer(centers)
        np.testing.assert_array_equal(tb.boundaries, jb.boundaries)
        np.testing.assert_array_equal(tb.centers, jb.centers)
        x = np.concatenate([rng.uniform(-0.1, 1.1, 500), jb.boundaries]).astype(np.float32)
        idx = tb.encode(torch.from_numpy(x))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jb.encode(x)))
        np.testing.assert_array_equal(tb.decode(idx).numpy(), np.asarray(jb.decode(idx.numpy())))


def test_kmeans_tokenizer_is_exact_and_loads_from_the_cache(tmp_path):
    weights = _kmeans_weights(bins=(128,))
    with open(jcache.kmeans_clusters_path(str(tmp_path), "pku10"), "wb") as f:
        pickle.dump(weights, f)
    over = [f"cache_dir={tmp_path}"]  # no tokenizer.* override: it would edit JAX's preset
    jc = jconfig.build_config("layoutdm", over)
    tc = tconfig.build_config("layoutdm", over)
    jt, tt = jconfig.build_tokenizer(jc), tconfig.build_tokenizer(tc)
    assert tt.config.geo_quantization == "kmeans"
    for k in jcache.GEO_KEYS:
        np.testing.assert_array_equal(tt.bucketizers[k].centers, jt.bucketizers[k].centers)
    rng = np.random.default_rng(4)
    n = rng.integers(1, 11, size=8)
    mask = np.arange(10)[None] < n[:, None]
    arrays = {"label": np.where(mask, rng.integers(0, 3, (8, 10)), 0), "mask": mask,
              **{k: np.where(mask, rng.uniform(0, 1, (8, 10)), 0).astype(np.float32)
                 for k in jcache.GEO_KEYS}}
    jenc = jt.encode(JLayout.fromdict(arrays))
    tenc = tt.encode(TLayout.fromdict(arrays))
    np.testing.assert_array_equal(tenc["seq"].numpy(), np.asarray(jenc["seq"]))
    np.testing.assert_array_equal(tenc["mask"].numpy(), np.asarray(jenc["mask"]))
    jdec, tdec = jt.decode(jenc["seq"]), tt.decode(tenc["seq"])
    for k, a in tdec.numpy().items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jdec, k)), err_msg=k)
    # no centers: an error naming the file, or the linear vocabulary when allowed
    empty = tconfig.build_config("layoutdm", [f"cache_dir={tmp_path / 'none'}"])
    with pytest.raises(FileNotFoundError, match="kmeans"):
        tconfig.build_tokenizer(empty)
    empty.allow_linear_fallback = True
    assert tconfig.build_tokenizer(empty).config.geo_quantization == "linear"


# ---- the checkpoint file -------------------------------------------------------


def test_params_npz_round_trip_is_the_identity(tmp_path):
    """JAX variables -> port module -> export -> .npz -> a fresh port module:
    every tensor equal; the exported tree equals JAX's leaf for leaf."""
    jt = JTokenizer(JTokCfg(num_labels=3, max_seq_length=10, num_bin=16))
    tt = TTokenizer(TTokCfg(num_labels=3, max_seq_length=10, num_bin=16))
    jg = JRALF(jt, JGenCfg(**TINY), "uncond", image_hw=(64, 48), top_k=4)
    v = jax.tree.map(np.asarray, jg.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
                         v["batch_stats"])
    a = TRALF(tt, TGenCfg(**TINY), "uncond", image_hw=(64, 48), top_k=4, device="cpu", seed=1)
    load_jax_params(a.core, v["params"], stats)
    params, batch_stats = export_params(a.core)
    flat = lambda t: {jax.tree_util.keystr(p): x for p, x in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    jp, tp = flat(v["params"]), flat(params)
    assert tp.keys() == jp.keys()
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    assert flat(batch_stats).keys() == flat(stats).keys()
    path = str(tmp_path / "ckpt_final.npz")
    save_params_npz(path, params, batch_stats)
    p2, s2 = load_params_npz(path)
    b = TRALF(tt, TGenCfg(**TINY), "uncond", image_hw=(64, 48), top_k=4, device="cpu", seed=2)
    load_jax_params(b.core, p2, s2)
    sa, sb = a.core.state_dict(), b.core.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    np.savez(str(tmp_path / "bad.npz"), **{"opt_state/x": np.zeros(2)})
    with pytest.raises(KeyError, match="opt_state"):
        load_params_npz(str(tmp_path / "bad.npz"))
