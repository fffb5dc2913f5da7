"""The port's data pipeline and retrieval variants against the JAX package:
the native collator bit for bit, the batch loader's partial batch, rng
stream and prefetch thread, the parquet reader on a dump this test writes,
and the retriever's cache, top-1 copy, MMR rerank and random retrieval.
Everything here is exact: integer and float arrays compared for equality.
"""

import numpy as np
import pytest
import torch

from ralf_tpu.data import dataset as jdata
from ralf_tpu.data import native as jnative
from ralf_tpu.retrieval import retriever as jret
from ralf_tpu.retrieval import wrapper as jwrap
from ralf_tpu_torch import cache as tcache
from ralf_tpu_torch.data import dataset as tdata
from ralf_tpu_torch.data import native as tnative
from ralf_tpu_torch.retrieval import retriever as tret
from ralf_tpu_torch.retrieval import wrapper as twrap

torch.set_num_threads(2)
HW = (40, 32)


def _datasets(size=21, seed=3, hw=HW, name="synthetic"):
    return (jdata.SyntheticPosterDataset(jdata.DatasetConfig(name=name), size, seed, hw),
            tdata.SyntheticPosterDataset(tdata.DatasetConfig(name=name), size, seed, hw))


def _assert_batches_equal(jb, tb):
    np.testing.assert_array_equal(tb["indices"], jb["indices"])
    np.testing.assert_array_equal(tb["id"], jb["id"])
    for k, a in tb["layout"].numpy().items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jb["layout"], k)), err_msg=k)
    if "image" in jb:
        np.testing.assert_array_equal(tb["image"], jb["image"])
    else:
        assert "image" not in tb


# ---- the native collator ---------------------------------------------------


@pytest.mark.parametrize("transforms", [["sort_label"], ["sort_lexicographic"],
                                        ["sort_label", "sort_lexicographic"], ["shuffle"],
                                        ["shuffle", "sort_label", "sort_lexicographic"]])
def test_native_collate_is_bit_for_bit_jax(transforms):
    """The port's copy of collate.cpp gives JAX's library's output for the
    same seed and transforms (shuffle draws from the same mt19937_64)."""
    assert jnative.native_available()
    jd, _ = _datasets(size=16)
    lay = jd.get_layouts(np.arange(16))
    for seed in (0, 12345678901234):
        want = jnative.collate_batch({k: v.copy() for k, v in lay.items()}, transforms, seed)
        got = tnative.collate_batch(lay, transforms, seed)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype
    idx = np.random.default_rng(0).integers(0, 16, size=(5, 4))
    want = jnative.gather_neighbors(lay, idx)
    got = tnative.gather_neighbors(lay, idx)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], lay[k][idx], err_msg=k)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No quiet numpy fallback: without a compiler the native path raises."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    _, td = _datasets(size=8)
    loader = tdata.BatchLoader(td, 4, prefetch=0)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        next(iter(loader))
    plain = tdata.BatchLoader(td, 4, prefetch=0, use_native=False)
    assert len(list(plain)) == 2  # the numpy path only when asked for
    # retrieval on that loader gathers its neighbours by numpy too
    retriever = tret.Retriever.build(td, device="cpu")
    wrapped = twrap.RetrievalAugmentedLoader(plain, retriever, top_k=2)
    for batch in wrapped:
        for k, a in batch["retrieved"].items():
            np.testing.assert_array_equal(a, retriever.layouts[k][batch["retrieved_indices"]])
    no_collate = tdata.BatchLoader(td, 4, prefetch=0, transforms=())  # native gather only
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        next(iter(twrap.RetrievalAugmentedLoader(no_collate, retriever, top_k=2)))


# ---- the batch loader --------------------------------------------------------


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_keeps_or_drops_the_partial_batch_as_jax(drop_last):
    """21 canvases in batches of 8: the inference loader (drop_last=False)
    yields the last 5 too."""
    jd, td = _datasets()
    kw = dict(shuffle=False, drop_last=drop_last, prefetch=0)
    jl, tl = jdata.BatchLoader(jd, 8, **kw), tdata.BatchLoader(td, 8, **kw)
    assert len(tl) == len(jl) == (2 if drop_last else 3)
    batches = list(tl)
    for jb, tb in zip(jl, batches, strict=True):
        _assert_batches_equal(jb, tb)
    assert sum(len(b["indices"]) for b in batches) == (16 if drop_last else 21)


@pytest.mark.parametrize("use_native", [True, False])
def test_loader_rng_stream_matches_jax_over_epochs(use_native):
    """Shuffled epochs: the native path draws its collate seed where JAX
    draws it, so the second epoch's permutation is JAX's too."""
    jd, td = _datasets()
    kw = dict(seed=4, use_native=use_native, with_images=False, image_dtype=np.uint8)
    jl = jdata.BatchLoader(jd, 8, prefetch=0, **kw)
    tl = tdata.BatchLoader(td, 8, prefetch=2, **kw)
    for _ in range(3):
        for jb, tb in zip(jl, tl, strict=True):
            _assert_batches_equal(jb, tb)


def test_loader_with_images_and_prefetch_matches_jax():
    jd, td = _datasets()
    jl = jdata.BatchLoader(jd, 8, drop_last=False, image_dtype=np.uint8)
    tl = tdata.BatchLoader(td, 8, drop_last=False, image_dtype=np.uint8)
    for jb, tb in zip(jl, tl, strict=True):
        _assert_batches_equal(jb, tb)


def test_prefetch_passes_producer_errors_on():
    class Broken(tdata.SyntheticPosterDataset):
        def get_images(self, indices, dtype=np.float32):
            if int(indices[0]) >= 8:
                raise ValueError("canvas 8 is unreadable")
            return super().get_images(indices, dtype)

    ds = Broken(tdata.DatasetConfig(name="synthetic"), 20, 0, HW)
    it = iter(tdata.BatchLoader(ds, 8, shuffle=False, prefetch=2))
    assert len(next(it)["indices"]) == 8
    with pytest.raises(ValueError, match="unreadable"):
        next(it)


def test_loader_rejects_a_transform_it_cannot_apply():
    _, td = _datasets(size=8)
    with pytest.raises(KeyError, match="flip_horizontal"):
        tdata.BatchLoader(td, 4, transforms=("shuffle", "flip_horizontal"))


# ---- the parquet reader --------------------------------------------------------


@pytest.fixture(scope="module")
def parquet_root(tmp_path_factory):
    hfds = pytest.importorskip("datasets")
    from PIL import Image

    root = tmp_path_factory.mktemp("pq")
    rng = np.random.default_rng(0)
    H, W = 40, 32
    for split, n in (("train", 13), ("with_no_annotation", 3)):
        records = []
        for i in range(n):
            k = int(rng.integers(1, 13))  # some past max_seq_length: truncated
            size = (W + 8, H - 4) if i % 4 == 0 else (W, H)  # some resized on decode
            records.append({
                "id": f"{split}{i}",
                "image": Image.fromarray((rng.random((size[1], size[0], 3)) * 255).astype("uint8")),
                "saliency": Image.fromarray((rng.random((size[1], size[0])) * 255).astype("uint8")),
                "label": rng.integers(0, 3, k).tolist(),
                "center_x": rng.random(k).tolist(), "center_y": rng.random(k).tolist(),
                "width": rng.random(k).tolist(), "height": rng.random(k).tolist(),
            })
        (root / split).mkdir()
        hfds.Dataset.from_list(records).to_parquet(str(root / split / "part-0.parquet"))
    return str(root), H, W


def test_parquet_dataset_matches_jax(parquet_root):
    root, H, W = parquet_root
    for split in ("train", "with_no_annotation"):
        jd = jdata.HFParquetDataset(jdata.DatasetConfig(name="pku10", data_dir=root, image_h=H,
                                                        image_w=W), split)
        td = tdata.HFParquetDataset(tdata.DatasetConfig(name="pku10", data_dir=root, image_h=H,
                                                        image_w=W), split)
        assert len(td) == len(jd)
        idx = np.asarray([len(jd) - 1, 0] + list(range(1, len(jd) - 1)))
        for k, a in td.get_layouts(idx).items():
            np.testing.assert_array_equal(a, jd.get_layouts(idx)[k], err_msg=k)
        np.testing.assert_array_equal(td.get_ids(idx), jd.get_ids(idx))
        for dt in (np.float32, np.uint8):
            got, want = td.get_images(idx, dt), jd.get_images(idx, dt)
            assert got.dtype == want.dtype and got.shape == (len(idx), H, W, 4)
            np.testing.assert_array_equal(got, want)
    kw = dict(shuffle=False, drop_last=False, prefetch=0)
    for jb, tb in zip(jdata.BatchLoader(jd, 2, **kw), tdata.BatchLoader(td, 2, **kw), strict=True):
        _assert_batches_equal(jb, tb)


def test_parquet_dataset_says_what_is_missing(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="data_dir"):
        tdata.HFParquetDataset(tdata.DatasetConfig(), "test")
    with pytest.raises(FileNotFoundError, match="test"):
        tdata.HFParquetDataset(tdata.DatasetConfig(data_dir=str(tmp_path)), "test")
    (tmp_path / "test").mkdir()
    import builtins

    real_import = builtins.__import__

    def no_datasets(name, *a, **k):
        if name == "datasets":
            raise ImportError("No module named 'datasets'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_datasets)
    with pytest.raises(ImportError, match="HFParquetDataset reads parquet dumps"):
        tdata.HFParquetDataset(tdata.DatasetConfig(data_dir=str(tmp_path)), "test")


# ---- retrieval ---------------------------------------------------------------


@pytest.fixture(scope="module")
def retrievers(tmp_path_factory):
    """Galleries of 40 canvases: JAX's builds and saves its features, the
    port's reads that cache; a second port build embeds them itself."""
    cache = str(tmp_path_factory.mktemp("cache"))
    jg, tg = _datasets(size=40, seed=5, hw=(48, 32))
    jr = jret.Retriever.build(jg, cache_dir=cache, dataset_name="synthetic")
    tr = tret.Retriever.build(tg, cache_dir=cache, dataset_name="synthetic", device="cpu")
    fresh = tret.Retriever.build(tg, device="cpu")
    return jr, tr, fresh, cache


def test_retriever_gallery_cache_crosses_and_matches(retrievers, tmp_path):
    jr, tr, fresh, cache = retrievers
    np.testing.assert_array_equal(tr.features.numpy(), np.asarray(jr.features))
    np.testing.assert_allclose(fresh.features.numpy(), np.asarray(jr.features), atol=1e-6)
    for k, a in tr.layouts.items():
        np.testing.assert_array_equal(a, jr.layouts[k], err_msg=k)
    # the port saves what JAX then reads
    _, tg = _datasets(size=40, seed=5, hw=(48, 32))
    tret.Retriever.build(tg, cache_dir=str(tmp_path), dataset_name="g", device="cpu")
    saved = tcache.load_gallery_features(str(tmp_path), "g", "saliency", 40)
    jr2 = jret.Retriever.build(tg, cache_dir=str(tmp_path), dataset_name="g")
    np.testing.assert_array_equal(np.asarray(jr2.features),
                                  saved / np.linalg.norm(saved, axis=-1, keepdims=True))


@pytest.mark.parametrize("backbone,error", [("dreamsim", NotImplementedError),
                                            ("vgg", NotImplementedError), ("nope", ValueError)])
def test_retriever_backbones_other_than_saliency_raise(backbone, error):
    _, tg = _datasets(size=4)
    with pytest.raises(error, match="Queue A item 9" if error is NotImplementedError else "nope"):
        tret.Retriever.build(tg, backbone=backbone, device="cpu")


def test_predict_top1_and_mmr_rerank_match_jax(retrievers):
    jr, tr, _, _ = retrievers
    jq, tq = _datasets(size=12, seed=6, hw=(48, 32))
    imgs = tq.get_images(np.arange(12))
    want, got = jr.predict_top1(imgs), tr.predict_top1(imgs)
    for k, a in got.numpy().items():
        np.testing.assert_array_equal(a, np.asarray(getattr(want, k)), err_msg=k)
    q = np.asarray(jr.embed(imgs))
    feats = np.asarray(jr.features)
    cand = jr.topk(jr.embed(imgs), 10)
    np.testing.assert_array_equal(tr.topk(tr.embed(imgs), 10), cand)
    for lam in (0.0, 0.5, 0.9):
        np.testing.assert_array_equal(tret.mmr_rerank(feats, cand, q, 4, lam),
                                      jret.mmr_rerank(feats, cand, q, 4, lam))


@pytest.mark.parametrize("mode", ["random", "table", "train_split"])
def test_retrieval_loader_variants_match_jax(retrievers, mode):
    """random_retrieval (the same numpy draws), a precomputed table, and
    the train split's self-excluding table, with the feature table."""
    jr, tr, _, _ = retrievers
    if mode == "train_split":
        jq, tq = _datasets(size=40, seed=5, hw=(48, 32))
    else:
        jq, tq = _datasets(size=12, seed=6, hw=(48, 32))
    kw = dict(top_k=4, seed=9, feats_table=np.random.default_rng(7).normal(size=(40, 8)))
    if mode == "random":
        kw["random_retrieval"] = True
    elif mode == "table":
        kw["table"] = np.random.default_rng(8).integers(0, 40, size=(12, 6))
    else:
        kw["is_train_split"] = True
    lkw = dict(shuffle=True, seed=2, drop_last=False, with_images=False)
    jl = jwrap.RetrievalAugmentedLoader(jdata.BatchLoader(jq, 5, prefetch=0, **lkw), jr, **kw)
    tl = twrap.RetrievalAugmentedLoader(tdata.BatchLoader(tq, 5, **lkw), tr, **kw)
    assert len(tl) == len(jl)
    for _ in range(2):
        for jb, tb in zip(jl, tl, strict=True):
            _assert_batches_equal(jb, tb)
            np.testing.assert_array_equal(tb["retrieved_indices"], jb["retrieved_indices"])
            if mode == "train_split":
                assert not (tb["retrieved_indices"] == tb["indices"][:, None]).any()
            for k, a in tb["retrieved"].items():
                np.testing.assert_array_equal(a, np.asarray(jb["retrieved"][k]), err_msg=k)
