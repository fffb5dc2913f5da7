"""The port's offline dataset build against the JAX package, on the CPU.

`read_pku`, `read_cgl` and `load_split_mapping` against JAX's on the
fabricated raw trees of tests/test_build_dataset.py (every drop rule of the
reference: the NG list, too many or no elements, unknown labels, CGL's
unannotated split and its .jpg identifiers), then both packages'
`cli.build_dataset` `main`s in process on those trees: the same
vocabulary.json, the same shard files, and every split's rows equal (ids,
sizes, labels, boxes, the decoded image and saliency pixels); the port's
`HFParquetDataset` reads the port's dump.
"""

import io
import json
import os
import sys

import numpy as np
import pyarrow.parquet as pq
import pytest
from PIL import Image

from ralf_tpu.cli import build_dataset as jbuild
from ralf_tpu.preprocess import readers as jread
from ralf_tpu_torch.cli import build_dataset as tbuild
from ralf_tpu_torch.data.dataset import IMAGE_H, IMAGE_W, DatasetConfig, HFParquetDataset
from ralf_tpu_torch.preprocess import readers as tread
from test_build_dataset import _fabricate_cgl, _fabricate_pku

FABRICATE = {"pku": _fabricate_pku, "cgl": _fabricate_cgl}
READERS = {"pku": (jread.read_pku, tread.read_pku), "cgl": (jread.read_cgl, tread.read_cgl)}


@pytest.fixture(scope="module", params=["pku", "cgl"])
def raw(request, tmp_path_factory):
    """(the dataset type, its fabricated raw tree)."""
    root = str(tmp_path_factory.mktemp(request.param) / "raw")
    return request.param, FABRICATE[request.param](root)


@pytest.mark.parametrize("max_seq_length", [10, 2])
def test_readers_match_jax(raw, max_seq_length):
    kind, root = raw
    jax_read, port_read = READERS[kind]
    want = jax_read(root, max_seq_length)
    assert port_read(root, max_seq_length) == want
    assert want  # the trees hold samples that survive
    splits = os.path.join(root, "splits")
    assert tread.load_split_mapping(splits) == jread.load_split_mapping(splits)


def test_reader_constants_match_jax():
    for name in ("PKU_CANVAS_W", "PKU_CANVAS_H", "PKU_LABELS", "PKU_CSV_FILES", "PKU_NG_KEYS",
                 "CGL_LABELS", "CGL_JSON_FILES"):
        assert getattr(tread, name) == getattr(jread, name), name
    assert tread._valid_area(0.5, 0.5, 0.0, 0.1) is jread._valid_area(0.5, 0.5, 0.0, 0.1) is False


def _rows(path: str) -> list[dict]:
    return pq.read_table(path).to_pylist()


def _pixels(cell) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(cell["bytes"])))


@pytest.fixture(scope="module")
def dumps(raw, tmp_path_factory):
    """(the dataset type, {package: its dump dir}) of both CLIs on one tree."""
    kind, root = raw
    out = tmp_path_factory.mktemp(f"{kind}_dumps")
    common = ["--dataset-type", kind, "--dataset-root", root,
              "--splits-dir", os.path.join(root, "splits"), "--num-shards", "2"]
    dirs = {p: str(out / p) for p in ("jax", "port")}
    argv = sys.argv
    try:
        sys.argv = ["build_dataset", *common, "--output-dir", dirs["jax"]]
        jbuild.main()
    finally:
        sys.argv = argv
    tbuild.main([*common, "--output-dir", dirs["port"]])
    return kind, dirs


def test_build_dataset_matches_jax(dumps):
    kind, dirs = dumps
    vocab = {p: json.load(open(os.path.join(d, "vocabulary.json"))) for p, d in dirs.items()}
    assert vocab["port"] == vocab["jax"]
    files = {p: sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d)
                       for f in fs if f.endswith(".parquet")) for p, d in dirs.items()}
    assert files["port"] == files["jax"]
    assert {f.split("/")[0] for f in files["port"]} == {"train", "val", "test",
                                                        "with_no_annotation"}
    for f in files["port"]:
        got, want = (_rows(os.path.join(dirs[p], f)) for p in ("port", "jax"))
        assert len(got) == len(want), f
        for a, b in zip(got, want):
            assert list(a) == list(b)  # the columns, in JAX's order
            for k in a:
                if k in ("image", "saliency"):
                    pa, pb = _pixels(a[k]), _pixels(b[k])
                    assert pa.shape[:2] == (IMAGE_H, IMAGE_W)
                    np.testing.assert_array_equal(pa, pb, err_msg=f"{f} {a['id']} {k}")
                else:
                    assert a[k] == b[k], (f, a["id"], k)


def test_port_reader_reads_the_port_dump(dumps):
    kind, dirs = dumps
    cfg = DatasetConfig(name="pku10" if kind == "pku" else "cgl", data_dir=dirs["port"])
    vocab = json.load(open(os.path.join(dirs["port"], "vocabulary.json")))["label"]
    assert list(cfg.label_names) == sorted(vocab)
    train = HFParquetDataset(cfg, "train")
    want = {"pku": 8, "cgl": 2}[kind]
    assert len(train) == want
    lay = train.get_layouts(np.arange(want))
    assert lay["mask"].sum() == sum(len(r["label"]) for r in _train_rows(dirs["port"]))
    img = train.get_images(np.arange(want))
    assert img.shape == (want, IMAGE_H, IMAGE_W, 4)
    # the saliency channel is the pixel max of saliency/ and saliency_sub/
    np.testing.assert_allclose(img[..., 3], {"pku": 200, "cgl": 99}[kind] / 255.0, atol=1e-3)


def _train_rows(d: str) -> list[dict]:
    return [r for f in sorted(os.listdir(os.path.join(d, "train")))
            for r in _rows(os.path.join(d, "train", f))]
