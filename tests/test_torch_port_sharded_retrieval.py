"""The port's gallery-sharded top-k (`retrieval.retriever.sharded_topk`,
`Retriever.shard_gallery`) over gloo on the CPU, against JAX's
`exact_topk` and `sharded_topk` on its 8 CPU devices and against the port's
own unsharded scan; the twin of tests/test_sharded_retrieval.py.

The gallery's rows lie on a `gallery` axis of 2 ranks (and of 3, whose
shards of a 37-row gallery need padding too), spawned by
`tests/torch_port_ranks.py`.  Results are compared exactly: N=37 with
padding and self-exclusion, a gallery of repeated rows whose scores tie
(the candidates' order is JAX's `lax.top_k` over its gathered array, the
lower row first), the padded rows and the query's own row never come back,
one all-gather a scan; then a Retriever's top-k table and the
retrieval-augmented loader's batches with the sharded gallery.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from ralf_tpu.data.dataset import DatasetConfig as JDatasetConfig
from ralf_tpu.data.dataset import SyntheticPosterDataset as JSynthetic
from ralf_tpu.parallel.mesh import GALLERY_AXIS, make_mesh
from ralf_tpu.retrieval.retriever import Retriever as JRetriever
from ralf_tpu.retrieval.retriever import exact_topk, sharded_topk
from ralf_tpu_torch.data.dataset import BatchLoader, DatasetConfig, SyntheticPosterDataset
from ralf_tpu_torch.retrieval.retriever import Retriever
from ralf_tpu_torch.retrieval.wrapper import RetrievalAugmentedLoader

torch.set_num_threads(2)


def _cases():
    """name: (queries [B, D], gallery [N, D], k, query ids or None)."""
    rng = np.random.default_rng(0)
    N, D, B, K = 37, 16, 5, 4  # 37 rows: padding on 2, 3 and 8 shards
    g = rng.normal(size=(N, D)).astype(np.float32)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    q = g[:B] + 0.01 * rng.normal(size=(B, D)).astype(np.float32)
    tied = np.repeat(g[:6], 3, axis=0)[:17]  # each row three times: every score ties
    return {"exclude_self": (q, g, K, np.arange(B, dtype=np.int32)),
            "keep_self": (q, g, K, None),
            "ties": (tied[[0, 4, 9]] * 1.0, tied, 5, None),
            "k_past_a_shard": (q, g, 20, np.arange(B, dtype=np.int32))}


def _jax_topk(q, g, k, qid):
    mesh = make_mesh((1, 8))
    pad = (-g.shape[0]) % 8
    gp = jnp.pad(jnp.asarray(g), ((0, pad), (0, 0)))
    j_qid = jnp.asarray(qid if qid is not None else np.zeros(len(q), np.int32))
    exact = np.asarray(exact_topk(jnp.asarray(q), jnp.asarray(g), k, qid is not None, j_qid))
    sharded = np.asarray(sharded_topk(mesh, GALLERY_AXIS, jnp.asarray(q), gp, k,
                                      exclude_self=qid is not None, query_ids=j_qid,
                                      n_valid=g.shape[0]))
    return exact, sharded


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: the ranks' results} for gallery axes of 2 and 3 ranks."""
    root = tmp_path_factory.mktemp("sharded_retrieval")
    procs = {}
    for world in (2, 3):
        d = root / f"world{world}"
        d.mkdir()
        with open(d / "inputs.pkl", "wb") as f:
            pickle.dump({"cases": _cases()}, f)
        procs[world] = (ranks.start(ranks.sharded_retrieval, world, str(d)), str(d))
    return {w: ranks.finish(ctx, d) for w, (ctx, d) in procs.items()}


@pytest.mark.parametrize("name", list(_cases()))
def test_sharded_topk_equals_jax_exactly(runs, name):
    q, g, k, qid = _cases()[name]
    exact, sharded = _jax_topk(q, g, k, qid)
    if name != "ties":  # lax.top_k and the sharded reduce order ties alike
        np.testing.assert_array_equal(sharded, exact)
    for world, out in runs.items():
        for r, rank in enumerate(out):
            got = rank["topk"][name]
            np.testing.assert_array_equal(got, sharded, err_msg=f"world {world} rank {r}")
            assert (got < g.shape[0]).all()  # padded rows never retrieved
            if qid is not None:
                assert (got != qid[:, None]).all()  # self excluded
            assert rank["counts"][name] == {"all_gather": 1}


def test_tied_scores_come_back_lower_row_first(runs):
    got = runs[2][0]["topk"]["ties"]
    # query 0 equals rows 0-2 and 3-5 of the tied gallery's first two distinct rows
    assert list(got[0][:3]) == [0, 1, 2]
    assert (np.diff(got[:, :3], axis=1) > 0).all()


def test_shard_gallery_table_equals_the_plain_scan_and_jax(runs):
    ds = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=21, seed=3,
                                image_hw=(64, 48))
    plain = Retriever.build(ds, device="cpu").precompute_table(ds, k=4, is_train_split=True)
    jds = JSynthetic(JDatasetConfig(name="synthetic"), size=21, seed=3, image_hw=(64, 48))
    want = JRetriever.build(jds).shard_gallery(make_mesh((1, 8))).precompute_table(
        jds, k=4, is_train_split=True)
    np.testing.assert_array_equal(plain, want)
    for world, out in runs.items():
        for rank in out:
            np.testing.assert_array_equal(rank["table"], want, err_msg=f"world {world}")
            assert (rank["table"] != np.arange(21)[:, None]).all()


def test_loader_with_a_sharded_retriever_gives_the_plain_batches(runs):
    ds = SyntheticPosterDataset(DatasetConfig(name="synthetic"), size=12, seed=1,
                                image_hw=(64, 48))
    want = list(RetrievalAugmentedLoader(
        BatchLoader(ds, 4, shuffle=False, seed=0, use_native=False),
        Retriever.build(ds, device="cpu"), top_k=3, is_train_split=True))
    for out in runs.values():
        got = out[1]["batches"]
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["retrieved_indices"], b["retrieved_indices"])
            for key in b["retrieved"]:
                np.testing.assert_array_equal(a["retrieved"][key], b["retrieved"][key])
            assert (a["retrieved_indices"] != a["indices"][:, None]).all()
