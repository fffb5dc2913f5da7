"""Cache-file contract: path conventions and loaders for offline artifacts,
the counterpart of `ralf_tpu/cache.py`.

The paths and file formats are the JAX package's, so each package reads
what the other wrote:
  * `{ds}_{split}_{backbone}_wo_head_table_between_dataset_indexes_top_k{K}.npz`
    (key `table`): per-split retrieval top-k tables;
  * `{ds}_{backbone}_gallery_features.npz` (key `features`, float32): the
    gallery embedding matrix;
  * `{ds}_kmeans_train_clusters.pkl`: kmeans centers per `{geo_key}-{num_bin}`;
  * `{ds}_relationships_dic.pkl`: the precomputed relation clauses;
  * `eval_gt_features_{ds}_{split}_{tag}.npz` (key `features`): FIDNet
    features of a split's GT layouts, per feature extractor `tag`.

Cache keys are by dataset NAME: rebuilding a dataset under the same name
invalidates nothing, so delete the cache dir when the data changes.
"""

from __future__ import annotations

import glob
import logging
import os
import pickle
import re
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

GEO_KEYS = ("center_x", "center_y", "width", "height")


# -------------------------------------------------------------------------
# retrieval top-k tables
# -------------------------------------------------------------------------


def retrieval_table_path(
    cache_dir: str, dataset: str, split: str, backbone: str, top_k: int
) -> str:
    return os.path.join(
        cache_dir,
        f"{dataset}_{split}_{backbone}_wo_head_table_"
        f"between_dataset_indexes_top_k{top_k}.npz",
    )


def load_retrieval_table(
    cache_dir: str, dataset: str, split: str, backbone: str, top_k: int,
    expect_rows: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Load a precomputed [N, >=top_k] table, sliced to top_k columns.

    Any cached table with K' >= top_k qualifies (the cache-building default is
    K=32; models consume 16 — `generator/ralf.yaml` top_k).  Returns None
    when no qualifying file exists or the row count mismatches the split.
    """
    pattern = retrieval_table_path(cache_dir, dataset, split, backbone, 0)
    pattern = pattern.replace("top_k0.npz", "top_k*.npz")
    best: tuple[int, str] | None = None
    for path in glob.glob(pattern):
        m = re.search(r"top_k(\d+)\.npz$", path)
        if not m:
            continue
        k = int(m.group(1))
        if k >= top_k and (best is None or k < best[0]):
            best = (k, path)
    if best is None:
        return None
    table = np.load(best[1])["table"]
    if table.shape[1] < top_k:
        return None
    if expect_rows is not None and table.shape[0] != expect_rows:
        logger.warning(
            "retrieval table %s has %d rows, split has %d — ignoring",
            best[1], table.shape[0], expect_rows,
        )
        return None
    logger.info("retrieval table cache hit: %s (k=%d, using %d)",
                best[1], best[0], top_k)
    return np.asarray(table[:, :top_k])


def save_retrieval_table(
    cache_dir: str, dataset: str, split: str, backbone: str, table: np.ndarray
) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    path = retrieval_table_path(
        cache_dir, dataset, split, backbone, table.shape[1]
    )
    np.savez(path, table=table)
    return path


# -------------------------------------------------------------------------
# gallery features
# -------------------------------------------------------------------------


def gallery_features_path(cache_dir: str, dataset: str, backbone: str) -> str:
    return os.path.join(
        cache_dir, f"{dataset}_{backbone}_gallery_features.npz"
    )


def load_gallery_features(
    cache_dir: str, dataset: str, backbone: str, expect_rows: Optional[int] = None
) -> Optional[np.ndarray]:
    path = gallery_features_path(cache_dir, dataset, backbone)
    if not os.path.exists(path):
        return None
    feats = np.load(path)["features"]
    if expect_rows is not None and feats.shape[0] != expect_rows:
        logger.warning(
            "gallery feature cache %s has %d rows, dataset has %d — ignoring",
            path, feats.shape[0], expect_rows,
        )
        return None
    logger.info("gallery feature cache hit: %s %s", path, feats.shape)
    return feats


def save_gallery_features(
    cache_dir: str, dataset: str, backbone: str, features: np.ndarray
) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    path = gallery_features_path(cache_dir, dataset, backbone)
    np.savez(path, features=np.asarray(features, np.float32))
    return path


# -------------------------------------------------------------------------
# kmeans token vocabularies
# -------------------------------------------------------------------------


def kmeans_clusters_path(cache_dir: str, dataset: str) -> str:
    return os.path.join(cache_dir, f"{dataset}_kmeans_train_clusters.pkl")


def load_kmeans_centers(
    cache_dir: str, dataset: str, num_bin: int
) -> Optional[dict]:
    """-> {geo_key: [num_bin] sorted centers} for the tokenizer, or None.

    The cache-building CLI pickles every power-of-two bin count as `{key}-{n}`
    (`cli/build_caches.py --what clusters`, mirroring
    `save_clustering_coordinates.py:70-86`).
    """
    path = kmeans_clusters_path(cache_dir, dataset)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        raw = pickle.load(f)
    out = {}
    for key in GEO_KEYS:
        name = f"{key}-{num_bin}"
        if name not in raw:
            logger.warning("kmeans cache %s lacks %s — ignoring", path, name)
            return None
        out[key] = np.asarray(raw[name], np.float32)
    logger.info("kmeans cluster cache hit: %s (num_bin=%d)", path, num_bin)
    return out


# -------------------------------------------------------------------------
# relationship tables
# -------------------------------------------------------------------------


def relationships_path(cache_dir: str, dataset: str) -> str:
    return os.path.join(cache_dir, f"{dataset}_relationships_dic.pkl")


def load_relationships(cache_dir: str, dataset: str) -> Optional[dict]:
    path = relationships_path(cache_dir, dataset)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


# -------------------------------------------------------------------------
# eval GT features (`eval.py:335-350` caches FIDNet features per split)
# -------------------------------------------------------------------------


def gt_features_path(cache_dir: str, dataset: str, split: str, tag: str) -> str:
    """`tag` distinguishes the feature extractor (e.g. 'trained'/'untrained'
    FIDNet) so a later trained run never reads stale untrained features."""
    return os.path.join(
        cache_dir, f"eval_gt_features_{dataset}_{split}_{tag}.npz"
    )


def load_gt_features(
    cache_dir: str, dataset: str, split: str, tag: str,
    expect_rows: Optional[int] = None,
) -> Optional[np.ndarray]:
    path = gt_features_path(cache_dir, dataset, split, tag)
    if not os.path.exists(path):
        return None
    feats = np.load(path)["features"]
    if expect_rows is not None and feats.shape[0] != expect_rows:
        logger.warning("GT feature cache %s has %d rows, split has %d — "
                       "ignoring", path, feats.shape[0], expect_rows)
        return None
    logger.info("GT feature cache hit: %s %s", path, feats.shape)
    return feats


def save_gt_features(
    cache_dir: str, dataset: str, split: str, tag: str, features: np.ndarray
) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    path = gt_features_path(cache_dir, dataset, split, tag)
    np.savez(path, features=np.asarray(features, np.float32))
    return path
