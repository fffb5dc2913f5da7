"""Brute-force top-k retrieval over the gallery, the counterpart of
`ralf_tpu/retrieval/retriever.py`.

Query and gallery features come from a backbone (`get_backbone`) and are
L2-normalized; neighbours are the inner-product top-k, one matrix product
on the device.  The backbones:

  * `saliency`: 16x16 saliency thumbnails, a bilinear downsample WITH
    antialiasing, as `jax.image.resize(method="linear")` does when it
    shrinks (without it the thumbnails differ by up to 0.48);
  * `dreamsim` (the paper's default), `clip` and `vgg`: the feature towers
    of `models/towers.py` (`build_feature_fn`), their checkpoints read from
    the cache dir, else random with a warning.

`Retriever.build` loads the gallery features from, and saves them to, the
cache of `ralf_tpu_torch/cache.py` (`{name}_{backbone}_gallery_features.npz`,
the JAX package's file), so repeated runs embed nothing.  `predict_top1` is
the non-learnable top-1 copy baseline; `mmr_rerank` the maximal-marginal-
relevance diversity rerank.  `Retriever.shard_gallery` splits the gallery's
rows over a mesh axis; its `topk` then runs `sharded_topk`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ralf_tpu_torch.core.layout import Layout
from ralf_tpu_torch.utils.device import resolve_device

BACKBONE_NAMES = ("saliency", "dreamsim", "clip", "vgg")


def coarse_saliency_features(images: torch.Tensor, grid: int = 16) -> torch.Tensor:
    """[B, H, W, 4] -> L2-normalized [B, grid*grid] saliency thumbnails."""
    sal = images[..., 3].float()
    if not images.is_floating_point():
        sal = sal * (1.0 / 255.0)
    feat = F.interpolate(sal[:, None], size=(grid, grid), mode="bilinear",
                         align_corners=False, antialias=True)
    feat = feat.reshape(sal.shape[0], grid * grid)
    return feat / feat.norm(dim=-1, keepdim=True).clamp_min(1e-8)


def _check_backbone(backbone: str) -> None:
    if backbone not in BACKBONE_NAMES:
        raise ValueError(f"unknown retrieval backbone {backbone!r}; choose from {BACKBONE_NAMES}")


def get_backbone(kind: str, cache_dir: str = "cache", device="cuda"):
    """`fn(images [B, H, W, 4]) -> [B, D]` features on `device`: the gallery's
    and the queries' embedder (a tower is built, or loaded, at each call)."""
    _check_backbone(kind)
    dev = resolve_device(device)
    if kind == "saliency":
        return lambda images: coarse_saliency_features(torch.as_tensor(np.asarray(images),
                                                                       device=dev))
    from ralf_tpu_torch.models.towers import build_feature_fn

    return build_feature_fn(kind, cache_dir, dev)


def exact_topk(query: torch.Tensor, gallery: torch.Tensor, k: int,
               exclude_self: bool = False,
               query_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inner-product top-k gallery rows [B, k]; optionally never the query's own row."""
    scores = query.float() @ gallery.float().t()
    if exclude_self:
        rows = torch.arange(gallery.shape[0], device=scores.device)
        scores = scores.masked_fill(rows[None, :] == query_ids[:, None], float("-inf"))
    return torch.topk(scores, k, dim=-1).indices


def _top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, equal values in
    ascending index order, as `lax.top_k` returns them."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sharded_topk(mesh, axis: str, query: torch.Tensor, gallery: torch.Tensor, k: int, *,
                 exclude_self: bool = False, query_ids: Optional[torch.Tensor] = None,
                 n_valid: Optional[int] = None) -> torch.Tensor:
    """Top-k gallery rows [B, k] of a gallery whose rows are split over the
    mesh axis `axis`: `gallery` is this rank's shard [N / shards, D] of the
    zero-padded gallery (`Retriever.shard_gallery`), `query` [B, D] the same
    on every rank.  Each rank takes the top-k of its shard, one all-gather
    over the axis brings every shard's (score, global row), and the global
    top-k of those candidates, in shard order, is the result: equal values
    in ascending candidate order, as JAX's `lax.top_k` over its gathered
    array.  Rows >= `n_valid` (the padding) and, with exclude_self, each
    query's own row (`query_ids`) never come back."""
    from ralf_tpu_torch.parallel.mesh import all_gather

    n_shards, shard = mesh.shape[axis], mesh.coords[axis]
    shard_n = gallery.shape[0]
    k_local = min(k, shard_n)  # a tiny shard still yields the exact top-k overall
    if k > n_shards * k_local:
        raise ValueError(f"k={k} exceeds the gallery's {n_shards * shard_n} rows")
    n_real = n_shards * shard_n if n_valid is None else n_valid
    rows = shard * shard_n + torch.arange(shard_n, device=gallery.device)
    s = query.float() @ gallery.float().t()
    dead = (rows >= n_real)[None, :]
    if exclude_self:
        dead = dead | (rows[None, :] == query_ids.to(rows.device)[:, None])
    s = s.masked_fill(dead, float("-inf"))
    val, idx = _top_k_stable(s, k_local)
    # one gather of both: fp64 holds every fp32 score and every row index exactly
    cand = all_gather(torch.stack([val.double(), (idx + shard * shard_n).double()])
                      .permute(1, 2, 0)[None], mesh.group(axis))  # [shards, B, k_local, 2]
    cand = cand.permute(1, 0, 2, 3).reshape(query.shape[0], n_shards * k_local, 2)
    _, pick = _top_k_stable(cand[..., 0], k)
    return cand[..., 1].gather(1, pick).long()


class Retriever:
    """Gallery of (features on the device, layouts on the host); `embed` runs
    the backbone, built at its first use (or given by `build`, which embedded
    the gallery with it)."""

    def __init__(self, features, layouts: dict, device="cuda", backbone: str = "saliency",
                 cache_dir: str = "cache", backbone_fn=None) -> None:
        _check_backbone(backbone)
        self.device = resolve_device(device)
        self.backbone_name = backbone
        self.cache_dir = cache_dir
        self._backbone_fn = backbone_fn
        f = np.asarray(features, np.float32)  # normalized in numpy, as JAX does
        f = f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-8)
        self.features = torch.as_tensor(f, device=self.device)
        self.layouts = {k: np.asarray(v) for k, v in layouts.items()}
        self.mesh = self.mesh_axis = self._sharded_features = None  # shard_gallery

    def shard_gallery(self, mesh, axis: str = "gallery") -> "Retriever":
        """Split the gallery's rows over the mesh axis `axis`, zero-padded to a
        multiple of its size: this rank keeps its shard, and `topk` (hence
        `precompute_table` and `retrieval.wrapper.RetrievalAugmentedLoader`)
        runs `sharded_topk`, where padding never comes back."""
        n_shards = mesh.shape[axis]
        f = torch.nn.functional.pad(self.features, (0, 0, 0, (-self.features.shape[0]) % n_shards))
        per = f.shape[0] // n_shards
        self._sharded_features = f[mesh.coords[axis] * per:(mesh.coords[axis] + 1) * per].clone()
        self.mesh, self.mesh_axis = mesh, axis
        return self

    @classmethod
    def build(cls, dataset, backbone: str = "saliency", batch_size: int = 256,
              cache_dir: Optional[str] = None, dataset_name: Optional[str] = None,
              device="cuda") -> "Retriever":
        """The features of every gallery canvas of `dataset`; with `cache_dir`
        they load from, or are saved to, `{name}_{backbone}_gallery_features.npz`."""
        _check_backbone(backbone)
        dev = resolve_device(device)
        n = len(dataset)
        layouts = dataset.get_layouts(np.arange(n))
        name = dataset_name or getattr(getattr(dataset, "cfg", None), "name", None)
        if cache_dir and name:
            from ralf_tpu_torch import cache as cache_mod

            cached = cache_mod.load_gallery_features(cache_dir, name, backbone, expect_rows=n)
            if cached is not None:
                return cls(cached, layouts, dev, backbone, cache_dir)
        fn = get_backbone(backbone, cache_dir or "cache", dev)
        feats = [fn(dataset.get_images(np.arange(s, min(s + batch_size, n)))).float().cpu().numpy()
                 for s in range(0, n, batch_size)]
        features = np.concatenate(feats, 0)
        if cache_dir and name:
            from ralf_tpu_torch import cache as cache_mod

            cache_mod.save_gallery_features(cache_dir, name, backbone, features)
        return cls(features, layouts, dev, backbone, cache_dir or "cache", fn)

    def embed(self, images) -> torch.Tensor:
        if self._backbone_fn is None:
            self._backbone_fn = get_backbone(self.backbone_name, self.cache_dir, self.device)
        return self._backbone_fn(images)

    def topk(self, query_feats: torch.Tensor, k: int, exclude_self: bool = False,
             query_ids: Optional[np.ndarray] = None) -> np.ndarray:
        qid = None
        if exclude_self:
            qid = torch.as_tensor(np.asarray(query_ids), device=self.device)
        if self.mesh is not None:
            return sharded_topk(self.mesh, self.mesh_axis, query_feats, self._sharded_features,
                                k, exclude_self=exclude_self, query_ids=qid,
                                n_valid=self.features.shape[0]).cpu().numpy()
        return exact_topk(query_feats, self.features, k, exclude_self, qid).cpu().numpy()

    def gather_neighbors(self, idx: np.ndarray, use_native: bool = True) -> dict:
        """[B, K] gallery indices -> {'label': [B, K, S], ..., 'mask': [B, K, S]},
        one call into the native collator (`data/native.py`), or numpy
        indexing, its plain version, with use_native=False."""
        if not use_native:
            return {k: a[idx] for k, a in self.layouts.items()}
        from ralf_tpu_torch.data import native

        return native.gather_neighbors(self.layouts, np.asarray(idx))

    def predict_top1(self, images) -> Layout:
        """Top-1 copy baseline: the nearest gallery layout of each query canvas."""
        idx = self.topk(self.embed(images), k=1)[:, 0]
        return Layout.fromdict({k: v[idx] for k, v in self.layouts.items()}, device=self.device)

    def precompute_table(self, dataset, k: int, is_train_split: bool,
                         batch_size: int = 256) -> np.ndarray:
        """Top-k table [N, k] for a whole split."""
        out = np.zeros((len(dataset), k), np.int64)
        for s in range(0, len(dataset), batch_size):
            idx = np.arange(s, min(s + batch_size, len(dataset)))
            q = self.embed(dataset.get_images(idx))
            out[idx] = self.topk(q, k, exclude_self=is_train_split, query_ids=idx)
        return out


def mmr_rerank(features: np.ndarray, candidates: np.ndarray, query_feats: np.ndarray,
               k: int, lam: float = 0.5) -> np.ndarray:
    """Maximal-marginal-relevance rerank (numpy, as in JAX): from each row's
    candidates [B, C] pick k greedily, each maximizing
    lam * sim(query) - (1 - lam) * max sim(already picked)."""
    B, _ = candidates.shape
    out = np.zeros((B, k), np.int64)
    for b in range(B):
        cand = list(candidates[b])
        cf = features[candidates[b]]  # [C, D]
        qsim = cf @ query_feats[b]
        picked: list[int] = []
        picked_feat = []
        for slot in range(k):
            if picked_feat:
                div = np.max(np.stack(picked_feat) @ cf.T, axis=0)
            else:
                div = np.zeros(len(cand))
            score = lam * qsim - (1 - lam) * div
            score[[i for i, c in enumerate(cand) if c in picked]] = -np.inf
            j = int(np.argmax(score))
            picked.append(cand[j])
            picked_feat.append(cf[j])
            out[b, slot] = cand[j]
    return out
