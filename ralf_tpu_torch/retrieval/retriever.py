"""Brute-force top-k retrieval over the gallery, the counterpart of
`ralf_tpu/retrieval/retriever.py` with the `saliency` backbone.

Query and gallery features are L2-normalized 16x16 saliency thumbnails;
neighbours are the inner-product top-k, one matrix product on the device.
The thumbnail is a bilinear downsample WITH antialiasing, as
`jax.image.resize(method="linear")` does when it shrinks (without it the
thumbnails differ by up to 0.48).

`Retriever.build` loads the gallery features from, and saves them to, the
cache of `ralf_tpu_torch/cache.py` (the JAX package's file), so repeated
runs embed nothing.  `predict_top1` is the non-learnable top-1 copy
baseline; `mmr_rerank` the maximal-marginal-relevance diversity rerank.
The other backbones (dreamsim, clip, vgg) are towers not ported yet.
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
    if backbone == "saliency":
        return
    if backbone in BACKBONE_NAMES:
        raise NotImplementedError(
            f"retrieval backbone {backbone!r} runs a feature tower the port does not have "
            "yet (ROADMAP.md Queue A item 9, towers); use backbone='saliency'")
    raise ValueError(f"unknown retrieval backbone {backbone!r}; choose from {BACKBONE_NAMES}")


def exact_topk(query: torch.Tensor, gallery: torch.Tensor, k: int,
               exclude_self: bool = False,
               query_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inner-product top-k gallery rows [B, k]; optionally never the query's own row."""
    scores = query.float() @ gallery.float().t()
    if exclude_self:
        rows = torch.arange(gallery.shape[0], device=scores.device)
        scores = scores.masked_fill(rows[None, :] == query_ids[:, None], float("-inf"))
    return torch.topk(scores, k, dim=-1).indices


class Retriever:
    """Gallery of (features on the device, layouts on the host)."""

    def __init__(self, features, layouts: dict, device="cuda", backbone: str = "saliency") -> None:
        _check_backbone(backbone)
        self.device = resolve_device(device)
        self.backbone_name = backbone
        f = np.asarray(features, np.float32)  # normalized in numpy, as JAX does
        f = f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-8)
        self.features = torch.as_tensor(f, device=self.device)
        self.layouts = {k: np.asarray(v) for k, v in layouts.items()}

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
                return cls(cached, layouts, dev, backbone)
        feats = []
        for s in range(0, n, batch_size):
            idx = np.arange(s, min(s + batch_size, n))
            images = torch.from_numpy(dataset.get_images(idx)).to(dev)
            feats.append(coarse_saliency_features(images).cpu().numpy())
        features = np.concatenate(feats, 0)
        if cache_dir and name:
            from ralf_tpu_torch import cache as cache_mod

            cache_mod.save_gallery_features(cache_dir, name, backbone, features)
        return cls(features, layouts, dev, backbone)

    def embed(self, images) -> torch.Tensor:
        return coarse_saliency_features(torch.as_tensor(np.asarray(images), device=self.device))

    def topk(self, query_feats: torch.Tensor, k: int, exclude_self: bool = False,
             query_ids: Optional[np.ndarray] = None) -> np.ndarray:
        qid = None
        if exclude_self:
            qid = torch.as_tensor(np.asarray(query_ids), device=self.device)
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
