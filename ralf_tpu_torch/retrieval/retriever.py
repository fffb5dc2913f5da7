"""Brute-force top-k retrieval over the gallery, the counterpart of
`ralf_tpu/retrieval/retriever.py` with the `saliency` backbone.

Query and gallery features are L2-normalized 16x16 saliency thumbnails;
neighbours are the inner-product top-k, one matrix product on the device.
The thumbnail is a bilinear downsample WITH antialiasing, as
`jax.image.resize(method="linear")` does when it shrinks (without it the
thumbnails differ by up to 0.48).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ralf_tpu_torch.utils.device import resolve_device


def coarse_saliency_features(images: torch.Tensor, grid: int = 16) -> torch.Tensor:
    """[B, H, W, 4] -> L2-normalized [B, grid*grid] saliency thumbnails."""
    sal = images[..., 3].float()
    if not images.is_floating_point():
        sal = sal * (1.0 / 255.0)
    feat = F.interpolate(sal[:, None], size=(grid, grid), mode="bilinear",
                         align_corners=False, antialias=True)
    feat = feat.reshape(sal.shape[0], grid * grid)
    return feat / feat.norm(dim=-1, keepdim=True).clamp_min(1e-8)


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

    def __init__(self, features, layouts: dict, device="cuda") -> None:
        self.device = resolve_device(device)
        f = torch.as_tensor(np.asarray(features, np.float32), device=self.device)
        self.features = f / f.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        self.layouts = {k: np.asarray(v) for k, v in layouts.items()}

    @classmethod
    def build(cls, dataset, batch_size: int = 256, device="cuda") -> "Retriever":
        """Saliency features of every gallery canvas of `dataset`."""
        dev = resolve_device(device)
        n = len(dataset)
        feats = []
        for s in range(0, n, batch_size):
            idx = np.arange(s, min(s + batch_size, n))
            images = torch.from_numpy(dataset.get_images(idx)).to(dev)
            feats.append(coarse_saliency_features(images).cpu().numpy())
        return cls(np.concatenate(feats, 0), dataset.get_layouts(np.arange(n)), dev)

    def embed(self, images) -> torch.Tensor:
        return coarse_saliency_features(torch.as_tensor(np.asarray(images), device=self.device))

    def topk(self, query_feats: torch.Tensor, k: int, exclude_self: bool = False,
             query_ids: Optional[np.ndarray] = None) -> np.ndarray:
        qid = None
        if exclude_self:
            qid = torch.as_tensor(np.asarray(query_ids), device=self.device)
        return exact_topk(query_feats, self.features, k, exclude_self, qid).cpu().numpy()

    def gather_neighbors(self, idx: np.ndarray) -> dict:
        """[B, K] gallery indices -> {'label': [B, K, S], ..., 'mask': [B, K, S]}."""
        idx = np.asarray(idx)
        return {key: arr[idx] for key, arr in self.layouts.items()}

    def precompute_table(self, dataset, k: int, is_train_split: bool,
                         batch_size: int = 256) -> np.ndarray:
        """Top-k table [N, k] for a whole split."""
        out = np.zeros((len(dataset), k), np.int64)
        for s in range(0, len(dataset), batch_size):
            idx = np.arange(s, min(s + batch_size, len(dataset)))
            q = self.embed(dataset.get_images(idx))
            out[idx] = self.topk(q, k, exclude_self=is_train_split, query_ids=idx)
        return out
